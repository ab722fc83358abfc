"""iterseg's anisotropic 3D U-Net in plain PyTorch, from its checkpoint.

Encoder blocks ``c0``-``c4`` (1 -> 32 -> 64 -> 128 -> 256 -> 256), each
(conv 3x3x3 -> BatchNorm -> ReLU) twice, with max pools of (1, 2, 2) and a
bottom pool of (2, 2, 2), all padded (0, 1, 1); decoder blocks ``c5_0``-
``c8_0`` after depthwise transposed convs ``up0``-``up3`` (kernel =
stride), whose outputs are cropped ``[..., :-1, :-1]`` (inner three) and
``[..., 1:-1, 1:-1]`` (outer) and concatenated before the skip; a sigmoid
head. Eval mode normalises with the running statistics, train mode with
the batch's (biased variance), as ``torch.nn.BatchNorm3d`` does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

ENCODER = ("c0", "c1", "c2", "c3", "c4")
POOLS = ((1, 2, 2), (1, 2, 2), (1, 2, 2), (2, 2, 2))
DECODER = (("up0", (2, 2, 2), 0, "c5_0"), ("up1", (1, 2, 2), 0, "c6_0"),
           ("up2", (1, 2, 2), 0, "c7_0"), ("up3", (1, 2, 2), 1, "c8_0"))
EPS = 1e-5


def load_params(path, device, dtype=torch.float32):
    """The checkpoint's arrays as tensors on ``device``."""
    with np.load(path) as data:
        return {k: torch.from_numpy(np.array(data[k], np.float32)).to(
                    device=device, dtype=dtype)
                for k in data.files if not k.endswith("num_batches_tracked")}


def trainable(params):
    """The names of the learnt leaves (the running statistics are not)."""
    return [k for k in params if "running" not in k]


def _norm(x, p, name, train):
    w = p[name + ".weight"].reshape(1, -1, 1, 1, 1)
    b = p[name + ".bias"].reshape(1, -1, 1, 1, 1)
    if train:
        mean = x.mean(dim=(0, 2, 3, 4), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(0, 2, 3, 4), keepdim=True)
    else:
        mean = p[name + ".running_mean"].reshape(1, -1, 1, 1, 1)
        var = p[name + ".running_var"].reshape(1, -1, 1, 1, 1)
    return (x - mean) / torch.sqrt(var + EPS) * w + b


def _block(x, p, name, train, head=False):
    x = F.conv3d(x, p[name + ".conv0.weight"], p[name + ".conv0.bias"],
                 padding=1)
    x = torch.relu(_norm(x, p, name + ".batch0", train))
    x = F.conv3d(x, p[name + ".conv1.weight"], p[name + ".conv1.bias"],
                 padding=1)
    x = _norm(x, p, name + ".batch1", train)
    return torch.sigmoid(x) if head else torch.relu(x)


def forward(p, x, train=False):
    """NCZYX in, the 5 sigmoid channels out."""
    skips = []
    h = x
    for i, name in enumerate(ENCODER):
        if i:
            h = F.max_pool3d(h, POOLS[i - 1], POOLS[i - 1], padding=(0, 1, 1))
        h = _block(h, p, name, train)
        skips.append(h)
    h = skips.pop()
    for up, k, c, name in DECODER:
        skip = skips.pop()
        u = F.conv_transpose3d(h, p[up + ".weight"], p[up + ".bias"],
                               stride=k, groups=h.shape[1])
        u = u[..., c:-1, c:-1]
        h = _block(torch.cat([u, skip], 1), p, name, train,
                   head=name == "c8_0")
    return h


def axis_grid(n, chunk, margin):
    """Chunk starts and writeback crops along one axis (iterseg
    ``predict.py``): starts advance by ``chunk - 2 margin`` and the last is
    pinned to the end; each chunk writes its share between the boundaries
    ``0, start_i + margin (interior), n``."""
    stride = chunk - 2 * margin
    count = max(1, -(-(n - 2 * margin) // stride))
    starts = [i * stride for i in range(count - 1)] + [n - chunk]
    if count >= 2 and starts[-1] == starts[-2]:
        starts.pop()
        count -= 1
    bounds = [0] + [i * stride + margin for i in range(1, count)] + [n]
    return [(s, bounds[i] - s, bounds[i + 1] - s)
            for i, s in enumerate(starts)]


def chunk_grid(shape, chunk, margin):
    """(start, crop) of every chunk of the grid, z-major."""
    axes = [axis_grid(n, c, m) for n, c, m in zip(shape, chunk, margin)]
    return [((a[0], b[0], c[0]), ((a[1], a[2]), (b[1], b[2]), (c[1], c[2])))
            for a in axes[0] for b in axes[1] for c in axes[2]]


def check_geometry(shape, chunk, margin):
    """The grids the reference runs: chunks no larger than the volume, z
    even, y and x multiples of 16, margins under half a chunk."""
    for n, c, m, mult in zip(shape, chunk, margin, (2, 16, 16)):
        if c > n or c % mult or 2 * m >= c:
            raise ValueError(f"unsupported geometry {shape} {chunk} {margin}")


def features(p, vol, chunk, margin, batch=6):
    """The U-Net's 5 channels over a (z, y, x) float volume, chunk by
    chunk, each chunk's margins cropped away."""
    check_geometry(vol.shape, chunk, margin)
    grid = chunk_grid(vol.shape, chunk, margin)
    out = torch.empty((5,) + tuple(vol.shape), dtype=torch.float32,
                      device=vol.device)
    with torch.no_grad():
        for b in range(0, len(grid), batch):
            part = grid[b:b + batch]
            xs = torch.stack([vol[s[0]:s[0] + chunk[0], s[1]:s[1] + chunk[1],
                                  s[2]:s[2] + chunk[2]] for s, _ in part])
            ys = forward(p, xs[:, None]).float()
            for y, (s, cr) in zip(ys, part):
                (z0, z1), (y0, y1), (x0, x1) = cr
                out[:, s[0] + z0:s[0] + z1, s[1] + y0:s[1] + y1,
                    s[2] + x0:s[2] + x1] = y[:, z0:z1, y0:y1, x0:x1]
    return out


def widths(params):
    """The U-Net's widths as the configurations state them, read from the
    checkpoint's array shapes."""
    def conv(name):
        return tuple(params[name + ".weight"].shape[:2])  # (out, in)

    return {"in_channels": conv("c0.conv0")[1],
            "encoder_channels": [conv(n + ".conv1")[0] for n in ENCODER],
            "decoder_channels": [[conv(n + ".conv0")[1], conv(n + ".conv1")[0]]
                                 for *_, n in DECODER],
            "out_channels": conv("c8_0.conv1")[0],
            "learnt_parameters": int(sum(params[k].numel()
                                         for k in trainable(params)))}
