"""Swin UNETR (MONAI ``SwinUNETR`` v1, ``feature_size`` F) in plain
PyTorch, from its state dict; and its affinity watershed.

Hatamizadeh et al., arXiv:2201.01266; MONAI
``monai/networks/nets/swin_unetr.py`` with ``downsample="merging"``,
``use_v2=False``, ``normalize=True``, instance norm, dropouts 0. Written
from those equations with unfused attention, as MONAI computes it:

- stem: ``Conv3d(in, F, k=2, s=2)`` with bias;
- stage i (C = F 2^i, heads from the bias tables): channels-last tokens;
  window 7 and shift 3 per axis, an axis of at most 7 taking its size as
  window and shift 0; blocks ``x + Attn(LN1(x))`` then
  ``x + Linear(GELU(Linear(LN2(x))))`` (exact GELU), the odd blocks
  shifted when any shift is > 0. Attn: zero-pad LN1's output at the far
  end to a multiple of the window (padded tokens are keys, unmasked), roll
  by -shift, partition into windows, ``qkv = Linear(C, 3C)``, ``q`` scaled
  by width^-1/2, ``q k^T`` plus the bias gathered from the table by the
  full 7^3 window's relative index (``[:n, :n]`` of it for a window of n
  tokens) plus -100 where the region ids of ``compute_mask`` differ
  (shifted blocks), softmax, ``@ v``, ``proj``, reverse, roll back, crop;
- patch merging: v1's 8 slices ``(0,0,0) (1,0,0) (0,1,0) (0,0,1) (1,0,1)
  (0,1,0) (0,0,1) (1,1,1)`` (two repeated; MONAI's pretrained weights
  assume it), LayerNorm(8C), Linear(8C -> 2C) without bias;
- skips: every stage's input and the last output LayerNormed without
  weights; residual conv blocks (3^3 convs without bias, InstanceNorm
  without affine, LeakyReLU 0.01, a 1^3 conv on the residual when the
  widths differ), full 2^3 transposed convs without bias, a 1^3 output
  conv with bias.

One departure from MONAI: iterseg's sigmoid on the outputs, as the
U-Net's heads have. LayerNorm and InstanceNorm eps 1e-5.

``init_params`` draws MONAI's initial distributions from a seed; ``widths``
reads the configuration's keys back from a state dict; ``features`` runs
the network over the chunk grid; ``affinity_labels`` is
``reference.segment.affinity_labels`` with this network's features.
"""
from __future__ import annotations

import contextlib
import itertools
import math

import torch
import torch.nn.functional as F

from . import segment
from . import unet as ref_unet

WINDOW, SHIFT, PATCH, EPS = 7, 3, 2, 1e-5
MERGE = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 0),
         (0, 0, 1), (1, 1, 1))
DECODERS = (("decoder5", 3), ("decoder4", "enc3"), ("decoder3", "enc2"),
            ("decoder2", "enc1"), ("decoder1", "enc0"))
MULTIPLE = 32


def names(feature_size=48, in_channels=1, out_channels=5,
          depths=(2, 2, 2, 2), heads=(3, 6, 12, 24)):
    """MONAI's state-dict names and shapes, as a dict."""
    f, out = feature_size, {}
    out["swinViT.patch_embed.proj.weight"] = (f, in_channels, 2, 2, 2)
    out["swinViT.patch_embed.proj.bias"] = (f,)
    for i, (depth, h) in enumerate(zip(depths, heads)):
        c = f * 2 ** i
        layer = f"swinViT.layers{i + 1}.0."
        for b in range(depth):
            p = f"{layer}blocks.{b}."
            for name, shape in (
                    ("norm1.weight", (c,)), ("norm1.bias", (c,)),
                    ("attn.relative_position_bias_table", (13 ** 3, h)),
                    ("attn.relative_position_index", (343, 343)),
                    ("attn.qkv.weight", (3 * c, c)), ("attn.qkv.bias",
                                                      (3 * c,)),
                    ("attn.proj.weight", (c, c)), ("attn.proj.bias", (c,)),
                    ("norm2.weight", (c,)), ("norm2.bias", (c,)),
                    ("mlp.linear1.weight", (4 * c, c)),
                    ("mlp.linear1.bias", (4 * c,)),
                    ("mlp.linear2.weight", (c, 4 * c)),
                    ("mlp.linear2.bias", (c,))):
                out[p + name] = shape
        out[layer + "downsample.reduction.weight"] = (2 * c, 8 * c)
        out[layer + "downsample.norm.weight"] = (8 * c,)
        out[layer + "downsample.norm.bias"] = (8 * c,)

    def res(prefix, cin, cout):
        out[prefix + "conv1.conv.weight"] = (cout, cin, 3, 3, 3)
        out[prefix + "conv2.conv.weight"] = (cout, cout, 3, 3, 3)
        if cin != cout:
            out[prefix + "conv3.conv.weight"] = (cout, cin, 1, 1, 1)

    for name, cin, cout in (("encoder1", in_channels, f), ("encoder2", f, f),
                            ("encoder3", 2 * f, 2 * f),
                            ("encoder4", 4 * f, 4 * f),
                            ("encoder10", 16 * f, 16 * f)):
        res(name + ".layer.", cin, cout)
    for name, cin, cout in (("decoder5", 16 * f, 8 * f),
                            ("decoder4", 8 * f, 4 * f),
                            ("decoder3", 4 * f, 2 * f),
                            ("decoder2", 2 * f, f), ("decoder1", f, f)):
        out[name + ".transp_conv.conv.weight"] = (cin, cout, 2, 2, 2)
        res(name + ".conv_block.", 2 * cout, cout)
    out["out.conv.conv.weight"] = (out_channels, f, 1, 1, 1)
    out["out.conv.conv.bias"] = (out_channels,)
    return out


def relative_index():
    """MONAI's ``relative_position_index`` of the 7^3 window: (343, 343)."""
    r = torch.arange(WINDOW)
    coords = torch.stack(torch.meshgrid(r, r, r, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (
        WINDOW - 1)
    span = 2 * WINDOW - 1
    return rel[..., 0] * span * span + rel[..., 1] * span + rel[..., 2]


def init_params(seed, **widths):
    """A state dict in MONAI's initial distributions: convs and linears
    (weights and biases) uniform in +-1/sqrt(fan-in), fan-in
    ``weight.shape[1] x prod(kernel)`` (torch's defaults); the bias tables
    normal with std 0.02 truncated at +-2; LayerNorm weight 1, bias 0.
    Drawn from a CPU ``torch.Generator`` seeded by ``seed``."""
    gen = torch.Generator().manual_seed(int(seed) % (1 << 63))
    shapes = names(**widths)
    params = {}
    for k, shape in shapes.items():
        if k.endswith("relative_position_index"):
            params[k] = relative_index()
        elif k.endswith("relative_position_bias_table"):
            params[k] = torch.randn(shape, generator=gen).mul_(0.02).clamp_(
                -2.0, 2.0)
        elif ".norm" in k:
            params[k] = (torch.ones if k.endswith("weight") else
                         torch.zeros)(shape)
        else:
            fan_in = math.prod(shapes[k.rsplit(".", 1)[0] + ".weight"][1:])
            bound = 1.0 / math.sqrt(fan_in)
            params[k] = torch.empty(shape).uniform_(-bound, bound,
                                                    generator=gen)
    return params


def load_params(path, device):
    """A ``.pt`` state dict's float tensors on ``device`` (the index
    buffers as int64)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: (v.long() if k.endswith("relative_position_index")
                else v.float()).to(device) for k, v in sd.items()}


def widths(params):
    """The configuration's architecture keys, read from a state dict."""
    emb = params["swinViT.patch_embed.proj.weight"].shape
    depths, heads = [], []
    for i in range(1, 5):
        p = f"swinViT.layers{i}.0.blocks."
        depths.append(len({k.split(".")[4] for k in params
                           if k.startswith(p)}))
        heads.append(int(params[p + "0.attn.relative_position_bias_table"]
                         .shape[1]))
    return {"in_channels": int(emb[1]),
            "out_channels": int(params["out.conv.conv.weight"].shape[0]),
            "feature_size": int(emb[0]), "depths": depths,
            "num_heads": heads,
            "window_size": (round(params["swinViT.layers1.0.blocks.0.attn."
                                         "relative_position_bias_table"]
                                  .shape[0] ** (1 / 3)) + 1) // 2,
            "patch_size": int(emb[2]),
            "mlp_ratio": int(params["swinViT.layers1.0.blocks.0.mlp."
                                    "linear1.weight"].shape[0]
                             // emb[0]),
            "learnt_parameters": int(sum(
                v.numel() for k, v in params.items()
                if not k.endswith("relative_position_index")))}


def _partition(x, w):
    b, d, h, ww_, c = x.shape
    x = x.view(b, d // w[0], w[0], h // w[1], w[1], ww_ // w[2], w[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, w[0] * w[1] * w[2],
                                                      c)


def _reverse(win, w, b, d, h, ww_):
    x = win.view(b, d // w[0], h // w[1], ww_ // w[2], w[0], w[1], w[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, ww_, -1)


def _mask(dims, w, s, device):
    """MONAI ``compute_mask``: (windows, n, n) of 0 and -100."""
    img = torch.zeros((1,) + tuple(dims) + (1,), device=device)
    cnt = 0
    for a in (slice(-w[0]), slice(-w[0], -s[0]), slice(-s[0], None)):
        for b in (slice(-w[1]), slice(-w[1], -s[1]), slice(-s[1], None)):
            for c in (slice(-w[2]), slice(-w[2], -s[2]), slice(-s[2], None)):
                img[:, a, b, c, :] = cnt
                cnt += 1
    win = _partition(img, w).squeeze(-1)
    diff = win.unsqueeze(1) - win.unsqueeze(2)
    return diff.masked_fill(diff != 0, -100.0).masked_fill(diff == 0, 0.0)


def _attention(p, pre, x, w, s):
    """One block's attention on channels-last tokens (MONAI
    ``forward_part1`` with ``WindowAttention``)."""
    b, d, h, ww_, c = x.shape
    heads = p[pre + "attn.relative_position_bias_table"].shape[1]
    y = F.layer_norm(x, (c,), p[pre + "norm1.weight"], p[pre + "norm1.bias"],
                     EPS)
    pads = [(-n) % k for n, k in zip((d, h, ww_), w)]
    y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    dims = y.shape[1:4]
    shifted = any(v > 0 for v in s)
    if shifted:
        y = torch.roll(y, (-s[0], -s[1], -s[2]), (1, 2, 3))
    win = _partition(y, w)
    nb, n, _ = win.shape
    qkv = F.linear(win, p[pre + "attn.qkv.weight"], p[pre + "attn.qkv.bias"])
    q, k, v = qkv.reshape(nb, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    a = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1)
    idx = p[pre + "attn.relative_position_index"][:n, :n].reshape(-1)
    bias = p[pre + "attn.relative_position_bias_table"][idx]
    a = a + bias.reshape(n, n, heads).permute(2, 0, 1).unsqueeze(0)
    if shifted:
        m = _mask(dims, w, s, x.device)
        a = (a.view(nb // m.shape[0], m.shape[0], heads, n, n)
             + m.unsqueeze(1).unsqueeze(0)).view(nb, heads, n, n)
    a = torch.softmax(a, -1)
    o = (a @ v).transpose(1, 2).reshape(nb, n, c)
    o = F.linear(o, p[pre + "attn.proj.weight"], p[pre + "attn.proj.bias"])
    o = _reverse(o, w, b, *dims)
    if shifted:
        o = torch.roll(o, s, (1, 2, 3))
    return o[:, :d, :h, :ww_]


def _block(p, pre, x, shifted):
    dims = x.shape[1:4]
    w = tuple(min(n, WINDOW) for n in dims)
    s = tuple(SHIFT if n > WINDOW and shifted else 0 for n in dims)
    x = x + _attention(p, pre, x, w, s)
    c = x.shape[-1]
    y = F.layer_norm(x, (c,), p[pre + "norm2.weight"], p[pre + "norm2.bias"],
                     EPS)
    y = F.gelu(F.linear(y, p[pre + "mlp.linear1.weight"],
                        p[pre + "mlp.linear1.bias"]))
    return x + F.linear(y, p[pre + "mlp.linear2.weight"],
                        p[pre + "mlp.linear2.bias"])


def _merge(p, pre, x, order=MERGE):
    d, h, w = x.shape[1:4]
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    x = torch.cat([x[:, i::2, j::2, k::2, :] for i, j, k in order], -1)
    x = F.layer_norm(x, (x.shape[-1],), p[pre + "norm.weight"],
                     p[pre + "norm.bias"], EPS)
    return F.linear(x, p[pre + "reduction.weight"])


def _skip(x):
    """A channels-last stage output, LayerNormed without weights, NCDHW."""
    return F.layer_norm(x, (x.shape[-1],), eps=EPS).permute(0, 4, 1, 2, 3)


def _res(p, pre, x):
    def conv(name, t):
        wt = p[pre + name + ".conv.weight"]
        return F.conv3d(t, wt, padding=wt.shape[-1] // 2)

    def norm(t):
        return F.instance_norm(t, eps=EPS)

    o = F.leaky_relu(norm(conv("conv1", x)), 0.01)
    o = norm(conv("conv2", o))
    r = norm(conv("conv3", x)) if pre + "conv3.conv.weight" in p else x
    return F.leaky_relu(o + r, 0.01)


def forward(p, x, merge_order=MERGE):
    """NCDHW in (axes multiples of 32), the sigmoid outputs out."""
    if any(n % MULTIPLE for n in x.shape[2:]):
        raise ValueError(f"axes {tuple(x.shape[2:])} are not multiples of "
                         f"{MULTIPLE}")
    h = F.conv3d(x, p["swinViT.patch_embed.proj.weight"],
                 p["swinViT.patch_embed.proj.bias"], stride=PATCH)
    h = h.permute(0, 2, 3, 4, 1)
    hs = [_skip(h)]
    for i in range(1, 5):
        layer = f"swinViT.layers{i}.0."
        for b in itertools.count():
            if layer + f"blocks.{b}.norm1.weight" not in p:
                break
            h = _block(p, layer + f"blocks.{b}.", h, shifted=b % 2 == 1)
        h = _merge(p, layer + "downsample.", h, merge_order)
        hs.append(_skip(h))
    enc = {"enc0": _res(p, "encoder1.layer.", x),
           "enc1": _res(p, "encoder2.layer.", hs[0]),
           "enc2": _res(p, "encoder3.layer.", hs[1]),
           "enc3": _res(p, "encoder4.layer.", hs[2])}
    y = _res(p, "encoder10.layer.", hs[4])
    for name, skip in DECODERS:
        skip = hs[skip] if isinstance(skip, int) else enc[skip]
        u = F.conv_transpose3d(y, p[name + ".transp_conv.conv.weight"],
                               stride=2)
        y = _res(p, name + ".conv_block.", torch.cat([u, skip], 1))
    y = F.conv3d(y, p["out.conv.conv.weight"], p["out.conv.conv.bias"])
    return torch.sigmoid(y)


def check_geometry(shape, chunk, margin):
    """The grids the reference runs: chunk axes multiples of 32, no larger
    than the volume, margins under half a chunk."""
    for n, c, m in zip(shape, chunk, margin):
        if c > n or c % MULTIPLE or 2 * m >= c:
            raise ValueError(f"unsupported geometry {shape} {chunk} {margin}")


def features(p, vol, chunk, margin, batch=2):
    """The network's 5 channels over a (z, y, x) float volume, chunk by
    chunk on the shared chunk grid, each chunk's margins cropped away."""
    check_geometry(vol.shape, chunk, margin)
    grid = ref_unet.chunk_grid(vol.shape, chunk, margin)
    out_ch = p["out.conv.conv.weight"].shape[0]
    out = torch.empty((out_ch,) + tuple(vol.shape), dtype=torch.float32,
                      device=vol.device)
    with torch.no_grad():
        for b in range(0, len(grid), batch):
            part = grid[b:b + batch]
            xs = torch.stack([vol[s[0]:s[0] + chunk[0], s[1]:s[1] + chunk[1],
                                  s[2]:s[2] + chunk[2]] for s, _ in part])
            ys = forward(p, xs[:, None])
            for y, (s, cr) in zip(ys, part):
                (z0, z1), (y0, y1), (x0, x1) = cr
                out[:, s[0] + z0:s[0] + z1, s[1] + y0:s[1] + y1,
                    s[2] + x0:s[2] + x1] = y[:, z0:z1, y0:y1, x0:x1]
    return out


class _Network:
    """The module ``reference.segment`` reads its features from."""

    features = staticmethod(features)


@contextlib.contextmanager
def _network_features():
    """``reference.segment`` computing this network's features: its
    post-processing (normalisation, affinities, Otsu mask, peaks, size
    filter, flood) is reused as it is."""
    saved = segment.unet
    segment.unet = _Network
    try:
        yield
    finally:
        segment.unet = saved


def affinity_labels(frame, params, chunk, margin, device, tf32=False):
    """Labels of one frame by the affinity watershed of this network
    (``tf32``: its convolutions and matmuls round to TF32, the control)."""
    with _network_features():
        return segment.affinity_labels(frame, params, chunk, margin, device,
                                       tf32=tf32)
