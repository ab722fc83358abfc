"""Seeded synthetic inputs: blob frames and training chunks.

A frame is a platelet-like fluorescence volume: ``blobs`` points, blurred
by a Gaussian of sigma (1, 4, 4) (edges repeated), scaled to ``peak`` and
plus integer noise in [0, ``noise``), as uint16. Frames are made on the
device from one ``torch.Generator`` and handed over as host numpy arrays,
as users hand theirs. Training chunks are crops of such frames with
iterseg's targets (of z-1, y-1, x-1 affinities, mask, centreness-log, as
the configuration names them) of the blobs' ground truth: the blurred blobs above a quarter of their
maximum, labelled by 6-connectivity.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage as ndi


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def _taps(sigma, device):
    r = int(4.0 * sigma + 0.5)
    x = torch.arange(-r, r + 1, dtype=torch.float64)
    w = torch.exp(-0.5 * (x / sigma) ** 2)
    return (w / w.sum()).to(device=device, dtype=torch.float32)


def _blur(vol, sigmas):
    """Separable Gaussian over the last three axes of (n, z, y, x)."""
    for axis, s in zip((1, 2, 3), sigmas):
        w = _taps(s, vol.device)
        r = len(w) // 2
        x = vol.movedim(axis, -1)
        shape = x.shape
        x = F.pad(x.reshape(-1, 1, shape[-1]), (r, r), mode="replicate")
        x = F.conv1d(x, w.view(1, 1, -1)).reshape(shape)
        vol = x.movedim(-1, axis)
    return vol


def blob_stack(gen, n, shape, blobs, peak, noise):
    """(n, *shape) float32 blurred blobs (before scaling) and the uint16
    frames made from them, both on the generator's device."""
    dev = gen.device
    pts = [torch.randint(2, s - 2, (n, blobs), generator=gen, device=dev)
           for s in shape]
    vol = torch.zeros((n,) + tuple(shape), device=dev)
    frame_ix = torch.arange(n, device=dev)[:, None].expand(n, blobs)
    vol[frame_ix, pts[0], pts[1], pts[2]] = 1.0
    blur = _blur(vol, (1.0, 4.0, 4.0))
    top = blur.amax(dim=(1, 2, 3), keepdim=True)
    frames = (blur / top * peak
              + torch.randint(0, noise, blur.shape, generator=gen,
                              device=dev)).to(torch.int32)
    return blur / top, frames


def _as_frame(f, dtype):
    """A frame as the host array of ``dtype`` that users hand over."""
    dtype = np.dtype(dtype)
    if f.max() > np.iinfo(dtype).max:
        raise ValueError(f"frames do not fit {dtype}")
    return f.astype(dtype)


def frame_pool(seed, n, shape, blobs, peak, noise, device, dtype="uint16"):
    """``n`` distinct frames of ``shape`` and integer ``dtype`` from
    ``seed``, as host arrays."""
    _, frames = blob_stack(generator(seed, device), n, shape, blobs, peak,
                           noise)
    return [_as_frame(f.cpu().numpy(), dtype) for f in frames]


def _affinity(labels, axis):
    """1 where the label changes to the next voxel along ``axis`` (the
    last voxel compares with its reflection)."""
    pad = [(0, 0)] * 3
    pad[axis] = (1, 1)
    lp = np.pad(labels, pad, mode="reflect")
    n = labels.shape[axis]
    a = np.take(lp, np.arange(0, n), axis=axis)
    b = np.take(lp, np.arange(1, n + 1), axis=axis)
    return (a != b).astype(np.float32)


def _centreness_log(labels, scale=(4, 1, 1)):
    """Per object: 1 - (log distance to its centroid, shifted to start at
    0, over its largest); 0 off objects."""
    out = np.zeros(labels.shape, np.float32)
    idx = np.flatnonzero(labels)
    if idx.size == 0:
        return out
    lab = labels.ravel()[idx]
    coords = np.stack(np.unravel_index(idx, labels.shape), 1).astype(
        np.float64)
    count = np.bincount(lab)
    cent = np.stack([np.bincount(lab, coords[:, a]) for a in range(3)], 1)
    cent = cent / np.maximum(count, 1)[:, None]
    d = np.linalg.norm((cent[lab] - coords) * np.asarray(scale), axis=1)
    d = np.where(d > 0, np.log(np.where(d > 0, d, 1.0)), d)
    lo = np.full(count.size, np.inf)
    np.minimum.at(lo, lab, d)
    d = d + np.abs(lo[lab])
    hi = np.zeros(count.size)
    np.maximum.at(hi, lab, d)
    with np.errstate(invalid="ignore", divide="ignore"):
        score = 1 - d / hi[lab]
    out.ravel()[idx] = np.nan_to_num(score)
    return out


TARGETS = {
    "z-1": lambda labels, scale: _affinity(labels, 0),
    "y-1": lambda labels, scale: _affinity(labels, 1),
    "x-1": lambda labels, scale: _affinity(labels, 2),
    "mask": lambda labels, scale: (labels > 0).astype(np.float32),
    "centreness-log": lambda labels, scale: _centreness_log(labels, scale),
}


def targets(labels, names=tuple(TARGETS), scale=(4, 1, 1)):
    """The named training targets of a labelled chunk, (c, z, y, x)."""
    unknown = [n for n in names if n not in TARGETS]
    if unknown:
        raise ValueError(f"no recipe for the targets {unknown}")
    return np.stack([TARGETS[n](labels, tuple(scale)) for n in names])


def train_chunks(seed, n, chunk, source_frames, shape, blobs, peak, noise,
                 device, dtype="uint16", names=tuple(TARGETS),
                 scale=(4, 1, 1)):
    """``n`` distinct (x, y) training chunks: x (z, y, x) float32 in
    [0, 1], y (c, z, y, x) float32 of the targets ``names``, cropped at
    seeded places from ``source_frames`` frames of integer ``dtype``."""
    gen = generator(seed, device)
    blur, frames = blob_stack(gen, source_frames, shape, blobs, peak, noise)
    rng = np.random.default_rng(int(seed) % (1 << 63))
    out = []
    frames = _as_frame(frames.cpu().numpy(), dtype)
    blur = blur.cpu().numpy()
    for i in range(n):
        f = i % source_frames
        start = [int(rng.integers(0, s - c + 1)) for s, c in
                 zip(shape, chunk)]
        sl = tuple(slice(a, a + c) for a, c in zip(start, chunk))
        x = frames[f][sl].astype(np.float32)
        labels, _ = ndi.label(blur[f][sl] > 0.25)
        out.append((x / x.max(), targets(labels, names, scale)))
    return out
