"""The two segmenters' labels for one (z, y, x) uint16 frame.

``affinity_labels``: iterseg's ``affinity_unet_watershed`` — the frame
over its maximum, the U-Net over the chunk grid, the affinities over each
channel's maximum and padded by one, seeds at the peaks (above 0.04) of
the centre channel smoothed by sigma (0, 1, 1), the mask channel above the
Otsu threshold of its sigma-2 smoothing, objects outside [10, 1e7) voxels
dropped with their seeds, then the affinity flood.

``dog_labels``: iterseg's ``dog_blob_watershed`` — the frame over its
maximum, padded by one; the mask where the difference of Gaussians
(sigma 1 and 1.5) exceeds 0.02; seeds at scikit-image ``blob_dog``'s blobs
(sigma ratio 1.6, overlap 0.5), labelled by 6-connectivity; the image flood
of the negated Euclidean distance to the frame's zero voxels.

``dtype`` is the precision of the filters (and ``tf32`` lets the U-Net's
convolutions round to TF32): float32 with TF32 off is what the
configurations state; lower precisions are the controls.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage as ndi
from scipy import spatial

from . import filters, flood, unet


@contextlib.contextmanager
def tf32_mode(on: bool):
    """cuDNN and matmuls with TF32 on or off, cuDNN's deterministic
    algorithms; restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = bool(on)
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


def _normalised(frame, device, dtype=torch.float32):
    if not np.all(frame.reshape(frame.shape[0], -1).sum(1)):
        raise ValueError("a z plane of the frame is all zero")
    v = torch.from_numpy(np.asarray(frame, np.int32)).to(device).float()
    return (v / v.max()).to(dtype)


def affinity_labels(frame, params, chunk, margin, device, tf32=False):
    """Labels of one frame by the affinity U-Net watershed."""
    with tf32_mode(tf32):
        feat = unet.features(params, _normalised(frame, device), chunk,
                             margin)
    aff = feat[:3] / torch.amax(feat[:3], dim=(1, 2, 3)).reshape(-1, 1, 1, 1)
    aff = F.pad(aff, (1, 1, 1, 1, 1, 1)).cpu().numpy()
    cent = filters.gaussian(feat[4], (0, 1, 1))
    thresh = filters.otsu(filters.gaussian(feat[3], 2.0).cpu().numpy())
    mask = (feat[3] > torch.tensor(thresh, device=device)).cpu().numpy()
    seeds = filters.local_peaks(cent, 0.04, border=1) + 1
    mask = np.pad(mask, 1)
    comp, _ = ndi.label(mask)
    sizes = np.bincount(comp.ravel())
    keep = (sizes >= 10) & (sizes < 10_000_000)
    keep[0] = False
    mask = keep[comp]
    if len(seeds):
        seeds = seeds[mask[tuple(seeds.T)]]
    return flood.affinity_flood(aff, seeds, mask)[1:-1, 1:-1, 1:-1]


def _blob_overlap(b1, b2):
    """Share of the smaller sphere inside the larger (scikit-image
    ``_blob_overlap``, 3D, one sigma a blob)."""
    root = np.sqrt(3)
    if b1[-1] > b2[-1]:
        big, r1, r2 = b1[-1], 1.0, b2[-1] / b1[-1]
    else:
        big, r2, r1 = b2[-1], 1.0, b1[-1] / b2[-1]
    if big == 0:
        return 0.0
    d = np.sqrt(np.sum((b2[:3] / (big * root) - b1[:3] / (big * root)) ** 2))
    if d > r1 + r2:
        return 0.0
    if d <= abs(r1 - r2):
        return 1.0
    vol = (np.pi / (12 * d) * (r1 + r2 - d) ** 2
           * (d ** 2 + 2 * d * (r1 + r2) - 3 * (r1 - r2) ** 2))
    return vol / (4.0 / 3.0 * np.pi * min(r1, r2) ** 3)


def _prune(blobs, overlap):
    """scikit-image ``_prune_blobs``: of two blobs that overlap by more
    than ``overlap`` the smaller goes (the first of the pair on a tie);
    pairs in sorted order."""
    if len(blobs) == 0:
        return blobs
    dist = 2 * blobs[:, -1].max() * np.sqrt(3)
    for i, j in sorted(spatial.cKDTree(blobs[:, :3]).query_pairs(dist)):
        b1, b2 = blobs[i], blobs[j]
        if b1[-1] == 0 or b2[-1] == 0:
            continue
        if _blob_overlap(b1, b2) > overlap:
            if b1[-1] > b2[-1]:
                b2[-1] = 0
            else:
                b1[-1] = 0
    return blobs[blobs[:, -1] > 0]


def blob_dog(v, min_sigma, max_sigma, ratio, threshold, overlap):
    """scikit-image ``blob_dog`` of a 3D tensor with scalar sigmas:
    (n, 4) rows of (z, y, x, sigma)."""
    k = int(np.log(max_sigma / min_sigma) / np.log(ratio) + 1)
    sigmas = [min_sigma * ratio ** i for i in range(k + 1)]
    g = [filters.gaussian(v, s) for s in sigmas]
    scale = torch.tensor(1 / (ratio - 1), dtype=v.dtype, device=v.device)
    cube = torch.stack([(g[i] - g[i + 1]) * scale for i in range(k)], -1)
    # peaks of the (z, y, x, scale) cube: a 3^4 window, nearest at the ends
    cmax = cube
    for axis in range(4):
        n = cube.shape[axis]
        idx = torch.arange(-1, n + 1, device=v.device).clamp(0, n - 1)
        cp = cmax.index_select(axis, idx)
        cmax = torch.maximum(torch.maximum(cp.narrow(axis, 0, n),
                                           cp.narrow(axis, 1, n)),
                             cp.narrow(axis, 2, n))
    cand = (cube == cmax) & (cube > threshold)
    coords = torch.nonzero(cand).cpu().numpy()
    order = np.argsort(-cube[cand].float().cpu().numpy(), kind="stable")
    coords = filters.ensure_spacing(coords[order])
    blobs = np.hstack([coords[:, :3].astype(np.float64),
                       np.asarray(sigmas)[coords[:, 3]][:, None]])
    return _prune(blobs, overlap)


def dog_labels(frame, cfg, device, dtype=torch.float32):
    """Labels of one frame by the DoG blob watershed (``cfg``: the
    configuration's sigmas, ratio, threshold and overlap)."""
    v = F.pad(_normalised(frame, device, dtype), (1, 1, 1, 1, 1, 1))
    lo, hi = float(cfg["min_sigma"]), float(cfg["max_sigma"])
    dog = filters.gaussian(v, lo) - filters.gaussian(v, hi)
    mask = (dog > cfg["threshold"]).cpu().numpy()
    blobs = blob_dog(v, lo, hi, float(cfg["sigma_ratio"]),
                     float(cfg["threshold"]), float(cfg["overlap"]))
    points = np.zeros(v.shape, bool)
    points[tuple(blobs[:, :3].astype(int).T)] = True
    markers, _ = ndi.label(points)
    dist = ndi.distance_transform_edt(v.float().cpu().numpy() != 0)
    labels = flood.image_flood(-dist.astype(np.float32), markers, mask)
    return labels[1:-1, 1:-1, 1:-1]
