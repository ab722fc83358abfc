"""Gaussian and maximum filters, Otsu's threshold and peak spacing.

``gaussian`` is scipy's ``gaussian_filter`` (``mode='nearest'``,
``truncate=4.0``): a 1D correlation per axis with scipy's normalised taps,
computed in the dtype of the tensor it is given, the taps added in order.
``otsu`` is scikit-image's ``threshold_otsu`` over numpy's 256-bin
histogram. ``ensure_spacing`` is scikit-image's greedy Chebyshev rejection.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_taps(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy's order-0 Gaussian taps: radius ``int(truncate * sigma + 0.5)``,
    float64, summing to one."""
    radius = int(truncate * float(sigma) + 0.5)
    if sigma <= 0 or radius == 0:
        return np.ones(1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (float(sigma) ** 2) * x ** 2)
    return phi / phi.sum()


def _correlate_axis(x: torch.Tensor, taps: np.ndarray, axis: int):
    """``sum_i x[j + i - r] * taps[i]`` along ``axis``, edge samples
    repeated past the ends."""
    r = len(taps) // 2
    n = x.shape[axis]
    idx = torch.arange(-r, n + r, device=x.device).clamp(0, n - 1)
    xp = x.index_select(axis, idx)
    out = torch.zeros_like(x)
    for i, w in enumerate(taps):
        out = out + xp.narrow(axis, i, n) * torch.tensor(
            w, dtype=x.dtype, device=x.device)
    return out


def gaussian(x: torch.Tensor, sigma) -> torch.Tensor:
    """scipy ``gaussian_filter(x, sigma, mode='nearest')`` in ``x.dtype``;
    ``sigma`` a scalar or one per axis (0 leaves the axis alone)."""
    sigmas = ([float(sigma)] * x.ndim if np.isscalar(sigma)
              else [float(s) for s in sigma])
    for axis, s in enumerate(sigmas):
        taps = gaussian_taps(s)
        if len(taps) > 1:
            x = _correlate_axis(x, taps, axis)
    return x


def max3(x: torch.Tensor) -> torch.Tensor:
    """scipy ``maximum_filter(x, size=3, mode='nearest')`` of a 3D
    tensor."""
    xp = F.pad(x[None, None].float(), (1, 1, 1, 1, 1, 1), mode="replicate")
    return F.max_pool3d(xp, 3, 1)[0, 0].to(x.dtype)


def otsu(image: np.ndarray) -> np.floating:
    """scikit-image ``threshold_otsu(image)`` (256 bins, image range)."""
    counts, edges = np.histogram(image.ravel(), bins=256)
    centers = (edges[:-1] + edges[1:]) / 2
    counts = counts.astype(np.float32)
    w1 = np.cumsum(counts)
    w2 = np.cumsum(counts[::-1])[::-1]
    m1 = np.cumsum(counts * centers) / w1
    m2 = (np.cumsum((counts * centers)[::-1]) / w2[::-1])[::-1]
    var12 = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    return centers[np.argmax(var12)]


def ensure_spacing(coords: np.ndarray) -> np.ndarray:
    """Keep each point, in order, unless an earlier kept point lies within
    Chebyshev distance 1 of it."""
    kept, taken = [], set()
    ndim = coords.shape[1] if coords.ndim == 2 else 0
    offsets = np.stack(np.meshgrid(*[(-1, 0, 1)] * ndim, indexing="ij"),
                       -1).reshape(-1, ndim) if ndim else np.zeros((1, 0))
    offsets = [tuple(int(v) for v in o) for o in offsets]
    for i, c in enumerate(coords.tolist()):
        if any(tuple(a + b for a, b in zip(c, o)) in taken for o in offsets):
            continue
        kept.append(i)
        taken.add(tuple(c))
    return coords[kept]


def local_peaks(image: torch.Tensor, threshold: float,
                border: int) -> np.ndarray:
    """scikit-image ``peak_local_max(image, threshold_abs=threshold,
    min_distance=1, exclude_border=border)`` of a 3D image: plateau
    maxima of the 3x3x3 neighbourhood above ``threshold``, ``border``
    planes left out at every face, brightest first (raster order among
    equals), then spaced."""
    cand = (image == max3(image)) & (image > threshold)
    if border:
        keep = torch.zeros_like(cand)
        keep[border:-border, border:-border, border:-border] = True
        cand &= keep
    coords = torch.nonzero(cand).cpu().numpy()
    values = image[cand].cpu().numpy()
    order = np.argsort(-values, kind="stable")
    return ensure_spacing(coords[order])
