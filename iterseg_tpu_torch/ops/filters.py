"""Separable Gaussian and max filters on torch tensors.

The port of the main-path part of ``iterseg_tpu/ops/filters.py``:

- ``gaussian`` ≡ ``skimage.filters.gaussian(img, sigma)`` (scipy's
  ``gaussian_filter``, ``mode='nearest'``, ``truncate=4.0``). Each axis is a
  1D correlation over an edge-padded copy whose taps are accumulated one by
  one in tap order, ``out = out + x[i:i+n] * w_i`` — the same order as the
  JAX ``_correlate1d_nearest``. ``torch.nn.functional.conv*`` is not used:
  its reduction order differs.
- ``maximum_filter`` ≡ ``scipy.ndimage.maximum_filter(size=3,
  mode='nearest')`` (what ``peak_local_max`` uses): exact selection.

The functions run on the device of the tensor they are given.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_kernel1d", "gaussian", "maximum_filter"]


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Order-0 Gaussian taps identical to ``scipy.ndimage._gaussian_kernel1d``
    (radius ``int(truncate * sigma + 0.5)``, float64, normalised)."""
    sigma = float(sigma)
    radius = int(truncate * sigma + 0.5)
    if sigma <= 0 or radius == 0:
        return np.ones(1, dtype=np.float64)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return phi / phi.sum()


def _correlate1d_nearest(x: torch.Tensor, taps: np.ndarray,
                         axis: int) -> torch.Tensor:
    """1D correlation along ``axis`` with edge replication, taps summed
    sequentially in tap order."""
    radius = (taps.size - 1) // 2
    n = x.shape[axis]
    xm = torch.movedim(x, axis, -1)
    left = xm[..., :1].expand(*xm.shape[:-1], radius)
    right = xm[..., -1:].expand(*xm.shape[:-1], radius)
    xp = torch.cat([left, xm, right], dim=-1)
    out = torch.zeros_like(xm)
    for i, w in enumerate(taps):
        out = out + xp[..., i:i + n] * float(np.float32(w))
    return torch.movedim(out, -1, axis)


def _as_axis_sigmas(sigma, ndim) -> tuple:
    if np.isscalar(sigma):
        return (float(sigma),) * ndim
    sigma = tuple(float(s) for s in sigma)
    assert len(sigma) == ndim
    return sigma


def gaussian(image: torch.Tensor, sigma, truncate: float = 4.0):
    """Gaussian filter with skimage semantics (float output,
    ``mode='nearest'``). ``sigma`` is a scalar or per axis; sigma 0 leaves
    that axis untouched (e.g. ``(0, 1, 1)`` on the centroid channel)."""
    x = image if image.is_floating_point() else image.to(torch.float32)
    for axis, s in enumerate(_as_axis_sigmas(sigma, x.ndim)):
        taps = gaussian_kernel1d(s, truncate)
        if taps.size > 1:
            x = _correlate1d_nearest(x, taps, axis)
    return x


def maximum_filter(image: torch.Tensor, size: int = 3):
    """Cube max filter with edge replication (scipy ``mode='nearest'``) on
    a 3D tensor."""
    r = size // 2
    x = image[None, None]
    x = F.pad(x, (r, r, r, r, r, r), mode="replicate")
    return F.max_pool3d(x, size, stride=1)[0, 0]
