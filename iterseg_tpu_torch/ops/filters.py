"""Separable Gaussian, Laplacian-of-Gaussian and max filters on torch
tensors.

The port of ``iterseg_tpu/ops/filters.py``:

- ``gaussian`` ≡ ``skimage.filters.gaussian(img, sigma)`` (scipy's
  ``gaussian_filter``, ``mode='nearest'``, ``truncate=4.0``). Each axis is a
  1D correlation over a padded copy whose taps are accumulated one by one in
  tap order, ``out = out + x[i:i+n] * w_i`` — the same order as the JAX
  ``_correlate1d_nearest``. ``torch.nn.functional.conv*`` is not used: its
  reduction order differs.
- ``gaussian_laplace`` ≡ ``scipy.ndimage.gaussian_laplace`` (``mode=
  'reflect'``, numpy's ``symmetric`` padding): per output axis an order-2
  derivative kernel on that axis and order-0 Gaussians on the others,
  summed over axes in axis order.
- ``dog_image`` (difference of Gaussians) and ``smooth_planes`` (per-z-plane
  2D Gaussian).
- ``maximum_filter`` ≡ ``scipy.ndimage.maximum_filter(size, mode=
  'nearest')`` on any number of dimensions (the 3D peak maps and the 4D
  (z, y, x, scale) DoG cube): a 1D max per axis over an edge-padded copy.
  The cube window is the product of the per-axis windows and max is exact
  selection, so the separable form is bit-equal to the cube.

The functions run on the device of the tensor they are given.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["gaussian_kernel1d", "gaussian_kernel1d_order2", "gaussian",
           "gaussian_laplace", "dog_image", "maximum_filter",
           "smooth_planes"]


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


def gaussian_kernel1d_order2(sigma: float,
                             truncate: float = 4.0) -> np.ndarray:
    """Second-derivative Gaussian taps, identical to scipy's
    ``_gaussian_kernel1d(sigma, order=2, radius)``: the normalised Gaussian
    times ``x²/σ⁴ − 1/σ²`` (float64, symmetric)."""
    sigma = float(sigma)
    radius = int(truncate * sigma + 0.5)
    sigma2 = sigma * sigma
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / sigma2 * x ** 2)
    phi = phi / phi.sum()
    return phi * (x ** 2 / (sigma2 * sigma2) - 1.0 / sigma2)


def _pad_index(n: int, radius: int, mode: str, device) -> torch.Tensor:
    """Source index of each of the ``n + 2 * radius`` padded positions:
    ``nearest`` clamps (edge replication), ``reflect`` mirrors with the
    edge sample repeated (numpy ``symmetric``, periodic for any radius)."""
    p = torch.arange(-radius, n + radius, device=device)
    if mode == "nearest":
        return p.clamp(0, n - 1)
    if mode == "reflect":
        m = torch.remainder(p, 2 * n)
        return torch.where(m < n, m, 2 * n - 1 - m)
    raise ValueError(f"unsupported mode {mode!r}")


def _correlate1d(x: torch.Tensor, taps: np.ndarray, axis: int,
                 mode: str = "nearest") -> torch.Tensor:
    """1D correlation along ``axis`` with scipy's boundary ``mode``, taps
    summed sequentially in tap order."""
    radius = (taps.size - 1) // 2
    n = x.shape[axis]
    xm = torch.movedim(x, axis, -1)
    xp = xm.index_select(-1, _pad_index(n, radius, mode, x.device))
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


def _as_float(image: torch.Tensor) -> torch.Tensor:
    return image if image.is_floating_point() else image.to(torch.float32)


def gaussian(image: torch.Tensor, sigma, truncate: float = 4.0):
    """Gaussian filter with skimage semantics (float output,
    ``mode='nearest'``). ``sigma`` is a scalar or per axis; sigma 0 leaves
    that axis untouched (e.g. ``(0, 1, 1)`` on the centroid channel)."""
    x = _as_float(image)
    for axis, s in enumerate(_as_axis_sigmas(sigma, x.ndim)):
        taps = gaussian_kernel1d(s, truncate)
        if taps.size > 1:
            x = _correlate1d(x, taps, axis)
    return x


def gaussian_laplace(image: torch.Tensor, sigma, truncate: float = 4.0):
    """Laplacian of Gaussian, ``scipy.ndimage.gaussian_laplace`` semantics
    (``mode='reflect'``). Used by ``ops.blob.blob_log``."""
    x = _as_float(image)
    sig = _as_axis_sigmas(sigma, x.ndim)
    out = None
    for d2_axis in range(x.ndim):
        term = x
        for axis, s in enumerate(sig):
            taps = (gaussian_kernel1d_order2(s, truncate) if axis == d2_axis
                    else gaussian_kernel1d(s, truncate))
            if taps.size > 1:
                term = _correlate1d(term, taps, axis, mode="reflect")
        out = term if out is None else out + term
    return out


def dog_image(input_vol: torch.Tensor, sigma_min, sigma_max):
    """Difference of Gaussians (iterseg ``segmentation.py:678-680``)."""
    return gaussian(input_vol, sigma_min) - gaussian(input_vol, sigma_max)


def smooth_planes(image: torch.Tensor, z_axis: int = 0, sigma: float = 1.0):
    """Per-z-plane 2D Gaussian smoothing (iterseg ``labels.py:312-321``)."""
    sig = [float(sigma)] * image.ndim
    sig[z_axis] = 0.0
    return gaussian(image, tuple(sig))


def maximum_filter(image: torch.Tensor, size: int = 3, mode: str = "nearest"):
    """Cube max filter of side ``size`` with edge replication (scipy
    ``mode='nearest'``) on a tensor of any number of dimensions."""
    if mode != "nearest":
        raise ValueError(f"unsupported mode {mode!r}")
    r = size // 2
    x = image
    for axis in range(image.ndim):
        n = x.shape[axis]
        xm = torch.movedim(x, axis, -1)
        xp = xm.index_select(-1, _pad_index(n, r, "nearest", x.device))
        out = xp[..., 0:n]
        for i in range(1, size):
            out = torch.maximum(out, xp[..., i:i + n])
        x = torch.movedim(out, -1, axis)
    return x.contiguous()
