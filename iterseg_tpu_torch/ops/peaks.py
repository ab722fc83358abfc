"""Local-maximum peak detection with ``skimage.feature.peak_local_max`` parity.

The port of ``iterseg_tpu/ops/peaks.py``: the O(N) candidate mask
(max filter + compare + threshold) runs on the tensor's device; ordering and
the minimum-spacing rejection run on host in exact numpy (with the native
Chebyshev spacing kernel when it is available).
"""
from __future__ import annotations

from itertools import product

import numpy as np
import torch

from ..device import resolve_device
from .filters import maximum_filter

__all__ = ["peak_candidate_mask", "peak_local_max"]


def peak_candidate_mask(image: torch.Tensor, threshold_abs,
                        min_distance: int = 1) -> torch.Tensor:
    """Plateau-inclusive local maxima above ``threshold_abs`` (skimage
    ``_get_peak_mask``: ``image == maximum_filter(image, 2*md+1,
    mode='nearest')`` and ``image > threshold_abs``)."""
    image_max = maximum_filter(image, size=2 * min_distance + 1)
    return (image == image_max) & (image > threshold_abs)


def _ensure_spacing(coords: np.ndarray, spacing: float) -> np.ndarray:
    """Greedy Chebyshev-spacing rejection, identical to skimage
    ``ensure_spacing`` with ``p_norm=inf``: iterate candidates in order,
    accept one and reject every other candidate within distance <= spacing.
    Grid-bucketed, O(n)."""
    n = len(coords)
    if n == 0:
        return coords
    if np.issubdtype(coords.dtype, np.integer):
        from .. import native

        try:
            keep = native.ensure_spacing_cheb(coords, int(spacing))
            return coords[keep]
        except native.NativeUnavailable:
            pass
    spacing_i = max(int(np.ceil(spacing)), 1)
    keep = []
    buckets = {}
    cells = (coords // spacing_i).astype(np.int64)
    ndim = coords.shape[1]
    neighborhood = list(product((-1, 0, 1), repeat=ndim))
    for i in range(n):
        c = coords[i]
        cell = tuple(cells[i])
        conflict = False
        for off in neighborhood:
            for j in buckets.get(
                tuple(cell[d] + off[d] for d in range(ndim)), ()
            ):
                if np.max(np.abs(coords[j] - c)) <= spacing:
                    conflict = True
                    break
            if conflict:
                break
        if conflict:
            continue
        keep.append(i)
        buckets.setdefault(cell, []).append(i)
    return coords[keep]


def peak_local_max(image, threshold_abs=None, min_distance: int = 1,
                   exclude_border=True, device=None):
    """Peak coordinates, ordered and spaced exactly like skimage: an
    (n_peaks, ndim) int array, for an image of any number of dimensions
    (3D maps, the 4D DoG/LoG scale cube). ``exclude_border`` is a bool, an
    int or one int per axis. A tensor runs on its own device; a numpy image
    runs on ``device`` (CUDA by default)."""
    if isinstance(image, torch.Tensor):
        img_t = image
    else:
        img_t = torch.as_tensor(np.asarray(image),
                                device=resolve_device(device))
    img_np = img_t.cpu().numpy()
    if threshold_abs is None:
        threshold_abs = img_np.min()
    # the JAX package computes the mask on a device array, where float64
    # is float32; the ordering below uses the image as given
    mask_in = img_t.float() if img_t.dtype == torch.float64 else img_t
    mask = peak_candidate_mask(mask_in, float(threshold_abs),
                               min_distance).cpu().numpy()
    if isinstance(exclude_border, bool):
        border = (min_distance if exclude_border else 0,) * img_np.ndim
    elif isinstance(exclude_border, int):
        border = (exclude_border,) * img_np.ndim
    else:
        border = tuple(exclude_border)
    for ax, b in enumerate(border):
        if b == 0:
            continue
        sl = [slice(None)] * img_np.ndim
        sl[ax] = slice(None, b)
        mask[tuple(sl)] = False
        sl[ax] = slice(-b, None)
        mask[tuple(sl)] = False
    coords = np.nonzero(mask)
    intensities = img_np[coords]
    idx_maxsort = np.argsort(-intensities, kind="stable")
    coords = np.transpose(coords)[idx_maxsort]
    if len(coords) == 0:
        return np.empty((0, img_np.ndim), dtype=np.intp)
    return _ensure_spacing(coords, spacing=min_distance)
