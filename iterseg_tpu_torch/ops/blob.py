"""Difference-of-Gaussian and Laplacian-of-Gaussian blob detection
(``skimage.feature.blob_dog`` / ``blob_log`` semantics, used by the DoG
segmenter at iterseg ``segmentation.py:638`` and the LoG ``blob_watershed``).

The port of ``iterseg_tpu/ops/blob.py``: the Gaussian scale space (the
O(N·scales) work) runs on the device (``ops.filters``); the cube is then
formed on the host in numpy exactly as the JAX package forms it, and
scale-space peak extraction (``ops.peaks``) and sphere-overlap pruning run
over the small candidate list.

Notes on parity: the scale count is ``k = int(log(max/min)/log(ratio) + 1)``,
scales are ``min * ratio**i``, the DoG cube is scaled by ``1/(ratio-1)``,
peaks come from a 3^(ndim+1) local-max footprint over the (space..., scale)
cube with ``threshold_abs=threshold``, and overlapping blobs (sphere overlap
fraction > ``overlap``) are pruned keeping the larger sigma. Pair iteration
during pruning is sorted (deterministic), unlike skimage's set ordering.

Provenance: ``_blob_overlap``/``_prune_blobs`` re-derive scikit-image's
BSD-3-licensed ``skimage/feature/blob.py`` semantics (sphere/lens overlap
geometry and KD-tree pair pruning).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import spatial

from ..device import resolve_device
from .filters import gaussian, gaussian_laplace
from .peaks import peak_local_max

__all__ = ["blob_dog", "blob_log"]


def _blob_overlap(blob1, blob2, sigma_dim=1):
    ndim = len(blob1) - sigma_dim
    if ndim > 3:
        return 0.0
    root_ndim = np.sqrt(ndim)
    if blob1[-1] > blob2[-1]:
        max_sigma = blob1[-sigma_dim:]
        r1, r2 = 1.0, blob2[-1] / blob1[-1]
    else:
        max_sigma = blob2[-sigma_dim:]
        r2, r1 = 1.0, blob1[-1] / blob2[-1]
    if np.all(max_sigma == 0):
        return 0.0
    pos1 = blob1[:ndim] / (max_sigma * root_ndim)
    pos2 = blob2[:ndim] / (max_sigma * root_ndim)
    d = np.sqrt(np.sum((pos2 - pos1) ** 2))
    if d > r1 + r2:
        return 0.0
    if d <= abs(r1 - r2):
        return 1.0
    if ndim == 2:
        ratio1 = np.clip((d**2 + r1**2 - r2**2) / (2 * d * r1), -1, 1)
        ratio2 = np.clip((d**2 + r2**2 - r1**2) / (2 * d * r2), -1, 1)
        a = (
            r1**2 * np.arccos(ratio1)
            + r2**2 * np.arccos(ratio2)
            - 0.5 * np.sqrt(abs((-d + r1 + r2) * (d + r1 - r2)
                                * (d - r1 + r2) * (d + r1 + r2)))
        )
        return a / (np.pi * min(r1, r2) ** 2)
    # 3D lens (sphere-sphere intersection) volume
    vol = (
        np.pi
        / (12 * d)
        * (r1 + r2 - d) ** 2
        * (d**2 + 2 * d * (r1 + r2) - 3 * (r1 - r2) ** 2)
    )
    return vol / (4.0 / 3.0 * np.pi * min(r1, r2) ** 3)


def _prune_blobs(blobs_array, overlap, sigma_dim=1):
    if len(blobs_array) == 0:
        return blobs_array
    sigma = blobs_array[:, -sigma_dim:].max()
    distance = 2 * sigma * np.sqrt(blobs_array.shape[1] - sigma_dim)
    tree = spatial.cKDTree(blobs_array[:, :-sigma_dim])
    pairs = sorted(tree.query_pairs(distance))
    for i, j in pairs:
        blob1, blob2 = blobs_array[i], blobs_array[j]
        if blob1[-1] == 0 or blob2[-1] == 0:
            continue
        if _blob_overlap(blob1, blob2, sigma_dim) > overlap:
            if blob1[-1] > blob2[-1]:
                blob2[-1] = 0
            else:
                blob1[-1] = 0
    return np.stack([b for b in blobs_array if b[-1] > 0]) if np.any(
        blobs_array[:, -1] > 0
    ) else np.empty((0, blobs_array.shape[1]))


def _scale_cube_blobs(cube, sigma_list, threshold, overlap, exclude_border,
                      scalar_sigma, empty_cols, device=None):
    """Shared peak-extraction + pruning tail of blob_dog/blob_log: local
    maxima of the (space..., scale) cube → (coords..., sigma) rows →
    sphere-overlap pruning. ``empty_cols`` preserves each caller's
    (skimage-inherited) empty-result width."""
    ndim = cube.ndim - 1
    if isinstance(exclude_border, int) and not isinstance(
        exclude_border, bool
    ):
        border = (exclude_border,) * ndim + (0,)
    else:
        border = exclude_border
    local_maxima = peak_local_max(
        cube, threshold_abs=threshold, min_distance=1, exclude_border=border,
        device=device,
    )
    if local_maxima.size == 0:
        return np.empty((0, empty_cols))
    lm = local_maxima.astype(np.float64)
    sigmas_of_peaks = sigma_list[local_maxima[:, -1]]
    if scalar_sigma:
        sigmas_of_peaks = sigmas_of_peaks[:, :1]
    lm = np.hstack([lm[:, :-1], sigmas_of_peaks])
    return _prune_blobs(lm, overlap, sigma_dim=sigmas_of_peaks.shape[1])


def blob_dog(
    image,
    min_sigma=1,
    max_sigma=50,
    sigma_ratio=1.6,
    threshold=0.5,
    overlap=0.5,
    exclude_border=False,
    device=None,
):
    """Return (n, ndim+1) array of blob (coords..., sigma). The scale space
    runs on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    image = np.asarray(image, dtype=np.float32)
    img_t = torch.as_tensor(image, device=dev)
    ndim = image.ndim
    min_sigma_a = np.full(ndim, min_sigma, dtype=float) if np.isscalar(
        min_sigma
    ) else np.asarray(min_sigma, dtype=float)
    max_sigma_a = np.full(ndim, max_sigma, dtype=float) if np.isscalar(
        max_sigma
    ) else np.asarray(max_sigma, dtype=float)
    k = int(np.mean(np.log(max_sigma_a / min_sigma_a) / np.log(sigma_ratio) + 1))
    sigma_list = np.array(
        [min_sigma_a * (sigma_ratio**i) for i in range(k + 1)]
    )
    # device: gaussian scale space; host: the DoG cube
    gaussians = [gaussian(img_t, tuple(s)).cpu().numpy() for s in sigma_list]
    dog_cube = np.stack(
        [gaussians[i] - gaussians[i + 1] for i in range(k)], axis=-1
    )
    dog_cube *= 1 / (sigma_ratio - 1)
    scalar_sigma = np.isscalar(min_sigma) and np.isscalar(max_sigma)
    return _scale_cube_blobs(
        dog_cube, sigma_list, threshold, overlap, exclude_border,
        scalar_sigma, empty_cols=ndim + 1, device=dev,
    )


def blob_log(
    image,
    min_sigma=1,
    max_sigma=50,
    num_sigma=10,
    threshold=0.2,
    overlap=0.5,
    log_scale=False,
    exclude_border=False,
    device=None,
):
    """Laplacian-of-Gaussian blob detection (``skimage.feature.blob_log``
    semantics — the seed detector of the reference's disabled
    ``blob_watershed``, iterseg ``segmentation.py:509``).

    Returns an (n, ndim+sigma_dim) array of blob (coords..., sigma). The
    scale space ``-gaussian_laplace(image, s) * mean(s)**2`` over
    ``num_sigma`` linearly (or log-) spaced sigmas is computed on device;
    scale-cube peak extraction and sphere-overlap pruning run on host over
    the small candidate list, exactly as in :func:`blob_dog`. The scale
    space runs on ``device`` (CUDA by default).
    """
    dev = resolve_device(device)
    image = np.asarray(image, dtype=np.float32)
    img_t = torch.as_tensor(image, device=dev)
    ndim = image.ndim
    scalar_sigma = np.isscalar(min_sigma) and np.isscalar(max_sigma)
    min_sigma_a = np.full(ndim, min_sigma, dtype=float) if np.isscalar(
        min_sigma
    ) else np.asarray(min_sigma, dtype=float)
    max_sigma_a = np.full(ndim, max_sigma, dtype=float) if np.isscalar(
        max_sigma
    ) else np.asarray(max_sigma, dtype=float)
    if log_scale:
        start = np.log10(min_sigma_a)
        stop = np.log10(max_sigma_a)
        sigma_list = np.stack(
            [np.logspace(lo, hi, num_sigma) for lo, hi in zip(start, stop)],
            axis=-1,
        )
    else:
        sigma_list = np.linspace(min_sigma_a, max_sigma_a, num_sigma)
    # device: the LoG scale space; host: -LoG * mean(sigma)^2 (float64,
    # as numpy promotes it in the JAX package)
    gl_cube = np.stack(
        [
            -gaussian_laplace(img_t, tuple(s)).cpu().numpy()
            * np.mean(s) ** 2
            for s in sigma_list
        ],
        axis=-1,
    )
    return _scale_cube_blobs(
        gl_cube, sigma_list, threshold, overlap, exclude_border,
        scalar_sigma, empty_cols=ndim + (1 if scalar_sigma else ndim),
        device=dev,
    )
