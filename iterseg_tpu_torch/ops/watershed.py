"""Affinity watershed and the U-Net-output postprocessing pipeline.

The port of ``iterseg_tpu/ops/watershed.py``:

- ``affinity_watershed``: the seeded heap flood over a (ndim, *shape)
  affinity image — the native C++ kernel, with the pure-Python oracle as
  fallback (``py_func=True`` forces it);
- ``image_watershed``: the seeded flood of a scalar priority image with
  ``skimage.segmentation.watershed`` semantics (the DoG segmenter's flood
  on −EDT), through the same native kernel and oracle fallback;
- ``_prep_feature_maps``: per-channel max-normalise and pad the affinities,
  Gaussian σ=(0,1,1) on the centroid channel, Gaussian σ=2 and a 256-bin
  Otsu on the mask channel — on the tensors' device;
- ``segment_output_image``: the whole postprocessing of one 5-channel
  U-Net output.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import watershed_oracle as oracle
from .cc import size_band_filter
from .filters import gaussian
from .peaks import peak_local_max
from .threshold import threshold_otsu
from ..device import resolve_device

__all__ = ["affinity_watershed", "image_watershed", "segment_output_image"]


def affinity_watershed(image, marker_coords, mask, scale=None, out=None,
                       py_func=False):
    """Seeded flood over a (ndim, *shape) affinity image.

    Seeds take labels 1..n in row order of ``marker_coords``. ``mask`` must
    have a False border ring. Writes into ``out`` (raveled int32) when given.
    """
    from .. import native

    image = np.asarray(image, dtype=np.float32)
    shape = image.shape[1:]
    ndim = len(shape)
    if mask is None:
        small_shape = [s - 2 for s in shape]
        mask = np.pad(np.ones(small_shape, dtype=bool), 1, constant_values=0)
    mask = np.asarray(mask)
    marker_coords = np.asarray(marker_coords)
    if out is None:
        output = np.zeros(int(np.prod(shape)), dtype=np.int32)
    else:
        output = out
        output[:] = 0
    if py_func:
        return oracle.affinity_flood_py(
            image, marker_coords, mask, output=output, scale=scale
        )
    aff = image.reshape(ndim, -1)
    if scale is not None:
        aff = aff * np.abs(np.asarray(scale, dtype=np.float32)).reshape(-1, 1)
    offsets, axes = oracle.neighbor_offsets(shape)
    n_half = len(offsets) // 2
    val_off = offsets.copy()
    val_off[:n_half] = 0
    if len(marker_coords):
        markers = np.ravel_multi_index(tuple(marker_coords.T), shape)
    else:
        markers = np.zeros((0,), dtype=np.int64)
    output[markers] = np.arange(len(markers), dtype=np.int32) + 1
    seed_values = np.zeros(len(markers), dtype=np.float32)
    try:
        native.priority_flood(
            aff, offsets, axes, val_off, markers, seed_values,
            mask.ravel(), output,
        )
    except native.NativeUnavailable:
        return oracle.affinity_flood_py(
            image, marker_coords, mask, output=output, scale=scale
        )
    return output.reshape(shape)


def image_watershed(image, markers, mask, py_func=False):
    """Seeded watershed on a scalar priority image:
    ``skimage.segmentation.watershed(image, markers, mask=mask)`` parity
    (connectivity 1, compactness 0, no watershed line)."""
    from .. import native

    image = np.asarray(image, dtype=np.float32)
    markers = np.asarray(markers)
    mask = np.asarray(mask).astype(bool)
    if py_func:
        return oracle.image_flood_py(image, markers, mask)
    pad_img = np.pad(image, 1, constant_values=0)
    pad_mask = np.pad(mask, 1, constant_values=False)
    pad_markers = np.pad(markers, 1, constant_values=0)
    output = np.where(pad_mask, pad_markers, 0).astype(np.int32).ravel()
    marker_locations = np.flatnonzero(output).astype(np.int64)
    img_r = pad_img.ravel()
    offsets, _ = oracle.neighbor_offsets(pad_img.shape)
    val_chan = np.zeros(len(offsets), dtype=np.int64)
    try:
        native.priority_flood(
            img_r[None], offsets, val_chan, offsets, marker_locations,
            img_r[marker_locations], pad_mask.ravel(), output,
        )
    except native.NativeUnavailable:
        return oracle.image_flood_py(image, markers, mask)
    out = output.reshape(pad_img.shape)
    return out[(slice(1, -1),) * pad_img.ndim]


def _prep_feature_maps(affinities: torch.Tensor, centroids_img: torch.Tensor,
                       masking_img: torch.Tensor):
    """Feature-map preparation on the tensors' device: returns
    ``(aff_pad (3, z+2, y+2, x+2), cent_smooth, otsu 0-d)``."""
    aff = affinities / torch.amax(affinities, dim=(1, 2, 3)).reshape(
        -1, 1, 1, 1)
    aff = F.pad(aff, (1, 1, 1, 1, 1, 1))
    cent_smooth = gaussian(centroids_img, (0.0, 1.0, 1.0))
    otsu = threshold_otsu(gaussian(masking_img, 2.0))
    return aff, cent_smooth, otsu


def _prep_feature_maps_host(affinities, centroids_img, masking_img):
    """Host (scipy float) twin of ``_prep_feature_maps``."""
    from scipy import ndimage as ndi
    from .threshold import threshold_otsu_np

    aff = affinities / np.max(affinities, axis=(1, 2, 3)).reshape(-1, 1, 1, 1)
    aff = np.pad(aff, ((0, 0), (1, 1), (1, 1), (1, 1)))
    cent_smooth = ndi.gaussian_filter(centroids_img, (0, 1, 1),
                                      mode="nearest")
    otsu = threshold_otsu_np(ndi.gaussian_filter(masking_img, 2.0,
                                                 mode="nearest"))
    return aff, cent_smooth, otsu


def segment_output_image(
    unet_output,
    affinities_channels,
    centroids_channel,
    thresholding_channel,
    scale=None,
    absolute_thresh=None,
    out=None,
    py_func=False,
    device_featuremaps=True,
    device=None,
):
    """Instance labels from the 5-channel U-Net output: normalise + pad the
    affinities; seeds from smoothed peak detection (threshold_abs=.04, +1
    for padding); mask from Otsu of the σ=2 smoothed channel (or
    ``absolute_thresh``); drop objects outside the [10, 1e7) size band and
    seeds outside survivors; flood; crop. Returns (segmentation, seeds,
    mask). The feature maps are prepared on ``device`` (CUDA by default)."""
    unet_output = np.asarray(np.squeeze(np.asarray(unet_output)))
    affinities = unet_output[list(affinities_channels)].astype(np.float32)
    centroids_img = unet_output[centroids_channel]
    masking_img_np = unet_output[thresholding_channel]
    if device_featuremaps:
        dev = resolve_device(device)
        aff_t, cent_t, otsu_t = _prep_feature_maps(
            torch.as_tensor(affinities, device=dev),
            torch.as_tensor(np.ascontiguousarray(centroids_img), device=dev),
            torch.as_tensor(np.ascontiguousarray(masking_img_np), device=dev),
        )
        aff = aff_t.cpu().numpy()
        otsu = otsu_t.item()
        centroids = peak_local_max(cent_t, threshold_abs=0.04) + 1
    else:
        aff, cent_smooth, otsu = _prep_feature_maps_host(
            affinities, centroids_img, masking_img_np
        )
        centroids = peak_local_max(cent_smooth, threshold_abs=0.04,
                                   device=device) + 1
    if absolute_thresh is None:
        mask = masking_img_np > np.float32(otsu)
    else:
        mask = masking_img_np > absolute_thresh
    mask = np.pad(mask, 1, constant_values=0)
    mask, centroids = size_band_filter(
        mask, centroids, min_area=10, max_area=10000000
    )
    segmentation = affinity_watershed(
        aff, centroids, mask, scale=scale, out=out, py_func=py_func
    )
    segmentation = segmentation[1:-1, 1:-1, 1:-1]
    seeds = centroids - 1
    return segmentation, seeds, mask
