"""Connected components and the object-size band filter (host).

The host part of ``iterseg_tpu/ops/cc.py``: ``label_np`` (6-connectivity,
scipy raster numbering; the native C++ labeller for 3D masks, scipy
otherwise) and ``size_band_filter`` (``_remove_unwanted_objects`` parity).
The on-device labeller ``label_jax`` is not on the main path; its port waits
for the slice that needs it.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage as ndi

__all__ = ["label_np", "size_band_filter"]


def label_np(mask):
    """6-connectivity component labels, scipy raster numbering."""
    mask = np.asarray(mask)
    if mask.ndim == 3:
        from .. import native

        try:
            return native.label_cc6(mask)
        except native.NativeUnavailable:
            pass
    labels, n = ndi.label(mask)
    return labels, n


def size_band_filter(mask, centroids, min_area=0, max_area=1000000):
    """Keep objects with ``min_area <= size < max_area`` and the centroids
    that fall inside a surviving object."""
    labels, _ = label_np(mask)
    sizes = np.bincount(labels.ravel())
    keep = (sizes >= min_area) & (sizes < max_area)
    keep[0] = False
    labels_goldilocks = np.where(keep[labels], labels, 0)
    centroid_labels = labels_goldilocks[tuple(np.transpose(centroids))]
    new_centroids = centroids[centroid_labels > 0]
    new_mask = labels_goldilocks.astype(bool)
    return new_mask, new_centroids
