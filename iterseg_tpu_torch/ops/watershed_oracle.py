"""Pure-Python heap watershed oracles.

These are slow, exact re-derivations of the two priority-flood variants the
framework must reproduce bit-for-bit:

- ``affinity_flood_py``: the affinity watershed of iterseg
  ``watershed.py:95-159`` (``raveled_affinity_watershed``): a min-heap of
  ``(value, age, index)`` elements, seeds pushed with value 0 / age 0, and
  *claim-at-push* — when an element pops, every in-mask unlabelled face
  neighbour immediately takes its label and is pushed with the affinity of
  the crossed edge as its value.
- ``image_flood_py``: classic seeded watershed on a scalar image
  (``skimage.segmentation.watershed`` with connectivity 1, compactness 0,
  no watershed line) as used by the DoG segmenter at iterseg
  ``segmentation.py:646``: identical structure, but the pushed value is the
  image value at the claimed voxel and seeds are pushed with the image value
  at the seed.

Neighbour iteration order (ties!): raster order of the connectivity-1
footprint, i.e. (z-, y-, x-, x+, y+, z+) — this matches
``_offsets_to_raveled_neighbors`` for a 6-cross where all offsets have equal
distance so the stable distance sort preserves footprint raster order.

The production kernels (native C++ ``iterseg_tpu_torch/native`` and the
on-device propagation kernel) are validated against these oracles.
"""
from __future__ import annotations

import heapq

import numpy as np

__all__ = [
    "neighbor_offsets",
    "affinity_flood_py",
    "image_flood_py",
]


def neighbor_offsets(shape):
    """Raveled face-neighbour offsets in footprint raster order.

    For 3D this is [-YX, -X, -1, +1, +X, +YX] with affinity channel order
    [0, 1, 2, 2, 1, 0] (iterseg ``watershed.py:84-92``).
    """
    ndim = len(shape)
    strides = np.ones(ndim, dtype=np.int64)
    for i in range(ndim - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    neg = [-strides[a] for a in range(ndim)]
    pos = [strides[a] for a in reversed(range(ndim))]
    offsets = np.array(neg + pos, dtype=np.int64)
    axes = np.concatenate(
        [np.arange(ndim), np.arange(ndim)[::-1]]
    ).astype(np.int64)
    return offsets, axes


def affinity_flood_py(affinities, marker_coords, mask, output=None, scale=None):
    """Exact affinity priority flood. ``affinities``: (ndim, *shape) float32.

    ``marker_coords``: (n, ndim) int seed coordinates; ``mask``: bool array
    of ``shape`` whose border ring must be False (the caller pads);
    ``output``: optional int32 raveled output buffer. Returns labels of
    ``shape`` (seeds take labels 1..n in row order).
    """
    shape = affinities.shape[1:]
    ndim = len(shape)
    aff = affinities.reshape(ndim, -1).astype(np.float32)
    if scale is not None:
        aff = aff * np.abs(np.asarray(scale, dtype=np.float32)).reshape(-1, 1)
    offsets, axes = neighbor_offsets(shape)
    n_half = len(offsets) // 2
    # affinity sample offset: 0 for negative directions, +stride for positive
    aff_off = offsets.copy()
    aff_off[:n_half] = 0
    mask_r = np.asarray(mask).ravel()
    raveled_markers = np.ravel_multi_index(
        tuple(np.asarray(marker_coords).T), shape
    ).astype(np.int64)
    if output is None:
        out = np.zeros(mask_r.shape, dtype=np.int32)
    else:
        out = output
    out[raveled_markers] = np.arange(len(raveled_markers)) + 1

    heap = []
    age = 0
    for i, m in enumerate(raveled_markers):
        heapq.heappush(heap, (np.float32(0.0), 0, int(m)))
    while heap:
        value, _, index = heapq.heappop(heap)
        lab = out[index]
        for k in range(len(offsets)):
            nbr = index + offsets[k]
            if not mask_r[nbr]:
                continue
            if out[nbr]:
                continue
            out[nbr] = lab
            v = aff[axes[k], aff_off[k] + index]
            age += 1
            heapq.heappush(heap, (v, age, int(nbr)))
    return out.reshape(shape)


def image_flood_py(image, markers, mask):
    """Exact skimage-style seeded watershed (connectivity 1).

    ``image``: priority landscape (lower floods first); ``markers``: int
    label array (nonzero = seeds); ``mask``: bool. The border handling
    matches skimage: arrays are padded by one masked-out voxel internally.
    """
    image = np.asarray(image)
    pad_img = np.pad(image, 1, mode="constant", constant_values=0)
    pad_mask = np.pad(np.asarray(mask).astype(bool), 1, constant_values=False)
    pad_markers = np.pad(np.asarray(markers), 1, constant_values=0)
    shape = pad_img.shape
    img_r = pad_img.ravel()
    mask_r = pad_mask.ravel()
    out = np.where(pad_mask, pad_markers, 0).astype(np.int32).ravel()
    offsets, _ = neighbor_offsets(shape)

    heap = []
    age = 0
    marker_locations = np.flatnonzero(out)
    for m in marker_locations:
        heapq.heappush(heap, (img_r[m], 0, int(m)))
    while heap:
        value, _, index = heapq.heappop(heap)
        lab = out[index]
        for k in range(len(offsets)):
            nbr = index + offsets[k]
            if nbr < 0 or nbr >= out.size:
                continue
            if not mask_r[nbr]:
                continue
            if out[nbr]:
                continue
            out[nbr] = lab
            age += 1
            heapq.heappush(heap, (img_r[nbr], age, int(nbr)))
    out = out.reshape(shape)
    crop = tuple(slice(1, -1) for _ in shape)
    return out[crop]
