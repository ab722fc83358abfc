"""Seeded priority floods, as plain Python heaps over the masked voxels.

Both are iterseg's floods: a min-heap of ``(value, age, voxel)``; a popped
voxel gives its label to each unlabelled face neighbour in the mask, in
the order (z-, y-, x-, x+, y+, z+), and pushes it. ``affinity_flood``
(iterseg ``watershed.py``, ``raveled_affinity_watershed``) pushes a
neighbour with the affinity of the edge crossed, seeds with value 0;
``image_flood`` (``skimage.segmentation.watershed`` with connectivity 1)
pushes the image value at the neighbour, seeds with their own. The heap
holds compact indices of the masked voxels, which keep the raster order,
so ties fall as they do over raveled indices.
"""
from __future__ import annotations

import heapq

import numpy as np


def _neighbours(mask: np.ndarray):
    """Raveled indices of the masked voxels and, for each of the six
    directions, the compact index of each one's neighbour (-1 outside the
    mask). The mask's outer faces must be False."""
    shape = mask.shape
    flat = np.flatnonzero(mask)
    strides = (shape[1] * shape[2], shape[2], 1)
    offsets = [-strides[0], -strides[1], -strides[2],
               strides[2], strides[1], strides[0]]
    nbrs = []
    for off in offsets:
        target = flat + off
        pos = np.searchsorted(flat, target)
        pos_c = np.minimum(pos, len(flat) - 1)
        hit = (len(flat) > 0) & (flat[pos_c] == target)
        nbrs.append(np.where(hit, pos_c, -1))
    return flat, offsets, nbrs


def _flood(n, nbrs, push_value, seeds, seed_values, labels):
    """The heap loop over compact indices; ``push_value(d, i, j)`` is the
    value pushed when voxel ``i`` claims neighbour ``j`` in direction
    ``d``."""
    nb = [a.tolist() for a in nbrs]
    heap = [(v, 0, s) for s, v in zip(seeds, seed_values)]
    heapq.heapify(heap)
    age = 0
    pop, push = heapq.heappop, heapq.heappush
    while heap:
        _, _, i = pop(heap)
        lab = labels[i]
        for d in range(6):
            j = nb[d][i]
            if j < 0 or labels[j]:
                continue
            labels[j] = lab
            age += 1
            push(heap, (push_value(d, i, j), age, j))
    return labels


def affinity_flood(aff: np.ndarray, seeds: np.ndarray,
                   mask: np.ndarray) -> np.ndarray:
    """Labels of ``mask``'s shape: seed ``k`` (row ``k`` of ``seeds``,
    voxel coordinates) takes label ``k + 1``. ``aff``: (3, *shape) float32,
    channel ``a`` the edge between a voxel and its predecessor on axis
    ``a``."""
    shape = mask.shape
    flat, _, nbrs = _neighbours(mask)
    n = len(flat)
    out = np.zeros(int(np.prod(shape)), np.int32)
    if n == 0 or len(seeds) == 0:
        return out.reshape(shape)
    seed_flat = np.ravel_multi_index(tuple(np.asarray(seeds).T), shape)
    seed_c = np.searchsorted(flat, seed_flat)
    if not np.array_equal(flat[np.minimum(seed_c, n - 1)], seed_flat):
        raise ValueError("a seed lies outside the mask")
    a = aff.reshape(3, -1)
    # value of the edge crossed from i to j in direction d: the affinity
    # stored at the later voxel of the pair, on the direction's axis
    axis = (0, 1, 2, 2, 1, 0)
    at_i = [a[axis[d]][flat].tolist() for d in range(3)]
    at_j = [None] * 3 + [a[axis[d]][flat].tolist() for d in range(3, 6)]

    def push_value(d, i, j):
        return at_i[d][i] if d < 3 else at_j[d][j]

    labels = [0] * n
    for k, s in enumerate(seed_c.tolist()):
        labels[s] = k + 1
    _flood(n, nbrs, push_value, seed_c.tolist(), [0.0] * len(seed_c),
           labels)
    out[flat] = labels
    return out.reshape(shape)


def image_flood(image: np.ndarray, markers: np.ndarray,
                mask: np.ndarray) -> np.ndarray:
    """``skimage.segmentation.watershed(image, markers, mask=mask)`` with
    connectivity 1: labels of ``image``'s shape. Markers outside the mask
    are dropped."""
    pad = [(1, 1)] * image.ndim
    img = np.pad(np.asarray(image, np.float32), pad)
    m = np.pad(np.asarray(mask, bool), pad)
    mk = np.pad(np.asarray(markers), pad)
    flat, _, nbrs = _neighbours(m)
    vals = img.ravel()[flat].tolist()
    labels = np.where(m, mk, 0).ravel()[flat].astype(np.int64).tolist()
    seeds = [i for i, v in enumerate(labels) if v]

    def push_value(d, i, j):
        return vals[j]

    _flood(len(flat), nbrs, push_value, seeds, [vals[s] for s in seeds],
           labels)
    out = np.zeros(img.size, np.int32)
    out[flat] = labels
    return out.reshape(img.shape)[(slice(1, -1),) * image.ndim]
