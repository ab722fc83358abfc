"""Connected components and object-size filtering.

The port of ``iterseg_tpu/ops/cc.py``:

- ``label_np``: 6-connectivity labels in scipy's raster numbering on the
  host (the native C++ labeller for 3D masks, scipy otherwise), and
  ``size_band_filter`` (``_remove_unwanted_objects`` parity);
- the on-device labeller as torch ops (JAX's is XLA, not Pallas):
  ``component_roots`` is min-index propagation over face neighbours with
  pointer jumping, and ``label_jax``/``label_device`` renumber its roots to
  scipy's raster order, so their labels are ``label_np``'s bit for bit;
- ``component_sizes`` and ``remove_small_objects`` (skimage parity).

The pipelines label on the host, as JAX's do: every consumer of the labels
is a host stage. The device labeller is the building block for a caller
whose mask already lives on the card.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage as ndi

__all__ = [
    "label_np",
    "label_jax",
    "label_device",
    "component_roots",
    "component_sizes",
    "remove_small_objects",
    "size_band_filter",
]


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


def component_roots(m):
    """Min-index connected components (6-connectivity) of the bool tensor
    ``m``: int32 labels where each masked voxel carries the smallest raveled
    index of its component and the background carries ``m.numel()``.
    Rounds of a face-neighbour min and two pointer jumps, until a round
    changes nothing (one host read a round)."""
    shape = tuple(m.shape)
    n = m.numel()
    big = torch.tensor(n, dtype=torch.int64, device=m.device)
    lab = torch.where(m, torch.arange(n, device=m.device).reshape(shape),
                      big)

    def neighbor_min(lab):
        out = lab
        for axis in range(lab.ndim):
            edge = list(shape)
            edge[axis] = 1
            fill = big.expand(edge)
            fwd = torch.cat([lab.narrow(axis, 1, shape[axis] - 1), fill],
                            axis)
            bwd = torch.cat([fill, lab.narrow(axis, 0, shape[axis] - 1)],
                            axis)
            out = torch.minimum(out, torch.minimum(fwd, bwd))
        return torch.where(m, out, big)

    def jump(lab):
        ext = torch.cat([lab.reshape(-1), big.reshape(1)])
        return ext[lab.reshape(-1)].reshape(shape)

    while True:
        prev = lab
        lab = neighbor_min(lab)
        lab = torch.where(m, torch.minimum(lab, jump(lab)), big)
        lab = torch.where(m, torch.minimum(lab, jump(lab)), big)
        if torch.equal(lab, prev):
            return lab.to(torch.int32)


def label_jax(mask, max_labels: int = 16384):
    """The torch labeller under JAX's name: ``(labels, num)`` for the mask
    tensor ``mask`` (nonzero = foreground), int32 labels with background 0
    and ids in raster order of each component's first voxel (scipy's
    numbering), on ``mask``'s device; ``num`` is a 0-d int32 tensor.

    ``num`` is always the true component count. As in JAX, at most
    ``max_labels`` components are renumbered: past that the labels are
    invalid and the caller retries with a larger bound, as
    ``label_device`` does."""
    m = torch.as_tensor(mask) != 0
    n = m.numel()
    flat = component_roots(m).reshape(-1).to(torch.int64)
    idx = torch.arange(n, device=m.device)
    roots = torch.where(flat == idx, flat, n)
    num = (roots < n).sum().to(torch.int32)
    # sorted unique roots, truncated or padded (with n) to max_labels + 1
    uniq = torch.unique(roots)[:max_labels + 1]
    if uniq.numel() < max_labels + 1:
        uniq = torch.cat([uniq, uniq.new_full(
            (max_labels + 1 - uniq.numel(),), n)])
    rank = torch.searchsorted(uniq, flat) + 1
    labels = torch.where(m.reshape(-1), rank, 0).to(torch.int32)
    return labels.reshape(m.shape), num


def label_device(mask, max_labels: int = 16384, device=None):
    """``label_jax`` with the overflow retry: when the component count
    exceeds ``max_labels`` (past which the renumbering is truncated), label
    again with a bound sized to the true count. A numpy ``mask`` is
    uploaded to ``device`` (CUDA unless given); a tensor stays on its
    own."""
    if not isinstance(mask, torch.Tensor):
        from ..device import resolve_device

        mask = torch.from_numpy(np.ascontiguousarray(mask)).to(
            resolve_device(device))
    labels, num = label_jax(mask, max_labels=max_labels)
    n = int(num)
    if n > max_labels:
        bound = 1 << int(np.ceil(np.log2(n)))
        labels, num = label_jax(mask, max_labels=bound)
    return labels, num


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def component_sizes(labels, num=None):
    """Voxel count per label id (index 0 = background)."""
    return np.bincount(_host(labels).ravel())


def remove_small_objects(labels, min_size):
    """skimage parity: zero out components with size < min_size."""
    labels = _host(labels)
    sizes = np.bincount(labels.ravel())
    keep = sizes >= min_size
    keep[0] = False
    return np.where(keep[labels], labels, 0)


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
