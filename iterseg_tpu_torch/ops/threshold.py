"""Otsu threshold (256 bins) with skimage/numpy parity, on torch tensors.

The port of ``iterseg_tpu/ops/threshold.py``. For a float32 image
``np.histogram`` runs in float32: edges by the ``np.linspace`` recipe
(``arange * (d / nbins) + lo``, last edge set to ``hi``), candidate bin
``((x - lo) / d) * nbins`` truncated toward zero, then numpy's
decrement/increment correction against the edges. This module does the same
operations in the same order, each rounded on its own (eager torch runs one
kernel per op, so no multiply-add is contracted into an FMA), and counts
with an integer ``scatter_add_`` into the ``nbins`` bins (exact integers;
``torch.bincount`` would read the bin range back to the host, which waits
for the device). ``torch.histc`` bins differently and is not used.

The inter-class-variance scan runs in float32 as on the JAX device path;
the argmax can differ from a float64 scan only at a near-tie of the top two
variances (same documented gap as the JAX package).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["threshold_otsu", "threshold_otsu_np"]


def _histogram_f32(x: torch.Tensor, nbins: int):
    """``np.histogram(x, nbins)`` of a raveled f32 tensor: exact int64
    counts and the f32 edges."""
    lo = torch.min(x)
    hi = torch.max(x)
    # np._get_outer_edges: a constant image histograms over [v-.5, v+.5]
    same = lo == hi
    lo = torch.where(same, lo - 0.5, lo)
    hi = torch.where(same, hi + 0.5, hi)
    d = hi - lo
    step = d / nbins
    edges = torch.arange(nbins + 1, dtype=torch.float32, device=x.device)
    edges = edges * step
    edges = edges + lo
    edges[nbins] = hi  # np.linspace endpoint override
    f_idx = (x - lo) / d
    f_idx = f_idx * nbins
    idx = f_idx.to(torch.int64)
    idx = torch.where(idx == nbins, nbins - 1, idx)
    idx = idx - (x < edges[idx]).to(torch.int64)
    inc = (x >= edges[idx + 1]) & (idx != nbins - 1)
    idx = idx + inc.to(torch.int64)
    counts = torch.zeros(nbins, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return counts, edges


def _otsu_from_counts(counts, bin_centers):
    """Inter-class-variance argmax (skimage formula, f32)."""
    counts = counts.to(torch.float32)
    weight1 = torch.cumsum(counts, 0)
    weight2 = torch.flip(torch.cumsum(torch.flip(counts, [0]), 0), [0])
    cb = counts * bin_centers
    mean1 = torch.cumsum(cb, 0) / weight1
    mean2 = torch.flip(torch.cumsum(torch.flip(cb, [0]), 0)
                       / torch.flip(weight2, [0]), [0])
    variance12 = weight1[:-1] * weight2[1:] * (mean1[:-1] - mean2[1:]) ** 2
    # a 0-d index tensor would be read back to the host; a 1-d one is not
    best = torch.argmax(variance12).reshape(1)
    return bin_centers.index_select(0, best).reshape(())


def threshold_otsu(image: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Otsu threshold of a float image, as a 0-d f32 tensor on the image's
    device (no host synchronisation)."""
    x = image.reshape(-1).to(torch.float32)
    counts, edges = _histogram_f32(x, nbins)
    bin_centers = (edges[:-1] + edges[1:]) / 2.0
    return _otsu_from_counts(counts, bin_centers)


def threshold_otsu_np(image, nbins: int = 256):
    """Numpy oracle with the exact skimage float path."""
    image = np.asarray(image)
    counts, bin_edges = np.histogram(image.ravel(), nbins,
                                     range=(image.min(), image.max()))
    bin_centers = (bin_edges[:-1] + bin_edges[1:]) / 2.0
    counts = counts.astype(float)
    weight1 = np.cumsum(counts)
    weight2 = np.cumsum(counts[::-1])[::-1]
    mean1 = np.cumsum(counts * bin_centers) / weight1
    with np.errstate(invalid="ignore", divide="ignore"):
        mean2 = (np.cumsum((counts * bin_centers)[::-1])
                 / weight2[::-1])[::-1]
    variance12 = weight1[:-1] * weight2[1:] * (mean1[:-1] - mean2[1:]) ** 2
    idx = np.argmax(variance12)
    return bin_centers[idx]
