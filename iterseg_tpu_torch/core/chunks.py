"""Overlapping chunk grid over large volumes.

This is the spatial decomposition at the heart of the framework: big zyx
volumes are processed as a grid of overlapping chunks whose margins are
discarded on writeback, so the full volume is covered exactly once.

The grid is specified by a tiling invariant (matching the behaviour of the
reference generator, iterseg ``predict.py:38-96``, which the golden tests in
``tests/test_chunks.py`` pin):

* Per axis, chunks advance by ``stride = chk - 2*mrg``; the number of
  placements is ``ceil((arr - 2*mrg) / stride)``, and the final chunk is
  pinned to end at the array edge (``start = arr - chk``).
* The covered spans partition ``[0, arr)`` with boundaries at ``0``, at
  ``i*stride + mrg`` for each interior placement index ``i``, and at
  ``arr``.  A chunk's writeback crop is its span expressed relative to its
  own start — so interior chunks contribute ``[mrg, chk - mrg)``, the first
  chunk contributes from 0, and the pinned final chunk absorbs whatever
  tail remains.

Everything here is pure host-side index arithmetic (static shapes) — the
device-side consumers (the batched GPU predictor in ``engine/predict.py``)
consume the grid as static metadata so the compiled program sees a fixed
chunk batch.
"""
from __future__ import annotations

import itertools
from typing import Callable, Sequence

import numpy as np

__all__ = [
    "make_chunks",
    "chunk_slices",
    "process_chunks",
    "get_slices_from_chunks",
]


def _axis_grid(arr: int, chk: int, mrg: int):
    """Chunk starts and (lo, hi) crops for one axis.

    Derived from the tiling invariant in the module docstring.  Returns
    parallel lists ``starts`` and ``crops`` such that the half-open spans
    ``[starts[i] + crops[i][0], starts[i] + crops[i][1])`` partition
    ``[0, arr)``.
    """
    stride = chk - 2 * mrg
    if stride <= 0:
        raise ValueError(
            f"margin {mrg} too large for chunk size {chk} (stride <= 0)"
        )
    if chk > arr:
        raise ValueError(f"chunk size {chk} exceeds axis size {arr}")
    # number of stride placements needed so the walk reaches arr - 2*mrg
    n = max(1, -(-(arr - 2 * mrg) // stride))
    starts = [i * stride for i in range(n - 1)]
    starts.append(arr - chk)  # final chunk pinned to the array edge
    if n >= 2 and starts[-1] == starts[-2]:
        starts.pop()  # pinned placement coincides with the natural one
        n -= 1
    # coverage boundaries: natural-placement interiors, then the edges
    bounds = [0] + [i * stride + mrg for i in range(1, n)] + [arr]
    crops = [
        (bounds[i] - starts[i], bounds[i + 1] - starts[i]) for i in range(n)
    ]
    return starts, crops


def make_chunks(arr_shape, chunk_shape, margin):
    """Compute chunk start coordinates and writeback crops.

    Parameters
    ----------
    arr_shape : sequence of int
        Shape of the (spatial) array to be chunked.
    chunk_shape : sequence of int
        Shape of each chunk, per axis. Must be <= arr_shape per axis.
    margin : int or sequence of int
        Overlap margin per axis (same for both sides).

    Returns
    -------
    chunk_starts : list of tuple of int
        Start coordinate of every chunk (outer product over axes).
    chunk_crops : list of tuple of (lo, hi) pairs
        Per-axis crop applied to each chunk on writeback, such that the
        crops exactly tile ``arr_shape``.

    Notes
    -----
    Grid semantics (incl. the pinned final chunk) match the reference
    generator, iterseg ``predict.py:38-61``; pinned by the golden tests in
    ``tests/test_chunks.py``.
    """
    ndim = len(arr_shape)
    if isinstance(margin, (int, np.integer)):
        margin = [int(margin)] * ndim
    per_axis = [
        _axis_grid(int(arr_shape[d]), int(chunk_shape[d]), int(margin[d]))
        for d in range(ndim)
    ]
    chunk_starts = list(itertools.product(*(axis[0] for axis in per_axis)))
    chunk_crops = list(itertools.product(*(axis[1] for axis in per_axis)))
    return chunk_starts, chunk_crops


def chunk_slices(start, chunk_shape):
    """Spatial slice tuple selecting one chunk from a volume."""
    return tuple(
        slice(int(s0), int(s0) + int(step))
        for s0, step in zip(start, chunk_shape)
    )


def process_chunks(
    input_volume,
    chunk_size,
    output_volume,
    margin,
    process_data_function: Callable,
    config=None,
):
    """Run ``process_data_function`` over the chunk grid, blending margins.

    Host-side driver with the same contract as the reference
    (iterseg ``predict.py:64-96``): the processing function receives the
    whole input volume plus a slice (with a leading ``slice(None)`` channel
    axis) and returns a (possibly higher-rank) prediction; the margin crop
    of the prediction is written into ``output_volume``.

    The device fast path (``engine.predict.predict_volume``) batches the
    chunks through one microbatched forward instead of looping here; this
    generic version remains for arbitrary per-chunk callables.
    """
    kwargs = config or {}
    spatial_ndim = len(chunk_size)
    starts, crops = make_chunks(
        input_volume.shape[-spatial_ndim:], chunk_size, margin=margin
    )
    for start, crop in zip(starts, crops):
        window = (slice(None),) + chunk_slices(start, chunk_size)
        prediction = process_data_function(input_volume, window, **kwargs)
        # the prediction may carry extra leading dims (e.g. batch, channel)
        # beyond the output's rank; keep them whole in the crop, and index
        # the first one away when reading from the prediction.
        n_extra = prediction.ndim - output_volume.ndim
        crop_ix = (slice(None),) * n_extra + tuple(
            slice(int(lo), int(hi)) for lo, hi in crop
        )
        cropped = prediction[(0,) + crop_ix]
        # output_volume[window] is a view for ndarray-like stores; zarr-like
        # stores need read-modify-write
        region = output_volume[window]
        region[crop_ix] = cropped
        if not isinstance(region, np.ndarray) or region.base is None:
            output_volume[window] = region
    return output_volume


def get_slices_from_chunks(arr_shape, chunk_size, margin):
    """Per-(frame, chunk) slice/crop pairs for chunkwise evaluation.

    Mirrors iterseg ``_dock_widgets.py:871-888``: for 4D data a leading
    ``slice(t, t+1)`` selects the frame; usage is ``labels[sl][cr]`` after a
    squeeze.
    """
    if len(arr_shape) <= 3:
        ts = range(1)
        fshape = arr_shape
    else:
        ts = range(arr_shape[0])
        fshape = arr_shape[1:]
    chunk_starts, chunk_crops = make_chunks(fshape, chunk_size, margin)
    slices = []
    for t in ts:
        for start, crop in zip(chunk_starts, chunk_crops):
            sl = (slice(t, t + 1),) + chunk_slices(start, chunk_size)
            cr = tuple(slice(int(lo), int(hi)) for lo, hi in crop)
            slices.append((sl, cr))
    return slices
