"""Volume normalisation and cleanup utilities.

Host-side (numpy) helpers matching the reference's per-volume preparation
(iterseg ``segmentation.py:885-916`` and ``train_io.py:505-515``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["normalise_data", "remove_sum_zero_slices", "prepare_volume"]


def normalise_data(image):
    """Scale image values so the max is 1 (iterseg ``train_io.py:505``)."""
    return image / image.max()


def remove_sum_zero_slices(input_volume, return_kept=False):
    """Drop all-zero hyperplanes along every axis.

    Matches iterseg ``segmentation.py:903-916``: for each axis, keep only
    the indices whose hyperplane sum is nonzero.  Vectorised instead of the
    reference's per-index Python loop, and an axis that keeps every index
    is not indexed (a volume that loses nothing comes back as it is, not
    copied).  With ``return_kept``, also returns the per-axis kept index
    arrays so results computed on the reduced volume can be scattered back
    to the original shape.
    """
    kept = []
    for ax_i in range(input_volume.ndim):
        other = tuple(i for i in range(input_volume.ndim) if i != ax_i)
        sums = input_volume.sum(axis=other)
        nonzero = np.flatnonzero(sums)
        kept.append(nonzero)
        if len(nonzero) < input_volume.shape[ax_i]:
            s = [slice(None)] * input_volume.ndim
            s[ax_i] = nonzero
            input_volume = input_volume[tuple(s)]
    if return_kept:
        return input_volume, kept
    return input_volume


def prepare_volume(input_volume, return_kept=False):
    """Reference pre-segmentation normalisation (``segmentation.py:885-889``).

    If the volume contains zeros, all-zero slices are removed (these arise
    from ragged-frame zero padding); then values are scaled to [0, 1].

    With ``return_kept``, also returns the per-axis kept indices (or None
    when nothing was removed) for scattering labels back — the reference
    crashes on writeback whenever slices were actually removed; we restore
    instead (documented deviation).
    """
    input_volume = np.asarray(input_volume).astype(np.float32)
    kept = None
    if input_volume.min() == 0:
        original_shape = input_volume.shape
        input_volume, kept = remove_sum_zero_slices(
            input_volume, return_kept=True
        )
        if input_volume.shape == original_shape:
            kept = None
    input_volume = input_volume / np.max(input_volume)
    if return_kept:
        return input_volume, kept
    return input_volume


def restore_labels(labels, kept, original_shape):
    """Scatter labels computed on a zero-slice-reduced volume back into the
    original frame shape (removed hyperplanes stay background)."""
    if kept is None:
        return labels
    out = np.zeros(original_shape, dtype=labels.dtype)
    out[np.ix_(*kept)] = labels
    return out
