"""The numbers that decide ``correct``.

``label_mismatch``: the share of the voxels labelled on either side that
the best one-to-one pairing of the two sides' objects does not cover
(0 when the labels agree up to renumbering).

Training, per leaf (a learnt array of the U-Net): the gap between the
program's norm and the reference's, over the reference's norm of that leaf
or of the median leaf, whichever is larger. The worst leaf is compared,
over the leaves whose gradient is not nought: a conv bias right before a
BatchNorm has an exact gradient of nought, and its float32 gradient and
its moves under Adam are round-off, so ``moved_leaves`` leaves it out by
the reference's gradient in float64.
"""
from __future__ import annotations

import numpy as np


def label_mismatch(a: np.ndarray, b: np.ndarray) -> float:
    if a.shape != b.shape:
        return 1.0
    fg = (a > 0) | (b > 0)
    n = int(fg.sum())
    if n == 0:
        return 0.0
    pa = a[fg].astype(np.int64)
    pb = b[fg].astype(np.int64)
    base = int(pb.max()) + 1
    pairs, counts = np.unique(pa * base + pb, return_counts=True)
    ka, kb = pairs // base, pairs % base
    used_a, used_b, matched = set(), set(), 0
    for i in np.argsort(-counts, kind="stable"):
        x, y = int(ka[i]), int(kb[i])
        if x == 0 or y == 0 or x in used_a or y in used_b:
            continue
        used_a.add(x)
        used_b.add(y)
        matched += int(counts[i])
    return 1.0 - matched / n


def leaf_gaps(program: dict, reference: dict, leaves=None) -> dict:
    """Per leaf ``|program - reference| / max(reference, median)`` of the
    leaves' norms (``leaves``: the ones counted; all by default)."""
    leaves = list(reference) if leaves is None else list(leaves)
    med = float(np.median([reference[k] for k in leaves]))
    return {k: abs(program[k] - reference[k]) / max(reference[k], med)
            for k in leaves}


def worst_leaves(program: dict, reference: dict, leaves=None, n=4):
    """The ``n`` leaves with the widest gaps, as (name, program,
    reference, gap) rows."""
    gaps = leaf_gaps(program, reference, leaves)
    return [(k, program[k], reference[k], g) for k, g in
            sorted(gaps.items(), key=lambda kv: -kv[1])[:n]]


def moved_leaves(first_grad_norms: dict, share=1e-3):
    """Leaves whose first gradient is at least ``share`` of the median
    leaf's: the rest (biases under a BatchNorm, whose float64 gradient
    reads under 1e-10 of the median) move under Adam by round-off alone."""
    med = float(np.median(list(first_grad_norms.values())))
    return [k for k, v in first_grad_norms.items() if v >= share * med]


def loss_gap(program, reference) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))
