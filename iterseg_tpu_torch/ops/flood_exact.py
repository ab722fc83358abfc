"""The verified exact flood: a certificate of the heap flood's labels and a
proven repair, in plain torch on any device.

The port of ``iterseg_tpu/ops/flood_exact.py`` (its module docstring holds
the proofs). The sequential heap flood (``ops/watershed_oracle``) claims
each voxel from the first neighbour to pop, and pops come in increasing
virtual time ``V(u) = max(V(claimer), w(claimer -> u))``, so a label
depends on the schedule only where exact f32 ties leave the first popping
neighbour ambiguous.

*Certificate* (``_certificate_core``), three monotone fixed points:

- phase A: ``V_lb``, the minimax distance, a lower bound of every
  schedule's virtual time;
- phase B: the interval ``[V_lb, V_ub]`` tightened jointly, where a
  neighbour ``v`` is a *possible claimer* of ``u`` when
  ``V_lb(v) <= min over the neighbours of V_ub``;
- phase C: ``rep``, the label of the ``(V_lb, index)``-least labelled
  possible claimer, and ``unc``, set where the possible claimers disagree
  or one of them is uncertain. Where ``unc`` is False, ``rep`` is the
  heap's label under every consistent schedule.

*Verified repair* (``_verified_core``): the certificate runs again on the
uncertain set ``R`` plus its certain labelled rim, the rim seeded at its
``[V_lb, V_ub]`` release interval. If every voxel of ``R`` comes out
certain, the labels are proven the heap's; otherwise the caller runs the
exact host flood. Two guards route tie-heavy inputs to the host flood
early: the tie probe (``TIE_PROBE_DEFAULT``) before the certificate, the
repair doom (``REPAIR_DOOM_FRAC``) after phase C.

Translation: each ``lax.while_loop`` is ``device_flood.run_checked`` (the
same groups of ``check_every`` steps, the same ``max_iters`` cap, the same
extra deciding step, one host read a group) and each ``lax.cond`` a branch
on one scalar read from the device. Everything is exact f32 selection
(min, max, compare) and int32/bool logic, so the outputs are bit-equal to
JAX's on every device. Neighbour views follow JAX's footprint order (z-,
y-, x-, x+, y+, z+); note that ``_edge_weights`` puts the shifted weights
at indices 3-5, unlike ``device_flood.edge_weights``.
"""
from __future__ import annotations

import numpy as np
import torch

from .device_flood import _seed_image, _tensors, run_checked

__all__ = [
    "certificate_flood_core",
    "certificate_flood",
    "image_certificate_flood_core",
    "image_certificate_flood",
    "verified_exact_flood",
    "verified_exact_image_flood",
    "exact_affinity_flood",
    "exact_image_flood",
    "TIE_PROBE_DEFAULT",
    "REPAIR_DOOM_FRAC",
]

# the tied-voxel fraction above which the certificate is skipped and the
# caller goes straight to the exact host flood (JAX's calibration)
TIE_PROBE_DEFAULT = 0.02

# the uncertain fraction after phase C above which the repair is skipped
# and the caller goes to the exact host flood (JAX's calibration)
REPAIR_DOOM_FRAC = 0.03

_INF = float("inf")


def _neighbour_views(arrs, fills):
    """For each array, its 6 face-neighbour views in the footprint order
    (z-, y-, x-, x+, y+, z+), filled past the edge with the array's fill;
    returns a list of 6 tuples."""
    pads = []
    for x, fill in zip(arrs, fills):
        p = torch.full(tuple(s + 2 for s in x.shape), fill, dtype=x.dtype,
                       device=x.device)
        p[1:-1, 1:-1, 1:-1] = x
        pads.append(p)
    c = slice(1, -1)
    sls = [(slice(0, -2), c, c), (c, slice(0, -2), c), (c, c, slice(0, -2)),
           (c, c, slice(2, None)), (c, slice(2, None), c),
           (slice(2, None), c, c)]
    return [tuple(p[sl] for p in pads) for sl in sls]


def _edge_weights(affinities):
    """``weights[k][u]``: the arc value entering ``u`` from footprint
    direction ``k`` (stored at the higher index, as the oracle's
    ``aff_off`` table has it)."""
    aff = affinities.to(torch.float32)
    weights = [aff[a] for a in range(3)]
    for a in reversed(range(3)):
        w = torch.full_like(aff[a], _INF)
        dst = [slice(None)] * 3
        src = [slice(None)] * 3
        dst[a] = slice(0, -1)
        src[a] = slice(1, None)
        w[tuple(dst)] = aff[a][tuple(src)]
        weights.append(w)
    return weights


def _certificate_core(weights, seeds, mask, seed_values, max_iters,
                      check_every, seed_values_ub=None, phase_s=None):
    """Phases A, B and C over a per-direction weight list. ``seed_values``
    (a float or a tensor): the seeds' virtual pop time, 0 for the affinity
    heap, the seeds' own value for the image heap. ``seed_values_ub``: the
    upper end when seed release times are intervals (the repair). With
    ``phase_s`` (a dict) each phase's seconds are added under ``"A"``,
    ``"B"``, ``"C"``. Returns ``(rep, unc, v_lb, v_ub, converged)``, the
    last a python bool."""
    import time

    mask = mask.to(torch.bool)
    dev = mask.device
    seeded = (seeds > 0) & mask
    frozen = seeded | ~mask
    lab_seed = torch.where(seeded, seeds, 0).to(torch.int32)
    idx = torch.arange(mask.numel(), dtype=torch.int32,
                       device=dev).reshape(mask.shape)
    inf = torch.tensor(_INF, device=dev)

    def timed(name, fn):
        if phase_s is None:
            return fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - t0
        return out

    def at_seeds(values):
        values = torch.as_tensor(values, dtype=torch.float32, device=dev)
        return torch.where(seeded, values, inf)

    # ---- phase A: V_lb = the minimax distance (monotone decreasing) ----
    v0 = at_seeds(seed_values)
    v0_ub = v0 if seed_values_ub is None else at_seeds(seed_values_ub)

    def step_a(state):
        (v,) = state
        best = v
        for k, (v_n,) in enumerate(_neighbour_views([v], [_INF])):
            best = torch.minimum(best, torch.maximum(v_n, weights[k]))
        v_new = torch.where(frozen, v0, torch.where(mask, best, inf))
        return (v_new,), (v_new != v).any()

    (v_lb,), _, conv_a = timed("A", lambda: run_checked(
        step_a, (v0,), max_iters, check_every))

    # ---- phase B: the joint [V_lb, V_ub] interval iteration ----
    def step_b(state):
        lb, ub = state
        nbrs = _neighbour_views([lb, ub], [_INF, _INF])
        m_high = torch.full_like(lb, _INF)
        for _lb_n, ub_n in nbrs:
            m_high = torch.minimum(m_high, ub_n)
        m_low = torch.full_like(lb, _INF)  # least lb of a possible claimer
        w_min = torch.full_like(lb, _INF)
        w_max = torch.full_like(lb, -_INF)
        any_poss = torch.zeros_like(mask)
        for k, (lb_n, _ub_n) in enumerate(nbrs):
            poss = (lb_n <= m_high) & (lb_n < _INF)
            m_low = torch.where(poss, torch.minimum(m_low, lb_n), m_low)
            w_min = torch.where(poss, torch.minimum(w_min, weights[k]), w_min)
            w_max = torch.where(poss, torch.maximum(w_max, weights[k]), w_max)
            any_poss = any_poss | poss
        lb_cand = torch.where(any_poss, torch.maximum(m_low, w_min), lb)
        ub_cand = torch.where(any_poss, torch.maximum(m_high, w_max), inf)
        lb_new = torch.where(frozen, v0, torch.where(
            mask, torch.maximum(lb, lb_cand), inf))
        ub_new = torch.where(frozen, v0_ub, torch.where(
            mask, torch.minimum(ub, ub_cand), inf))
        return (lb_new, ub_new), ((lb_new != lb) | (ub_new != ub)).any()

    (v_lb, v_ub), _, conv_b = timed("B", lambda: run_checked(
        step_b, (v_lb, v0_ub), max_iters, check_every))

    # the possible-claimer threshold, fixed from here on
    m_high = torch.full_like(v_ub, _INF)
    for (u_n,) in _neighbour_views([v_ub], [_INF]):
        m_high = torch.minimum(m_high, u_n)
    lb_views = _neighbour_views([v_lb, idx], [_INF, 0])
    poss_k = [(lb_n <= m_high) & (lb_n < _INF) for lb_n, _ in lb_views]

    # ---- phase C: representative labels + uncertainty ----
    def step_c(state):
        rep, unc = state
        nbrs = _neighbour_views([rep, unc], [0, False])
        best_key_v = torch.full_like(v_lb, _INF)
        best_key_i = torch.zeros_like(rep)
        best_rep = torch.zeros_like(rep)
        seen_lab = torch.zeros_like(rep)
        disagree = torch.zeros_like(unc)
        poss_unc = torch.zeros_like(unc)
        for (rep_n, unc_n), (lb_n, idx_n), poss in zip(nbrs, lb_views,
                                                      poss_k):
            labd = poss & (rep_n > 0)
            # the deterministic representative: the (V_lb, index)-least
            # labelled possible claimer
            better = labd & ((lb_n < best_key_v)
                             | ((lb_n == best_key_v) & (idx_n < best_key_i)))
            best_key_v = torch.where(better, lb_n, best_key_v)
            best_key_i = torch.where(better, idx_n, best_key_i)
            best_rep = torch.where(better, rep_n, best_rep)
            disagree = disagree | (labd & (seen_lab > 0) & (rep_n != seen_lab))
            seen_lab = torch.where(labd & (seen_lab == 0), rep_n, seen_lab)
            poss_unc = poss_unc | (poss & unc_n)
        unc_new = (unc | disagree | poss_unc) & mask & ~frozen
        # rep freezes once uncertain (its value is the repair's business)
        rep_new = torch.where(frozen, lab_seed,
                              torch.where(mask & ~unc, best_rep, rep))
        rep_new = torch.where(mask, rep_new, 0)
        return (rep_new, unc_new), ((rep_new != rep) | (unc_new != unc)).any()

    (rep, unc), _, conv_c = timed("C", lambda: run_checked(
        step_c, (lab_seed, torch.zeros_like(mask)), max_iters, check_every))
    return rep, unc, v_lb, v_ub, conv_a and conv_b and conv_c


def certificate_flood_core(affinities, seeds, mask, max_iters=1024,
                           check_every=8, phase_s=None):
    """The affinity certificate on the tensors' device (JAX
    ``certificate_flood_jit``): ``(rep int32, unc bool, v_lb f32, v_ub f32,
    converged)``."""
    return _certificate_core(_edge_weights(affinities), seeds, mask, 0.0,
                             max_iters, check_every, phase_s=phase_s)


def image_certificate_flood_core(values, seeds, mask, max_iters=1024,
                                 check_every=8, phase_s=None):
    """The image-watershed certificate (JAX
    ``image_certificate_flood_jit``): every entry weight is the node's own
    value, and seeds pop at their own value."""
    values = values.to(torch.float32)
    return _certificate_core([values] * 6, seeds, mask, values, max_iters,
                             check_every, phase_s=phase_s)


def _numpy_out(rep, unc, v_lb, v_ub, conv):
    return (rep.cpu().numpy(), unc.cpu().numpy(), v_lb.cpu().numpy(),
            v_ub.cpu().numpy(), bool(conv))


def certificate_flood(affinities, marker_coords, mask, max_iters=1024,
                      device=None):
    """NumPy-facing certificate (the oracle's calling convention: seeds take
    labels 1..n in row order). Returns ``(rep, unc, v_lb, v_ub,
    converged)`` as numpy arrays and a bool."""
    from ..device import resolve_device

    mask = np.asarray(mask).astype(bool)
    a, s, m = _tensors(resolve_device(device),
                       np.asarray(affinities, np.float32),
                       _seed_image(mask.shape, marker_coords), mask)
    return _numpy_out(*certificate_flood_core(a, s, m, max_iters))


def image_certificate_flood(values, markers_or_coords, mask, max_iters=1024,
                            device=None):
    """NumPy-facing image certificate (coordinate rows label 1..n, or a full
    int seed image)."""
    from ..device import resolve_device

    mask = np.asarray(mask).astype(bool)
    v, s, m = _tensors(resolve_device(device), np.asarray(values, np.float32),
                       _seed_image(mask.shape, markers_or_coords), mask)
    return _numpy_out(*image_certificate_flood_core(v, s, m, max_iters))


def _affinity_ties(weights, mask):
    """Voxels whose claim competition is exactly tied on arc values: two or
    more in-mask incoming arcs with bit-equal f32 weights. The heap breaks
    such ties by its global FIFO age, which no device schedule can
    reproduce."""
    valid = [m for (m,) in _neighbour_views([mask], [False])]
    tie = torch.zeros_like(mask)
    for i in range(len(weights)):
        for j in range(i + 1, len(weights)):
            tie = tie | (valid[i] & valid[j] & (weights[i] == weights[j]))
    return tie & mask


def _image_ties(values, mask):
    """The image twin: every incoming arc carries the node's own value, so
    claimer competitions tie where neighbours' values are bit-equal."""
    nbrs = _neighbour_views([values, mask], [_INF, False])
    tie = torch.zeros_like(mask)
    for i in range(len(nbrs)):
        v_i, m_i = nbrs[i]
        for j in range(i + 1, len(nbrs)):
            v_j, m_j = nbrs[j]
            tie = tie | (m_i & m_j & (v_i == v_j))
    return tie & mask


def _verified_core(weights, seeds, mask, seed_values, max_iters,
                   check_every, ties=None, tie_probe=0.0,
                   repair_doom=REPAIR_DOOM_FRAC, phase_s=None):
    """Certificate plus the verified restricted repair (JAX
    ``_verified_core``). Returns ``(labels int32, resolved, unc_count,
    n_mask, tie_frac)``, the last four host scalars (``tie_frac`` a
    ``np.float32``). ``resolved`` False sends the caller to the exact host
    flood; ``unc_count == -1`` marks a tie-probe skip (the certificate never
    ran). ``tie_probe=0`` disables the probe and ``repair_doom=0`` the
    post-phase-C guard. ``phase_s`` gets each certificate phase's seconds
    (``"A"``, ``"B"``, ``"C"``, summed over both runs) and ``"repair"``."""
    mask_b = mask.to(torch.bool)
    n_mask = int(mask_b.sum())
    tie_frac = np.float32(0.0)
    if ties is not None and tie_probe > 0.0:
        tie_frac = np.float32(int(ties.sum())) / np.float32(max(n_mask, 1))
        if not tie_frac <= np.float32(tie_probe):
            return (torch.zeros_like(seeds, dtype=torch.int32), False, -1,
                    n_mask, tie_frac)
    rep, unc, v_lb, v_ub, conv = _certificate_core(
        weights, seeds, mask_b, seed_values, max_iters, check_every,
        phase_s=phase_s)
    unc_count = int(unc.sum())
    if repair_doom > 0.0 and (np.float32(unc_count) > np.float32(repair_doom)
                              * np.float32(n_mask)):
        # a large uncertain set has never proven out: resolve to the
        # fallback at about the certificate's cost
        return (torch.zeros_like(seeds, dtype=torch.int32), False, unc_count,
                n_mask, tie_frac)
    if unc_count == 0:
        # R is empty: the restricted run is trivially converged and certain
        return (torch.where(mask_b, rep, 0), conv, 0, n_mask, tie_frac)
    R = unc
    grow = R
    for (r_n,) in _neighbour_views([R], [False]):
        grow = grow | r_n
    B = grow & ~R & (rep > 0)
    sub = {} if phase_s is not None else None
    rep_r, unc_r, _lb, _ub, conv_r = _certificate_core(
        weights, torch.where(B, rep, 0), R | B, v_lb, max_iters, check_every,
        seed_values_ub=v_ub, phase_s=sub)
    if sub is not None:
        phase_s["repair"] = phase_s.get("repair", 0.0) + sum(sub.values())
    resolved = conv and conv_r and not bool((unc_r & R).any())
    labels = torch.where(mask_b, torch.where(R, rep_r, rep), 0)
    return labels.to(torch.int32), resolved, unc_count, n_mask, tie_frac


def verified_exact_flood(affinities, seeds, mask, max_iters=1024,
                         check_every=8, tie_probe=0.0,
                         repair_doom=REPAIR_DOOM_FRAC, phase_s=None):
    """The verified exact affinity flood on the tensors' device (JAX
    ``verified_exact_flood_jit``): ``(labels, resolved, unc_count, n_mask,
    tie_frac)``. The labels are the heap's bit for bit when ``resolved``;
    otherwise the caller runs the exact host flood."""
    mask_b = mask.to(torch.bool)
    weights = _edge_weights(affinities)
    ties = _affinity_ties(weights, mask_b) if tie_probe > 0.0 else None
    return _verified_core(weights, seeds, mask_b, 0.0, max_iters,
                          check_every, ties=ties, tie_probe=tie_probe,
                          repair_doom=repair_doom, phase_s=phase_s)


def verified_exact_image_flood(values, seeds, mask, max_iters=1024,
                               check_every=8, tie_probe=0.0,
                               repair_doom=REPAIR_DOOM_FRAC, phase_s=None):
    """The image-watershed twin of ``verified_exact_flood``."""
    mask_b = mask.to(torch.bool)
    values = values.to(torch.float32)
    ties = _image_ties(values, mask_b) if tie_probe > 0.0 else None
    return _verified_core([values] * 6, seeds, mask_b, values, max_iters,
                          check_every, ties=ties, tie_probe=tie_probe,
                          repair_doom=repair_doom, phase_s=phase_s)


def _fill_telemetry(tele, resolved, unc_count, n_mask, tie_frac):
    """Decode the path into ``tele``; True when the caller must run the
    exact host flood."""
    unc_count, n_mask = int(unc_count), int(n_mask)
    tele["tie_frac"] = float(tie_frac)
    if unc_count < 0:  # the tie probe skipped the certificate
        tele["uncertain_frac"] = None
        tele["path"] = "fallback:tie-density"
        return True
    tele["uncertain_frac"] = unc_count / n_mask if n_mask else 0.0
    if not bool(resolved):
        tele["path"] = "fallback:unresolved"
        return True
    tele["path"] = "certified" if unc_count == 0 else "repaired"
    return False


def exact_affinity_flood(affinities, marker_coords, mask, telemetry=None,
                         tie_probe=TIE_PROBE_DEFAULT,
                         repair_doom=REPAIR_DOOM_FRAC, device=None):
    """Labels bit-equal to the exact heap flood
    (``watershed_oracle.affinity_flood_py``): the verified flood on
    ``device``, or the port's exact host flood (``ops/watershed``) when the
    repair cannot be proven. ``telemetry`` (a dict) gets
    ``uncertain_frac``, ``tie_frac`` and ``path`` ("certified",
    "repaired" or "fallback:*")."""
    from ..device import resolve_device
    from .watershed import affinity_watershed

    mask = np.asarray(mask).astype(bool)
    mc = np.asarray(marker_coords)
    tele = telemetry if telemetry is not None else {}
    a, s, m = _tensors(resolve_device(device),
                       np.asarray(affinities, np.float32),
                       _seed_image(mask.shape, mc), mask)
    labels, *rest = verified_exact_flood(a, s, m, tie_probe=float(tie_probe),
                                         repair_doom=float(repair_doom))
    if _fill_telemetry(tele, *rest):
        return affinity_watershed(affinities, mc, mask)
    return labels.cpu().numpy()


def exact_image_flood(values, markers_or_coords, mask, telemetry=None,
                      tie_probe=TIE_PROBE_DEFAULT,
                      repair_doom=REPAIR_DOOM_FRAC, device=None):
    """The image twin of ``exact_affinity_flood``: labels bit-equal to
    ``watershed_oracle.image_flood_py`` and the exact host image flood."""
    from ..device import resolve_device
    from .watershed import image_watershed

    mask = np.asarray(mask).astype(bool)
    values_np = np.asarray(values, np.float32)
    markers = _seed_image(mask.shape, markers_or_coords)
    tele = telemetry if telemetry is not None else {}
    v, s, m = _tensors(resolve_device(device), values_np, markers, mask)
    labels, *rest = verified_exact_image_flood(
        v, s, m, tie_probe=float(tie_probe), repair_doom=float(repair_doom))
    if _fill_telemetry(tele, *rest):
        return image_watershed(values_np, markers, mask)
    return labels.cpu().numpy()
