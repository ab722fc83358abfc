"""The wavefront floods in plain torch: the ``device_flood="xla"`` floods of
both pipelines, and the readable spec of the flood rules that the CUDA
kernels run (``ops/flood_kernel.py`` for the affinity flood,
``ops/image_flood_kernel.py`` for the image flood).

The port of ``iterseg_tpu/ops/device_flood.py``: approximations of the
sequential heap flood (claim-at-push, reference ``watershed.py:95-159``),
in two modes. ``mode="minimax"`` is the classic monotone recurrence
``d(u) = min over v of max(d(v), w(u, v))``, the neighbours visited in
JAX's footprint order (z-, y-, x-, x+, y+, z+), the first of equal
candidates kept. ``mode="claim"`` is the claim recurrence below.

**Affinity flood** (``hop_ties=False``):

- Each free voxel ``u`` (in the mask, not a seed) looks at its 6 face
  neighbours ``v`` that carry a label and picks the one with the smallest
  key ``(d_v, idx_v)``: virtual time first, then the row-major ravel index
  of the voxel (any row-major embedding orders voxels the same way, so the
  JAX recurrence's index, the Pallas kernel's guard-geometry index and this
  one agree on every tie).
- ``u`` claims only if that key is strictly below the claimant key
  ``(ckd_u, cki_u)`` it last claimed with; then ``d_u = max(d_v, w_uv)``,
  ``lab_u = lab_v`` and the claimant key is stored. The edge weight
  ``w_uv`` crossing between ``p`` and ``p + e_a`` is ``aff[a, p + e_a]``:
  entering ``u`` from ``u - e_a`` it is ``aff[a, u]``, from ``u + e_a`` it
  is ``aff[a, u + e_a]``.
- Seeds start at ``d = 0`` with claimant key ``-inf`` and never change;
  voxels outside the mask never carry a label.

**Image flood** (skimage's node-keyed ``watershed(values, markers, mask)``,
the DoG path's flood on −EDT; JAX ``wavefront_image_flood_jit``, which runs
the recurrence with ``hop_ties=True``). Three differences:

- seeds start at their own value, ``d0 = values[seed]``;
- the weight entering ``u`` is ``values[u]`` from every direction;
- a third state array ``h`` counts hops since the virtual time last rose,
  and keys are ``(d, h, idx)``, compared in that order. A claim sets
  ``h_u = 0`` when ``max(best_d, values[u]) > best_d``, else
  ``best_h + 1``: on an equal-value plateau the heap's FIFO age order is a
  BFS from the plateau's entry fronts, which the hop count tracks.

Every step updates every voxel at once (Jacobi), so the recurrences are
deterministic; the per-voxel key only decreases over a finite set, so they
terminate. Two loops drive them. ``wavefront_flood`` and
``wavefront_image_flood_core`` run JAX's (``run_checked``: groups of
``check_every`` steps, one host read a group, one extra step deciding
convergence) and return JAX's labels, ``n_iters`` and ``converged`` bit
for bit. ``claim_until_quiet`` and ``image_claim_until_quiet`` stop at the
first step that claims nothing, as the CUDA kernels do, and are their plain
versions at ``inner_cap=1``.

The state lives on padded arrays (one voxel of ring: ``d = inf``,
``lab = 0``, ``h = 0``), so a step reads its neighbours as slices; the
step functions also serve the tile-local relaxation of the kernels' plain
versions, where leading dimensions index tiles.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["init_state", "edge_weights", "wavefront_flood",
           "wavefront_affinity_flood", "wavefront_image_flood_core",
           "wavefront_image_flood", "run_checked", "run_until_quiet",
           "claim_until_quiet", "image_claim_until_quiet"]

_INF = float("inf")


def init_state(seeds: torch.Tensor, mask: torch.Tensor, seed_values=None):
    """``(d, lab, ckd, cki, code)`` of the flood's start; code is uint8
    (0 outside the mask, 1 free, 2 seed). Seeds start at ``d = 0``, or at
    ``seed_values`` (a float32 tensor of the mask's shape) when given."""
    mask = mask.to(torch.bool)
    lab = torch.where(mask, seeds.to(torch.int32), 0).to(torch.int32)
    seeded = lab > 0
    start = 0.0 if seed_values is None else seed_values.to(torch.float32)
    d = torch.where(seeded, start, _INF).to(torch.float32)
    ckd = torch.where(seeded, -_INF, _INF).to(torch.float32)
    cki = torch.zeros_like(lab)
    code = torch.where(seeded, 2, mask.to(torch.uint8)).to(torch.uint8)
    return d, lab, ckd, cki, code


def edge_weights(aff: torch.Tensor):
    """The six weights entering each voxel, direction order (z-, z+, y-,
    y+, x-, x+): ``aff[a]`` from ``u - e_a``, ``aff[a]`` shifted down by
    one along ``a`` (``inf`` past the edge) from ``u + e_a``."""
    out = []
    for a in range(3):
        w = aff[a]
        nxt = torch.full_like(w, _INF)
        dst = [slice(None)] * 3
        src = [slice(None)] * 3
        dst[a] = slice(0, -1)
        src[a] = slice(1, None)
        nxt[tuple(dst)] = w[tuple(src)]
        out += [w, nxt]
    return torch.stack(out)


def neighbour_index(shape, device):
    """``idx_u`` (int32 row-major ravel) and the per-direction offsets
    ``(-YX, +YX, -X, +X, -1, +1)``."""
    Z, Y, X = shape
    idx = torch.arange(Z * Y * X, dtype=torch.int32,
                       device=device).reshape(Z, Y, X)
    offs = (-Y * X, Y * X, -X, X, -1, 1)
    return idx, offs


def pad_ring(x: torch.Tensor, fill, dims=3):
    """``x`` with a one-voxel ring of ``fill`` on its last ``dims`` axes."""
    shape = x.shape[:-dims] + tuple(s + 2 for s in x.shape[-dims:])
    out = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    out[(..., ) + (slice(1, -1),) * dims] = x
    return out


_NBR = (  # neighbour slices of the padded arrays, direction order
    (slice(0, -2), slice(1, -1), slice(1, -1)),   # z-
    (slice(2, None), slice(1, -1), slice(1, -1)),  # z+
    (slice(1, -1), slice(0, -2), slice(1, -1)),   # y-
    (slice(1, -1), slice(2, None), slice(1, -1)),  # y+
    (slice(1, -1), slice(1, -1), slice(0, -2)),   # x-
    (slice(1, -1), slice(1, -1), slice(2, None)),  # x+
)
_INTERIOR = (Ellipsis, slice(1, -1), slice(1, -1), slice(1, -1))


def _claim_step(d_pad, lab_pad, ckd, cki, weights, idx, offs, free):
    """One synchronous claim update of the interior of padded state
    ``(d_pad, lab_pad)`` (…, a+2, b+2, c+2); ``ckd``, ``cki``, ``idx``,
    ``free`` and ``weights[k]`` have the interior's shape. Returns the new
    interior ``(d, lab, ckd, cki)`` and the claim mask."""
    best_kd = torch.full_like(ckd, _INF)
    best_ki = torch.zeros_like(cki)
    best_lab = torch.zeros_like(cki)
    best_w = torch.zeros_like(ckd)
    for k, sl in enumerate(_NBR):
        d_v = d_pad[(Ellipsis,) + sl]
        lab_v = lab_pad[(Ellipsis,) + sl]
        idx_v = idx + offs[k]
        better = (lab_v > 0) & (
            (d_v < best_kd) | ((d_v == best_kd) & (idx_v < best_ki)))
        best_kd = torch.where(better, d_v, best_kd)
        best_ki = torch.where(better, idx_v, best_ki)
        best_w = torch.where(better, weights[k], best_w)
        best_lab = torch.where(better, lab_v, best_lab)
    claim = ((best_kd < ckd) | ((best_kd == ckd) & (best_ki < cki))) & free
    d_new = torch.where(claim, torch.maximum(best_kd, best_w),
                        d_pad[_INTERIOR])
    lab_new = torch.where(claim, best_lab, lab_pad[_INTERIOR])
    return (d_new, lab_new, torch.where(claim, best_kd, ckd),
            torch.where(claim, best_ki, cki), claim)


def _image_claim_step(d_pad, lab_pad, h_pad, ckd, ckh, cki, values, idx,
                      offs, free):
    """One synchronous hop-tie claim update of the image flood on padded
    state ``(d_pad, lab_pad, h_pad)``; the other arguments have the
    interior's shape. Returns the new interior ``(d, lab, h, ckd, ckh,
    cki)`` and the claim mask."""
    best_kd = torch.full_like(ckd, _INF)
    best_kh = torch.zeros_like(ckh)
    best_ki = torch.zeros_like(cki)
    best_lab = torch.zeros_like(cki)
    for k, sl in enumerate(_NBR):
        sl = (Ellipsis,) + sl
        d_v, lab_v, h_v = d_pad[sl], lab_pad[sl], h_pad[sl]
        idx_v = idx + offs[k]
        better = (lab_v > 0) & (
            (d_v < best_kd) | ((d_v == best_kd) & (
                (h_v < best_kh) | ((h_v == best_kh) & (idx_v < best_ki)))))
        best_kd = torch.where(better, d_v, best_kd)
        best_kh = torch.where(better, h_v, best_kh)
        best_ki = torch.where(better, idx_v, best_ki)
        best_lab = torch.where(better, lab_v, best_lab)
    claim = ((best_kd < ckd) | ((best_kd == ckd) & (
        (best_kh < ckh) | ((best_kh == ckh) & (best_ki < cki))))) & free
    d_claim = torch.maximum(best_kd, values)
    # hop count: +1 within a value plateau, reset on a strict rise
    h_claim = torch.where(d_claim > best_kd, 0, best_kh + 1).to(torch.int32)
    return (torch.where(claim, d_claim, d_pad[_INTERIOR]),
            torch.where(claim, best_lab, lab_pad[_INTERIOR]),
            torch.where(claim, h_claim, h_pad[_INTERIOR]),
            torch.where(claim, best_kd, ckd),
            torch.where(claim, best_kh, ckh),
            torch.where(claim, best_ki, cki), claim)


def image_init_state(values, seeds, mask):
    """``(d, lab, h, ckd, ckh, cki, code)`` of the image flood's start:
    seeds at their own value, hop counts 0."""
    d, lab, ckd, cki, code = init_state(seeds, mask, seed_values=values)
    return d, lab, torch.zeros_like(lab), ckd, torch.zeros_like(cki), cki, code


# JAX's footprint order (z-, y-, x-, x+, y+, z+) as indices into ``_NBR``:
# the minimax update keeps the first of several equal candidates, so its
# labels depend on the order in which the neighbours are visited
_FOOTPRINT = (0, 2, 4, 5, 3, 1)


def _steps(weights, seeds, mask, mode, seed_values=None, hop_ties=False):
    """``(step, state0)`` of one recurrence: ``step(state)`` returns the
    next state (fresh tensors; ``state`` is left as it was) and a device
    bool, whether the step changed anything. ``state[1]`` holds the padded
    labels. ``weights``: the six entry weights in ``_NBR`` order, or the one
    tensor of node values when ``hop_ties``."""
    idx, offs = neighbour_index(mask.shape, mask.device)
    if mode == "minimax":
        d0, lab0, _, _, code = init_state(seeds, mask, seed_values)
        frozen = code != 1
        if hop_ties:
            weights = [weights] * 6

        def step(state):
            d_pad, lab_pad = state
            best_d, best_lab = d_pad[_INTERIOR], lab_pad[_INTERIOR]
            d, lab = best_d, best_lab
            for k in _FOOTPRINT:
                cand = torch.maximum(d_pad[_NBR[k]], weights[k])
                take = cand < best_d
                best_d = torch.where(take, cand, best_d)
                best_lab = torch.where(take, lab_pad[_NBR[k]], best_lab)
            d_new = torch.where(frozen, d0, best_d)
            lab_new = torch.where(frozen, lab0, best_lab)
            changed = ((lab_new != lab) | (d_new != d)).any()
            return (pad_ring(d_new, _INF), pad_ring(lab_new, 0)), changed

        return step, (pad_ring(d0, _INF), pad_ring(lab0, 0))
    if mode != "claim":
        raise ValueError(f"mode must be 'claim' or 'minimax', got {mode!r}")
    if not hop_ties:
        d, lab, ckd, cki, code = init_state(seeds, mask, seed_values)
        free = code == 1

        def step(state):
            d, lab, ckd, cki, claim = _claim_step(*state, weights, idx, offs,
                                                  free)
            return (pad_ring(d, _INF), pad_ring(lab, 0), ckd,
                    cki), claim.any()

        return step, (pad_ring(d, _INF), pad_ring(lab, 0), ckd, cki)
    d, lab, h, ckd, ckh, cki, code = image_init_state(weights, seeds, mask)
    free = code == 1

    def step(state):
        d, lab, h, ckd, ckh, cki, claim = _image_claim_step(
            *state, weights, idx, offs, free)
        return (pad_ring(d, _INF), pad_ring(lab, 0), pad_ring(h, 0), ckd, ckh,
                cki), claim.any()

    return step, (pad_ring(d, _INF), pad_ring(lab, 0), pad_ring(h, 0), ckd,
                  ckh, cki)


def run_checked(step, state, max_iters, check_every):
    """JAX's ``lax.while_loop`` over a recurrence, with one host read a
    group: while the last step changed something and fewer than
    ``max_iters`` steps ran, run ``check_every`` more steps (the count can
    pass ``max_iters`` when it is not a multiple of ``check_every``); then
    one extra step, whose result is dropped, decides convergence. Returns
    ``(state, n_steps, converged)``."""
    it, changed = 0, True
    while changed and it < max_iters:
        for _ in range(check_every):
            state, flag = step(state)
        it += check_every
        changed = bool(flag)
    _, flag = step(state)
    return state, it, not bool(flag)


def run_until_quiet(step, state, max_steps):
    """The CUDA kernels' stopping rule: steps until the first that changes
    nothing. Returns ``(state, n_steps, converged)``: ``n_steps`` counts
    that quiet step, or is ``max_steps`` when every step changed
    something."""
    for it in range(1, max_steps + 1):
        new, flag = step(state)
        if not bool(flag):
            return new, it, True
        state = new
    return state, max_steps, False


def _seed_image(shape, marker_coords_or_seeds):
    """A full int32 seed image, or labels 1..n at (n, ndim) coordinates."""
    seeds = np.asarray(marker_coords_or_seeds)
    if seeds.shape == tuple(shape):
        return seeds.astype(np.int32)
    out = np.zeros(shape, np.int32)
    if len(seeds):
        out[tuple(seeds.T)] = np.arange(1, len(seeds) + 1, dtype=np.int32)
    return out


def _tensors(dev, *arrays):
    return [torch.as_tensor(np.ascontiguousarray(a), device=dev)
            for a in arrays]


def wavefront_image_flood_core(values: torch.Tensor, seeds: torch.Tensor,
                               mask: torch.Tensor, mode="claim",
                               max_iters: int = 512, check_every: int = 8):
    """The image flood on the tensors' device (JAX
    ``wavefront_image_flood_jit``): ``mode="claim"`` is the hop-tie claim
    recurrence, ``"minimax"`` the monotone one. ``values`` (Z, Y, X) float,
    ``seeds`` (Z, Y, X) int (0 = unseeded), ``mask`` (Z, Y, X) bool.
    Returns ``(labels int32, n_iters, converged)`` with JAX's loop
    (``run_checked``)."""
    step, state = _steps(values.to(torch.float32), seeds, mask, mode,
                         seed_values=values.to(torch.float32), hop_ties=True)
    state, it, conv = run_checked(step, state, max_iters, check_every)
    return state[1][_INTERIOR], it, conv


def wavefront_image_flood(values, marker_coords_or_seeds, mask,
                          mode="claim", max_iters=512, check_every=8,
                          device=None):
    """NumPy-facing image flood. ``marker_coords_or_seeds``: an (n, ndim)
    coordinate array (labels 1..n in row order) or a full int32 seed image.
    Returns ``(labels int32, n_iters, converged)``."""
    from ..device import resolve_device

    mask = np.asarray(mask).astype(bool)
    v, s, m = _tensors(resolve_device(device),
                       np.asarray(values, np.float32),
                       _seed_image(mask.shape, marker_coords_or_seeds), mask)
    lab, it, conv = wavefront_image_flood_core(v, s, m, mode, max_iters,
                                               check_every)
    return lab.cpu().numpy(), it, conv


def wavefront_flood(affinities: torch.Tensor, seeds: torch.Tensor,
                    mask: torch.Tensor, mode="claim", max_iters: int = 512,
                    check_every: int = 8):
    """The affinity flood on the tensors' device (JAX
    ``wavefront_flood_jit``): ``mode="claim"`` is the claim recurrence,
    ``"minimax"`` the monotone one. ``affinities`` (3, Z, Y, X) float,
    ``seeds`` (Z, Y, X) int (0 = unseeded), ``mask`` (Z, Y, X) bool.
    Returns ``(labels int32, n_iters, converged)`` with JAX's loop
    (``run_checked``)."""
    step, state = _steps(edge_weights(affinities.to(torch.float32)), seeds,
                         mask, mode)
    state, it, conv = run_checked(step, state, max_iters, check_every)
    return state[1][_INTERIOR], it, conv


def wavefront_affinity_flood(affinities, marker_coords, mask, mode="claim",
                             max_iters=512, check_every=8, device=None):
    """NumPy-facing wrapper with the oracle's calling convention: seeds
    take labels 1..n in row order. Returns ``(labels int32, n_iters,
    converged)``."""
    from ..device import resolve_device

    mask = np.asarray(mask).astype(bool)
    a, s, m = _tensors(resolve_device(device),
                       np.asarray(affinities, np.float32),
                       _seed_image(mask.shape, marker_coords), mask)
    lab, it, conv = wavefront_flood(a, s, m, mode, max_iters, check_every)
    return lab.cpu().numpy(), it, conv


def claim_until_quiet(affinities, seeds, mask, max_steps):
    """The affinity claim recurrence under the CUDA kernel's stopping rule
    (``run_until_quiet``): the plain version of the kernel at
    ``inner_cap=1``."""
    step, state = _steps(edge_weights(affinities.to(torch.float32)), seeds,
                         mask, "claim")
    state, n, conv = run_until_quiet(step, state, max_steps)
    return state[1][_INTERIOR], n, conv


def image_claim_until_quiet(values, seeds, mask, max_steps):
    """The hop-tie image recurrence under the CUDA kernel's stopping rule:
    the plain version of the image kernel at ``inner_cap=1``."""
    values = values.to(torch.float32)
    step, state = _steps(values, seeds, mask, "claim", seed_values=values,
                         hop_ties=True)
    state, n, conv = run_until_quiet(step, state, max_steps)
    return state[1][_INTERIOR], n, conv
