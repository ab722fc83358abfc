"""The port's seeded affinity flood: the plain torch version of the CUDA
kernel, held against the JAX claim recurrence, the heap oracle and the
Pallas kernel (interpreted) on the fixtures of ``tests/test_device_flood``.

- ``inner_cap=1``: bit-equal to JAX ``wavefront_flood_jit(mode="claim")``.
- Exact invariants: labels exactly on the seed-reachable mask voxels, seeds
  keep their ids, every label is a seed id.
- Floors: mean oracle agreement > 0.94 on ``smooth_case`` seeds 0-2, and
  > 0.9 against ``pallas_wavefront_flood(..., interpret=True)``.
- ``wavefront_affinity_flood`` (the ``device_flood="xla"`` flood) in both
  modes: labels, ``n_iters`` and ``converged`` equal to JAX's, also where
  the loop reaches ``max_iters`` and stops past it (``max_iters`` not a
  multiple of ``check_every``).
- The CUDA kernel itself runs only on a card: ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from iterseg_tpu.ops.device_flood import (
    wavefront_affinity_flood as jax_affinity_flood,
    wavefront_flood_jit,
)
from iterseg_tpu.ops.pallas_flood import pallas_wavefront_flood
from iterseg_tpu.ops.watershed_oracle import affinity_flood_py
from iterseg_tpu_torch.ops import device_flood as tdf
from iterseg_tpu_torch.ops import flood_kernel as fk

from test_device_flood import make_case, smooth_case
from torch_threads import two_torch_threads  # noqa: F401


def as_inputs(aff, coords, mask, device="cpu"):
    seeds = np.zeros(mask.shape, np.int32)
    if len(coords):
        seeds[tuple(coords.T)] = np.arange(1, len(coords) + 1,
                                           dtype=np.int32)
    return (torch.from_numpy(np.ascontiguousarray(aff)).to(device),
            torch.from_numpy(seeds).to(device),
            torch.from_numpy(mask).to(device))


def reachable(coords, mask):
    comp, _ = ndi.label(mask)
    seeded = set(comp[tuple(coords.T)]) - {0}
    return mask & np.isin(comp, sorted(seeded))


CASES = [
    pytest.param(lambda: make_case(), id="make_case"),
    pytest.param(lambda: make_case(seed=4, quantised=True),
                 id="make_case_quantised"),
    pytest.param(lambda: smooth_case(seed=0), id="smooth_case0"),
    pytest.param(lambda: smooth_case(seed=1), id="smooth_case1"),
]


@pytest.mark.parametrize("case", CASES)
def test_plain_equals_jax_claim_recurrence(case):
    aff, coords, mask = case()
    a, s, m = as_inputs(aff, coords, mask)
    want, _, conv = wavefront_flood_jit(jnp.asarray(aff), jnp.asarray(
        s.numpy()), jnp.asarray(mask), mode="claim")
    assert bool(conv)
    got, n, converged = fk.affinity_flood_plain(a, s, m, inner_cap=1)
    assert converged and n > 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("inner_cap", [1, 4])
def test_invariants(inner_cap):
    aff, coords, mask = make_case(seed=1)
    labels, _, converged = fk.affinity_flood_plain(
        *as_inputs(aff, coords, mask), inner_cap=inner_cap)
    labels = labels.numpy()
    assert converged
    assert ((labels > 0) == reachable(coords, mask)).all()
    assert labels.max() <= len(coords)
    np.testing.assert_array_equal(labels[tuple(coords.T)],
                                  np.arange(1, len(coords) + 1))


def test_oracle_agreement_smooth(record_property):
    scores = []
    for seed in range(3):
        aff, coords, mask = smooth_case(seed=seed)
        oracle = affinity_flood_py(aff, coords, mask.copy())
        got, _, converged = fk.affinity_flood_plain(
            *as_inputs(aff, coords, mask), inner_cap=1)
        assert converged
        sel = mask & (oracle > 0)
        scores.append((got.numpy()[sel] == oracle[sel]).mean())
    record_property("mean_agreement", float(np.mean(scores)))
    assert np.mean(scores) > 0.94, scores


def test_agreement_with_pallas_kernel(record_property):
    aff, coords, mask = smooth_case(seed=0)
    pal, _, conv = pallas_wavefront_flood(aff, coords, mask, max_sweeps=128,
                                          inner_cap=1, interpret=True)
    assert conv
    got, _, converged = fk.affinity_flood_plain(
        *as_inputs(aff, coords, mask), inner_cap=1)
    got = got.numpy()
    assert converged
    np.testing.assert_array_equal(got > 0, pal > 0)
    sel = pal > 0
    agreement = float((got[sel] == pal[sel]).mean())
    record_property("agreement", agreement)
    assert agreement > 0.9


@pytest.mark.parametrize("seed", [0, 2])
def test_inner_cap_converges_to_same_support(seed):
    aff, coords, mask = smooth_case(seed=seed)
    inputs = as_inputs(aff, coords, mask)
    one, n1, c1 = fk.affinity_flood_plain(*inputs, inner_cap=1)
    many, n4, c4 = fk.affinity_flood_plain(*inputs, inner_cap=4)
    assert c1 and c4 and n4 < n1
    assert torch.equal(one > 0, many > 0)
    assert set(one.unique().tolist()) == set(many.unique().tolist())


def test_one_tile_schedule_is_the_global_recurrence(monkeypatch):
    """With one tile covering the volume, ``inner_cap`` steps per launch are
    ``inner_cap`` global steps: the fixed point equals the recurrence's."""
    aff, coords, mask = smooth_case(seed=1)
    inputs = as_inputs(aff, coords, mask)
    want, n1, _ = fk.affinity_flood_plain(*inputs, inner_cap=1)
    monkeypatch.setattr(fk, "TILE", tuple(-(-s // 8) * 8 for s in mask.shape))
    got, n3, conv = fk.affinity_flood_plain(*inputs, inner_cap=3)
    assert conv and n3 == -(-(n1 - 1) // 3) + 1
    assert torch.equal(got, want)


def test_wrapper_takes_plain_path_on_cpu():
    aff, coords, mask = make_case(seed=2)
    inputs = as_inputs(aff, coords, mask)
    before = fk.launches()
    got = fk.affinity_flood(*inputs, inner_cap=2)
    want = fk.affinity_flood_plain(*inputs, inner_cap=2)
    assert fk.launches() == before
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]


def test_non_convergence_and_empty_seeds():
    aff, coords, mask = smooth_case(seed=0)
    _, n, converged = fk.affinity_flood(*as_inputs(aff, coords, mask),
                                        max_launches=2)
    assert n == 2 and not converged
    labels, n, converged = fk.affinity_flood(
        *as_inputs(aff, coords[:0], mask))
    assert converged and n == 1 and int(labels.max()) == 0


def test_wrapper_checks_inputs():
    aff, coords, mask = make_case(seed=3)
    a, s, m = as_inputs(aff, coords, mask)
    with pytest.raises(TypeError):
        fk.affinity_flood(a.double(), s, m)
    with pytest.raises(ValueError):
        fk.affinity_flood(a[:2], s, m)
    with pytest.raises(ValueError):
        fk.affinity_flood(a, s, m, inner_cap=0)


def test_numpy_wrapper_matches_jax():
    aff, coords, mask = make_case(seed=5)
    got, _, conv = tdf.wavefront_affinity_flood(aff, coords, mask,
                                                device="cpu")
    want, _, jconv = jax_affinity_flood(aff, coords, mask, mode="claim")
    assert conv and jconv
    np.testing.assert_array_equal(got, want)


LOOPS = [pytest.param((512, 8), id="default"),
         pytest.param((5, 1), id="check_every_1")]


@pytest.mark.parametrize("loop", LOOPS)
@pytest.mark.parametrize("case,mode", [
    pytest.param(CASES[0].values[0], "claim", id="make_case-claim"),
    pytest.param(CASES[2].values[0], "claim", id="smooth_case0-claim"),
    pytest.param(CASES[0].values[0], "minimax", id="make_case-minimax"),
])
def test_wavefront_affinity_flood_equals_jax(case, mode, loop):
    aff, coords, mask = case()
    max_iters, check_every = loop
    want = jax_affinity_flood(aff, coords, mask, mode=mode,
                              max_iters=max_iters, check_every=check_every)
    got = tdf.wavefront_affinity_flood(aff, coords, mask, mode=mode,
                                       max_iters=max_iters,
                                       check_every=check_every, device="cpu")
    assert got[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[1] % check_every == 0


def test_wavefront_reaches_max_iters_then_decides():
    """At the cap the extra step decides: ``smooth_case(1)`` stops at 16
    steps with ``max_iters=10`` and converges in JAX's extra step, which
    the kernels' stopping rule at 10 steps calls unconverged."""
    aff, coords, mask = smooth_case(seed=1)
    got = tdf.wavefront_affinity_flood(aff, coords, mask, max_iters=10,
                                       device="cpu")
    want = jax_affinity_flood(aff, coords, mask, max_iters=10)
    assert got[1:] == want[1:] == (16, True)
    np.testing.assert_array_equal(got[0], want[0])
    _, n, conv = tdf.claim_until_quiet(*as_inputs(aff, coords, mask), 10)
    assert (n, conv) == (10, False)


def test_wavefront_rejects_unknown_mode():
    aff, coords, mask = make_case(seed=3)
    with pytest.raises(ValueError, match="minimax"):
        tdf.wavefront_affinity_flood(aff, coords, mask, mode="heap",
                                     device="cpu")
