"""The port's verified exact flood (``ops/flood_exact``) against the JAX
package and the heap oracles, on the CPU, tolerance zero everywhere.

- ``certificate_flood`` / ``image_certificate_flood``: all five outputs
  bit-equal to JAX's on ``make_case``, its quantised case, ``smooth_case``,
  ``prod_case`` and ``edt_case`` (the fixtures of ``tests/test_device_flood``
  and ``tests/test_flood_exact``, at their shapes (12, 20, 20) and
  (16, 48, 48), so JAX compiles each certificate once a shape).
- ``exact_affinity_flood`` / ``exact_image_flood``: bit-equal to
  ``affinity_flood_py`` / ``image_flood_py`` with the guards on and off,
  with the telemetry of each path (certified, repaired, both fallbacks).
- The in-suite fuzz subset of ``tests/test_flood_fuzz.py``, the tie-heavy
  families with both guards off, from ``benchmarks/exact_flood_fuzz``.
"""
import numpy as np
import pytest
import torch

from iterseg_tpu.ops import flood_exact as jfe
from iterseg_tpu.ops.watershed_oracle import affinity_flood_py, image_flood_py
from iterseg_tpu_torch.ops import flood_exact as tfe

from test_device_flood import edt_case, make_case, smooth_case
from test_flood_exact import prod_case
from test_flood_fuzz import _random_case
from torch_threads import two_torch_threads  # noqa: F401

BIG = (16, 48, 48)
AFFINITY_CASES = [
    pytest.param(lambda: make_case(seed=0), id="make_case"),
    pytest.param(lambda: make_case(seed=4, quantised=True), id="quantised"),
    pytest.param(lambda: smooth_case(shape=BIG, seed=1), id="smooth_case"),
    pytest.param(lambda: prod_case(seed=0), id="prod_case0"),
    pytest.param(lambda: prod_case(seed=1), id="prod_case1"),
]


def assert_same_certificate(got, want):
    names = ("rep", "unc", "v_lb", "v_ub")
    for name, g, w in zip(names, got[:4], want[:4]):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[4] is want[4] is True


@pytest.mark.parametrize("case", AFFINITY_CASES)
def test_certificate_equals_jax(case):
    aff, coords, mask = case()
    want = jfe.certificate_flood(aff, coords, mask)
    got = tfe.certificate_flood(aff, coords, mask, device="cpu")
    assert_same_certificate(got, want)
    oracle = affinity_flood_py(aff, coords, mask.copy())
    certain = mask & ~got[1]
    np.testing.assert_array_equal(got[0][certain], oracle[certain])


@pytest.mark.parametrize("seed", [0, 1])
def test_image_certificate_equals_jax(seed):
    image, markers, mask = edt_case(seed=seed)
    want = jfe.image_certificate_flood(image, markers, mask)
    got = tfe.image_certificate_flood(image, markers, mask, device="cpu")
    assert_same_certificate(got, want)
    assert got[1].any()  # quantised EDT: the uncertain set is not empty


def test_certificate_max_iters_caps_every_phase():
    aff, coords, mask = smooth_case(shape=BIG, seed=1)
    got = tfe.certificate_flood(aff, coords, mask, max_iters=4,
                                device="cpu")
    assert got[4] is False


GUARDS = [pytest.param((tfe.TIE_PROBE_DEFAULT, tfe.REPAIR_DOOM_FRAC),
                       id="guards_on"),
          pytest.param((0.0, 0.0), id="guards_off")]


@pytest.mark.parametrize("guards", GUARDS)
@pytest.mark.parametrize("case,paths", [
    pytest.param(lambda: make_case(seed=0), {"fallback:unresolved"},
                 id="make_case"),
    pytest.param(lambda: make_case(seed=4, quantised=True),
                 {"fallback:tie-density", "fallback:unresolved"},
                 id="quantised"),
    pytest.param(lambda: smooth_case(seed=0),
                 {"fallback:tie-density", "fallback:unresolved"},
                 id="smooth_case"),
    pytest.param(lambda: prod_case(seed=0), {"certified"}, id="prod_case0"),
    pytest.param(lambda: prod_case(seed=1), {"repaired"}, id="prod_case1"),
])
def test_exact_affinity_flood_equals_heap(case, paths, guards):
    aff, coords, mask = case()
    oracle = affinity_flood_py(aff, coords, mask.copy())
    tele = {}
    got = tfe.exact_affinity_flood(aff, coords, mask, telemetry=tele,
                                   tie_probe=guards[0], repair_doom=guards[1],
                                   device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, oracle)
    assert tele["path"] in paths
    if guards[0] == 0.0:
        assert tele["path"] != "fallback:tie-density"
        assert tele["tie_frac"] == 0.0
    if tele["path"] == "fallback:tie-density":
        assert tele["uncertain_frac"] is None and tele["tie_frac"] > 0.02
    else:
        assert 0.0 <= tele["uncertain_frac"] <= 1.0


@pytest.mark.parametrize("guards", GUARDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_image_flood_equals_heap(seed, guards):
    image, markers, mask = edt_case(seed=seed)
    oracle = image_flood_py(image, markers, mask)
    tele = {}
    got = tfe.exact_image_flood(image, markers, mask, telemetry=tele,
                                tie_probe=guards[0], repair_doom=guards[1],
                                device="cpu")
    np.testing.assert_array_equal(got, oracle)
    assert tele["path"].startswith("fallback:")
    if guards[0] == 0.0:
        assert 0.0 < tele["uncertain_frac"] < 0.5


def test_verified_flood_outputs():
    """The tensor-level flood: the repaired labels come back with the
    counts, and a tie-probe skip returns ``unc_count == -1``."""
    aff, coords, mask = prod_case(seed=1)
    seeds = np.zeros(mask.shape, np.int32)
    seeds[tuple(coords.T)] = np.arange(1, len(coords) + 1)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (aff, seeds, mask)]
    phases = {}
    labels, resolved, unc, n_mask, tie_frac = tfe.verified_exact_flood(
        *t, tie_probe=0.0, repair_doom=0.0, phase_s=phases)
    assert resolved and unc > 0 and n_mask == int(mask.sum())
    assert tie_frac == 0.0 and set(phases) == {"A", "B", "C", "repair"}
    np.testing.assert_array_equal(labels.numpy(),
                                  affinity_flood_py(aff, coords, mask.copy()))
    aff_q, coords_q, mask_q = make_case(seed=4, quantised=True)
    seeds_q = np.zeros(mask_q.shape, np.int32)
    seeds_q[tuple(coords_q.T)] = np.arange(1, len(coords_q) + 1)
    out = tfe.verified_exact_flood(
        *[torch.from_numpy(a) for a in (aff_q, seeds_q, mask_q)],
        tie_probe=tfe.TIE_PROBE_DEFAULT)
    assert out[1:4] == (False, -1, int(mask_q.sum())) and out[4] > 0.02
    assert int(out[0].abs().sum()) == 0


def test_empty_seeds():
    aff, coords, mask = make_case(seed=1)
    got = tfe.exact_affinity_flood(aff, coords[:0], mask, device="cpu")
    assert (got == 0).all()


def test_fuzz_subset_affinity_bit_exact():
    """The 12 seeded draws of ``test_flood_fuzz`` across the five
    families: bit-equal to the heap oracle whatever the path."""
    rng = np.random.default_rng(2024)
    paths = []
    for i in range(12):
        family, aff, coords, mask = _random_case(rng)
        tele = {}
        got = tfe.exact_affinity_flood(aff, coords, mask, telemetry=tele,
                                       device="cpu")
        np.testing.assert_array_equal(
            got, affinity_flood_py(aff, coords, mask.copy()),
            err_msg=f"draw {i} family={family}")
        paths.append(tele["path"])
    assert len(set(paths)) >= 2, paths


def test_fuzz_subset_tie_heavy_families_guards_off():
    """Certificate and repair on massed exact ties with both guards off (a
    false accept of the repair shows as a bit mismatch)."""
    rng = np.random.default_rng(77)
    ran = 0
    for _ in range(8):
        family, aff, coords, mask = _random_case(rng)
        if family not in ("quant", "smooth-dup", "saturated"):
            continue
        tele = {}
        got = tfe.exact_affinity_flood(aff, coords, mask, telemetry=tele,
                                       tie_probe=0.0, repair_doom=0.0,
                                       device="cpu")
        np.testing.assert_array_equal(
            got, affinity_flood_py(aff, coords, mask.copy()))
        assert tele["path"] != "fallback:tie-density"
        ran += 1
    assert ran >= 2


def test_fuzz_subset_image_bit_exact():
    from scipy import ndimage as ndi

    rng = np.random.default_rng(5)
    for i in range(4):
        _family, _aff, coords, mask = _random_case(rng)
        image = (-ndi.distance_transform_edt(mask)).astype(np.float32)
        markers = np.zeros(mask.shape, np.int32)
        if len(coords):
            markers[tuple(coords.T)] = np.arange(1, len(coords) + 1,
                                                 dtype=np.int32)
        oracle = image_flood_py(image, markers, mask)
        for guards in ((tfe.TIE_PROBE_DEFAULT, tfe.REPAIR_DOOM_FRAC),
                       (0.0, 0.0)):
            got = tfe.exact_image_flood(image, markers, mask,
                                        tie_probe=guards[0],
                                        repair_doom=guards[1], device="cpu")
            np.testing.assert_array_equal(got, oracle, err_msg=f"draw {i}")
