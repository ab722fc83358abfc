"""The port's seeded image flood: the plain torch version of the CUDA image
kernel, held against the JAX hop-tie recurrence, the heap oracle and the
Pallas image kernel (interpreted) on ``tests/test_device_flood.edt_case``,
the DoG path's −EDT landscape.

- ``inner_cap=1``: bit-equal to JAX ``wavefront_image_flood_jit(mode=
  "claim")``.
- Exact invariants: labels exactly on the seed-reachable mask voxels,
  markers keep their ids, every label comes from the seeds; one marker per
  component is exact against the heap.
- Floors: mean oracle agreement > 0.97 on seeds 0-2, and > 0.9 against
  ``pallas_image_flood(..., interpret=True)`` with the same support.
- ``wavefront_image_flood`` (the DoG ``device_flood="xla"`` flood) in both
  modes: labels, ``n_iters`` and ``converged`` equal to JAX's, also when
  ``max_iters`` cuts the loop.
- The CUDA kernel itself runs only on a card: ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from iterseg_tpu.ops.device_flood import (
    wavefront_image_flood as jax_image_flood,
    wavefront_image_flood_jit,
)
from iterseg_tpu.ops.pallas_flood import pallas_image_flood
from iterseg_tpu.ops.watershed import image_watershed
from iterseg_tpu_torch.ops import device_flood as tdf
from iterseg_tpu_torch.ops import image_flood_kernel as ifk

from test_device_flood import edt_case
from torch_threads import two_torch_threads  # noqa: F401


def as_inputs(image, markers, mask):
    return (torch.from_numpy(np.ascontiguousarray(image, np.float32)),
            torch.from_numpy(markers.astype(np.int32)),
            torch.from_numpy(mask))


def reachable(markers, mask):
    comp, _ = ndi.label(mask)
    seeded = set(comp[markers > 0]) - {0}
    return mask & np.isin(comp, sorted(seeded))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_equals_jax_hop_tie_recurrence(seed):
    image, markers, mask = edt_case(seed=seed)
    want, _, conv = wavefront_image_flood_jit(
        jnp.asarray(image), jnp.asarray(markers), jnp.asarray(mask),
        mode="claim")
    assert bool(conv)
    got, n, converged = ifk.image_flood_plain(*as_inputs(image, markers,
                                                         mask))
    assert converged and n > 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("inner_cap", [1, 4])
def test_invariants(inner_cap):
    image, markers, mask = edt_case(seed=3)
    labels, _, converged = ifk.image_flood_plain(
        *as_inputs(image, markers, mask), inner_cap=inner_cap)
    labels = labels.numpy()
    assert converged
    np.testing.assert_array_equal(labels > 0, reachable(markers, mask))
    m = markers > 0
    np.testing.assert_array_equal(labels[m], markers[m])
    assert set(np.unique(labels)) <= set(np.unique(markers))


def test_single_marker_per_component_exact():
    image, markers, mask = edt_case(n=1, seed=2)
    markers = (markers > 0).astype(np.int32)
    got, _, converged = ifk.image_flood_plain(*as_inputs(image, markers,
                                                         mask))
    assert converged
    np.testing.assert_array_equal(got.numpy(),
                                  image_watershed(image, markers, mask))


def test_oracle_agreement_edt(record_property):
    scores = []
    for seed in range(3):
        image, markers, mask = edt_case(seed=seed)
        exact = image_watershed(image, markers, mask)
        got, _, converged = ifk.image_flood_plain(
            *as_inputs(image, markers, mask))
        assert converged
        sel = mask & (exact > 0)
        scores.append(float((got.numpy()[sel] == exact[sel]).mean()))
    record_property("mean_agreement", float(np.mean(scores)))
    assert np.mean(scores) > 0.97, scores


def test_agreement_with_pallas_image_kernel(record_property):
    image, markers, mask = edt_case(seed=0)
    pal, _, conv = pallas_image_flood(image, markers, mask, max_sweeps=256,
                                      inner_cap=1, interpret=True)
    assert conv
    got, _, converged = ifk.image_flood_plain(*as_inputs(image, markers,
                                                         mask))
    got = got.numpy()
    assert converged
    np.testing.assert_array_equal(got > 0, pal > 0)
    sel = pal > 0
    agreement = float((got[sel] == pal[sel]).mean())
    record_property("agreement", agreement)
    assert agreement > 0.9


@pytest.mark.parametrize("seed", [0, 4])
def test_inner_cap_converges_to_same_support(seed):
    inputs = as_inputs(*edt_case(seed=seed))
    one, n1, c1 = ifk.image_flood_plain(*inputs, inner_cap=1)
    many, n4, c4 = ifk.image_flood_plain(*inputs, inner_cap=4)
    assert c1 and c4 and n4 < n1
    assert torch.equal(one > 0, many > 0)
    assert set(one.unique().tolist()) == set(many.unique().tolist())


def test_one_tile_schedule_is_the_global_recurrence(monkeypatch):
    """With one tile covering the volume, ``inner_cap`` steps per launch
    are ``inner_cap`` global steps: the fixed point equals the
    recurrence's."""
    image, markers, mask = edt_case(seed=1)
    inputs = as_inputs(image, markers, mask)
    want, n1, _ = ifk.image_flood_plain(*inputs, inner_cap=1)
    monkeypatch.setattr(ifk, "TILE",
                        tuple(-(-s // 8) * 8 for s in mask.shape))
    got, n3, conv = ifk.image_flood_plain(*inputs, inner_cap=3)
    assert conv and n3 == -(-(n1 - 1) // 3) + 1
    assert torch.equal(got, want)


def test_coords_convention_and_numpy_wrapper():
    """(n, 3) coordinate markers label 1..n in row order; the numpy wrapper
    equals JAX's on both forms."""
    image, markers, mask = edt_case(seed=4)
    coords = np.array([np.argwhere(markers == i)[0]
                       for i in range(1, int(markers.max()) + 1)])
    single = np.zeros_like(markers)
    single[tuple(coords.T)] = np.arange(1, len(coords) + 1)
    a, _, ca = tdf.wavefront_image_flood(image, single, mask, device="cpu")
    b, _, cb = tdf.wavefront_image_flood(image, coords, mask, device="cpu")
    assert ca and cb
    np.testing.assert_array_equal(a, b)
    want, _, _ = jax_image_flood(image, coords, mask)
    np.testing.assert_array_equal(b, want)


def test_empty_seeds_and_non_convergence():
    image, markers, mask = edt_case(seed=2)
    inputs = as_inputs(image, markers, mask)
    labels, n, converged = ifk.image_flood(inputs[0],
                                           torch.zeros_like(inputs[1]),
                                           inputs[2])
    assert converged and n == 1 and int(labels.max()) == 0
    _, n, converged = ifk.image_flood(*inputs, max_launches=2)
    assert n == 2 and not converged


def test_wrapper_takes_plain_path_on_cpu():
    inputs = as_inputs(*edt_case(seed=5))
    before = ifk.launches()
    got = ifk.image_flood(*inputs, inner_cap=2)
    want = ifk.image_flood_plain(*inputs, inner_cap=2)
    assert ifk.launches() == before
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]


def test_wrapper_checks_inputs():
    values, seeds, mask = as_inputs(*edt_case(seed=6))
    with pytest.raises(TypeError):
        ifk.image_flood(values.double(), seeds, mask)
    with pytest.raises(TypeError):
        ifk.image_flood(values, seeds.long(), mask)
    with pytest.raises(ValueError):
        ifk.image_flood(values[:-1], seeds, mask)
    with pytest.raises(ValueError):
        ifk.image_flood(values[None], seeds[None], mask[None])
    with pytest.raises(ValueError):
        ifk.image_flood(values, seeds, mask, inner_cap=0)


@pytest.mark.parametrize("mode,loop", [
    pytest.param("claim", (512, 8), id="claim-default"),
    pytest.param("claim", (3, 2), id="claim-cut"),
    pytest.param("minimax", (3, 2), id="minimax-cut"),
])
def test_wavefront_image_flood_equals_jax(mode, loop):
    image, markers, mask = edt_case(seed=1)
    max_iters, check_every = loop
    want = jax_image_flood(image, markers, mask, mode=mode,
                           max_iters=max_iters, check_every=check_every)
    got = tdf.wavefront_image_flood(image, markers, mask, mode=mode,
                                    max_iters=max_iters,
                                    check_every=check_every, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
