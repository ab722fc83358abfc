"""The CUDA floods' frontier schedule, on the CPU: the plain tiled schedule
run with the kernels' worklists (``flood_kernel.run_tiled(stats=)``) against
the full sweep of every tile, for the affinity flood (white-noise and
smooth fixtures) and the image flood (the DoG path's −EDT fixture), at
``inner_cap`` 1 and 4, on a tile-aligned and a ragged shape.

- Labels and step counts bit-equal to the full sweep, and at
  ``inner_cap=1`` to JAX ``wavefront_flood_jit`` /
  ``wavefront_image_flood_jit(mode="claim")``.
- The skip rule never misses a tile: every tile that would claim at step k
  was on list k (``missed == 0``); without the neighbour rule it would.
- On the sparse fixtures the lists hold fewer tile-steps than a sweep of
  every tile on every step.
- The kernels themselves run only on a card: ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iterseg_tpu.ops.device_flood import (wavefront_flood_jit,
                                          wavefront_image_flood_jit)
from iterseg_tpu_torch.ops import flood_kernel as fk
from iterseg_tpu_torch.ops import image_flood_kernel as ifk

from test_device_flood import edt_case, make_case, smooth_case
from torch_threads import two_torch_threads  # noqa: F401

SHAPES = [(16, 40, 40), (13, 37, 45)]


def affinity_inputs(aff, coords, mask):
    seeds = np.zeros(mask.shape, np.int32)
    seeds[tuple(coords.T)] = np.arange(1, len(coords) + 1, dtype=np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x))
                 for x in (aff, seeds, mask))


def noise(shape):
    return "affinity", affinity_inputs(*make_case(shape=shape, seed=7))


def smooth(shape):
    return "affinity", affinity_inputs(*smooth_case(shape=shape, seed=3))


def edt(shape):
    image, markers, mask = edt_case(shape=shape, seed=5)
    return "image", (torch.from_numpy(image), torch.from_numpy(markers),
                     torch.from_numpy(mask))


PLAIN = {"affinity": fk.affinity_flood_plain, "image": ifk.image_flood_plain}
JAX = {"affinity": wavefront_flood_jit, "image": wavefront_image_flood_jit}


@pytest.mark.parametrize("inner_cap", [1, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=["aligned", "ragged"])
@pytest.mark.parametrize("case", [noise, smooth, edt])
def test_frontier_equals_full_sweep(case, shape, inner_cap):
    kind, inputs = case(shape)
    stats = {}
    got, n, conv = PLAIN[kind](*inputs, inner_cap=inner_cap, stats=stats)
    want, n_full, conv_full = PLAIN[kind](*inputs, inner_cap=inner_cap)
    assert conv and conv_full and n == n_full == stats["steps"] and n > 1
    assert torch.equal(got, want)
    assert stats["missed"] == 0
    if inner_cap == 1:
        jax_labels, _, jax_conv = JAX[kind](
            *(jnp.asarray(x.numpy()) for x in inputs), mode="claim")
        assert bool(jax_conv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_labels))


@pytest.mark.parametrize("inner_cap", [1, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=["aligned", "ragged"])
@pytest.mark.parametrize("case", [smooth, edt])
def test_tile_steps_below_full_sweep(case, shape, inner_cap):
    kind, inputs = case(shape)
    stats = {}
    PLAIN[kind](*inputs, inner_cap=inner_cap, stats=stats)
    grid = fk.TileGrid(shape, fk.TILE)
    assert stats["tiles"] == int(np.prod(grid.n))
    free = (inputs[2] & (inputs[1] <= 0)).float()
    holding = int(grid.tiled(free, 0).flatten(3).amax(-1).sum())
    # list 1 is every tile that holds a free voxel
    assert stats["lists"][0] == holding
    assert len(stats["lists"]) == stats["steps"]
    assert sum(stats["lists"]) == stats["tile_steps"]
    assert stats["tile_steps"] < stats["tiles"] * stats["steps"]


@pytest.mark.parametrize("inner_cap", [1, 4])
@pytest.mark.parametrize("case", [smooth, edt])
def test_frontier_step_cap(case, inner_cap):
    """A flood stopped by the step cap returns the full sweep's partial
    labels."""
    kind, inputs = case(SHAPES[1])
    stats = {}
    part, n, conv = PLAIN[kind](*inputs, max_launches=2, inner_cap=inner_cap,
                                stats=stats)
    want, n_full, conv_full = PLAIN[kind](*inputs, max_launches=2,
                                          inner_cap=inner_cap)
    assert n == n_full == stats["steps"] == 2 and not conv and not conv_full
    assert torch.equal(part, want) and stats["missed"] == 0


def test_skip_rule_check_has_teeth(monkeypatch):
    """Without the face neighbours on the next list, tiles that would claim
    are skipped, and the check counts them."""
    kind, inputs = smooth(SHAPES[0])
    monkeypatch.setattr(fk, "_next_tiles", lambda c: c.flatten(3).any(-1))
    stats = {}
    got, _, _ = PLAIN[kind](*inputs, stats=stats)
    want, _, _ = PLAIN[kind](*inputs)
    assert stats["missed"] > 0 and not torch.equal(got, want)


@pytest.mark.parametrize("case", [smooth, edt])
def test_wrapper_passes_stats_on_cpu(case):
    kind, inputs = case(SHAPES[0])
    wrapper = {"affinity": fk.affinity_flood, "image": ifk.image_flood}[kind]
    s_wrap, s_plain = {}, {}
    got = wrapper(*inputs, inner_cap=2, stats=s_wrap)
    want = PLAIN[kind](*inputs, inner_cap=2, stats=s_plain)
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
    assert s_wrap == s_plain


def test_schedule_constants_follow_the_tile():
    """Both kernels share one schedule and tile; the traffic constants
    count the halo'd tile the schedule loads."""
    assert fk.TILE == ifk.TILE and fk.TILE[2] % 32 == 0
    halo = int(np.prod([t + 2 for t in fk.TILE]))
    assert fk.BYTES_PER_TILE_STEP > 2 * 4 * halo
    assert ifk.BYTES_PER_TILE_STEP > 3 * 4 * halo
