"""The seeded image watershed on Hopper: a hand-written CUDA kernel, its
plain torch version, and the wrapper that picks between them.

Replaces the TPU kernel ``iterseg_tpu/ops/pallas_flood.py:
_image_flood_kernel`` (``_image_sweep_call`` / ``pallas_image_flood_jit``),
which the DoG pipeline runs with ``device_flood="pallas"``. The source is
``iterseg_tpu_torch/csrc/image_flood.cu``; its header note gives the flood
rule (skimage's node-keyed heap rule on −EDT: the weight entering ``u`` is
``values[u]``, seeds start at their own value, keys ``(d, h, idx)`` with a
hop count that resets on a strict rise) and the tie order. The schedule is
the affinity kernel's, ``csrc/flood_schedule.cuh``: double-buffered state,
``TILE`` tiles relaxed with a frozen 1-voxel halo for up to ``inner_cap``
Jacobi steps, an init kernel that writes the start state and the first
worklist, and one persistent cooperative launch that runs every step over a
frontier of active tiles with a grid sync between steps. With
``inner_cap=1`` both the kernel and ``image_flood_plain`` equal the
synchronous hop-tie recurrence
(``ops/device_flood.image_claim_until_quiet``) and JAX
``wavefront_image_flood_jit(mode="claim")`` bit for bit.

Unlike the Pallas kernel, which does not tile x and so cannot hold a frame
wider than ~510 voxels in VMEM (the JAX pipeline then reroutes to its XLA
recurrence), this kernel tiles every axis: every shape runs it.

What bounds it on the H100: memory and the latency of a step. About 2.6% of
the DoG path's grid is free, so the frontier moves only the tiles that can
still change (``BYTES_PER_TILE_STEP`` each: d, lab and h through the halo'd
tile, code, ckd, ckh, cki and the value read, 6 words written), the init
pass (``INIT_BYTES_PER_VOXEL``) is the floor, and each of the 40-50 steps
costs a grid sync, not a launch and a host round trip.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a`` (no fast math) into a
plain C library, at first use, loaded with ``ctypes``. The wrapper
``image_flood`` takes the plain version only for CPU tensors; a CUDA tensor
launches the two kernels or raises.
"""
from __future__ import annotations

import math
import os
import threading

import torch

from .device_flood import (_image_claim_step, image_init_state,
                           neighbour_index, image_claim_until_quiet)
from .flood_kernel import (TileGrid, build_kernel_library, first_worklist,
                           flood_on_card, run_tiled, start_on_card)

__all__ = ["image_flood", "image_flood_plain", "image_flood_start", "build",
           "launches", "reset_launches", "TILE", "INIT_BYTES_PER_VOXEL",
           "BYTES_PER_TILE_STEP", "OPS_PER_FREE_VOXEL_STEP"]

TILE = (2, 8, 32)  # (TZ, TY, TX): must match csrc/flood_schedule.cuh
# the init kernel: seeds, mask and values read, code and both buffers' d,
# lab and h written (and ckd, ckh and cki at the few free voxels, not
# counted)
INIT_BYTES_PER_VOXEL = 4 + 1 + 4 + 1 + 2 * 3 * 4
# one tile processed at one step: d, lab and h of the halo'd tile read, and
# per voxel, as if all were free, code, ckd, ckh, cki and the value read and
# 6 state words written
BYTES_PER_TILE_STEP = (3 * 4 * math.prod(t + 2 for t in TILE)
                       + (1 + 4 * 4 + 6 * 4) * math.prod(TILE))
# compares, selects and the max of one claim step of one free voxel: six
# neighbours at ~14 each, plus the claim test, the max and the hop update
OPS_PER_FREE_VOXEL_STEP = 100
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "image_flood.cu")
_LOCK = threading.Lock()
_lib = None
_launches = 0
_INF = float("inf")


def launches() -> int:
    """Kernel launches made by ``image_flood`` (and ``image_flood_start``)
    since the last reset: 2 per flood, the init kernel and the one step
    kernel."""
    return _launches


def reset_launches():
    global _launches
    _launches = 0


def _count():
    global _launches
    _launches += 1


def build():
    """Compile (once per source version) and load the kernel library;
    returns the ``ctypes`` handle. Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    global _lib
    with _LOCK:
        if _lib is None:
            _lib = build_kernel_library(_SRC, "image_flood", TILE)
        return _lib


def _check(values, seeds, mask, inner_cap, max_launches):
    if values.ndim != 3:
        raise ValueError(f"values must be (Z, Y, X), got "
                         f"{tuple(values.shape)}")
    if tuple(seeds.shape) != tuple(values.shape) or tuple(
            mask.shape) != tuple(values.shape):
        raise ValueError("values, seeds and mask must share one (Z, Y, X)")
    if values.dtype != torch.float32 or seeds.dtype != torch.int32 or (
            mask.dtype != torch.bool):
        raise TypeError("values float32, seeds int32 and mask bool "
                        f"required, got {values.dtype}, {seeds.dtype}, "
                        f"{mask.dtype}")
    if not (values.device == seeds.device == mask.device):
        raise ValueError("values, seeds and mask must share a device")
    if inner_cap < 1 or max_launches < 1:
        raise ValueError(f"inner_cap and max_launches must be >= 1, got "
                         f"{inner_cap}, {max_launches}")
    if values.numel() >= 2 ** 31:
        raise ValueError("volumes of 2^31 voxels or more are not supported")


def image_flood_plain(values, seeds, mask, max_launches=512, inner_cap=1,
                      stats=None):
    """The kernel's function and schedule in plain torch, on any device.

    ``inner_cap=1`` is the synchronous hop-tie recurrence. For ``inner_cap
    > 1`` each step relaxes every tile of the kernel with a frozen
    1-voxel halo for ``inner_cap`` steps (``flood_kernel.run_tiled``). With
    ``stats`` (a dict) it runs the kernel's frontier schedule
    (``run_tiled(stats=)``) at any ``inner_cap`` and reports it there.
    Returns ``(labels int32, n_steps, converged)`` as ``image_flood``
    does."""
    _check(values, seeds, mask, inner_cap, max_launches)
    if inner_cap == 1 and stats is None:
        return image_claim_until_quiet(values, seeds, mask, max_launches)
    grid = TileGrid(mask.shape, TILE)
    d, lab, h, ckd, ckh, cki, code = image_init_state(values, seeds, mask)
    idx, offs = neighbour_index(mask.shape, values.device)
    idx_t = grid.tiled(idx, 0)
    val_t = grid.tiled(values, _INF)
    free_t = grid.tiled(code == 1, False)

    def step(halos, own):
        *interiors, ckd_t, ckh_t, cki_t, claim = _image_claim_step(
            halos[0], halos[1], halos[2], own[0], own[1], own[2], val_t,
            idx_t, offs, free_t)
        return interiors, (ckd_t, ckh_t, cki_t), claim

    own = (grid.tiled(ckd, _INF), grid.tiled(ckh, 0), grid.tiled(cki, 0))
    return run_tiled(grid, [(d, _INF), (lab, 0), (h, 0)], own, step,
                     max_launches, inner_cap, free_t, stats)


def image_flood_start(values, seeds, mask):
    """The init kernel alone, on CUDA tensors: ``(state (2, 6, Z, Y, X)
    int32 words d, lab, h, ckd, ckh, cki of both buffers, code, first
    worklist (sorted tile ids))``, for holding it against
    ``image_init_state``."""
    _check(values, seeds, mask, 1, 1)
    lib = build()
    with torch.cuda.device(mask.device):
        state, code, work = start_on_card(
            lib, "image_flood", 6, TILE, values.contiguous(),
            seeds.contiguous(), mask.contiguous(), _count)
        return state, code, first_worklist(work, (len(work) - 3) // 5)


def image_flood(values, seeds, mask, max_launches=512, inner_cap=1,
                stats=None):
    """Seeded image watershed: ``values`` (Z, Y, X) float32 (the flood's
    priorities, −EDT on the DoG path), ``seeds`` (Z, Y, X) int32 (0 =
    unseeded), ``mask`` (Z, Y, X) bool, all on one device. Returns
    ``(labels int32 (Z, Y, X), n_steps, converged)``: ``n_steps`` counts
    steps up to and including the first that claimed nothing, or
    ``max_launches`` when none did (``converged=False``; the caller then
    takes the exact host flood).

    CPU tensors run ``image_flood_plain``; CUDA tensors launch the init
    kernel and the one persistent step kernel on the current stream and
    read the device once, at the end. ``stats``, when a dict, gets the
    schedule's numbers (``flood_kernel.flood_on_card``; on the CPU,
    ``run_tiled``'s)."""
    if values.device.type == "cpu":
        return image_flood_plain(values, seeds, mask, max_launches,
                                 inner_cap, stats)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    _check(values, seeds, mask, inner_cap, max_launches)
    lib = build()
    with torch.cuda.device(values.device):
        return flood_on_card(lib, "image_flood", 6, TILE, values.contiguous(),
                             seeds.contiguous(), mask.contiguous(),
                             max_launches, inner_cap, stats, _count)
