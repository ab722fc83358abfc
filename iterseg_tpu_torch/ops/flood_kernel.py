"""The seeded affinity flood on Hopper: a hand-written CUDA kernel, its
plain torch version, and the wrapper that picks between them.

Replaces the TPU kernel ``iterseg_tpu/ops/pallas_flood.py:_flood_kernel``
(``_sweep_call`` / ``pallas_flood_jit``). The source is
``iterseg_tpu_torch/csrc/affinity_flood.cu`` (the state layout and the claim
rule) with the schedule it shares with the image flood in
``csrc/flood_schedule.cuh``, whose header note gives the schedule and why it
is exact. In short: the state is double-buffered and the grid is cut into
``TILE`` tiles, each relaxed with a frozen 1-voxel halo for up to
``inner_cap`` Jacobi steps; an init kernel writes the start state and the
first worklist (every tile that holds a free voxel), and one persistent
cooperative launch runs every step over a frontier of active tiles (a tile
that claimed puts itself on the next list, and each face neighbour that
reads a layer of it in which a voxel claimed), with a grid sync between
steps and one read of ``(steps, converged, tile_steps)`` at the end. Every
step is deterministic, so the kernel is held bit-equal to its plain
version; with ``inner_cap=1`` both equal the synchronous claim recurrence
(``ops/device_flood``) and JAX ``wavefront_flood_jit(mode="claim")``.

What bounds it on the H100: memory and the latency of a step. Only 2-3% of
the path's grid is free and most of it settles in a few steps, so the
frontier moves only the tiles that can still change
(``BYTES_PER_TILE_STEP`` each), the init pass (``INIT_BYTES_PER_VOXEL``)
is the floor, and the 40-50 steps cost a grid sync each instead of a launch
and a host round trip.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a plain C
library (``_build.build_dir``), at first use, loaded with ``ctypes``. The
wrapper ``affinity_flood`` takes the plain version only for CPU tensors; a
CUDA tensor launches the two kernels or raises.

The module also holds what the image flood (``ops/image_flood_kernel``)
shares with this kernel: the build (``build_kernel_library``), the card
driver (``flood_on_card``, ``start_on_card``) and the plain versions' tiled
schedule (``TileGrid``, ``run_tiled``).
"""
from __future__ import annotations

import ctypes
import math
import os
import subprocess
import threading

import torch

from .device_flood import (_INTERIOR, _claim_step, edge_weights, init_state,
                           neighbour_index, pad_ring, claim_until_quiet)

__all__ = ["affinity_flood", "affinity_flood_plain", "affinity_flood_start",
           "build", "launches", "reset_launches", "TILE",
           "INIT_BYTES_PER_VOXEL", "BYTES_PER_TILE_STEP",
           "OPS_PER_FREE_VOXEL_STEP", "TileGrid", "run_tiled",
           "build_kernel_library", "flood_on_card", "start_on_card"]

TILE = (2, 8, 32)  # (TZ, TY, TX): must match csrc/flood_schedule.cuh
# the init kernel: seeds and mask read, code and both buffers' d and lab
# written (and ckd and cki at the few free voxels, not counted)
INIT_BYTES_PER_VOXEL = 4 + 1 + 1 + 2 * 2 * 4
# one tile processed at one step: d and lab of the halo'd tile read, and per
# voxel, as if all were free, code, ckd, cki and 3 affinities read and 4
# state words written
BYTES_PER_TILE_STEP = (2 * 4 * math.prod(t + 2 for t in TILE)
                       + (1 + 4 * (2 + 3) + 4 * 4) * math.prod(TILE))
# compares, selects and the max of one claim step of one free voxel: six
# neighbours at ~11 each, plus the claim test and the update
OPS_PER_FREE_VOXEL_STEP = 72
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "affinity_flood.cu")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
_LOCK = threading.Lock()
_lib = None
_launches = 0
_INF = float("inf")


def launches() -> int:
    """Kernel launches made by ``affinity_flood`` (and
    ``affinity_flood_start``) since the last reset: 2 per flood, the init
    kernel and the one step kernel."""
    return _launches


def reset_launches():
    global _launches
    _launches = 0


def _count():
    global _launches
    _launches += 1


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build_kernel_library(src: str, stem: str, tile):
    """Compile ``src`` with ``nvcc`` for sm_90a (once per version of the
    source and the headers it includes, into ``_build.build_dir``), load it
    with ``ctypes``, check that ``<stem>_tile`` reports ``tile`` and bind
    ``<stem>_init`` and ``<stem>_run``. Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    from .._build import build_library

    try:
        path = build_library(src, stem, [_nvcc()] + _NVCC_FLAGS)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"nvcc failed to build {src}:\n{e.stdout}\n{e.stderr}") from e
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, stem + "_tile")
    fn.restype = None
    fn.argtypes = [ctypes.POINTER(ci)] * 3
    t = [ci(), ci(), ci()]
    fn(*[ctypes.byref(v) for v in t])
    if tuple(v.value for v in t) != tuple(tile):
        raise RuntimeError(f"kernel tile {[v.value for v in t]} != {tile}")
    init = getattr(lib, stem + "_init")
    init.restype = ci
    # state, code, input, seeds, mask, Z, Y, X, work, stream
    init.argtypes = [vp] * 5 + [ci] * 3 + [vp, vp]
    run = getattr(lib, stem + "_run")
    run.restype = ci
    # state, code, input, Z, Y, X, inner_cap, max_steps, work, result, stream
    run.argtypes = [vp] * 3 + [ci] * 5 + [vp] * 3
    return lib


def build():
    """Compile (once per source version) and load the kernel library;
    returns the ``ctypes`` handle. Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    global _lib
    with _LOCK:
        if _lib is None:
            _lib = build_kernel_library(_SRC, "affinity_flood", TILE)
        return _lib


def _raise_on(err, stem, kernel):
    if err:
        raise RuntimeError(f"{stem} {kernel} kernel launch failed: CUDA "
                           f"error {err}")


def start_on_card(lib, stem, n_words, tile, inputs, seeds, mask, count):
    """Launch ``<stem>_init`` on the current stream: returns ``(state
    (2, n_words, Z, Y, X) int32 words, code uint8, work int32)``, the start
    state in both buffers, the code (0 outside the mask, 1 free, 2 seed) and
    the work area with the first worklist. ``count()`` is called once the
    kernel is launched."""
    shape = tuple(mask.shape)
    n_tiles = math.prod(-(-s // t) for s, t in zip(shape, tile))
    dev = mask.device
    state = torch.empty((2, n_words) + shape, dtype=torch.int32, device=dev)
    code = torch.empty(shape, dtype=torch.uint8, device=dev)
    work = torch.empty(3 + 5 * n_tiles, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(getattr(lib, stem + "_init")(
        state.data_ptr(), code.data_ptr(), inputs.data_ptr(),
        seeds.data_ptr(), mask.data_ptr(), *shape, work.data_ptr(), stream),
        stem, "init")
    count()
    return state, code, work


def first_worklist(work, n_tiles):
    """The sorted tile ids of list 1 in a work area ``start_on_card``
    filled (for checks; it reads the device)."""
    n = int(work[1])
    return work[3 + n_tiles:3 + n_tiles + n].sort().values


def flood_on_card(lib, stem, n_words, tile, inputs, seeds, mask,
                  max_launches, inner_cap, stats, count):
    """One flood on the card: the init kernel, then the one cooperative
    launch of ``<stem>_run`` over the worklists, then one read of
    ``(steps, converged, tile_steps)``. Returns ``(labels, steps,
    converged)``; ``stats``, when a dict, gets ``steps``, ``tile_steps``,
    ``setup_ms`` (the init kernel) and ``steps_ms`` (the step kernel) by
    CUDA events."""
    dev = mask.device
    shape = tuple(mask.shape)
    events = None
    if stats is not None:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
    state, code, work = start_on_card(lib, stem, n_words, tile, inputs, seeds,
                                      mask, count)
    if events:
        events[1].record()
    result = torch.empty(3, dtype=torch.int64, device=dev)
    _raise_on(getattr(lib, stem + "_run")(
        state.data_ptr(), code.data_ptr(), inputs.data_ptr(), *shape,
        inner_cap, max_launches, work.data_ptr(), result.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), stem, "step")
    count()
    if events:
        events[2].record()
    steps, converged, tile_steps = result.tolist()
    if stats is not None:
        stats.update(steps=steps, tile_steps=tile_steps,
                     setup_ms=events[0].elapsed_time(events[1]),
                     steps_ms=events[1].elapsed_time(events[2]))
    return state[steps % 2, 1], steps, bool(converged)


def _check(aff, seeds, mask, inner_cap, max_launches):
    if aff.ndim != 4 or aff.shape[0] != 3:
        raise ValueError(f"affinities must be (3, Z, Y, X), got "
                         f"{tuple(aff.shape)}")
    if tuple(seeds.shape) != tuple(aff.shape[1:]) or tuple(
            mask.shape) != tuple(aff.shape[1:]):
        raise ValueError("seeds and mask must have the affinities' (Z, Y, X)")
    if aff.dtype != torch.float32 or seeds.dtype != torch.int32 or (
            mask.dtype != torch.bool):
        raise TypeError("affinities float32, seeds int32 and mask bool "
                        f"required, got {aff.dtype}, {seeds.dtype}, "
                        f"{mask.dtype}")
    if not (aff.device == seeds.device == mask.device):
        raise ValueError("affinities, seeds and mask must share a device")
    if inner_cap < 1 or max_launches < 1:
        raise ValueError(f"inner_cap and max_launches must be >= 1, got "
                         f"{inner_cap}, {max_launches}")
    if aff[0].numel() >= 2 ** 31:
        raise ValueError("volumes of 2^31 voxels or more are not supported")


class TileGrid:
    """A kernel's tiling of a (Z, Y, X) volume, for the plain versions:
    the volume embedded in a grid of whole ``tile``s, each tile's interior
    and its 1-voxel halo as views with leading tile axes."""

    def __init__(self, shape, tile):
        self.shape = tuple(shape)
        self.tile = tuple(tile)
        self.n = tuple(-(-s // t) for s, t in zip(self.shape, self.tile))
        self.grid = tuple(n * t for n, t in zip(self.n, self.tile))

    def to_grid(self, x, fill):
        """(..., Z, Y, X) -> (..., grid), padded with ``fill``."""
        Z, Y, X = self.shape
        out = torch.full(x.shape[:-3] + self.grid, fill, dtype=x.dtype,
                         device=x.device)
        out[..., :Z, :Y, :X] = x
        return out

    def tiles(self, x):
        """(..., grid) -> (..., nz, ny, nx, tz, ty, tx)."""
        (nz, ny, nx), (tz, ty, tx) = self.n, self.tile
        lead = x.shape[:-3]
        x = x.reshape(lead + (nz, tz, ny, ty, nx, tx))
        k = len(lead)
        return x.permute(*range(k), k, k + 2, k + 4, k + 1, k + 3, k + 5)

    def tiled(self, x, fill):
        return self.tiles(self.to_grid(x, fill))

    def untile(self, x):
        """Inverse of ``tiles`` for a tensor without leading axes."""
        return x.permute(0, 3, 1, 4, 2, 5).reshape(self.grid)

    def halo_tiles(self, x_pad):
        """(grid + 2) -> (nz, ny, nx, tz+2, ty+2, tx+2), copied."""
        tz, ty, tx = self.tile
        return (x_pad.unfold(0, tz + 2, tz).unfold(1, ty + 2, ty)
                .unfold(2, tx + 2, tx)).clone()

    def crop(self, x_pad):
        Z, Y, X = self.shape
        return x_pad[_INTERIOR][:Z, :Y, :X].contiguous()


def _next_tiles(claimed):
    """The tiles a step puts on the next list, from ``claimed`` (nz, ny, nx,
    tz, ty, tx), the voxels that claimed: each tile in which a voxel
    claimed, and the face neighbour across each face whose boundary layer
    holds a voxel that claimed (the layer that neighbour reads through its
    halo)."""
    out = claimed.flatten(3).any(-1)
    for dim in range(3):
        n = out.shape[dim]
        low = claimed.narrow(3 + dim, 0, 1).flatten(3).any(-1)
        high = claimed.narrow(3 + dim, claimed.shape[3 + dim] - 1,
                              1).flatten(3).any(-1)
        out.narrow(dim, 0, n - 1).logical_or_(low.narrow(dim, 1, n - 1))
        out.narrow(dim, 1, n - 1).logical_or_(high.narrow(dim, 0, n - 1))
    return out


def run_tiled(grid, halo_state, own_state, step, max_launches, inner_cap,
              free_t=None, stats=None):
    """The kernels' schedule in plain torch: every step gives each tile a
    copy of the state it reads through the halo (``halo_state``, a list of
    ``(tensor, ring fill)`` whose second entry holds the labels), frozen
    outside the tile's interior, runs ``inner_cap`` steps on every tile's
    interior and folds the interiors back. ``own_state`` (tiled per-voxel
    tensors) is carried from step to step. ``step(halos, own)`` returns
    ``(new interiors, new own, claim)``. Steps after a tile stops claiming
    change nothing, so this equals the kernels' early exit. Returns
    ``(labels, n_steps, converged)``.

    With ``stats`` (a dict), the kernels' frontier as well: ``free_t`` (the
    tiled free mask) gives list 1, the tiles that hold a free voxel; step k
    folds back only the tiles on list k, and list k + 1 is ``_next_tiles``
    of the voxels that claimed at step k, those tiles that hold a free
    voxel. Every tile is still computed, so the skip rule is checked:
    ``stats`` gets ``steps``, ``lists`` (the tiles on each step's list),
    ``tile_steps`` (their sum), ``missed`` (tiles off the list that would
    have claimed; 0 when the rule holds) and ``tiles``."""
    pads = [pad_ring(grid.to_grid(x, fill), fill) for x, fill in halo_state]
    frontier = stats is not None
    if frontier:
        has_free = free_t.flatten(3).any(-1)
        active, lists, missed = has_free, [], 0
    n, converged = max_launches, False
    for launch in range(1, max_launches + 1):
        halos = [grid.halo_tiles(p) for p in pads]
        own = own_state
        claimed = None  # the voxels that claimed in this step
        for _ in range(inner_cap):
            interiors, own, claim = step(halos, own)
            for h, i in zip(halos, interiors):
                h[_INTERIOR] = i
            claimed = claim if claimed is None else claimed | claim
        if frontier:
            on = active[..., None, None, None]
            lists.append(int(active.sum()))
            missed += int((claimed & ~on).any(-1).any(-1).any(-1).sum())
            claimed = claimed & on
            own = tuple(torch.where(on, a, b) for a, b in zip(own, own_state))
        own_state = own
        if not bool(claimed.any()):
            n, converged = launch, True
            break
        for p, h in zip(pads, halos):
            new = h[_INTERIOR]
            if frontier:
                new = torch.where(on, new, grid.tiles(p[_INTERIOR]))
            p[_INTERIOR] = grid.untile(new)
        if frontier:
            active = _next_tiles(claimed) & has_free
    if frontier:
        stats.update(steps=n, lists=lists, tile_steps=sum(lists),
                     missed=missed, tiles=math.prod(grid.n))
    return grid.crop(pads[1]), n, converged


def affinity_flood_plain(affinities, seeds, mask, max_launches=512,
                         inner_cap=1, stats=None):
    """The kernel's function and schedule in plain torch, on any device.

    ``inner_cap=1`` is the synchronous claim recurrence. For ``inner_cap >
    1`` each step relaxes every tile of the kernel with a frozen 1-voxel
    halo for ``inner_cap`` claim steps (``run_tiled``). With ``stats`` (a
    dict) it runs the kernel's frontier schedule (``run_tiled(stats=)``) at
    any ``inner_cap`` and reports it there. Returns ``(labels int32,
    n_steps, converged)`` as ``affinity_flood`` does."""
    _check(affinities, seeds, mask, inner_cap, max_launches)
    if inner_cap == 1 and stats is None:
        return claim_until_quiet(affinities, seeds, mask, max_launches)
    grid = TileGrid(mask.shape, TILE)
    d, lab, ckd, cki, code = init_state(seeds, mask)
    w_t = grid.tiled(edge_weights(affinities), _INF)
    w_t = [w_t[k] for k in range(6)]
    idx, offs = neighbour_index(mask.shape, affinities.device)
    idx_t = grid.tiled(idx, 0)
    free_t = grid.tiled(code == 1, False)

    def step(halos, own):
        d_i, lab_i, ckd_t, cki_t, claim = _claim_step(
            halos[0], halos[1], own[0], own[1], w_t, idx_t, offs, free_t)
        return (d_i, lab_i), (ckd_t, cki_t), claim

    return run_tiled(grid, [(d, _INF), (lab, 0)],
                     (grid.tiled(ckd, _INF), grid.tiled(cki, 0)), step,
                     max_launches, inner_cap, free_t, stats)


def affinity_flood_start(affinities, seeds, mask):
    """The init kernel alone, on CUDA tensors: ``(state (2, 4, Z, Y, X)
    int32 words d, lab, ckd, cki of both buffers, code, first worklist
    (sorted tile ids))``, for holding it against ``init_state``."""
    _check(affinities, seeds, mask, 1, 1)
    lib = build()
    with torch.cuda.device(mask.device):
        state, code, work = start_on_card(
            lib, "affinity_flood", 4, TILE, affinities.contiguous(),
            seeds.contiguous(), mask.contiguous(), _count)
        n_tiles = (len(work) - 3) // 5
        return state, code, first_worklist(work, n_tiles)


def affinity_flood(affinities, seeds, mask, max_launches=512, inner_cap=1,
                   stats=None):
    """Seeded affinity flood: ``affinities`` (3, Z, Y, X) float32,
    ``seeds`` (Z, Y, X) int32 (0 = unseeded), ``mask`` (Z, Y, X) bool, all
    on one device. Returns ``(labels int32 (Z, Y, X), n_steps,
    converged)``: ``n_steps`` counts steps up to and including the first
    that claimed nothing, or ``max_launches`` when none did
    (``converged=False``; the caller then takes the exact host flood).

    CPU tensors run ``affinity_flood_plain``; CUDA tensors launch the init
    kernel and the one persistent step kernel on the current stream and
    read the device once, at the end. ``stats``, when a dict, gets the
    schedule's numbers (``flood_on_card``; on the CPU,
    ``run_tiled``'s)."""
    if affinities.device.type == "cpu":
        return affinity_flood_plain(affinities, seeds, mask, max_launches,
                                    inner_cap, stats)
    if affinities.device.type != "cuda":
        raise ValueError(f"unsupported device {affinities.device}")
    _check(affinities, seeds, mask, inner_cap, max_launches)
    lib = build()
    with torch.cuda.device(affinities.device):
        return flood_on_card(lib, "affinity_flood", 4, TILE,
                             affinities.contiguous(), seeds.contiguous(),
                             mask.contiguous(), max_launches, inner_cap,
                             stats, _count)
