"""The seeded affinity flood on Hopper: a hand-written CUDA kernel, its
plain torch version, and the wrapper that picks between them.

Replaces the TPU kernel ``iterseg_tpu/ops/pallas_flood.py:_flood_kernel``
(``_sweep_call`` / ``pallas_flood_jit``). The source is
``iterseg_tpu_torch/csrc/affinity_flood.cu``; its header note gives the
flood rule, the tie order and the schedule. In short: the state is
double-buffered, one CTA relaxes one (4, 8, 32) tile with a frozen 1-voxel
halo for up to ``inner_cap`` Jacobi steps, and the host relaunches until no
voxel claims. Unlike the Pallas kernel's in-order Gauss-Seidel sweep, every
launch is deterministic, so the kernel is held bit-equal to its plain
version; with ``inner_cap=1`` both equal the synchronous claim recurrence
(``ops/device_flood``) and JAX ``wavefront_flood_jit(mode="claim")``.

What bounds it on the H100: memory. A launch reads about 7 state words and
3 affinities per voxel and writes 4 (``BYTES_PER_VOXEL_LAUNCH``), so its
floor is that traffic over the 3.35 TB/s of HBM3, times the launches the
data needs. The design keeps d and lab in a shared-memory tile (each word
loaded once per CTA, not once per neighbour), the rest of a voxel's state in
registers, and never rewrites voxels that cannot change.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a plain C
library (``_build.build_dir``), at first use, loaded with ``ctypes``. The
wrapper ``affinity_flood`` takes the plain version only for CPU tensors; a
CUDA tensor launches the kernel or raises.

The module also holds what the image flood (``ops/image_flood_kernel``)
shares with this kernel: the build (``build_kernel_library``), the host
relaunch loop (``relaunch``) and the plain versions' tiled schedule
(``TileGrid``, ``run_tiled``).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import torch

from .device_flood import (_INTERIOR, _claim_step, edge_weights, init_state,
                           neighbour_index, pad_ring, wavefront_flood)

__all__ = ["affinity_flood", "affinity_flood_plain", "build", "launches",
           "reset_launches", "TILE", "BYTES_PER_VOXEL_LAUNCH",
           "OPS_PER_FREE_VOXEL_STEP", "TileGrid", "run_tiled", "relaunch",
           "build_kernel_library"]

TILE = (4, 8, 32)  # (TZ, TY, TX): must match csrc/affinity_flood.cu
# words the kernel's schedule moves per voxel and launch: 7 of state read,
# the 3 affinities, 4 of state written
BYTES_PER_VOXEL_LAUNCH = (7 + 3 + 4) * 4
# compares, selects and the max of one claim step of one free voxel: six
# neighbours at ~11 each, plus the claim test and the update
OPS_PER_FREE_VOXEL_STEP = 72
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "affinity_flood.cu")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
# launches queued between reads of the convergence flags
_CHECK_EVERY = 8
_LOCK = threading.Lock()
_lib = None
_launches = 0
_INF = float("inf")


def launches() -> int:
    """Kernel launches made by ``affinity_flood`` since the last reset."""
    return _launches


def reset_launches():
    global _launches
    _launches = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build_kernel_library(src: str, stem: str, tile_fn: str, tile):
    """Compile ``src`` with ``nvcc`` for sm_90a (once per source version,
    into ``_build.build_dir``) and load it with ``ctypes``; check that its
    ``tile_fn`` reports ``tile``. Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    from .._build import build_library

    try:
        path = build_library(src, stem, [_nvcc()] + _NVCC_FLAGS)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"nvcc failed to build {src}:\n{e.stdout}\n{e.stderr}") from e
    lib = ctypes.CDLL(path)
    ci = ctypes.c_int
    fn = getattr(lib, tile_fn)
    fn.restype = None
    fn.argtypes = [ctypes.POINTER(ci)] * 3
    t = [ci(), ci(), ci()]
    fn(*[ctypes.byref(v) for v in t])
    if tuple(v.value for v in t) != tuple(tile):
        raise RuntimeError(f"kernel tile {[v.value for v in t]} != {tile}")
    return lib


def build():
    """Compile (once per source version) and load the kernel library;
    returns the ``ctypes`` handle. Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = build_kernel_library(_SRC, "affinity_flood",
                                       "affinity_flood_tile", TILE)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.affinity_flood_launch.restype = ci
            lib.affinity_flood_launch.argtypes = ([vp] * 10 + [ci] * 4
                                                  + [vp, ci, vp])
            _lib = lib
        return _lib


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


def run_tiled(grid, halo_state, own_state, step, max_launches, inner_cap):
    """The kernels' schedule in plain torch: every launch gives each tile
    a copy of the state it reads through the halo (``halo_state``, a list
    of ``(tensor, ring fill)`` whose second entry holds the labels), frozen
    outside the tile's interior, runs ``inner_cap`` steps on every tile's
    interior and folds the interiors back. ``own_state`` (tiled per-voxel
    tensors) is carried from step to step. ``step(halos, own)`` returns
    ``(new interiors, new own, claim)``. Steps after a tile stops claiming
    change nothing, so this equals the kernels' early exit. Returns
    ``(labels, n_launches, converged)``."""
    pads = [pad_ring(grid.to_grid(x, fill), fill) for x, fill in halo_state]
    for launch in range(1, max_launches + 1):
        halos = [grid.halo_tiles(p) for p in pads]
        changed = False
        for _ in range(inner_cap):
            interiors, own_state, claim = step(halos, own_state)
            for h, i in zip(halos, interiors):
                h[_INTERIOR] = i
            changed = changed or bool(claim.any())
        if not changed:
            return grid.crop(pads[1]), launch, True
        for p, h in zip(pads, halos):
            p[_INTERIOR] = grid.untile(h[_INTERIOR])
    return grid.crop(pads[1]), max_launches, False


def relaunch(launch_one, flags, max_launches):
    """Host loop of a relaunched kernel: ``launch_one(n)`` queues launch
    ``n`` (it reads ``flags[n - 1]`` and sets ``flags[n]`` when anything
    claimed), ``_CHECK_EVERY`` launches between reads of the flags. Returns
    ``(n_launches, converged)``: the first launch that claimed nothing, or
    ``max_launches``."""
    done = 0
    while done < max_launches:
        k = min(_CHECK_EVERY, max_launches - done)
        for launch in range(done + 1, done + k + 1):
            launch_one(launch)
        first = done + 1
        done += k
        still = flags[first:done + 1].cpu()
        idle = (still == 0).nonzero()
        if len(idle):
            return first + int(idle[0]), True
    return max_launches, False


def affinity_flood_plain(affinities, seeds, mask, max_launches=512,
                         inner_cap=1):
    """The kernel's function and schedule in plain torch, on any device.

    ``inner_cap=1`` is the synchronous claim recurrence. For ``inner_cap >
    1`` each launch relaxes every tile of the kernel with a frozen 1-voxel
    halo for ``inner_cap`` claim steps (``run_tiled``). Returns ``(labels
    int32, n_launches, converged)`` as ``affinity_flood`` does."""
    _check(affinities, seeds, mask, inner_cap, max_launches)
    if inner_cap == 1:
        return wavefront_flood(affinities, seeds, mask, max_iters=max_launches)
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
                     max_launches, inner_cap)


def affinity_flood(affinities, seeds, mask, max_launches=512, inner_cap=1):
    """Seeded affinity flood: ``affinities`` (3, Z, Y, X) float32,
    ``seeds`` (Z, Y, X) int32 (0 = unseeded), ``mask`` (Z, Y, X) bool, all
    on one device. Returns ``(labels int32 (Z, Y, X), n_launches,
    converged)``: ``n_launches`` counts launches up to and including the
    first that claimed nothing, or ``max_launches`` when none did
    (``converged=False``; the caller then takes the exact host flood).

    CPU tensors run ``affinity_flood_plain``; CUDA tensors launch the kernel
    on the current stream, reading the convergence flags every
    ``_CHECK_EVERY`` launches."""
    if affinities.device.type == "cpu":
        return affinity_flood_plain(affinities, seeds, mask, max_launches,
                                    inner_cap)
    if affinities.device.type != "cuda":
        raise ValueError(f"unsupported device {affinities.device}")
    _check(affinities, seeds, mask, inner_cap, max_launches)
    lib = build()
    aff = affinities.contiguous()
    Z, Y, X = mask.shape
    with torch.cuda.device(aff.device):
        d, lab, ckd, cki, code = init_state(seeds.contiguous(),
                                            mask.contiguous())
        bufs = [(d, lab, ckd, cki),
                (d.clone(), lab.clone(), ckd.clone(), cki.clone())]
        flags = torch.zeros(max_launches + 1, dtype=torch.int32,
                            device=aff.device)
        flags[0] = 1
        stream = torch.cuda.current_stream(aff.device).cuda_stream

        def launch_one(launch):
            global _launches
            src, dst = bufs[(launch - 1) % 2], bufs[launch % 2]
            err = lib.affinity_flood_launch(
                *[t.data_ptr() for t in src + dst], code.data_ptr(),
                aff.data_ptr(), Z, Y, X, inner_cap, flags.data_ptr(),
                launch, stream)
            if err:
                raise RuntimeError(
                    f"affinity_flood kernel launch failed: CUDA error {err}")
            _launches += 1

        n, converged = relaunch(launch_one, flags, max_launches)
        return bufs[n % 2][1], n, converged
