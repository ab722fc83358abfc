"""The seeded image watershed on Hopper: a hand-written CUDA kernel, its
plain torch version, and the wrapper that picks between them.

Replaces the TPU kernel ``iterseg_tpu/ops/pallas_flood.py:
_image_flood_kernel`` (``_image_sweep_call`` / ``pallas_image_flood_jit``),
which the DoG pipeline runs with ``device_flood="pallas"``. The source is
``iterseg_tpu_torch/csrc/image_flood.cu``; its header note gives the flood
rule (skimage's node-keyed heap rule on −EDT: the weight entering ``u`` is
``values[u]``, seeds start at their own value, keys ``(d, h, idx)`` with a
hop count that resets on a strict rise), the tie order and the schedule,
which is the affinity kernel's: double-buffered state, one CTA per (4, 8,
32) tile with a frozen 1-voxel halo for up to ``inner_cap`` Jacobi steps,
relaunched until no voxel claims. With ``inner_cap=1`` both the kernel and
``image_flood_plain`` equal the synchronous hop-tie recurrence
(``ops/device_flood.wavefront_image_flood_core``) and JAX
``wavefront_image_flood_jit(mode="claim")`` bit for bit.

Unlike the Pallas kernel, which does not tile x and so cannot hold a frame
wider than ~510 voxels in VMEM (the JAX pipeline then reroutes to its XLA
recurrence), this kernel tiles every axis: every shape runs it.

What bounds it on the H100: memory. A launch reads d, lab and h through the
halo'd tile, code, and ckd, ckh, cki and the value, and writes 6 words for
claiming voxels (``BYTES_PER_VOXEL_LAUNCH``); the floor of the flood is its
inputs read once and its labels written once.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a`` (no fast math) into a
plain C library, at first use, loaded with ``ctypes``. The wrapper
``image_flood`` takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from .device_flood import (_image_claim_step, image_init_state,
                           neighbour_index, wavefront_image_flood_core)
from .flood_kernel import TileGrid, build_kernel_library, relaunch, run_tiled

__all__ = ["image_flood", "image_flood_plain", "build", "launches",
           "reset_launches", "TILE", "BYTES_PER_VOXEL_LAUNCH",
           "OPS_PER_FREE_VOXEL_STEP"]

TILE = (4, 8, 32)  # (TZ, TY, TX): must match csrc/image_flood.cu
# bytes the kernel's schedule moves per voxel and launch: d, lab, h, ckd,
# ckh, cki and the value read (7 words), code (1 byte), 6 words written
BYTES_PER_VOXEL_LAUNCH = (7 + 6) * 4 + 1
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
    """Kernel launches made by ``image_flood`` since the last reset."""
    return _launches


def reset_launches():
    global _launches
    _launches = 0


def build():
    """Compile (once per source version) and load the kernel library;
    returns the ``ctypes`` handle. Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = build_kernel_library(_SRC, "image_flood",
                                       "image_flood_tile", TILE)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.image_flood_launch.restype = ci
            lib.image_flood_launch.argtypes = ([vp] * 14 + [ci] * 4
                                               + [vp, ci, vp])
            _lib = lib
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


def image_flood_plain(values, seeds, mask, max_launches=512, inner_cap=1):
    """The kernel's function and schedule in plain torch, on any device.

    ``inner_cap=1`` is the synchronous hop-tie recurrence. For ``inner_cap
    > 1`` each launch relaxes every tile of the kernel with a frozen
    1-voxel halo for ``inner_cap`` steps (``flood_kernel.run_tiled``).
    Returns ``(labels int32, n_launches, converged)`` as ``image_flood``
    does."""
    _check(values, seeds, mask, inner_cap, max_launches)
    if inner_cap == 1:
        return wavefront_image_flood_core(values, seeds, mask,
                                          max_iters=max_launches)
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
                     max_launches, inner_cap)


def image_flood(values, seeds, mask, max_launches=512, inner_cap=1):
    """Seeded image watershed: ``values`` (Z, Y, X) float32 (the flood's
    priorities, −EDT on the DoG path), ``seeds`` (Z, Y, X) int32 (0 =
    unseeded), ``mask`` (Z, Y, X) bool, all on one device. Returns
    ``(labels int32 (Z, Y, X), n_launches, converged)``: ``n_launches``
    counts launches up to and including the first that claimed nothing, or
    ``max_launches`` when none did (``converged=False``; the caller then
    takes the exact host flood).

    CPU tensors run ``image_flood_plain``; CUDA tensors launch the kernel
    on the current stream, reading the convergence flags every
    ``flood_kernel._CHECK_EVERY`` launches."""
    if values.device.type == "cpu":
        return image_flood_plain(values, seeds, mask, max_launches,
                                 inner_cap)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    _check(values, seeds, mask, inner_cap, max_launches)
    lib = build()
    vals = values.contiguous()
    Z, Y, X = mask.shape
    with torch.cuda.device(vals.device):
        d, lab, h, ckd, ckh, cki, code = image_init_state(
            vals, seeds.contiguous(), mask.contiguous())
        state = (d, lab, h, ckd, ckh, cki)
        bufs = [state, tuple(t.clone() for t in state)]
        flags = torch.zeros(max_launches + 1, dtype=torch.int32,
                            device=vals.device)
        flags[0] = 1
        stream = torch.cuda.current_stream(vals.device).cuda_stream

        def launch_one(launch):
            global _launches
            src, dst = bufs[(launch - 1) % 2], bufs[launch % 2]
            err = lib.image_flood_launch(
                *[t.data_ptr() for t in src + dst], code.data_ptr(),
                vals.data_ptr(), Z, Y, X, inner_cap, flags.data_ptr(),
                launch, stream)
            if err:
                raise RuntimeError(
                    f"image_flood kernel launch failed: CUDA error {err}")
            _launches += 1

        n, converged = relaunch(launch_one, flags, max_launches)
        return bufs[n % 2][1], n, converged
