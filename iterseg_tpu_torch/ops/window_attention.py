"""Shifted-window 3D multi-head attention (Swin UNETR) on Hopper: a
hand-written CUDA kernel, its plain torch version, and the wrapper that
picks between them.

Replaces no TPU kernel: the JAX package has no transformer. It was added
with ``models/swin_unetr.py``, whose blocks run MONAI's ``WindowAttention``
over windows of up to 7^3 = 343 tokens. Unfused, one stage-0 block of a
96^3 chunk writes a 343-window x 3-head x 343^2 score tensor (484 MB a
chunk) and reads it back for the bias add, the mask add and the softmax.

What it computes, for ``qkv`` (B, Dp, Hp, Wp, 3C) on the zero-padded token
grid (the qkv projection of the normalised, padded tokens; channels
ordered (q|k|v, head, width) as ``nn.Linear(C, 3C)`` gives them):

- the grid rolled by ``-shift`` and cut into windows of ``window`` tokens
  (MONAI ``window_partition``); both are the kernel's addressing: the token
  at position p of the rolled grid is read from, and its output written
  to, grid position (p + shift) mod P, which is where MONAI's reverse roll
  puts it;
- per window and head: ``softmax(q k^T / sqrt(width) + B + M) v``, where
  ``B`` is gathered from ``table`` (13^3 rows x heads) by MONAI's
  relative index of the full 7^3 window, ``FULL_WINDOW`` (a clipped window
  of n tokens takes rows and columns ``[:n, :n]`` of it, as MONAI slices
  it), and ``M`` is -100 where the query's and the key's region ids differ
  (MONAI ``compute_mask`` over the padded grid: per axis, ``[:-w]``,
  ``[-w:-s]`` and ``[-s:]``), in shifted windows only;
- the output (B, Dp, Hp, Wp, C), before the output projection.

What bounds it on the H100: float32 FMA throughput. A window-head of 343
tokens at width 16 is 7.5 MFLOP against 88 KB of q, k, v and output, so
the IEEE float32 products (no tensor cores, so no TF32, as
``device.f32_numerics`` requires) bound it, not memory. The source,
``iterseg_tpu_torch/csrc/window_attention.cu``, says the design: one block
a (window, head) holds the window's keys and values, the head's column of
the bias table and each key's offset and region id in shared memory; each
thread keeps two queries and their outputs in registers and walks the
keys with an online softmax. No score tensor is written to device memory.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a`` (the floods' flags)
into a plain C library (``_build.build_dir``), at first use, loaded with
``ctypes``. The wrapper ``window_attention`` takes the plain version only
for CPU tensors; a CUDA tensor launches the kernel or raises. It records
the span ``window_attention`` and the counter ``window_attention_windows``
(windows x heads of the call), and counts launches (``launches()``). There
is no backward: training Swin UNETR is not supported.
"""
from __future__ import annotations

import ctypes
import math
import os
import subprocess
import threading

import torch

from ..utils import count, span

__all__ = ["window_attention", "window_attention_plain", "relative_index",
           "region_ids", "launches", "reset_launches", "build",
           "FULL_WINDOW", "MASK_VALUE", "WIDTH"]

FULL_WINDOW = (7, 7, 7)
MASK_VALUE = -100.0
WIDTH = 16  # the one head width the kernel takes (Swin UNETR's at any size)
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "window_attention.cu")

_launches = 0
_lock = threading.Lock()
_lib = None


def launches() -> int:
    """Kernel launches since the last ``reset_launches``."""
    return _launches


def reset_launches():
    global _launches
    _launches = 0


def relative_index(n: int, device=None) -> torch.Tensor:
    """MONAI's ``relative_position_index`` of the full window, sliced to
    ``[:n, :n]``: (n, n) rows of the bias table."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(f, device=device) for f in FULL_WINDOW],
        indexing="ij"))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0)
    f0, f1, f2 = FULL_WINDOW
    idx = ((rel[..., 0] + f0 - 1) * (2 * f1 - 1) * (2 * f2 - 1)
           + (rel[..., 1] + f1 - 1) * (2 * f2 - 1) + rel[..., 2] + f2 - 1)
    return idx[:n, :n]


def region_ids(dims, window, shift, device=None) -> torch.Tensor:
    """MONAI ``compute_mask``'s region id of every position of the padded
    grid ``dims``, (d, h, w) int64. Per axis the slices ``[:-w]``,
    ``[-w:-s]``, ``[-s:]`` take ids 0, 1, 2, a later slice overwriting an
    earlier one (with s = 0 the last is the whole axis)."""
    ids = []
    for p, w, s in zip(dims, window, shift):
        a = torch.zeros(p, dtype=torch.int64, device=device)
        for k, sl in enumerate((slice(-w), slice(-w, -s), slice(-s, None))):
            a[sl] = k
        ids.append(a)
    return (ids[0][:, None, None] * 9 + ids[1][None, :, None] * 3
            + ids[2][None, None, :])


def _partition(x, window):
    """(B, D, H, W, C) -> (B * windows, n, C), windows in (b, d, h, w)
    order and tokens in raster order inside each (MONAI
    ``window_partition``)."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window
    x = x.view(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, c)


def _reverse(windows, window, dims):
    """The inverse of ``_partition`` onto (B, D, H, W, C)."""
    b, d, h, w = dims
    wd, wh, ww = window
    x = windows.view(b, d // wd, h // wh, w // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def window_attention_plain(qkv, table, heads, window, shift):
    """The plain torch version: roll, partition, MONAI's attention with the
    scores in memory, reverse, roll back."""
    b, dp, hp, wp, c3 = qkv.shape
    c = c3 // 3
    width = c // heads
    shifted = any(s > 0 for s in shift)
    x = torch.roll(qkv, [-s for s in shift], (1, 2, 3)) if shifted else qkv
    win = _partition(x, window)
    nb, n, _ = win.shape
    q, k, v = win.reshape(nb, n, 3, heads, width).permute(2, 0, 3, 1, 4)
    a = (q * width ** -0.5) @ k.transpose(-2, -1)
    bias = table[relative_index(n, qkv.device).reshape(-1)]
    a = a + bias.reshape(n, n, heads).permute(2, 0, 1)[None]
    if shifted:
        ids = _partition(region_ids((dp, hp, wp), window, shift,
                                    qkv.device)[None, ..., None],
                         window)[..., 0]
        mask = torch.where(ids[:, None, :] != ids[:, :, None], MASK_VALUE,
                           0.0).to(a.dtype)
        a = (a.view(b, -1, heads, n, n) + mask[None, :, None]).view(
            nb, heads, n, n)
    o = (torch.softmax(a, -1) @ v).transpose(1, 2).reshape(nb, n, c)
    o = _reverse(o, window, (b, dp, hp, wp))
    return torch.roll(o, list(shift), (1, 2, 3)) if shifted else o


def build():
    """Compile (once per source version) and load the kernel library;
    returns the ``ctypes`` handle. Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from .._build import build_library
        from .flood_kernel import _NVCC_FLAGS, _nvcc

        try:
            path = build_library(_SRC, "window_attention",
                                 [_nvcc()] + _NVCC_FLAGS)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"nvcc failed to build {_SRC}:\n{e.stdout}\n"
                               f"{e.stderr}") from e
        lib = ctypes.CDLL(path)
        lib.window_attention_width.restype = ctypes.c_int
        if lib.window_attention_width() != WIDTH:
            raise RuntimeError("kernel head width "
                               f"{lib.window_attention_width()} != {WIDTH}")
        run = lib.window_attention_run
        run.restype = ctypes.c_int
        # qkv, table, out, B, Dp, Hp, Wp, window, shift, heads, scale, stream
        run.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
                        + [ctypes.c_float, ctypes.c_void_p])
        _lib = lib
        return _lib


def _check(qkv, table, heads, window, shift):
    b, dp, hp, wp, c3 = qkv.shape
    c = c3 // 3
    width = c // heads
    if c3 != 3 * c or c != heads * width:
        raise ValueError(f"qkv width {c3} is not 3 x heads {heads} x width")
    if any(p % w for p, w in zip((dp, hp, wp), window)):
        raise ValueError(f"grid {(dp, hp, wp)} is not a multiple of the "
                         f"window {tuple(window)}")
    if any(w > f for w, f in zip(window, FULL_WINDOW)) or any(
            s >= w for s, w in zip(shift, window) if s):
        raise ValueError(f"window {tuple(window)} / shift {tuple(shift)} "
                         f"outside the full window {FULL_WINDOW}")
    rows = math.prod(2 * f - 1 for f in FULL_WINDOW)
    if tuple(table.shape) != (rows, heads):
        raise ValueError(f"bias table {tuple(table.shape)}, want "
                         f"{(rows, heads)}")
    return c, width


def window_attention(qkv, table, heads, window, shift):
    """Shifted-window attention of ``qkv`` (B, Dp, Hp, Wp, 3C) float32 on
    the padded grid; returns (B, Dp, Hp, Wp, C). ``window`` is the
    (clipped) window, ``shift`` its roll (all 0: an unshifted block).
    CPU tensors take the plain version; a CUDA tensor launches the kernel
    (float32, head width ``WIDTH``, contiguous) or raises."""
    global _launches
    window, shift = tuple(window), tuple(shift)
    c, width = _check(qkv, table, heads, window, shift)
    b, dp, hp, wp, _ = qkv.shape
    nwin = b * (dp // window[0]) * (hp // window[1]) * (wp // window[2])
    with span("window_attention"):
        count("window_attention_windows", nwin * heads)
        if qkv.device.type != "cuda":
            return window_attention_plain(qkv, table, heads, window, shift)
        if qkv.dtype != torch.float32 or table.dtype != torch.float32:
            raise ValueError("the window-attention kernel takes float32")
        if width != WIDTH:
            raise ValueError(f"head width {width}: the kernel takes {WIDTH}")
        if not (qkv.is_contiguous() and table.is_contiguous()):
            raise ValueError("the window-attention kernel takes contiguous "
                             "tensors")
        if qkv.numel() >= 2 ** 31 or nwin * heads >= 2 ** 31:
            raise ValueError("qkv too large for 32-bit offsets")
        if table.device != qkv.device:
            raise ValueError("qkv and the bias table lie on other devices")
        lib = build()
        out = torch.empty((b, dp, hp, wp, c), dtype=qkv.dtype,
                          device=qkv.device)
        with torch.cuda.device(qkv.device):
            stream = torch.cuda.current_stream(qkv.device).cuda_stream
            err = lib.window_attention_run(
                qkv.data_ptr(), table.data_ptr(), out.data_ptr(), b, dp, hp,
                wp, *window, *shift, heads, width ** -0.5, stream)
        if err:
            raise RuntimeError("window_attention kernel launch failed: CUDA "
                               f"error {err}")
        with _lock:
            _launches += 1
        return out
