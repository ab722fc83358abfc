"""Operations and bytes of the shifted-window attention of Swin UNETR,
counted from the configuration's geometry.

A chunk's forward runs one attention launch per Swin block: stage i sees
the chunk over ``patch_size * 2^i`` per axis, takes windows of
``window_size`` (an axis of at most that size takes its size), pads each
axis to a multiple of its window, and runs every window with
``num_heads[i]`` heads of width ``feature_size * 2^i / num_heads[i]``.

Per window and head of n tokens at width w: ``4 n^2 w`` operations (two
per multiply-add of ``q k^T`` and of ``softmax(.) v``), and ``4 n w``
float32 values of q, k, v read and of the output written. Each launch
also reads the stage's bias table, ``(2 window - 1)^3`` rows x heads.
"""
from __future__ import annotations

import math

BYTES = 4  # float32


def launches(chunk, feature_size, num_heads, depths, window_size=7,
             patch_size=2):
    """One ``(windows, heads, n, width)`` per attention launch of one
    chunk, in forward order."""
    dims = [c // patch_size for c in chunk]
    out = []
    for i, (heads, depth) in enumerate(zip(num_heads, depths)):
        width = feature_size * 2 ** i // heads
        win = [min(d, window_size) for d in dims]
        windows = math.prod(-(-d // w) for d, w in zip(dims, win))
        out += [(windows, heads, math.prod(win), width)] * depth
        dims = [-(-d // 2) for d in dims]
    return out


def flops(windows, heads, n, width) -> int:
    return windows * heads * 4 * n * n * width


def bytes_moved(windows, heads, n, width, window_size=7) -> int:
    """q, k, v read and the output written once, and the bias table."""
    table = (2 * window_size - 1) ** 3 * heads
    return BYTES * (windows * heads * 4 * n * width + table)


def windows_heads(chunk, **geometry) -> int:
    """Windows x heads of one chunk's launches: what the program's counter
    ``window_attention_windows`` adds up for that chunk."""
    return sum(w * h for w, h, _, _ in launches(chunk, **geometry))


def roofline_seconds(chunk, peak_flops, peak_bytes, **geometry) -> float:
    """The least time of one chunk's attention launches: per launch the
    larger of its operations over the peak rate and its bytes over the
    memory bandwidth."""
    ws = geometry.get("window_size", 7)
    return sum(max(flops(*l) / peak_flops,
                   bytes_moved(*l, window_size=ws) / peak_bytes)
               for l in launches(chunk, **geometry))
