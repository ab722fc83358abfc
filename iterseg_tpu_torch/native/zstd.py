"""Zstandard decoding and CRC-32C for orbax checkpoints, in C++.

``zstd_decode.cpp`` is a whole zstd decoder (RFC 8878); see its header for
what it covers. Orbax writes every array chunk, and every OCDBT manifest and
B-tree node, as zstd frames, and the decoder belongs in C++ because a
checkpoint is tens of MB of Huffman-coded literals, which Python would decode
byte by byte for tens of seconds. The library is built at first use with
``g++`` into the port's build directory, like ``priority_flood.cpp``. There is
no Python fallback: when it cannot be built, ``decompress`` raises
``NativeUnavailable``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .._build import build_library
from . import _CMD, NativeUnavailable

__all__ = ["decompress", "crc32c", "get_lib"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "zstd_decode.cpp")
_LOCK = threading.Lock()
_lib = None
# A block header and one RLE byte can stand for a whole 128 KiB block, so no
# valid input decodes to more than this many bytes per input byte.
_MAX_RATIO = 1 << 15


def get_lib():
    """Build (if needed) and load the decoder library."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        try:
            path = build_library(_SRC, "libiterseg_zstd", _CMD)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            raise NativeUnavailable(f"could not build the zstd decoder: {e}")
        lib = ctypes.CDLL(path)
        lib.zstd_decompress.restype = ctypes.c_int64
        lib.zstd_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,       # src, n
            ctypes.c_void_p, ctypes.c_int64,       # dst, cap
            ctypes.POINTER(ctypes.c_int64),        # want
            ctypes.c_char_p, ctypes.c_int64,       # err, err_cap
        ]
        lib.crc32c.restype = ctypes.c_uint32
        lib.crc32c.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        _lib = lib
        return _lib


def _src(data) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8) if len(data) else \
        np.zeros(1, np.uint8)[:0]


def decompress(data, size_hint: int = 0) -> np.ndarray:
    """Decode the zstd frames in ``data`` (any bytes-like object) into a new
    uint8 array. ``size_hint`` is the expected decoded size, when the caller
    knows it (a zarr chunk does); without it, or when it is short, the
    output grows until it fits. Raises ``ValueError`` naming the input
    offset for malformed, truncated or dictionary-coded input, and for a
    checksum mismatch."""
    lib = get_lib()
    src = _src(data)
    limit = _MAX_RATIO * src.size + 64
    cap = int(size_hint) if size_hint else max(4 * src.size, 1 << 16)
    cap = min(cap, limit)
    err = ctypes.create_string_buffer(256)
    want = ctypes.c_int64(0)
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        n = lib.zstd_decompress(src.ctypes.data, src.size, out.ctypes.data,
                                cap, ctypes.byref(want), err, len(err))
        if n >= 0:
            return out[:n]
        if n == -1:
            raise ValueError(f"zstd: {err.value.decode()}")
        if cap >= limit or want.value > limit:
            raise ValueError("zstd: the frames declare more output than "
                             f"{src.size} input bytes can hold")
        cap = min(max(2 * cap, want.value), limit)


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``, as OCDBT files end with it."""
    src = _src(data)
    return int(get_lib().crc32c(src.ctypes.data, src.size))
