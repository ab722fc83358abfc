"""Native (C++) host kernels, built lazily and loaded via ctypes.

The port's own copy of ``iterseg_tpu/native``, with the same ctypes
signatures. The priority-flood watershed is the one inherently sequential
hot loop of the inference pipeline (a heap-ordered flood; see
``ops/watershed_oracle.py`` for the semantics). ``priority_flood`` pops in
the heap's order from a bucketed queue over packed (value, age) keys, with
the JAX package's binary heap as its fallback (``priority_flood_heap``);
``bucket_flood_image`` is its exact bucket-queue twin for the DoG path's
integer squared distances. It runs on host, under the GPU's work on the
next frame, as an -O3 C++ kernel.

The shared library is compiled on first use with the system ``g++`` into the
port's build directory (``_build.build_dir``); set
``ITERSEG_TORCH_NO_NATIVE=1`` to force the pure-Python oracle fallback.
``loaded()`` says whether the library is in use, so a caller can assert that
a run took the native path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .._build import build_library
from ..utils import count

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "priority_flood.cpp")
_CMD = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fno-exceptions",
        "-fno-rtti"]
_LOCK = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def loaded() -> bool:
    """Whether the native library has been built and loaded."""
    return _lib is not None


def get_lib():
    """Build (if needed) and load the native library."""
    global _lib
    if os.environ.get("ITERSEG_TORCH_NO_NATIVE"):
        raise NativeUnavailable("native kernels disabled by env var")
    with _LOCK:
        if _lib is not None:
            return _lib
        try:
            path = build_library(_SRC, "libiterseg_native", _CMD)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            raise NativeUnavailable(f"could not build native kernels: {e}")
        lib = ctypes.CDLL(path)
        lib.label_cc6.restype = ctypes.c_int32
        lib.label_cc6.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.band_filter_cc6.restype = None
        lib.band_filter_cc6.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.band_filter_runs.restype = None
        lib.band_filter_runs.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.ensure_spacing_cheb.restype = None
        lib.ensure_spacing_cheb.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.bucket_flood_image.restype = None
        lib.bucket_flood_image.argtypes = [
            ctypes.POINTER(ctypes.c_int32),   # keys (d^2)
            ctypes.POINTER(ctypes.c_int64),   # offsets
            ctypes.c_int32,                   # n_nbr
            ctypes.POINTER(ctypes.c_int64),   # markers
            ctypes.c_int64,                   # n_markers
            ctypes.POINTER(ctypes.c_uint8),   # mask
            ctypes.POINTER(ctypes.c_int32),   # output
            ctypes.c_int64,                   # n
        ]
        lib.edt3d.restype = None
        lib.edt3d.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        for flood in (lib.priority_flood, lib.priority_flood_heap):
            flood.restype = ctypes.c_int64
            flood.argtypes = [
                ctypes.POINTER(ctypes.c_float),   # values
                ctypes.POINTER(ctypes.c_int64),   # offsets
                ctypes.POINTER(ctypes.c_int64),   # val_chan
                ctypes.POINTER(ctypes.c_int64),   # val_off
                ctypes.c_int32,                   # n_nbr
                ctypes.POINTER(ctypes.c_int64),   # markers
                ctypes.c_int64,                   # n_markers
                ctypes.POINTER(ctypes.c_float),   # seed_values
                ctypes.POINTER(ctypes.c_uint8),   # mask
                ctypes.POINTER(ctypes.c_int32),   # output
                ctypes.c_int64,                   # n
            ]
        _lib = lib
        return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _flood(entry, values, offsets, val_chan, val_off, markers, seed_values,
           mask, output):
    """Call the C flood ``entry`` in place on ``output``; returns what it
    returns: the most elements its queue held, or for ``priority_flood``
    -1 less the heap's most where the heap ran."""
    values = np.ascontiguousarray(values, dtype=np.float32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    val_chan = np.ascontiguousarray(val_chan, dtype=np.int64)
    val_off = np.ascontiguousarray(val_off, dtype=np.int64)
    markers = np.ascontiguousarray(markers, dtype=np.int64)
    seed_values = np.ascontiguousarray(seed_values, dtype=np.float32)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    assert output.dtype == np.int32 and output.flags.c_contiguous
    return entry(
        _ptr(values, ctypes.c_float),
        _ptr(offsets, ctypes.c_int64),
        _ptr(val_chan, ctypes.c_int64),
        _ptr(val_off, ctypes.c_int64),
        ctypes.c_int32(len(offsets)),
        _ptr(markers, ctypes.c_int64),
        ctypes.c_int64(len(markers)),
        _ptr(seed_values, ctypes.c_float),
        _ptr(mask, ctypes.c_uint8),
        _ptr(output, ctypes.c_int32),
        ctypes.c_int64(mask.size),
    )


def priority_flood(values, offsets, val_chan, val_off, markers, seed_values,
                   mask, output):
    """Run the native flood in place on ``output`` (raveled int32).

    The bucketed queue over packed (value, age) keys; where it cannot keep
    the heap's order (a NaN value, a label at or below 0 at a marker or
    below 0 anywhere, over 2^32 voxels and seeds) the heap runs instead,
    from the caller's seeded ``output``, with the counter
    ``flood_heap_fallback``."""
    if _flood(get_lib().priority_flood, values, offsets, val_chan, val_off,
              markers, seed_values, mask, output) < 0:
        count("flood_heap_fallback")
    return output


def priority_flood_heap(values, offsets, val_chan, val_off, markers,
                        seed_values, mask, output):
    """``priority_flood``'s fallback alone, the binary heap over (value,
    age, index): its oracle. Same arguments."""
    _flood(get_lib().priority_flood_heap, values, offsets, val_chan, val_off,
           markers, seed_values, mask, output)
    return output


# Heap-order equivalence bound for ``bucket_flood_image``: the heap orders
# by f32 ``-sqrt(k)``, the bucket queue strictly by integer ``k`` — they
# agree iff distinct keys map to distinct f32 priorities. For integers
# a < b, sqrt(b) - sqrt(a) >= 1 / (2*sqrt(b)), while one f32 value spans at
# most ulp(sqrt(b)) <= sqrt(b) * 2^-23; the gap exceeds the span whenever
# b < 2^22, so keys below 2^22 are provably collision-free (a 3D EDT hits
# this only past ~1180 voxels of axis-aligned distance).
BUCKET_FLOOD_MAX_KEY = 1 << 22


def bucket_flood_image(keys, offsets, markers, mask, output):
    """Image-mode priority flood with DISCRETE integer priorities.

    The exact heap-order twin of ``priority_flood`` in image mode when every
    priority is ``-sqrt(keys[i])`` for integer ``keys`` (the EDT
    watershed): buckets by key instead of a heap. ``markers`` must be
    ascending (flatnonzero order); ``output`` pre-seeded at markers. In
    place on raveled int32 ``output``.

    Raises ``ValueError`` when any key reaches ``BUCKET_FLOOD_MAX_KEY``:
    beyond it adjacent integer keys can round to the same f32 ``-sqrt``
    priority, where the heap tie-breaks by age but the bucket queue still
    orders strictly by key — callers must use ``priority_flood`` there.
    """
    lib = get_lib()
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    if keys.size and int(keys.max()) >= BUCKET_FLOOD_MAX_KEY:
        raise ValueError(
            f"bucket_flood_image key {int(keys.max())} >= 2^22: f32 -sqrt "
            "priorities may collide (heap would tie-break by age); use "
            "priority_flood for this volume"
        )
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    markers = np.ascontiguousarray(markers, dtype=np.int64)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    assert output.dtype == np.int32 and output.flags.c_contiguous
    lib.bucket_flood_image(
        _ptr(keys, ctypes.c_int32),
        _ptr(offsets, ctypes.c_int64),
        ctypes.c_int32(len(offsets)),
        _ptr(markers, ctypes.c_int64),
        ctypes.c_int64(len(markers)),
        _ptr(mask, ctypes.c_uint8),
        _ptr(output, ctypes.c_int32),
        ctypes.c_int64(mask.size),
    )
    return output


def edt3d(mask):
    """Exact EDT (f64) of a 3D mask: distance to the nearest zero voxel.
    Bit-identical to ``scipy.ndimage.distance_transform_edt``."""
    lib = get_lib()
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    assert m.ndim == 3
    out = np.empty(m.shape, dtype=np.float64)
    lib.edt3d(
        _ptr(m, ctypes.c_uint8),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(m.shape[0]),
        ctypes.c_int64(m.shape[1]),
        ctypes.c_int64(m.shape[2]),
    )
    return out


def label_cc6(mask):
    """6-connectivity CC labels, scipy raster numbering (3D only)."""
    lib = get_lib()
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    assert mask.ndim == 3
    labels = np.zeros(mask.shape, dtype=np.int32)
    num = lib.label_cc6(
        _ptr(mask, ctypes.c_uint8),
        _ptr(labels, ctypes.c_int32),
        ctypes.c_int64(mask.shape[0]),
        ctypes.c_int64(mask.shape[1]),
        ctypes.c_int64(mask.shape[2]),
    )
    return labels, int(num)


def ensure_spacing_cheb(coords, spacing):
    """Greedy Chebyshev spacing keep-flags for priority-ordered coords."""
    lib = get_lib()
    coords = np.ascontiguousarray(coords, dtype=np.int64)
    n, ndim = coords.shape
    keep = np.zeros(n, dtype=np.uint8)
    lib.ensure_spacing_cheb(
        _ptr(coords, ctypes.c_int64),
        ctypes.c_int64(n),
        ctypes.c_int64(ndim),
        ctypes.c_int64(int(spacing)),
        _ptr(keep, ctypes.c_uint8),
    )
    return keep.astype(bool)


def band_filter_cc6(mask, min_area, max_area):
    """In-place fused CC size-band filter on a 3D uint8/bool mask.

    Returns the filtered boolean mask (components with size outside
    [min_area, max_area) removed), by the run-based union-find kernel
    (``band_filter_runs``); the per-voxel BFS version
    (``band_filter_bfs``) is kept as its slow oracle.

    Aliasing contract: when ``mask`` is already a C-contiguous uint8
    array it is filtered IN PLACE and the returned bool array is a view
    sharing its memory — the caller's input mask is the filtered result
    afterwards. Any other dtype/layout is copied first (the input is then
    untouched and the return value owns fresh memory). Pass a copy if the
    original uint8 mask must survive.
    """
    lib = get_lib()
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    assert m.ndim == 3
    lib.band_filter_runs(
        _ptr(m, ctypes.c_uint8),
        ctypes.c_int64(m.shape[0]),
        ctypes.c_int64(m.shape[1]),
        ctypes.c_int64(m.shape[2]),
        ctypes.c_int64(int(min_area)),
        ctypes.c_int64(int(max_area)),
    )
    # uint8 0/1 reinterpreted as bool: no 17 MB copy
    return m.view(bool)


def band_filter_bfs(mask, min_area, max_area):
    """Per-voxel BFS size-band filter: the slow oracle for
    ``band_filter_cc6`` (identical output). Same aliasing contract."""
    lib = get_lib()
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    assert m.ndim == 3
    labels = np.zeros(m.shape, dtype=np.int32)
    lib.band_filter_cc6(
        _ptr(m, ctypes.c_uint8),
        _ptr(labels, ctypes.c_int32),
        ctypes.c_int64(m.shape[0]),
        ctypes.c_int64(m.shape[1]),
        ctypes.c_int64(m.shape[2]),
        ctypes.c_int64(int(min_area)),
        ctypes.c_int64(int(max_area)),
    )
    return m.view(bool)
