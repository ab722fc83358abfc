"""Minimal pure-NumPy zarr v2 driver — the no-tensorstore fallback.

The reference degrades gracefully to zarr-python when tensorstore is
absent (``_io.py:8-13,373-385``); neither tensorstore's wheel nor
zarr-python can be assumed on every deployment host, so this module
implements the small zarr v2 subset the framework needs with nothing
but the standard library + numpy:

* create / open filesystem arrays (``.zarray`` metadata, C order,
  ``fill_value`` handling, "." chunk-key separator);
* chunked slice reads and read-modify-write slice writes;
* compressors: ``None`` (raw), ``zlib``, ``gzip`` (stdlib).  Blosc
  stores (tensorstore's default here) need tensorstore — opening one
  without it raises a clear error naming the fix.

Stores this driver writes (zlib) are readable by tensorstore and
zarr-python, and vice versa for zlib/raw stores — round-trip pinned in
``tests/test_io.py`` against tensorstore when available.

``io/zarr_io`` selects this backend automatically when tensorstore is
not importable (or ``ITERSEG_TPU_NO_TENSORSTORE=1`` forces it, which is
how the tests exercise the fallback on this tensorstore-equipped host),
with a one-time warning mirroring the reference's.
"""
from __future__ import annotations

import json
import os
import uuid
import zlib

import numpy as np

__all__ = ["MiniZarrArray", "create", "open_array"]

_DEFAULT_COMPRESSOR = {"id": "zlib", "level": 3}


def _compress(buf, compressor):
    if compressor is None:
        return buf
    cid = compressor.get("id")
    if cid == "zlib":
        return zlib.compress(buf, compressor.get("level", 3))
    if cid == "gzip":
        import gzip

        return gzip.compress(buf, compressor.get("level", 3))
    raise ValueError(f"zarr_mini cannot write compressor {cid!r}")


def _decompress(buf, compressor):
    if compressor is None:
        return buf
    cid = compressor.get("id")
    if cid == "zlib":
        return zlib.decompress(buf)
    if cid == "gzip":
        import gzip

        return gzip.decompress(buf)
    if cid == "blosc":
        raise ValueError(
            "this zarr store is blosc-compressed; reading it needs "
            "tensorstore (pip install tensorstore) — the pure-python "
            "fallback only handles raw/zlib/gzip chunks"
        )
    raise ValueError(f"zarr_mini cannot read compressor {cid!r}")


def _write_atomic(path, buf):
    """Write ``buf`` to ``path`` through a temporary name of this writer's
    own (so two processes, even on two hosts, never share one), renamed
    into place: a reader sees the old file or the whole new one."""
    tmp = f"{path}.{uuid.uuid4().hex}.tmp"
    with open(tmp, "wb") as f:
        f.write(buf)
    os.replace(tmp, path)


class MiniZarrArray:
    """numpy-style adapter with the same surface as ``zarr_io.ZarrArray``
    (shape/dtype/chunks/ndim, slice get/set, ``write_async``)."""

    def __init__(self, path, meta):
        self.path = str(path)
        self._meta = meta
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self._fill = meta.get("fill_value", 0)
        if self._fill is None:
            self._fill = 0
        self._compressor = meta.get("compressor")
        self._sep = meta.get("dimension_separator", ".")
        if meta.get("order", "C") != "C":
            raise ValueError("zarr_mini supports C order only")
        if meta.get("filters"):
            raise ValueError("zarr_mini does not support filters")

    # -- metadata-compatible properties --------------------------------
    @property
    def ndim(self):
        return len(self.shape)

    def __len__(self):
        return self.shape[0]

    # -- selection normalisation ---------------------------------------
    def _normalise(self, sl):
        """Selection -> (per-axis slices, axes to squeeze)."""
        if not isinstance(sl, tuple):
            sl = (sl,)
        if Ellipsis in sl:
            i = sl.index(Ellipsis)
            fill = self.ndim - (len(sl) - 1)
            sl = sl[:i] + (slice(None),) * fill + sl[i + 1:]
        sl = sl + (slice(None),) * (self.ndim - len(sl))
        out, squeeze = [], []
        for ax, s in enumerate(sl):
            if isinstance(s, (int, np.integer)):
                s = int(s)
                if s < 0:
                    s += self.shape[ax]
                if not 0 <= s < self.shape[ax]:
                    raise IndexError(f"index {s} out of range on axis {ax}")
                out.append(slice(s, s + 1))
                squeeze.append(ax)
            elif isinstance(s, slice):
                start, stop, step = s.indices(self.shape[ax])
                if step != 1:
                    raise TypeError(
                        "zarr_mini supports contiguous slices only "
                        f"(axis {ax} got step {step}); read the array "
                        "and stride in numpy"
                    )
                out.append(slice(start, stop))
            else:
                raise TypeError(
                    f"zarr_mini supports int/slice selections, got {s!r}"
                )
        return tuple(out), tuple(squeeze)

    def _chunk_path(self, idx):
        return os.path.join(self.path, self._sep.join(map(str, idx)))

    def _chunk_range(self, sl):
        """Chunk index ranges intersecting the per-axis slices."""
        return [
            range(s.start // c, -(-s.stop // c) if s.stop > s.start
                  else s.start // c)
            for s, c in zip(sl, self.chunks)
        ]

    def _read_chunk(self, idx):
        p = self._chunk_path(idx)
        shape = self.chunks
        if not os.path.exists(p):
            return np.full(shape, self._fill, self.dtype)
        with open(p, "rb") as f:
            raw = _decompress(f.read(), self._compressor)
        return np.frombuffer(raw, self.dtype).reshape(shape).copy()

    def _write_chunk(self, idx, data):
        p = self._chunk_path(idx)
        buf = _compress(np.ascontiguousarray(data).tobytes(),
                        self._compressor)
        _write_atomic(p, buf)

    # -- reads / writes -------------------------------------------------
    def __getitem__(self, sl):
        sl, squeeze = self._normalise(sl)
        out_shape = tuple(s.stop - s.start for s in sl)
        out = np.empty(out_shape, self.dtype)
        if 0 in out_shape:
            return out
        for idx in np.ndindex(*[len(r) for r in self._chunk_range(sl)]):
            cidx = tuple(r[i] for r, i in zip(self._chunk_range(sl), idx))
            chunk = self._read_chunk(cidx)
            src, dst = [], []
            for ax, (s, c, ci) in enumerate(zip(sl, self.chunks, cidx)):
                c0 = ci * c
                lo = max(s.start, c0)
                hi = min(s.stop, c0 + c, self.shape[ax])
                src.append(slice(lo - c0, hi - c0))
                dst.append(slice(lo - s.start, hi - s.start))
            out[tuple(dst)] = chunk[tuple(src)]
        if squeeze:
            out = out.reshape(
                [n for ax, n in enumerate(out_shape) if ax not in squeeze]
            )
        return out

    def __setitem__(self, sl, value):
        sl, squeeze = self._normalise(sl)
        sel_shape = tuple(s.stop - s.start for s in sl)
        value = np.asarray(value, self.dtype)
        value = np.broadcast_to(value, [
            n for ax, n in enumerate(sel_shape) if ax not in squeeze
        ]).reshape(sel_shape)
        for idx in np.ndindex(*[len(r) for r in self._chunk_range(sl)]):
            cidx = tuple(r[i] for r, i in zip(self._chunk_range(sl), idx))
            src, dst = [], []
            full = True
            for ax, (s, c, ci) in enumerate(zip(sl, self.chunks, cidx)):
                c0 = ci * c
                lo = max(s.start, c0)
                hi = min(s.stop, c0 + c, self.shape[ax])
                src.append(slice(lo - c0, hi - c0))
                dst.append(slice(lo - s.start, hi - s.start))
                if hi - lo != c:
                    full = False
            if full:
                chunk = np.empty(self.chunks, self.dtype)
            else:
                chunk = self._read_chunk(cidx)
            chunk[tuple(src)] = value[tuple(dst)]
            self._write_chunk(cidx, chunk)

    def write_async(self, sl, value):
        """Synchronous shim of ``ZarrArray.write_async`` (no async IO
        engine here); returns a resolved-future-like object."""
        self[sl] = value

        class _Done:
            @staticmethod
            def result():
                return None

        return _Done()

    def __array__(self, dtype=None, copy=None):
        arr = self[...]
        return arr.astype(dtype) if dtype is not None else arr


def create(path, shape, chunks=None, dtype=np.uint32, fill_value=0,
           compressor=_DEFAULT_COMPRESSOR):
    path = str(path)
    os.makedirs(path, exist_ok=True)
    shape = tuple(int(s) for s in shape)
    if chunks is None:
        chunks = tuple(min(s, 128) if i >= max(0, len(shape) - 3) else 1
                       for i, s in enumerate(shape))
    meta = {
        "zarr_format": 2,
        "shape": list(shape),
        "chunks": [int(c) for c in chunks],
        "dtype": np.dtype(dtype).str,
        "compressor": dict(compressor) if compressor else None,
        "fill_value": fill_value,
        "order": "C",
        "filters": None,
        "dimension_separator": ".",
    }
    _write_atomic(os.path.join(path, ".zarray"), json.dumps(meta).encode())
    return MiniZarrArray(path, meta)


def open_array(path):
    path = str(path)
    with open(os.path.join(path, ".zarray")) as f:
        meta = json.load(f)
    return MiniZarrArray(path, meta)
