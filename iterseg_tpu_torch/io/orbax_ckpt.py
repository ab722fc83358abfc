"""Orbax checkpoints of a flat dict of arrays, read and written without orbax.

What ``orbax.checkpoint.StandardCheckpointer().save(dir, {name: array})``
writes (orbax-checkpoint 0.11.32, found byte by byte):

* ``_CHECKPOINT_METADATA``: JSON, the handler's dotted name
  (``item_handlers``), empty ``metrics``/``performance_metrics``/
  ``custom_metadata`` and the init and commit times in ns;
* ``_METADATA``: JSON ``{"tree_metadata": {"('<name>',)": {"key_metadata":
  [{"key": "<name>", "key_type": 2}], "value_metadata": {"value_type":
  "np.ndarray", "skip_deserialize": false}}, ...}, "use_ocdbt": true,
  "use_zarr3": false, "store_array_data_equal_to_fill_value": true,
  "custom_metadata": null}``, one entry a parameter, in the dict's order
  (``key_type`` 2 is a dict key; a nested tree has one key a level);
* one zarr v2 array a parameter, named ``<name>``: ``<name>/.zarray`` holds
  ``{"chunks": shape, "compressor": {"id": "zstd", "level": 1},
  "dimension_separator": ".", "dtype": "<f4", "fill_value": null,
  "filters": null, "order": "C", "shape": shape, "zarr_format": 2}`` and
  ``<name>/0.0.0.0.0`` (``0`` for a vector, one index a dimension) holds one
  zstd frame without a content-size field;
* with ``use_ocdbt`` (the default) those keys live in the OCDBT database of
  the directory (``io/ocdbt.py``); without it, as files
  ``<name>/.zarray`` and ``<name>/0.0``.

``read_orbax`` reads both layouts and any zarr v2 array within them: every
numpy dtype zarr v2 names, ``order`` C or F, ``compressor`` zstd or null,
any chunk grid with its edge chunks, and a missing chunk filled with
``fill_value`` (zeros when null).
zarr v3 (``use_zarr3``), a nested tree, filters or another compressor raise
``ValueError`` naming what was found.

``write_orbax`` writes the layout orbax writes with ``use_ocdbt=False``,
which orbax's ``StandardCheckpointer`` and the JAX package's
``load_checkpoint`` read back: the two metadata files and one uncompressed
chunk a parameter (``"compressor": null``). Uncompressed, because float32
weights gain ~13% from zstd (34.6 of 39.9 MB for the default U-Net) and a
frame of raw blocks gains nothing, while needing an encoder of its own.
"""
from __future__ import annotations

import base64
import itertools
import json
import math
import os
import shutil
import time
from typing import Callable, Dict, Mapping, Optional

import numpy as np

from ..native import zstd
from .ocdbt import OcdbtReader

__all__ = ["read_orbax", "write_orbax"]

_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")


def _dtype(spec, where: str) -> np.dtype:
    try:
        dt = np.dtype([tuple(f) for f in spec] if isinstance(spec, list)
                      else spec)
    except TypeError as e:
        raise ValueError(f"{where}: zarr dtype {spec!r}: {e}") from None
    if dt.hasobject:
        raise ValueError(f"{where}: zarr dtype {spec!r} holds objects")
    return dt


def _fill(value, dt: np.dtype, where: str) -> np.ndarray:
    if value is None:
        return np.zeros((), dt)
    if dt.kind in "SVU" or dt.fields:
        if dt.kind == "U":
            return np.array(value, dt)
        raw = base64.b64decode(value)
        if len(raw) != dt.itemsize:
            raise ValueError(f"{where}: fill_value of {len(raw)} bytes for "
                             f"dtype {dt}")
        return np.frombuffer(raw, dt)[0].copy()
    if dt.kind == "c" and isinstance(value, list):
        re, im = (float(v) if isinstance(v, str) else v for v in value)
        return np.array(complex(re, im), dt)
    if isinstance(value, str):           # "NaN", "Infinity", "-Infinity"
        return np.array(float(value), dt)
    return np.array(value, dt)


def _read_array(get: Callable[[str], Optional[bytes]], name: str,
                where: str) -> np.ndarray:
    raw_meta = get(f"{name}/.zarray")
    if raw_meta is None:
        raise ValueError(f"{where}: no zarr array {name!r} (missing "
                         f"{name}/.zarray)")
    meta = json.loads(raw_meta)
    where = f"{where}: {name}/.zarray"
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: zarr_format {meta.get('zarr_format')!r}")
    missing = [f for f in ("shape", "chunks", "dtype") if f not in meta]
    if missing:
        raise ValueError(f"{where}: no {', '.join(missing)}")
    if meta.get("filters"):
        raise ValueError(f"{where}: filters {meta['filters']!r} are not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{where}: compressor {comp!r} is not read (zstd "
                         "or null)")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"{where}: order {order!r}")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"{where}: chunks {chunks} for shape {shape}")
    dt = _dtype(meta["dtype"], where)
    out = np.empty(shape, dt)
    out[...] = _fill(meta.get("fill_value"), dt, where)
    sep = meta.get("dimension_separator", ".")
    chunk_bytes = math.prod(chunks) * dt.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = get(key)
        if data is None:
            continue
        if comp is not None:
            try:
                data = zstd.decompress(data, chunk_bytes)
            except ValueError as e:
                raise ValueError(f"{where}: chunk {key}: {e}") from None
        if len(data) != chunk_bytes:
            raise ValueError(f"{where}: chunk {key} holds {len(data)} bytes, "
                             f"expected {chunk_bytes}")
        block = np.frombuffer(data, dt).reshape(chunks, order=order)
        dst = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
    return out


def read_orbax(path) -> Dict[str, np.ndarray]:
    """The flat dict of arrays in orbax checkpoint directory ``path``, in
    ``_METADATA``'s order."""
    path = os.path.abspath(os.fspath(path))
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path} is not an orbax checkpoint: it has no "
                         "_METADATA")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{meta_path}: use_zarr3 is true; only zarr v2 "
                         "checkpoints are read")
    names = []
    for tree_key, entry in meta.get("tree_metadata", {}).items():
        keys = entry.get("key_metadata", [])
        if len(keys) != 1 or keys[0].get("key_type") != 2:
            raise ValueError(f"{meta_path}: {tree_key} is not a key of a "
                             "flat dict (nested trees are not read)")
        names.append(keys[0]["key"])
    if meta.get("use_ocdbt", True):
        store = OcdbtReader(path)
        get = store.read
    else:
        def get(key):
            p = os.path.join(path, *key.split("/"))
            if not os.path.isfile(p):
                return None
            with open(p, "rb") as f:
                return f.read()
    return {n: _read_array(get, n, path) for n in names}


def _dumps(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":"), sort_keys=True).encode()


def write_orbax(params: Mapping[str, np.ndarray], path) -> str:
    """Write ``params`` as orbax's ``use_ocdbt=False`` checkpoint directory
    ``path`` (which must not exist) and return its absolute path."""
    path = os.path.abspath(os.fspath(path))
    if os.path.exists(path):
        raise ValueError(f"{path} already exists")
    t0 = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        tree = {}
        for name, value in params.items():
            name = str(name)
            if "/" in name or name in ("", ".", ".."):
                raise ValueError(f"parameter name {name!r} cannot name a "
                                 "directory")
            a = np.asarray(value)
            if a.dtype.hasobject:
                raise ValueError(f"{name}: dtype {a.dtype} holds objects")
            if not a.size:
                raise ValueError(f"{name}: cannot save an array of zero "
                                 "size (orbax refuses them too)")
            d = os.path.join(tmp, name)
            os.makedirs(d)
            zarray = {"chunks": list(a.shape),
                      "compressor": None, "dimension_separator": ".",
                      "dtype": a.dtype.descr if a.dtype.fields
                      else a.dtype.str,
                      "fill_value": None, "filters": None, "order": "C",
                      "shape": list(a.shape), "zarr_format": 2}
            with open(os.path.join(d, ".zarray"), "wb") as f:
                f.write(_dumps(zarray))
            key = ".".join("0" for _ in a.shape) or "0"
            with open(os.path.join(d, key), "wb") as f:
                f.write(a.tobytes())
            tree[str((name,))] = {
                "key_metadata": [{"key": name, "key_type": 2}],
                "value_metadata": {"value_type": "np.ndarray",
                                   "skip_deserialize": False}}
        with open(os.path.join(tmp, "_METADATA"), "w") as f:
            json.dump({"tree_metadata": tree, "use_ocdbt": False,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": _HANDLER, "metrics": {},
                       "performance_metrics": {},
                       "init_timestamp_nsecs": t0,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        os.rename(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path
