"""Zarr / OME-Zarr volume I/O on the tensorstore C++ driver.

Replaces the reference's zarr/ome-zarr/dask stack (iterseg ``_io.py``) with
tensorstore (its own optional fast path, ``_io.py:8-13,325-386``) as the
primary backend: async C++ chunk I/O feeding the device pipeline, no Python
chunk loops.  Mirroring the reference's graceful degradation
(``_io.py:8-13,373-385``), hosts without tensorstore fall back to the
bundled pure-NumPy zarr v2 driver (``io/zarr_mini.py``: zlib-compressed
stores, readable by tensorstore/zarr-python) with a one-time warning;
``ITERSEG_TPU_NO_TENSORSTORE=1`` forces the fallback for testing.

API parity surface: ``open_zarr``, ``save_labels_to_ome``, ``load_ome_zarr``,
``ome_metadata``, ``is_ome_labels``, ``ome_to_napari``, ``napari_to_ome``,
``get_napari_reader`` plus ``zarr_save``/``zarr_open`` convenience twins of
``zarr.save``/``zarr.open``.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Optional

import numpy as np

try:
    import tensorstore as ts
except ImportError:  # pragma: no cover - this image ships tensorstore
    ts = None

_WARNED_FALLBACK = []


def _backend():
    """The active backend: tensorstore, or the mini driver (warn once,
    like the reference's zarr fallback)."""
    if ts is not None and not os.environ.get("ITERSEG_TPU_NO_TENSORSTORE"):
        return ts
    if not _WARNED_FALLBACK:
        import warnings

        warnings.warn(
            "tensorstore is not available: falling back to the bundled "
            "pure-python zarr driver (slower; writes zlib-compressed "
            "zarr v2). Install tensorstore for production I/O.",
            RuntimeWarning, stacklevel=3,
        )
        _WARNED_FALLBACK.append(True)
    return None

__all__ = [
    "ZarrArray",
    "open_zarr",
    "zarr_save",
    "zarr_open",
    "save_labels_to_ome",
    "add_pyramid_levels",
    "load_ome_zarr",
    "ome_metadata",
    "is_ome_labels",
    "ome_to_napari",
    "napari_to_ome",
    "get_napari_reader",
]


class ZarrArray:
    """Thin numpy-style adapter over a TensorStore array.

    Reads return numpy arrays; writes are blocking. Keeps the downstream
    code (chunked writeback, warm-restart scans) backend-agnostic.
    """

    def __init__(self, store: ts.TensorStore, path: Optional[str] = None):
        self._ts = store
        self.path = path

    @property
    def shape(self):
        return tuple(self._ts.shape)

    @property
    def dtype(self):
        return np.dtype(self._ts.dtype.numpy_dtype)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def chunks(self):
        return tuple(self._ts.chunk_layout.read_chunk.shape or ())

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, sl):
        return np.asarray(self._ts[sl].read().result())

    def __setitem__(self, sl, value):
        self._ts[sl].write(np.asarray(value)).result()

    def write_async(self, sl, value):
        """Non-blocking write; returns a future (overlaps with compute)."""
        return self._ts[sl].write(np.asarray(value))

    def __array__(self, dtype=None, copy=None):
        arr = self[...]
        return arr.astype(dtype) if dtype is not None else arr

    @property
    def store(self):
        return self._ts


def _spec(path, shape=None, chunks=None, dtype=None, create=False):
    spec = {
        "driver": "zarr",
        "kvstore": {"driver": "file", "path": str(path)},
    }
    if create:
        metadata = {
            "shape": list(shape),
            "dtype": np.dtype(dtype).str,
            "compressor": {"id": "blosc", "cname": "zstd", "clevel": 3,
                           "shuffle": 2},
        }
        if chunks is not None:
            metadata["chunks"] = [int(c) for c in chunks]
        spec["metadata"] = metadata
    return spec


def open_zarr(labels_file, *, shape=None, chunks=None, dtype=np.uint32):
    """Open a zarr array, creating it (zero-filled) if absent.

    Parity with iterseg ``_io.py:325-386`` (which prefers tensorstore when
    available; here it is always tensorstore).
    """
    path = str(labels_file)
    exists = os.path.exists(os.path.join(path, ".zarray"))
    backend = _backend()
    if backend is None:
        from . import zarr_mini

        if not exists:
            if shape is None:
                raise ValueError(
                    f"no zarr at {path} and no shape to create one"
                )
            return zarr_mini.create(path, shape, chunks=chunks, dtype=dtype)
        return zarr_mini.open_array(path)
    if not exists:
        if shape is None:
            raise ValueError(f"no zarr at {path} and no shape to create one")
        store = backend.open(
            _spec(path, shape, chunks, dtype, create=True),
            create=True,
            open=True,
        ).result()
    else:
        store = backend.open(_spec(path), open=True).result()
    return ZarrArray(store, path)


def zarr_save(path, data):
    """``zarr.save`` twin: write a whole array to ``path``."""
    data = np.asarray(data)
    chunks = (1,) * max(0, data.ndim - 3) + data.shape[-3:] if data.ndim else None
    arr = open_zarr(path, shape=data.shape, chunks=chunks, dtype=data.dtype)
    arr[...] = data
    return arr


def zarr_open(path, mode="a"):
    """``zarr.open`` twin (mode accepted for compatibility, unused)."""
    p = str(path)
    if os.path.exists(os.path.join(p, "0", ".zarray")) and not os.path.exists(
        os.path.join(p, ".zarray")
    ):
        # ome-zarr root: open highest resolution
        return open_zarr(os.path.join(p, "0"))
    return open_zarr(p)


# ---------------------------------------------------------------------------
# OME-Zarr (NGFF v0.4) metadata
# ---------------------------------------------------------------------------


def napari_to_ome(layer_meta: dict) -> dict:
    """Layer meta {scale, translate, name} → OME multiscales metadata.

    Axes are assumed tzyx/zyx/yx with µm/s units (iterseg ``_io.py:99-135``).
    """
    scale = list(map(float, layer_meta["scale"]))
    translate = list(map(float, layer_meta["translate"]))
    ndim = len(scale)
    axes = [
        {"name": "t", "type": "time", "unit": "second"},
        {"name": "z", "type": "space", "unit": "micrometer"},
        {"name": "y", "type": "space", "unit": "micrometer"},
        {"name": "x", "type": "space", "unit": "micrometer"},
    ][-ndim:]
    coordtfs = [
        {"type": "scale", "scale": scale},
        {"type": "translate", "translate": translate},
    ]
    datasets = [{"coordinateTransformations": coordtfs, "path": "0"}]
    return {"datasets": datasets, "axes": axes, "name": layer_meta["name"]}


def save_labels_to_ome(path, data=None, layer_meta=None, shape=None,
                       chunks=None, dtype=np.uint32):
    """Create an OME-Zarr labels store (iterseg ``_io.py:142-166``)."""
    path = pathlib.Path(path)
    if data is None and (shape is None or chunks is None):
        raise ValueError("either data or shape/chunks must be provided")
    os.makedirs(path, exist_ok=True)
    ome_meta = napari_to_ome(layer_meta)
    attrs = {
        "image-label": {},
        "multiscales": [
            {
                "version": "0.4",
                "name": ome_meta["name"],
                "axes": ome_meta["axes"],
                "datasets": ome_meta["datasets"],
            }
        ],
    }
    with open(path / ".zgroup", "w") as f:
        json.dump({"zarr_format": 2}, f)
    with open(path / ".zattrs", "w") as f:
        json.dump(attrs, f, indent=2)
    if data is not None:
        shape = data.shape
        dtype = data.dtype
        if chunks is None and hasattr(data, "chunks"):
            chunks = data.chunks
        elif chunks is None:
            chunks = (1,) * (len(shape) - 2) + tuple(shape[-2:])
    arr = open_zarr(path / "0", shape=shape, chunks=chunks, dtype=dtype)
    if data is not None:
        arr[...] = np.asarray(data)
    return arr


def _downsample_2x_yx(a, method):
    """Halve the last two axes: ``nearest`` = stride view (exact label
    subsampling, NGFF's convention for label pyramids), ``mean`` =
    2x2 block mean (images). Odd trailing rows/cols are cropped (floor
    semantics, matching common NGFF scalers). Host numpy on purpose:
    downsampling is memory-bound, so shipping the volume to the device
    costs more than the op (the transfer-budget rule,
    engine/device_pipeline.py)."""
    y, x = a.shape[-2] // 2, a.shape[-1] // 2
    a = a[..., : y * 2, : x * 2]
    if method == "nearest":
        return np.ascontiguousarray(a[..., ::2, ::2])
    blocks = a.reshape(a.shape[:-2] + (y, 2, x, 2))
    return blocks.mean(axis=(-3, -1), dtype=np.float64).astype(a.dtype)


def add_pyramid_levels(path, n_levels=2, method=None, min_yx=32):
    """Append NGFF multiscale levels to an existing OME-Zarr store.

    TPU-native extension beyond the reference (its writer is
    single-scale, ``_io.py:142-166``; its *reader* already consumes
    multiscale images — parity kept by ``load_ome_zarr``): level ``L+1``
    halves level ``L`` in y/x, with the datasets' scale transformations
    doubled accordingly (z/t scales untouched — anisotropic microscopy
    pyramids downsample in-plane only). Labels stores default to
    ``nearest`` (a stride view of the exact level-0 labels — level 0
    stays the source of truth, so warm restart and proofreading are
    unaffected); image stores default to ``mean``.

    Stops early once y or x would drop below ``min_yx`` (or at
    ``1 + n_levels`` total levels). Idempotent: a store already at the
    target depth is untouched, a shallower one only gains the missing
    levels. 4D stacks downsample one frame at a time (the stores are
    chunked one-frame-per-chunk), so host RAM stays O(frame) — the same
    budget as the serve loop. Returns the list of level paths.
    """
    path = pathlib.Path(path)
    meta = ome_metadata(path)
    ms = meta["multiscales"][0]
    ds = ms["datasets"]
    if method is None:
        method = "nearest" if is_ome_labels(meta) else "mean"
    target = 1 + int(n_levels)
    while len(ds) < target:
        prev = open_zarr(path / ds[-1]["path"])
        if min(prev.shape[-2:]) < 2 * int(min_yx):
            break
        lvl = len(ds)
        y2, x2 = prev.shape[-2] // 2, prev.shape[-1] // 2
        nxt_shape = prev.shape[:-2] + (y2, x2)
        arr = open_zarr(
            path / str(lvl), shape=nxt_shape,
            chunks=tuple(min(c, s) for c, s in
                         zip((1,) * (len(nxt_shape) - 2) + nxt_shape[-2:],
                             nxt_shape)),
            dtype=prev.dtype,
        )
        if len(nxt_shape) >= 4:
            for t in range(nxt_shape[0]):  # O(frame) RAM, not O(stack)
                arr[t] = _downsample_2x_yx(np.asarray(prev[t]), method)
        else:
            arr[...] = _downsample_2x_yx(np.asarray(prev[...]), method)
        tfs = []
        for tf in ds[-1].get("coordinateTransformations", []):
            tf = dict(tf)
            if tf.get("type") == "scale":
                s = list(map(float, tf["scale"]))
                s[-1] *= 2.0
                s[-2] *= 2.0
                tf["scale"] = s
            tfs.append(tf)
        ds.append({"coordinateTransformations": tfs, "path": str(lvl)})
        with open(path / ".zattrs", "w") as f:
            json.dump(meta, f, indent=2)
    return [d["path"] for d in ds]


def ome_metadata(path) -> dict:
    with open(pathlib.Path(path) / ".zattrs") as f:
        return json.load(f)


def is_ome_labels(ome_meta: dict) -> bool:
    return "image-label" in ome_meta


def _get_scale(ome_meta):
    axes = ome_meta["multiscales"][0]["axes"]
    non_channel = [i for i, ax in enumerate(axes) if ax["type"] != "channel"]
    default = np.ones(len(axes))
    ds = ome_meta["multiscales"][0]["datasets"][0]
    scale = default
    if "coordinateTransformations" in ds:
        scales = [d["scale"] for d in ds["coordinateTransformations"]
                  if d["type"] == "scale"]
        if scales:
            scale = np.multiply.reduce(scales)
    return scale[non_channel]


def _get_translate(ome_meta):
    axes = ome_meta["multiscales"][0]["axes"]
    non_channel = [i for i, ax in enumerate(axes) if ax["type"] != "channel"]
    default = np.zeros(len(axes))
    ds = ome_meta["multiscales"][0]["datasets"][0]
    translate = default
    if "coordinateTransformations" in ds:
        translates = [d["translation"] for d in ds["coordinateTransformations"]
                      if d["type"] == "translation"]
        if translates:
            translate = np.add.reduce(translates)
    return translate[non_channel]


def _get_contrast(ome_meta):
    """Contrast limits/ranges from the omero channel windows
    (reference semantics: iterseg ``_io.py:211-232``).

    Deviation (fix, PARITY.md L0): the reference appends raw
    ``ch.get('window', None)`` entries, so its all-or-none length guard
    is dead code (the list length always equals the channel count) and
    any channel without a window crashes with ``TypeError`` on
    ``'start' in None``. Filtering the Nones first makes the guard live
    (mixed metadata raises the intended ValueError) and the no-window
    case graceful."""
    contrast_limits = None
    contrast_range = None
    channels = ome_meta.get("omero", {}).get("channels")
    if channels:
        windows = [ch.get("window", None) for ch in channels]
        windows = [w for w in windows if w is not None]
        if 0 < len(windows) < len(channels):
            raise ValueError(
                "Either all or no channels should have window/contrast "
                "limits metadata"
            )
        if windows:
            contrast_limits = [(w["start"], w["end"]) for w in windows
                               if "start" in w and "end" in w]
            contrast_range = [(w["min"], w["max"]) for w in windows
                              if "min" in w and "max" in w]
    return contrast_limits, contrast_range


def _validate_colormap(cmap_str: str) -> str:
    """Prefix bare hex colormaps with '#' (iterseg ``_io.py:234-241``)."""
    import string as _string

    if (all(c in _string.hexdigits for c in cmap_str)
            and not cmap_str.startswith("#")):
        return "#" + cmap_str
    return cmap_str


def _get_channel_info(ome_meta):
    """Names, colormaps and visibility for all channels
    (reference semantics: iterseg ``_io.py:244-274``); each list is either
    complete or empty (partial per-channel metadata raises)."""
    names, colormaps, visibles = [], [], []
    channels = ome_meta.get("omero", {}).get("channels")
    if channels:
        names = [ch["label"] for ch in channels if "label" in ch]
        colormaps = [_validate_colormap(ch["color"]) for ch in channels
                     if "color" in ch]
        visibles = [ch["active"] for ch in channels if "active" in ch]
        for vals, what in ((names, "names"), (colormaps, "color"),
                           (visibles, "visibility")):
            if 0 < len(vals) < len(channels):
                raise ValueError(
                    f"Either all or no channels should have {what} metadata"
                )
    return names, colormaps, visibles


def _unwrap(arglist, channel_axis):
    """Single-channel images take the scalar, not a 1-list
    (iterseg ``_io.py:276-281``)."""
    if channel_axis is None and arglist is not None and len(arglist) > 0:
        return arglist[0]
    return arglist


def ome_to_napari(ome_meta: dict):
    """OME dict → (napari-style layer kwargs, layer_type).

    Image layers additionally recover the omero channel metadata the
    reference reader returns (``_io.py:284-321``): contrast limits,
    channel names, colormaps and visibility. Deviation (documented):
    when no omero channel names exist the reference passes ``name=[]``;
    here ``name`` falls back to the multiscales name instead.
    """
    layer_type = "labels" if is_ome_labels(ome_meta) else "image"
    axes = ome_meta["multiscales"][0]["axes"]
    meta = {
        "scale": _get_scale(ome_meta),
        "translate": _get_translate(ome_meta),
        "metadata": {"axes": axes},
    }
    if layer_type == "image":
        try:
            channel_axis = [i for i, ax in enumerate(axes)
                            if ax["type"] == "channel"][0]
        except IndexError:
            channel_axis = None
        contrast_limits, _ = _get_contrast(ome_meta)
        names, colormaps, visibles = _get_channel_info(ome_meta)
        meta["channel_axis"] = channel_axis
        meta["contrast_limits"] = _unwrap(contrast_limits, channel_axis)
        meta["name"] = (_unwrap(names, channel_axis) or
                        ome_meta["multiscales"][0].get("name"))
        meta["colormap"] = _unwrap(colormaps, channel_axis)
        meta["visible"] = _unwrap(visibles, channel_axis)
    return meta, layer_type


def load_ome_zarr(path):
    """Read an OME-Zarr image/labels store → [(data, meta, layer_type)]."""
    path = pathlib.Path(path)
    ome_meta = ome_metadata(path)
    layer_meta, layer_type = ome_to_napari(ome_meta)
    ds = ome_meta["multiscales"][0]["datasets"]
    if layer_type == "image" and len(ds) > 1:
        data = [open_zarr(path / d["path"]) for d in ds]
    else:
        data = open_zarr(path / ds[0]["path"])
    return [(data, layer_meta, layer_type)]


def get_napari_reader(path):
    if str(path).endswith("ome.zarr"):
        return load_ome_zarr
    return None
