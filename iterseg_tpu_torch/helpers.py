"""File discovery, logging, lazy image stacks, and the CSV and TIFF
writers of the training and evaluation paths.

The port's own copy of ``iterseg_tpu/helpers.py`` (``LINE``, ``write_log``,
``log_dir_or_None``, ``get_files``, ``get_paths``, ``_read_any``,
``get_ids``, ``check_ids_match``, ``LazyImageStack``, ``get_regex_images``,
``get_data_by_id``, ``get_dataset``, ``get_dataset_segs``), plus two
writers so that training and evaluation need neither pandas nor PIL:

- ``write_csv`` / ``read_csv``: the text layout of ``DataFrame.to_csv``
  (an unnamed index column, minimal quoting, floats as ``repr``, NaN as an
  empty field) and the column types ``pandas.read_csv`` would infer;
- ``write_tiff`` / ``read_tiff``: uncompressed, baseline, multi-page
  float32 TIFFs, one strip a page, readable by PIL as mode ``F``.

``_read_any`` reads TIFFs through PIL when it is installed, as JAX does, and
otherwise through ``read_baseline_tiff`` (uncompressed baseline TIFFs of
8/16/32-bit integers or 32-bit floats, either byte order, any strips).
"""
from __future__ import annotations

import csv
import math
import os
import re
import struct
from pathlib import Path

import numpy as np

LINE = "-" * 60

__all__ = [
    "LINE",
    "get_files",
    "get_paths",
    "write_log",
    "log_dir_or_None",
    "get_ids",
    "check_ids_match",
    "get_regex_images",
    "LazyImageStack",
    "get_data_by_id",
    "get_dataset",
    "get_dataset_segs",
    "write_csv",
    "read_csv",
    "write_tiff",
    "read_tiff",
    "read_baseline_tiff",
]


def get_files(
    data_dir,
    x_regex=r"\d{6}_\d{6}_\d{1,3}_image.tif",
    y_regex=r"\d{6}_\d{6}_\d{1,3}_labels.tif",
):
    x_paths = get_paths(data_dir, regex=x_regex)
    y_paths = get_paths(data_dir, regex=y_regex)
    m = "There is a mismatch in the number of images and training labels"
    assert len(x_paths) == len(y_paths), m
    return x_paths, y_paths


def get_paths(data_dir, regex=r"\d{6}_\d{6}_\d{1,3}_output.tif"):
    files = os.listdir(data_dir)
    pattern = re.compile(regex)
    paths = []
    for f in files:
        match = pattern.search(f)
        if match is not None:
            paths.append(os.path.join(data_dir, match[0]))
    return paths


def write_log(string, out_dir, log_name="log.txt"):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, log_name), "a") as log:
        log.write(string + "\n")


def log_dir_or_None(log, out_dir):
    return out_dir if log else None


def _read_any(path):
    """A zarr store, or a TIFF: through PIL when it can be imported, as the
    JAX package reads it, else through ``read_baseline_tiff``."""
    path = str(path)
    if path.endswith((".zarr", ".zar")):
        from .io.zarr_io import zarr_open

        return np.asarray(zarr_open(path))
    try:
        from PIL import Image
    except ImportError:
        frames = read_baseline_tiff(path)
    else:
        im = Image.open(path)
        frames = []
        try:
            while True:
                frames.append(np.array(im))
                im.seek(im.tell() + 1)
        except EOFError:
            pass
    arr = np.stack(frames) if len(frames) > 1 else frames[0]
    return np.squeeze(arr)


_TIFF_TYPES = {1: "B", 3: "H", 4: "I"}  # BYTE, SHORT, LONG
_TIFF_SAMPLE = {(1, 8): "u1", (1, 16): "u2", (1, 32): "u4", (2, 8): "i1",
                (2, 16): "i2", (2, 32): "i4", (3, 32): "f4"}
_TIFF_COMPRESSION = {2: "CCITT RLE", 3: "CCITT G3", 4: "CCITT G4", 5: "LZW",
                     6: "old JPEG", 7: "JPEG", 8: "Deflate", 32773: "PackBits",
                     32946: "Deflate", 50000: "ZSTD"}


def read_baseline_tiff(path):
    """The pages of an uncompressed baseline grayscale TIFF as a list of
    (y, x) numpy arrays in native byte order: little- or big-endian, one or
    many strips a page, 8/16/32-bit unsigned or signed integers and 32-bit
    floats. Raises ``ValueError`` for compressed or tiled files and other
    layouts."""
    with open(path, "rb") as f:
        buf = f.read()
    order = {b"II": "<", b"MM": ">"}.get(buf[:2])
    if order is None or struct.unpack_from(order + "H", buf, 2)[0] != 42:
        raise ValueError(f"{path}: not a TIFF (or a BigTIFF)")
    (off,) = struct.unpack_from(order + "I", buf, 4)
    pages = []
    while off:
        (n,) = struct.unpack_from(order + "H", buf, off)
        tags = {}
        for k in range(n):
            tag, typ, count = struct.unpack_from(order + "HHI", buf,
                                                 off + 2 + 12 * k)
            if typ not in _TIFF_TYPES:
                continue
            fmt = _TIFF_TYPES[typ]
            size = struct.calcsize(fmt) * count
            at = off + 10 + 12 * k
            if size > 4:
                (at,) = struct.unpack_from(order + "I", buf, at)
            tags[tag] = struct.unpack_from(f"{order}{count}{fmt}", buf, at)
        pages.append(_tiff_page(buf, order, tags, path))
        (off,) = struct.unpack_from(order + "I", buf, off + 2 + 12 * n)
    return pages


def _tiff_page(buf, order, tags, path):
    comp = tags.get(259, (1,))[0]
    if comp != 1:
        name = _TIFF_COMPRESSION.get(comp, "unknown")
        raise ValueError(f"{path}: compressed TIFF (compression tag 259 = "
                         f"{comp}, {name}); only uncompressed files are "
                         "read without PIL")
    if 322 in tags or 324 in tags:
        raise ValueError(f"{path}: tiled TIFF; only strips are read")
    if tags.get(277, (1,))[0] != 1:
        raise ValueError(f"{path}: several samples a pixel")
    bits, fmt = set(tags.get(258, (1,))), set(tags.get(339, (1,)))
    key = (min(fmt), min(bits))
    if len(bits) != 1 or len(fmt) != 1 or key not in _TIFF_SAMPLE:
        raise ValueError(f"{path}: unsupported sample layout "
                         f"(bits {tags.get(258)}, format {tags.get(339)})")
    h, w = tags[257][0], tags[256][0]
    dtype = np.dtype(order + _TIFF_SAMPLE[key])
    need = h * w * dtype.itemsize
    counts = tags.get(279)
    if counts is None:  # one strip without a byte count
        counts = (need,)
    data = b"".join(bytes(buf[o:o + c]) for o, c in zip(tags[273], counts))
    if len(data) < need:
        raise ValueError(f"{path}: strips hold {len(data)} bytes, the page "
                         f"needs {need}")
    page = np.frombuffer(data, dtype, h * w).reshape(h, w)
    return page.astype(dtype.newbyteorder("="))


def get_ids(paths, regex=r"\d{6}_\d{6}_\d{1,3}"):
    pattern = re.compile(regex)
    ids = []
    for p in paths:
        name = Path(p).stem
        match = pattern.search(name)
        if match is None:
            raise ValueError(
                "Irregular ID for training data file: must be "
                "YYMMDD_HHMMSS_<digit>"
            )
        ids.append(match[0])
    return ids


def check_ids_match(x, y, regex=r"\d{6}_\d{6}_\d{1,3}"):
    pattern = re.compile(regex)
    assert len(x) == len(y)
    for i in range(len(x)):
        if not os.path.exists(x[i]):
            assert x[i] == y[i]
        else:
            xid = pattern.search(Path(x[i]).stem)[0]
            yid = pattern.search(Path(y[i]).stem)[0]
            assert xid == yid


class LazyImageStack:
    """Stack of same-shape images read on demand (dask-stack equivalent,
    parity: helpers.py:157-180)."""

    def __init__(self, paths):
        self.paths = list(paths)
        sample = _read_any(self.paths[0])
        self.frame_shape = sample.shape
        self.dtype = sample.dtype
        self._cache = {0: sample}

    @property
    def shape(self):
        return (len(self.paths),) + self.frame_shape

    @property
    def ndim(self):
        return 1 + len(self.frame_shape)

    def __len__(self):
        return len(self.paths)

    def _stack_all(self):
        # ragged frames zero-pad to the common shape on materialisation —
        # the same contract as the eager path (widgets.correct_shape)
        from .widgets import correct_shape

        return np.stack(correct_shape([self[j]
                                       for j in range(len(self))]))

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            i = int(i) % len(self.paths)
            if i not in self._cache:
                self._cache[i] = np.squeeze(_read_any(self.paths[i]))
            return self._cache[i]
        return self._stack_all()[i]

    def __array__(self, dtype=None, copy=None):
        arr = self._stack_all()
        return arr.astype(dtype) if dtype is not None else arr


def get_regex_images(data_dir, regex, ids, id_regex=r"\d{6}_\d{6}_\d{1,3}"):
    """ID-ordered lazy image stack (parity: helpers.py:157-180)."""
    id_pattern = re.compile(id_regex)
    file_paths = sorted(get_paths(data_dir, regex))
    correct_paths = []
    for ID in ids:
        id_done = False
        for f in file_paths:
            n = Path(f).stem
            if id_pattern.search(n)[0] == ID:
                correct_paths.append(f)
                id_done = True
        assert id_done, f"No file match was found for ID: {ID}"
    return LazyImageStack(correct_paths)


_ID_REGEX = r"\d{6}_\d{6}_\d{1,3}"


def _run_ids_from_outputs(out_dir, validation):
    """Run IDs discovered from the train loop's saved prediction files
    (``<id>_output.tif`` / ``<id>_validation_output.tif``) — these anchor
    which runs a dataset directory contains."""
    suffix = "_validation_output.tif" if validation else "_output.tif"
    return get_ids(sorted(get_paths(out_dir, _ID_REGEX + suffix)))


def get_data_by_id(train_dir, suffixes, out_dir=None, validation=False):
    """One lazy stack per suffix, frames ordered by the run IDs of the
    prediction files in ``out_dir`` (behaviour parity: reference
    helpers.py:137-154)."""
    ids = _run_ids_from_outputs(out_dir or train_dir, validation)
    return tuple(
        get_regex_images(train_dir, _ID_REGEX + s, ids) for s in suffixes
    )


def get_dataset(train_dir, out_dir=None, GT=False, validation=False,
                return_ID=False):
    """Training-run stacks matched by run ID (behaviour parity: reference
    helpers.py:95-127).

    Observable-order note: the reference's implementation crosses its
    ``labs``/``images`` bindings, so its first returned stack is the
    ``_labels.tif`` one and its second the ``_image.tif`` one despite the
    variable names. Callers depend on what it *does*, so this port keeps
    that order: ``(labels, image, output[, GT][, ids])``.
    """
    out_dir = out_dir or train_dir
    o_s = "_validation_output.tif" if validation else "_output.tif"
    suffixes = ["_image.tif", "_labels.tif", o_s] + (
        ["_GT.tif"] if GT else []
    )
    # one directory scan: the same id list orders the stacks and is what
    # return_ID hands back (a second scan could disagree if files land
    # between listings)
    ids = _run_ids_from_outputs(out_dir, validation)
    stacks = {
        s: get_regex_images(train_dir, _ID_REGEX + s, ids) for s in suffixes
    }
    ordered = [stacks["_labels.tif"], stacks["_image.tif"], stacks[o_s]]
    if GT:
        ordered.append(stacks["_GT.tif"])
    if return_ID:
        ordered.append(ids)
    return tuple(ordered)


def get_dataset_segs(train_dir, out_dir=None, validation=True):
    """(GT, segmentation, DoG-segmentation, image) stacks by run ID
    (behaviour parity: reference helpers.py:130-134)."""
    return get_data_by_id(
        train_dir,
        ("_GT.tif", "_segmentation.tif", "_DoG-segmentation.tif",
         "_image.tif"),
        out_dir=out_dir, validation=validation,
    )


# ---------------------------------------------------------------------------
# CSV in the layout of DataFrame.to_csv
# ---------------------------------------------------------------------------

_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?"
                    r"|[+-]?(inf|Inf|INF|infinity|Infinity)|nan|NaN|NAN")


def _is_missing(v):
    return v is None or (isinstance(v, (float, np.floating))
                         and math.isnan(v))


def _is_int(v):
    return isinstance(v, (int, np.integer)) and not isinstance(
        v, (bool, np.bool_))


def _column_text(values):
    """One column's fields as ``to_csv`` writes its dtype: int64 as ints,
    float64 (ints and floats, or ints with a gap) as ``repr`` floats,
    object as ``str``; a missing value is an empty field."""
    present = [v for v in values if not _is_missing(v)]
    if all(_is_int(v) for v in present) and len(present) == len(values):
        return [str(int(v)) for v in values]
    if all(_is_int(v) or isinstance(v, (float, np.floating))
           for v in present):
        return ["" if _is_missing(v) else repr(float(v)) for v in values]
    return ["" if _is_missing(v) else str(v) for v in values]


def write_csv(path, columns, index=None):
    """``pd.DataFrame(columns).to_csv(path)``: ``columns`` maps each name to
    a list of values (int, float, str, or None for missing); ``index``
    defaults to 0..n-1."""
    names = list(columns)
    n = len(columns[names[0]]) if names else 0
    index = list(range(n)) if index is None else list(index)
    texts = [_column_text(list(columns[c])) for c in names]
    if any(len(t) != n for t in texts) or len(index) != n:
        raise ValueError("write_csv: columns and index differ in length")
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + names)
        for i in range(n):
            w.writerow([str(index[i])] + [t[i] for t in texts])


def _header_names(header):
    """``pandas.read_csv`` column names: an empty name is ``Unnamed: i``;
    a repeated name becomes ``name.1``, ``name.2``..., the given names
    keeping theirs before the unnamed ones are mangled."""
    names = [h if h else f"Unnamed: {i}" for i, h in enumerate(header)]
    unnamed = [i for i, h in enumerate(header) if not h]
    counts = {}
    for i in [i for i in range(len(names)) if i not in unnamed] + unnamed:
        col = old = names[i]
        cur = counts.get(col, 0)
        if cur > 0:
            while cur > 0:
                counts[old] = cur + 1
                col = f"{old}.{cur}"
                cur = cur + 1 if col in names else counts.get(col, 0)
            names[i] = col
        counts[col] = cur + 1
    return names


def _parse_column(fields):
    """A column as ``pandas.read_csv`` would type it: ints when every field
    is an int, floats when every present field is a number (an empty field
    is NaN), else strings (an empty field is missing)."""
    present = [f for f in fields if f != ""]
    if present and len(present) == len(fields) and all(
            _INT.fullmatch(f) for f in fields):
        return [int(f) for f in fields]
    if all(_FLOAT.fullmatch(f) for f in present):
        return [float(f) if f != "" else None for f in fields]
    return [f if f != "" else None for f in fields]


def read_csv(path):
    """The columns of a CSV as ``pandas.read_csv(path)`` gives them (no
    index column: the first column of a ``to_csv`` file is ``Unnamed: 0``),
    as a dict of lists."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    names = _header_names(rows[0])
    body = rows[1:]
    return {name: _parse_column([r[j] if j < len(r) else "" for r in body])
            for j, name in enumerate(names)}


# ---------------------------------------------------------------------------
# Baseline multi-page float32 TIFF
# ---------------------------------------------------------------------------

_SHORT, _LONG = 3, 4
_TAGS = (256, 257, 258, 259, 262, 273, 277, 278, 279, 284, 339)


def write_tiff(path, planes):
    """Write ``planes`` (any array whose last two axes are (y, x); the
    leading axes are flattened into the page sequence) as an uncompressed
    little-endian baseline TIFF of 32-bit float pages, one strip a page."""
    arr = np.ascontiguousarray(np.asarray(planes, dtype="<f4"))
    h, w = arr.shape[-2:]
    pages = arr.reshape((-1, h, w))
    n_entries = len(_TAGS)
    ifd_bytes = 2 + 12 * n_entries + 4
    page_bytes = h * w * 4
    stride = ifd_bytes + page_bytes + (-(ifd_bytes + page_bytes) % 4)
    if 8 + stride * len(pages) >= 2 ** 32:
        raise ValueError("write_tiff: the file would exceed 4 GiB")
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, 8))
        for i, page in enumerate(pages):
            ifd = 8 + i * stride
            data = ifd + ifd_bytes
            nxt = ifd + stride if i + 1 < len(pages) else 0
            values = {256: (_LONG, w), 257: (_LONG, h), 258: (_SHORT, 32),
                      259: (_SHORT, 1), 262: (_SHORT, 1),
                      273: (_LONG, data), 277: (_SHORT, 1),
                      278: (_LONG, h), 279: (_LONG, page_bytes),
                      284: (_SHORT, 1), 339: (_SHORT, 3)}
            f.write(struct.pack("<H", n_entries))
            for tag in _TAGS:
                typ, v = values[tag]
                if typ == _SHORT:
                    f.write(struct.pack("<HHIHH", tag, typ, 1, v, 0))
                else:
                    f.write(struct.pack("<HHII", tag, typ, 1, v))
            f.write(struct.pack("<I", nxt))
            f.write(page.tobytes())
            f.write(b"\0" * (stride - ifd_bytes - page_bytes))


def read_tiff(path):
    """The (pages, y, x) float32 array of a TIFF that ``write_tiff``
    wrote. Raises ``ValueError`` on any other layout."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"II*\0":
        raise ValueError(f"{path}: not a little-endian TIFF")
    (off,) = struct.unpack_from("<I", buf, 4)
    pages = []
    while off:
        (n,) = struct.unpack_from("<H", buf, off)
        tags = {}
        for k in range(n):
            tag, typ, count, raw = struct.unpack_from(
                "<HHI4s", buf, off + 2 + 12 * k)
            if count != 1 or typ not in (_SHORT, _LONG):
                raise ValueError(f"{path}: tag {tag} is not one value")
            fmt = "<H" if typ == _SHORT else "<I"
            tags[tag] = struct.unpack_from(fmt, raw)[0]
        if (tags.get(258), tags.get(259), tags.get(339), tags.get(277)) != (
                32, 1, 3, 1):
            raise ValueError(f"{path}: not uncompressed float32 pages")
        h, w = tags[257], tags[256]
        start = tags[273]
        pages.append(np.frombuffer(buf, "<f4", h * w, start).reshape(h, w))
        (off,) = struct.unpack_from("<I", buf, off + 2 + 12 * n)
    return np.stack(pages).astype(np.float32)
