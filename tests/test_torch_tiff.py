"""The port's TIFF reading without PIL (``helpers.read_baseline_tiff``, the
path ``_read_any`` takes when PIL cannot be imported) against PIL itself,
on files PIL writes: uint8, uint16 (both byte orders) and float32, one and
several pages, one and several strips a page. A big-endian float32 file,
which PIL does not write, is written here by hand and read by both. A
compressed file raises ``ValueError`` naming its compression."""
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from iterseg_tpu_torch import helpers


def pil_pages(path):
    im = Image.open(path)
    pages = []
    try:
        while True:
            pages.append(np.array(im))
            im.seek(im.tell() + 1)
    except EOFError:
        pass
    return pages


def write_pil(path, pages, rows_per_strip=None):
    ims = [Image.fromarray(p) for p in pages]
    kw = {} if rows_per_strip is None else {"tiffinfo": {278: rows_per_strip}}
    ims[0].save(path, save_all=len(ims) > 1, append_images=ims[1:], **kw)


def planes(dtype, n_pages, seed=0):
    r = np.random.default_rng(seed)
    a = r.random((n_pages, 37, 53)) * 250
    if np.dtype(dtype).kind == "f":
        a = a - 100
    elif np.dtype(dtype).itemsize > 1:
        a = a * 250
    return a.astype(dtype)


def no_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


def assert_same(got, want):
    assert got.dtype.kind == want.dtype.kind
    assert got.dtype.itemsize == want.dtype.itemsize
    assert got.dtype.isnative
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows_per_strip", [None, 5], ids=["one_strip",
                                                          "strips"])
@pytest.mark.parametrize("n_pages", [1, 3])
@pytest.mark.parametrize("dtype", ["u1", "<u2", ">u2", "<f4"])
def test_reader_equals_pil(tmp_path, monkeypatch, dtype, n_pages,
                           rows_per_strip):
    path = str(tmp_path / "a.tif")
    write_pil(path, planes(dtype, n_pages), rows_per_strip)
    with open(path, "rb") as f:
        assert f.read(2) == (b"MM" if dtype == ">u2" else b"II")
    want = pil_pages(path)
    got = helpers.read_baseline_tiff(path)
    assert len(got) == len(want) == n_pages
    for g, w in zip(got, want):
        assert_same(g, w)
    with_pil = helpers._read_any(path)
    no_pil(monkeypatch)
    without = helpers._read_any(path)
    assert_same(without, with_pil)
    assert without.shape == ((37, 53) if n_pages == 1 else (n_pages, 37, 53))


def write_big_endian_f32(path, pages, rows_per_strip):
    """Uncompressed big-endian float32 pages, ``rows_per_strip`` rows a
    strip; the byte counts of the several strips sit outside the IFD."""
    n, h, w = pages.shape
    strips = -(-h // rows_per_strip)
    out = bytearray(b"MM" + struct.pack(">HI", 42, 0))
    prev = 4  # where the offset of the next IFD goes
    for page in pages.astype(">f4"):
        offsets = []
        for s in range(strips):
            offsets.append(len(out))
            out += page[s * rows_per_strip:(s + 1) * rows_per_strip].tobytes()
        counts = [min(rows_per_strip, h - s * rows_per_strip) * w * 4
                  for s in range(strips)]
        arrays = len(out)
        out += struct.pack(f">{strips}I", *offsets)
        out += struct.pack(f">{strips}I", *counts)
        entries = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 32),
                   (259, 3, 1, 1), (262, 3, 1, 1), (273, 4, strips, arrays),
                   (277, 3, 1, 1), (278, 4, 1, rows_per_strip),
                   (279, 4, strips, arrays + 4 * strips), (339, 3, 1, 3)]
        ifd = len(out)
        struct.pack_into(">I", out, prev, ifd)
        out += struct.pack(">H", len(entries))
        for tag, typ, count, value in entries:
            if typ == 3 and count == 1:
                out += struct.pack(">HHIHH", tag, typ, count, value, 0)
            else:
                out += struct.pack(">HHII", tag, typ, count, value)
        prev = len(out)
        out += struct.pack(">I", 0)
    with open(path, "wb") as f:
        f.write(bytes(out))


def test_big_endian_float32_equals_pil(tmp_path, monkeypatch):
    path = str(tmp_path / "be.tif")
    pages = planes("<f4", 2, seed=3)
    write_big_endian_f32(path, pages, rows_per_strip=8)
    want = pil_pages(path)
    got = helpers.read_baseline_tiff(path)
    for g, w, p in zip(got, want, pages):
        assert_same(g, w)
        np.testing.assert_array_equal(g, p)
    no_pil(monkeypatch)
    np.testing.assert_array_equal(helpers._read_any(path), pages)


@pytest.mark.parametrize("compression,tag,name", [
    ("tiff_lzw", 5, "LZW"), ("tiff_adobe_deflate", 8, "Deflate"),
    ("packbits", 32773, "PackBits")])
def test_compressed_raises_naming_it(tmp_path, monkeypatch, compression, tag,
                                     name):
    path = str(tmp_path / "c.tif")
    Image.fromarray(planes("<u2", 1)[0]).save(path, compression=compression)
    np.testing.assert_array_equal(helpers._read_any(path),
                                  planes("<u2", 1)[0])  # PIL reads it
    no_pil(monkeypatch)
    with pytest.raises(ValueError, match=f"259 = {tag}, {name}"):
        helpers._read_any(path)


def test_not_a_tiff_raises(tmp_path):
    path = tmp_path / "x.tif"
    path.write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="not a TIFF"):
        helpers.read_baseline_tiff(str(path))


def test_write_tiff_reads_back_without_pil(tmp_path, monkeypatch):
    path = str(tmp_path / "w.tif")
    pages = planes("<f4", 4, seed=9)
    helpers.write_tiff(path, pages)
    no_pil(monkeypatch)
    np.testing.assert_array_equal(helpers._read_any(path), pages)
    np.testing.assert_array_equal(helpers.read_tiff(path), pages)
