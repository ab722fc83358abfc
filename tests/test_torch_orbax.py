"""Orbax checkpoints in the port without orbax (``native/zstd.py``,
``io/ocdbt.py``, ``io/orbax_ckpt.py``, ``models/convert.py``), held against
the libraries that write them.

- The C++ zstd decoder equals ``zstandard`` on seeded data at levels -5 to
  22, with and without the content size and checksum, on frames of several
  blocks, concatenated and skippable frames; malformed input raises
  ``ValueError`` (a bounded fuzz checks that it never crashes).
- ``OcdbtReader.list()``/``read()`` equal tensorstore's ``ocdbt`` driver on
  checkpoints orbax wrote and on a database with interior nodes, indirect
  values and older versions.
- zarr v2 arrays written by tensorstore's ``zarr`` driver read back equal
  (dtypes, order C and F, zstd or none, edge and missing chunks).
- Both directions against the JAX package on the full ``default_unet.npz``,
  bit for bit; the CLI chain across both packages; the entry points that
  take a U-Net path; and a process without jax, orbax, tensorstore and
  zstandard reads the committed fixture.

The fixture ``tests/data/torch_orbax/`` was written by ``write_fixture``
with orbax's own checkpointers (``python -c "import sys; sys.path[:0] =
['tests']; import test_torch_orbax as t; t.write_fixture(
'tests/data/torch_orbax')"`` from the repo root, which needs an empty
target); ``test_committed_fixture_matches_orbax`` writes it again.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard
from scipy import ndimage as ndi

from conftest import cpu_subprocess_env
from iterseg_tpu import cli as jcli
from iterseg_tpu.models import convert as jconvert
from iterseg_tpu_torch import cli as tcli
from iterseg_tpu_torch.engine.predict import DEFAULT_UNET_PATH, load_unet
from iterseg_tpu_torch.io.ocdbt import OcdbtReader
from iterseg_tpu_torch.io.orbax_ckpt import read_orbax, write_orbax
from iterseg_tpu_torch.models import convert as tconvert
from iterseg_tpu_torch.native import zstd
from torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_orbax")
CPU = torch.device("cpu")


def assert_same(got, want):
    """Same keys, dtypes, shapes and bytes."""
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


# ------------------------------------------------------------------ zstd ---

def sample(kind, n=160_000, seed=0):
    """Seeded data of ``kind``; the default size spans two 128 KiB blocks."""
    r = np.random.default_rng(seed)
    if kind == "random":
        return r.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "constant":
        return b"\x07" * n
    if kind == "ramp":
        return (np.arange(n) % 251).astype(np.uint8).tobytes()
    if kind == "float32":
        return r.standard_normal(n // 4).astype(np.float32).tobytes()
    if kind == "text":
        words = [b"zarr", b"chunk", b"orbax", b"ocdbt", b"manifest",
                 b"weight", b"bias", b"conv", b"the", b"of"]
        return b" ".join(r.choice(words, n // 5))[:n]
    if kind == "tokens":          # one literal and a 3-byte match, repeated
        chunks = r.integers(0, 256, (300, 3), dtype=np.uint8)
        lits = r.integers(0, 256, n // 4, dtype=np.uint8)
        return np.concatenate(
            [lits[:, None], chunks[r.integers(0, 300, n // 4)]], 1).tobytes()
    raise ValueError(kind)


def n_blocks(frame):
    """The number of blocks of one zstd frame (header parsed here)."""
    fhd = frame[4]
    single, did, fcs = (fhd >> 5) & 1, fhd & 3, fhd >> 6
    pos = 5 + (0 if single else 1) + (0, 1, 2, 4)[did]
    pos += (1 if single else 0, 2, 4, 8)[fcs]
    blocks = 0
    while True:
        h = int.from_bytes(frame[pos:pos + 3], "little")
        kind, size = (h >> 1) & 3, h >> 3
        pos += 3 + (1 if kind == 1 else size)
        blocks += 1
        if h & 1:
            return blocks


@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19, 22])
@pytest.mark.parametrize("kind", ["random", "constant", "ramp", "float32",
                                  "text", "tokens"])
def test_zstd_equals_zstandard(kind, level):
    data = sample(kind)
    for size in (True, False):
        for check in (True, False):
            frame = zstandard.ZstdCompressor(
                level=level, write_content_size=size,
                write_checksum=check).compress(data)
            want = zstandard.ZstdDecompressor().decompress(
                frame, max_output_size=len(data))
            assert want == data
            assert zstd.decompress(frame).tobytes() == want
            assert zstd.decompress(frame, 100).tobytes() == want
    if kind in ("random", "float32", "text"):
        assert n_blocks(frame) >= 2


def test_zstd_concatenated_and_skippable_frames():
    parts = [sample(k, 70_000, seed=i) for i, k in
             enumerate(["text", "float32", "constant", "tokens"])]
    frames = [zstandard.ZstdCompressor(level=lvl, write_checksum=True,
                                       write_content_size=lvl > 2)
              .compress(p) for lvl, p in zip((1, 3, 9, 19), parts)]
    skip = [(0x184D2A50 + i).to_bytes(4, "little") + (5 * i).to_bytes(
        4, "little") + bytes(range(5 * i)) for i in range(3)]
    stream = (skip[0] + frames[0] + frames[1] + skip[1] + frames[2]
              + skip[2] + frames[3])
    want = zstandard.ZstdDecompressor().stream_reader(
        stream, read_across_frames=True).read()
    assert want == b"".join(parts)
    assert zstd.decompress(stream).tobytes() == want
    assert zstd.decompress(skip[1] + frames[0]).tobytes() == parts[0]
    assert zstd.decompress(skip[1]).tobytes() == b""


def test_zstd_rle_literals_and_long_sequence_headers():
    """A block of RLE literals (a frame built here: no encoder emits one at
    this size) and blocks of more than 32,512 sequences (3-byte count)."""
    lit = bytes([(20 << 3) | 1, 0x41, 0x00])
    frame = (bytes.fromhex("28b52ffd") + bytes([0x00, 0x00])
             + ((len(lit) << 3) | (2 << 1) | 1).to_bytes(3, "little") + lit)
    want = zstandard.ZstdDecompressor().decompressobj().decompress(frame)
    assert want == b"A" * 20
    assert zstd.decompress(frame).tobytes() == want
    data = sample("tokens", 480_000, seed=4)
    frame = zstandard.ZstdCompressor(level=19).compress(data)
    assert zstd.decompress(frame).tobytes() == data


def corrupt_cases():
    data = sample("text", 50_000)
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        data)
    bad_sum = frame[:-4] + bytes(b ^ 0xFF for b in frame[-4:])
    trained = zstandard.train_dictionary(
        1024, [sample("text", 500, seed=i) for i in range(64)])
    dict_frame = zstandard.ZstdCompressor(
        level=3, dict_data=trained).compress(data)
    reserved = frame[:4] + bytes([frame[4] | 8]) + frame[5:]
    return {
        "empty": (b"", "empty"),
        "bad-magic": (b"\x00" + frame[1:], "magic"),
        "truncated-header": (frame[:5], "truncated"),
        "truncated-block": (frame[:len(frame) // 2], "truncated"),
        "truncated-checksum": (frame[:-2], "truncated"),
        "trailing-bytes": (frame + b"\x28\xb5", "truncated"),
        "checksum": (bad_sum, "checksum"),
        "dictionary": (dict_frame, "dictionary"),
        "reserved-bit": (reserved, "reserved"),
        "skippable-truncated": (b"\x50\x2a\x4d\x18\x10\x00\x00\x00abc",
                                "skippable"),
    }


@pytest.mark.parametrize("case", sorted(corrupt_cases()))
def test_zstd_malformed_raises(case):
    data, match = corrupt_cases()[case]
    with pytest.raises(ValueError, match=match):
        zstd.decompress(data)


def test_zstd_mutations_never_crash():
    """Mutated frames either decode to what ``zstandard`` gives or raise
    ``ValueError``; the decoder runs in this process, so a crash would end
    the test run."""
    r = np.random.default_rng(5)
    frames = [zstandard.ZstdCompressor(level=lvl, write_checksum=False)
              .compress(sample(kind, 20_000)) for kind, lvl in
              (("text", 3), ("float32", 1), ("tokens", 19), ("ramp", 9))]
    bad = 0
    for frame in frames:
        for _ in range(150):
            b = bytearray(frame)
            i = int(r.integers(4, len(b)))
            b[i] ^= 1 << int(r.integers(0, 8))
            try:
                got = zstd.decompress(bytes(b)).tobytes()
            except ValueError:
                bad += 1
                continue
            want = zstandard.ZstdDecompressor().decompressobj().decompress(
                bytes(b))
            assert got == want
    assert bad > 100


def test_crc32c():
    assert zstd.crc32c(b"") == 0
    assert zstd.crc32c(b"123456789") == 0xE3069283


# ----------------------------------------------------------------- OCDBT ---

def fixture_arrays(seed=0):
    r = np.random.default_rng(seed)
    return {
        "a.weight": r.standard_normal((3, 4)).astype(np.float32),
        "b.conv": r.standard_normal((64, 32, 3, 3, 3)).astype(np.float32),
        "c.index": r.integers(-1000, 1000, (5, 7)).astype(np.int32),
        "d.const": np.full((4, 4), 2.5, np.float32),
    }


def write_fixture(path):
    """The committed fixture: the arrays through orbax's
    ``StandardCheckpointer`` (OCDBT) and ``PyTreeCheckpointHandler(
    use_ocdbt=False)`` (plain files), and the truth as ``.npz``."""
    arrays = fixture_arrays()
    path = os.path.abspath(path)
    os.makedirs(path)
    std = ocp.StandardCheckpointer()
    std.save(os.path.join(path, "ocdbt"), arrays)
    std.wait_until_finished()
    plain = ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False))
    plain.save(os.path.join(path, "plain"), args=ocp.args.PyTreeSave(arrays))
    np.savez(os.path.join(path, "truth.npz"), **arrays)


def ts_kv(path):
    return ts.KvStore.open({"driver": "ocdbt",
                            "base": "file://" + str(path)}).result()


def assert_kv_equal(path):
    kv = ts_kv(path)
    keys = sorted(kv.list().result())
    reader = OcdbtReader(path)
    assert reader.list() == keys and keys
    for k in keys:
        assert reader.read(k) == bytes(kv.read(k).result().value), k
    assert reader.read(b"no/such/key") is None


def test_ocdbt_equals_tensorstore_on_orbax_output(tmp_path):
    write_fixture(str(tmp_path / "fx"))
    assert_kv_equal(tmp_path / "fx" / "ocdbt")
    # the root's leaves point into the process database
    assert any(os.path.isdir(tmp_path / "fx" / "ocdbt" / d)
               for d in os.listdir(tmp_path / "fx" / "ocdbt")
               if d.startswith("ocdbt.process_"))


def test_ocdbt_equals_tensorstore_on_a_deep_tree(tmp_path):
    """Small nodes and inline limits: interior nodes of height > 1,
    indirect values, a deleted range and 13 versions, most of them in
    version-tree nodes."""
    r = np.random.default_rng(1)
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{tmp_path}",
        "config": {"max_decoded_node_bytes": 400,
                   "max_inline_value_bytes": 20,
                   "version_tree_arity_log2": 1}}).result()
    for _ in range(4):
        with ts.Transaction() as t:
            for _ in range(150):
                k = "%s/%05d" % (r.choice(["a", "bb", "ccc/x", "d"]),
                                 r.integers(0, 3000))
                kv.with_transaction(t).write(k, r.integers(
                    0, 256, r.integers(0, 60), dtype=np.uint8).tobytes()
                ).result()
        kv.delete_range(ts.KvStore.KeyRange("d/00500", "d/01000")).result()
    for i in range(5):
        kv.write(f"late{i}", b"v" * (10 * i)).result()
    assert_kv_equal(tmp_path)


def test_ocdbt_empty_database(tmp_path):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path}"}).result()
    kv.write("k", b"v").result()
    kv.delete_range(ts.KvStore.KeyRange("", "")).result()
    assert OcdbtReader(tmp_path).list() == []


@pytest.mark.parametrize("damage,match", [
    ("magic", "magic"), ("length", "length field"), ("crc", "CRC-32C"),
    ("short", "too short"), ("missing", "cannot read")])
def test_ocdbt_damage_raises_naming_the_file(tmp_path, damage, match):
    shutil.copytree(os.path.join(FIXTURE, "ocdbt"), tmp_path / "ck")
    path = tmp_path / "ck" / "manifest.ocdbt"
    buf = bytearray(path.read_bytes())
    if damage == "magic":
        buf[0] ^= 1
    elif damage == "length":
        buf[4] ^= 1
    elif damage == "crc":
        buf[-1] ^= 1
    elif damage == "short":
        buf = buf[:10]
    if damage == "missing":
        os.remove(path)
    else:
        path.write_bytes(bytes(buf))
    with pytest.raises(ValueError, match=match) as e:
        OcdbtReader(tmp_path / "ck")
    assert "manifest.ocdbt" in str(e.value)


def test_ocdbt_damaged_node_names_file_and_offset(tmp_path):
    shutil.copytree(os.path.join(FIXTURE, "ocdbt"), tmp_path / "ck")
    [node] = os.listdir(tmp_path / "ck" / "d")
    path = tmp_path / "ck" / "d" / node
    buf = bytearray(path.read_bytes())
    buf[20] ^= 0x40
    path.write_bytes(bytes(buf))
    with pytest.raises(ValueError, match="CRC-32C") as e:
        OcdbtReader(tmp_path / "ck").list()
    assert node in str(e.value) and "at byte 0" in str(e.value)


# ------------------------------------------------------------- zarr v2 ---

DTYPES = ["bool", "int8", "uint8", "int16", "uint16", "int32", "uint32",
          "int64", "uint64", "float16", "float32", "float64", "complex64",
          "complex128", ">f4", ">i8", "|S4", "|V3"]


def random_array(dtype, shape, r):
    dt = np.dtype(dtype)
    if dt.kind in "SV":
        return r.integers(0, 256, shape + (dt.itemsize,),
                          dtype=np.uint8).view(dt).reshape(shape)
    if dt.kind == "b":
        return r.random(shape) < 0.5
    if dt.kind in "fc":
        return (r.standard_normal(shape) * 100).astype(dt)
    info = np.iinfo(dt)
    return r.integers(info.min, info.max, shape, dtype=dt.newbyteorder("="),
                      endpoint=True).astype(dt)


def orbax_metadata(names, use_ocdbt=False, **extra):
    return {"tree_metadata": {str((n,)): {
        "key_metadata": [{"key": n, "key_type": 2}],
        "value_metadata": {"value_type": "np.ndarray",
                           "skip_deserialize": False}} for n in names},
            "use_ocdbt": use_ocdbt, "use_zarr3": False, **extra}


@pytest.mark.parametrize("compressor", [None, "zstd"])
@pytest.mark.parametrize("order", ["C", "F"])
def test_zarr_arrays_equal_tensorstore(tmp_path, order, compressor):
    """Every dtype tensorstore's zarr v2 driver writes, several chunks with
    edge chunks, one chunk never written (read as the fill value), and
    ``dimension_separator`` "/"."""
    r = np.random.default_rng(2)
    shape, chunks = (5, 7, 3), (2, 3, 2)
    want = {}
    for i, dtype in enumerate(DTYPES):
        name = f"p{i}.{dtype.strip('<>|')}"
        a = random_array(dtype, shape, r)
        meta = {"shape": list(shape), "chunks": list(chunks), "order": order,
                "dtype": np.dtype(dtype).str,
                "compressor": compressor and {"id": "zstd", "level": 3},
                "dimension_separator": "/" if i % 2 else "."}
        if a.dtype.kind in "iuf":
            meta["fill_value"] = 3
        store = ts.open({"driver": "zarr", "kvstore": {
            "driver": "file", "path": str(tmp_path / name)},
            "metadata": meta, "create": True}).result()
        if a.dtype.kind in "SV":       # an inner axis of single bytes
            store[...] = a.view(np.uint8).reshape(shape + (-1,)).view(
                "S1" if a.dtype.kind == "S" else "V1")
        else:
            store[...] = a
        missing = os.path.join(str(tmp_path / name), "0" + (
            "/0/0" if i % 2 else ".0.0"))
        os.remove(missing)
        a = a.copy()
        fill = meta.get("fill_value")
        a[:2, :3, :2] = np.zeros((), a.dtype) if fill is None else fill
        want[name] = a
    (tmp_path / "_METADATA").write_text(json.dumps(orbax_metadata(want)))
    got = read_orbax(tmp_path)
    assert list(got) == list(want)
    assert_same(got, want)


def test_zarr_dtypes_tensorstore_does_not_write(tmp_path):
    """Datetimes, timedeltas, unicode and a structured dtype, chunks
    written here with their fill values."""
    r = np.random.default_rng(3)
    want = {
        "t": r.integers(0, 10**12, (3, 4)).astype("<M8[ns]"),
        "d": r.integers(-100, 100, (3, 4)).astype("<m8[s]"),
        "u": np.array([["ab", "c", "xyz", ""]] * 3, "<U3"),
        "s": np.zeros((3, 4), [("x", "<i4"), ("y", "<f8")]),
    }
    want["s"]["x"] = r.integers(-5, 5, (3, 4))
    want["s"]["y"] = r.standard_normal((3, 4))
    fills = {"t": 7, "d": -3, "u": "zz", "s": None}
    for name, a in want.items():
        os.makedirs(tmp_path / name)
        (tmp_path / name / ".zarray").write_text(json.dumps({
            "chunks": [2, 4], "compressor": None, "dimension_separator": ".",
            "dtype": a.dtype.descr if a.dtype.fields else a.dtype.str,
            "fill_value": fills[name], "filters": None, "order": "C",
            "shape": [3, 4], "zarr_format": 2}))
        (tmp_path / name / "0.0").write_bytes(a[:2].tobytes())
        want[name] = a.copy()
        want[name][2:] = np.zeros((), a.dtype) if fills[name] is None else \
            np.array(fills[name], a.dtype)
    (tmp_path / "_METADATA").write_text(json.dumps(orbax_metadata(want)))
    assert_same(read_orbax(tmp_path), want)


@pytest.mark.parametrize("change,match", [
    ({"use_zarr3": True}, "use_zarr3"),
    ({"nested": True}, "nested"),
    ({"filters": [{"id": "delta"}]}, "filters"),
    ({"compressor": {"id": "blosc"}}, "blosc"),
    ({"order": "K"}, "order"),
    ({"zarr_format": 3}, "zarr_format"),
    ({"dtype": "|O"}, "objects"),
    ({"no_array": True}, "missing"),
    ({"no_shape": True}, "no shape"),
])
def test_orbax_layout_refusals(tmp_path, change, match):
    write_orbax({"w": np.arange(6, dtype=np.float32)}, tmp_path / "ck")
    meta_path = tmp_path / "ck" / "_METADATA"
    meta = json.loads(meta_path.read_text())
    zpath = tmp_path / "ck" / "w" / ".zarray"
    zarray = json.loads(zpath.read_text())
    if "use_zarr3" in change:
        meta["use_zarr3"] = True
    elif "nested" in change:
        meta["tree_metadata"]["('w',)"]["key_metadata"].append(
            {"key": "x", "key_type": 2})
    elif "no_array" in change:
        os.remove(zpath)
    elif "no_shape" in change:
        del zarray["shape"]
    else:
        zarray.update(change)
    meta_path.write_text(json.dumps(meta))
    if zpath.exists():
        zpath.write_text(json.dumps(zarray))
    with pytest.raises(ValueError, match=match):
        read_orbax(tmp_path / "ck")


def test_write_orbax_refuses_an_existing_path(tmp_path):
    with pytest.raises(ValueError, match="exists"):
        write_orbax({"w": np.zeros(2, np.float32)}, tmp_path)


def test_write_orbax_layout_matches_orbax(tmp_path):
    """The port writes the files orbax writes without OCDBT, and orbax's
    own ``StandardCheckpointer`` restores them."""
    arrays = dict(fixture_arrays(), scalar=np.array(2.0, np.float64),
                  flag=np.array([True, False]))
    write_orbax(arrays, tmp_path / "port")
    ref = ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False))
    ref.save(str(tmp_path / "orbax"), args=ocp.args.PyTreeSave(
        fixture_arrays()))
    for name in fixture_arrays():
        assert (sorted(os.listdir(tmp_path / "port" / name))
                == sorted(os.listdir(tmp_path / "orbax" / name)))
        p = json.loads((tmp_path / "port" / name / ".zarray").read_text())
        o = json.loads((tmp_path / "orbax" / name / ".zarray").read_text())
        assert p.pop("compressor") is None and "zstd" in str(
            o.pop("compressor"))
        assert p == o
    pm = json.loads((tmp_path / "port" / "_METADATA").read_text())
    om = json.loads((tmp_path / "orbax" / "_METADATA").read_text())
    assert set(pm) == set(om)
    for k in fixture_arrays():
        assert pm["tree_metadata"][str((k,))] == om["tree_metadata"][
            str((k,))]
    assert set(json.loads((tmp_path / "port" / "_CHECKPOINT_METADATA")
                          .read_text())) == set(json.loads(
        (tmp_path / "orbax" / "_CHECKPOINT_METADATA").read_text()))
    restored = ocp.StandardCheckpointer().restore(str(tmp_path / "port"))
    assert_same({k: np.asarray(v) for k, v in restored.items()}, arrays)
    assert_same(read_orbax(tmp_path / "port"), arrays)


# ------------------------------------------- the fixture and the U-Net ---

def test_committed_fixture_matches_orbax(tmp_path):
    """orbax writes the fixture again; the port reads the committed copy
    and the new one equal to the truth, both layouts."""
    write_fixture(str(tmp_path / "fx"))
    with np.load(os.path.join(FIXTURE, "truth.npz")) as f:
        truth = dict(f)
    assert_same(truth, fixture_arrays())
    for root in (FIXTURE, str(tmp_path / "fx")):
        for layout in ("ocdbt", "plain"):
            assert_same(tconvert.load_checkpoint(os.path.join(root, layout)),
                        truth)
    assert (OcdbtReader(os.path.join(FIXTURE, "ocdbt")).list()
            == OcdbtReader(tmp_path / "fx" / "ocdbt").list())
    assert os.path.getsize(os.path.join(FIXTURE, "ocdbt", "_METADATA")) > 0


@pytest.fixture(scope="module")
def unet_npz():
    with np.load(DEFAULT_UNET_PATH) as f:
        return dict(f)


@pytest.fixture(scope="module")
def port_unet_dir(tmp_path_factory, unet_npz):
    path = tmp_path_factory.mktemp("unet") / "orbax"
    assert tconvert.save_checkpoint_orbax(unet_npz, path) == str(path)
    return str(path)


def test_port_reads_jax_orbax_bit_for_bit(tmp_path, unet_npz):
    path = jconvert.save_checkpoint_orbax(
        jconvert.load_checkpoint(DEFAULT_UNET_PATH), tmp_path / "jax")
    assert os.path.exists(os.path.join(path, "manifest.ocdbt"))
    got = tconvert.load_checkpoint(path)
    assert len(got) == 116
    assert sum(v.size for v in got.values()) == 9_976_533
    assert_same(got, unet_npz)
    assert_same(tconvert.load_checkpoint_orbax(path), unet_npz)


def test_jax_reads_port_orbax_bit_for_bit(port_unet_dir, unet_npz):
    assert_same(jconvert.load_checkpoint(port_unet_dir), unet_npz)
    assert_same(tconvert.load_checkpoint(port_unet_dir), unet_npz)


def test_cli_chain_across_both_packages(tmp_path, capsys, unet_npz):
    """.npz -> orbax (port) -> .pt (JAX) -> orbax (JAX) -> .npz (port)."""
    steps = [(tcli, tmp_path / "port-orbax"), (jcli, tmp_path / "a.pt"),
             (jcli, tmp_path / "jax-orbax"), (tcli, tmp_path / "back.npz")]
    prev = DEFAULT_UNET_PATH
    for cli, out in steps:
        assert cli.main(["convert", "--input", str(prev),
                         "--output", str(out)]) == 0
        assert capsys.readouterr().out.strip().splitlines()[-1] == str(out)
        prev = out
    assert os.path.exists(tmp_path / "port-orbax" / "_METADATA")
    assert os.path.exists(tmp_path / "jax-orbax" / "manifest.ocdbt")
    assert_same(tconvert.load_checkpoint(prev), unet_npz)


def blobs(shape=(8, 48, 48), n=30, seed=0):
    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    for c in np.stack([r.integers(2, s - 2, size=n) for s in shape], 1):
        vol[tuple(c)] = 1.0
    vol = ndi.gaussian_filter(vol, (1, 2, 2))
    return (vol / vol.max()).astype(np.float32)


def test_entry_points_take_an_orbax_dir(tmp_path, port_unet_dir):
    """``affinity_unet_watershed(unet=<dir>)``, ``segment_data`` with a JSON
    config naming the directory, and the warm server give the labels the
    ``.npz`` gives; ``load_unet`` holds the same weights."""
    from iterseg_tpu_torch.engine.segmentation import affinity_unet_watershed
    from iterseg_tpu_torch.engine.serve import SegmentationServer
    from iterseg_tpu_torch.widgets import segment_data

    grid = dict(chunk_size=(8, 48, 48), margin=(1, 8, 8))
    vol = blobs()
    want = affinity_unet_watershed(None, vol, None, "x", DEFAULT_UNET_PATH,
                                   debug=True, devices=[CPU], **grid)
    got = affinity_unet_watershed(None, vol, None, "x", port_unet_dir,
                                  debug=True, devices=[CPU], **grid)
    assert want.max() > 0
    np.testing.assert_array_equal(got, want)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"unet": port_unet_dir}))
    np.testing.assert_array_equal(
        segment_data(None, vol, None, "w", network_or_config_file=str(cfg),
                     devices=[CPU], **grid), want)
    server = SegmentationServer(network_or_config_file=str(cfg),
                                devices=[CPU], **grid)
    served = server.segment_to(vol, str(tmp_path / "served.ome.zarr"))
    np.testing.assert_array_equal(np.asarray(served), want)
    a, b = load_unet(port_unet_dir), load_unet(DEFAULT_UNET_PATH)
    for (ka, va), (kb, vb) in zip(a.module(CPU).state_dict().items(),
                                  b.module(CPU).state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_train_unet_starts_from_an_orbax_dir(port_unet_dir):
    from iterseg_tpu_torch.models.convert import params_to_numpy
    from iterseg_tpu_torch.train.train import train_unet

    r = np.random.default_rng(6)
    x = [r.random((2, 16, 16)).astype(np.float32)]
    y = [(r.random((5, 2, 16, 16)) < 0.3).astype(np.float32)]
    nets = [train_unet(x, [], y, [], epochs=1, validate=False, weights=w,
                       device=CPU)[0]
            for w in (port_unet_dir, DEFAULT_UNET_PATH)]
    got, want = (params_to_numpy(n.module(CPU)) for n in nets)
    assert_same(got, want)


def test_loads_with_jax_orbax_tensorstore_and_zstandard_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'orbax', 'orbax.checkpoint', "
        "'tensorstore', 'zstandard'):\n"
        "    sys.modules[m] = None\n"
        "import os, numpy as np\n"
        "from iterseg_tpu_torch.models.convert import load_checkpoint\n"
        f"root = {FIXTURE!r}\n"
        "truth = dict(np.load(os.path.join(root, 'truth.npz')))\n"
        "for layout in ('ocdbt', 'plain'):\n"
        "    got = load_checkpoint(os.path.join(root, layout))\n"
        "    assert set(got) == set(truth)\n"
        "    for k in truth:\n"
        "        assert got[k].tobytes() == truth[k].tobytes(), k\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "m.split('.')[0] in ('jax', 'iterseg_tpu', 'orbax', 'tensorstore', "
        "'zstandard')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=cpu_subprocess_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
