"""A read-only OCDBT key-value store: the database orbax writes checkpoints
into, read with numpy and the port's C++ zstd decoder (``native/zstd.py``).

OCDBT ("optionally-cooperative distributed B+tree") is tensorstore's
key-value format. ``OcdbtReader(dir).list()`` gives every key in order and
``read(key)`` its value, as tensorstore's ``ocdbt`` driver over
``file://dir`` does. Anything this module cannot read raises ``ValueError``
naming the file and the byte offset.

The layout, as found byte by byte against tensorstore 0.1.80 and the
checkpoints orbax-checkpoint 0.11.32 writes (all integers little-endian;
"varint" is LEB128, 7 bits a byte, low group first; ``x[n]`` is a column of
n values, each column written whole before the next):

**Files.** An orbax checkpoint directory holds a root database
(``manifest.ocdbt`` and ``d/<32 hex>``) and one database a writing process
(``ocdbt.process_<i>/manifest.ocdbt`` and ``ocdbt.process_<i>/d/*``). The
root's tree points into the processes' data files, so only the root
manifest is read. Every manifest and node is an envelope:

* bytes 0-3: magic, big-endian: ``0c db 3a 2a`` manifest, ``0c db 20 de``
  B-tree node;
* bytes 4-11: u64, the envelope's own length;
* varint format version (0), varint compression (0 none, 1 zstd);
* the body, one zstd frame when compressed (orbax's always are);
* the last 4 bytes: CRC-32C of everything before them.

A data file under ``d/`` holds envelopes and raw values back to back; a
node or value is named by (data file, offset, length).

**Data-file table** (heads the manifest and every node): varint n;
varint ``prefix[n-1]`` (bytes shared with the previous path); varint
``suffix_len[n]``; varint ``base_len[n]``; the suffixes. Path i is
``path[i-1][:prefix[i]] + suffix[i]``, its first ``base_len[i]`` bytes a base
directory. Paths are relative to the base of the file that holds the table
(the root directory for the manifest), and a node inherits as its base the
base of the entry that named its file: the root's leaves name
``ocdbt.process_0/`` + ``d/<hex>``.

**Manifest body.** Config: 16-byte uuid; varint manifest kind (0 single;
1 numbered, which this reader refuses); varint max inline value bytes
(orbax: 1024); varint max decoded node bytes (orbax: 100,000,000); u8
version-tree arity log2; varint compression (1 zstd, then an i32 level).
Then the data-file table; the newest versions: varint n, varint
``generation[n]``, u8 ``root_height[n]``, varint ``file[n]``, ``offset[n]``,
``length[n]`` (the root node), varint ``num_keys[n]``, ``tree_bytes[n]``,
``indirect_bytes[n]``, u64 ``commit_time[n]`` (ns); and the older versions'
subtrees: varint m, varint ``generation[m]``, ``file[m]``, ``offset[m]``,
``length[m]``, ``num_generations[m]``, u64 ``commit_time[m]``, u8
``height[m]``. The last version is the one read. An empty tree has root
offset and length 2^64-1.

**B-tree node body.** u8 height; the data-file table; varint n; varint
``key_prefix[n-1]`` (bytes shared with the previous key); varint
``key_suffix_len[n]``; for an interior node (height > 0) varint
``subtree_prefix[n]``; the key suffixes. A leaf then has varint
``value_len[n]``, varint ``kind[n]`` (0 inline, 1 in a data file), for the k
indirect values varint ``file[k]`` then ``offset[k]``, and the inline values
back to back. An interior node has varint ``file[n]``, ``offset[n]``,
``length[n]`` (the child), ``num_keys[n]``, ``tree_bytes[n]``,
``indirect_bytes[n]``. Entry i of an interior node is the child whose keys
start at key i; the first ``subtree_prefix[i]`` bytes of key i are common to
that subtree and left out of the child's keys.

**Version-tree node body** (magic ``0c db 12 34``; older versions only,
never read here, since the newest version is in the manifest): u8 arity
log2, u8 height, the data-file table, varint n and the manifest's version
columns (height 0) or subtree columns without the height column.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple, Union

from ..native import zstd

__all__ = ["OcdbtReader"]

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1
_ENVELOPE_MIN = 4 + 8 + 1 + 1 + 4


class _Cursor:
    """Reads the fields of one decoded body; errors name the file and the
    offset in the decoded body."""

    def __init__(self, buf: bytes, where: str):
        self.buf = buf
        self.pos = 0
        self.where = where

    def fail(self, what: str):
        raise ValueError(f"OCDBT {self.where}: decoded byte {self.pos}: {what}")

    def varint(self) -> int:
        v = shift = 0
        while True:
            if self.pos >= len(self.buf):
                self.fail("truncated varint")
            b = self.buf[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            self.fail(f"truncated: {n} bytes wanted")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8s(self, n: int) -> List[int]:
        return list(self.take(n))

    def u64s(self, n: int) -> List[int]:
        return [int.from_bytes(self.take(8), "little") for _ in range(n)]

    def end(self):
        if self.pos != len(self.buf):
            self.fail(f"{len(self.buf) - self.pos} bytes left over")


def _unwrap(buf: bytes, magic: int, where: str) -> bytes:
    """The body of one envelope (checked magic, length, version and CRC)."""
    if len(buf) < _ENVELOPE_MIN:
        raise ValueError(f"OCDBT {where}: byte 0: {len(buf)} bytes is too "
                         "short for a header and footer")
    got = int.from_bytes(buf[:4], "big")
    if got != magic:
        raise ValueError(f"OCDBT {where}: byte 0: magic {got:08x}, "
                         f"expected {magic:08x}")
    length = int.from_bytes(buf[4:12], "little")
    if length != len(buf):
        raise ValueError(f"OCDBT {where}: byte 4: length field {length}, "
                         f"but the envelope has {len(buf)} bytes")
    crc = int.from_bytes(buf[-4:], "little")
    if zstd.crc32c(buf[:-4]) != crc:
        raise ValueError(f"OCDBT {where}: byte {len(buf) - 4}: CRC-32C "
                         "mismatch")
    head = _Cursor(buf[:-4], where)
    head.pos = 12
    version = head.varint()
    if version != 0:
        raise ValueError(f"OCDBT {where}: byte 12: format version {version}")
    compression = head.varint()
    body = buf[head.pos:-4]
    if compression == 0:
        return bytes(body)
    if compression == 1:
        try:
            return zstd.decompress(body).tobytes()
        except ValueError as e:
            raise ValueError(f"OCDBT {where}: byte {head.pos}: {e}") from None
    raise ValueError(f"OCDBT {where}: byte 13: compression {compression}")


# A data file as (directory base, path below the database root).
_File = Tuple[str, str]


def _file_table(c: _Cursor, base: str) -> List[_File]:
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix_len = c.varints(n)
    base_len = c.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            c.fail(f"data file {i} shares {prefix[i]} bytes of a "
                   f"{len(prev)}-byte path")
        path = prev[:prefix[i]] + c.take(suffix_len[i])
        if base_len[i] > len(path):
            c.fail(f"data file {i}: base of {base_len[i]} bytes")
        text = path.decode()
        files.append((base + text[:base_len[i]], base + text))
        prev = path
    return files


def _pick(c: _Cursor, files: List[_File], i: int) -> _File:
    if i >= len(files):
        c.fail(f"data file {i} of a {len(files)}-file table")
    return files[i]


# A located value or node: (data file, offset, length).
_Ref = Tuple[_File, int, int]


class OcdbtReader:
    """Read-only view of the OCDBT database in directory ``root``."""

    def __init__(self, root: Union[str, os.PathLike]):
        self.root = os.path.abspath(os.fspath(root))
        self._index: Optional[Dict[bytes, Union[bytes, _Ref]]] = None
        buf = self._bytes("manifest.ocdbt")
        c = _Cursor(_unwrap(buf, MANIFEST_MAGIC, self._name("manifest.ocdbt")),
                    self._name("manifest.ocdbt"))
        c.take(16)                                   # uuid
        kind = c.varint()
        if kind != 0:
            c.fail(f"manifest kind {kind} (numbered manifests are not read)")
        c.varint(), c.varint()                       # inline, node limits
        c.u8s(1)                                     # version-tree arity
        if c.varint() == 1:
            c.take(4)                                # zstd level
        files = _file_table(c, "")
        n = c.varint()
        gen = c.varints(n)
        height = c.u8s(n)
        fid, off, length = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)                             # key, byte statistics
        c.u64s(n)                                    # commit times
        m = c.varint()
        c.varints(5 * m)                             # older subtrees
        c.u64s(m)
        c.u8s(m)
        c.end()
        if any(b <= a for a, b in zip(gen, gen[1:])):
            c.fail(f"generations {gen} are not increasing")
        self._root: Optional[Tuple[int, _Ref]] = None
        if n and off[-1] != _MISSING:
            self._root = (height[-1], (_pick(c, files, fid[-1]), off[-1],
                                       length[-1]))

    def _name(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def _bytes(self, rel: str, offset: int = 0, length: int = -1) -> bytes:
        path = self._name(rel)
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read() if length < 0 else f.read(length)
        except OSError as e:
            raise ValueError(f"OCDBT {path}: cannot read: {e}") from None
        if length >= 0 and len(data) != length:
            raise ValueError(f"OCDBT {path}: byte {offset}: {length} bytes "
                             f"wanted, {len(data)} found")
        return data

    def _node(self, ref: _Ref, height: int, prefix: bytes, out: dict):
        (base, rel), offset, length = ref
        where = f"{self._name(rel)} at byte {offset}"
        c = _Cursor(_unwrap(self._bytes(rel, offset, length), NODE_MAGIC,
                            where), where)
        got = c.u8s(1)[0]
        if got != height:
            c.fail(f"node height {got}, its parent says {height}")
        files = _file_table(c, base)
        n = c.varint()
        shared = [0] + c.varints(n - 1) if n else []
        suffix_len = c.varints(n)
        subtree = c.varints(n) if height else []
        keys, prev = [], b""
        for i in range(n):
            if shared[i] > len(prev):
                c.fail(f"key {i} shares {shared[i]} bytes of a "
                       f"{len(prev)}-byte key")
            prev = prev[:shared[i]] + c.take(suffix_len[i])
            keys.append(prev)
        if height:
            fid, off, length = c.varints(n), c.varints(n), c.varints(n)
            c.varints(3 * n)                         # key, byte statistics
            c.end()
            for i in range(n):
                if subtree[i] > len(keys[i]):
                    c.fail(f"entry {i}: subtree prefix of {subtree[i]} bytes")
                child = (_pick(c, files, fid[i]), off[i], length[i])
                self._node(child, height - 1, prefix + keys[i][:subtree[i]],
                           out)
            return
        value_len = c.varints(n)
        kind = c.varints(n)
        if any(k > 1 for k in kind):
            c.fail(f"value kinds {sorted(set(kind))}: only 0 and 1 exist")
        k = sum(kind)
        fid, off = c.varints(k), c.varints(k)
        j = 0
        for i in range(n):
            if kind[i]:
                out[prefix + keys[i]] = (_pick(c, files, fid[j]), off[j],
                                         value_len[i])
                j += 1
            else:
                out[prefix + keys[i]] = c.take(value_len[i])
        c.end()

    def _entries(self) -> Dict[bytes, Union[bytes, _Ref]]:
        if self._index is None:
            out: Dict[bytes, Union[bytes, _Ref]] = {}
            if self._root is not None:
                self._node(self._root[1], self._root[0], b"", out)
            self._index = out
        return self._index

    def list(self) -> List[bytes]:
        """Every key, in order."""
        return sorted(self._entries())

    def read(self, key: Union[str, bytes]) -> Optional[bytes]:
        """The value stored under ``key``, or None when there is none."""
        if isinstance(key, str):
            key = key.encode()
        v = self._entries().get(key)
        if v is None or isinstance(v, bytes):
            return v
        (_, rel), offset, length = v
        return self._bytes(rel, offset, length)
