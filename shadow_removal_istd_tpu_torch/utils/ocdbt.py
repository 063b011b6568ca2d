"""OCDBT, the key-value store under orbax checkpoints: a reader and a
one-version writer, in Python over ``utils/zstd.py``.

An OCDBT database is a directory: ``manifest.ocdbt`` at its root and data
files under ``d/`` (a multi-process JAX save adds ``ocdbt.process_<i>/``
databases, whose data files the root's b-tree references by their paths).
Every manifest and b-tree node file is framed the same way::

    magic (u32 big-endian: 0x0cdb3a2a manifest, 0x0cdb20de b-tree node)
    length (u64 little-endian, the whole file) · version (varint, 0)
    compression (varint: 0 none, 1 zstd) · body · CRC-32C (u32 LE)

Value data files hold the values' bytes back to back, unframed. Integers
in a body are varints (LEB128) unless said otherwise, and arrays of
records are stored column by column.

* Manifest body: the config (uuid[16], manifest kind (0 = single),
  max inline value bytes, max decoded node bytes, version tree arity log2
  (byte), compression (0, or 1 followed by the zstd level as an i32 LE)),
  a data file table, the newest versions (generation, root height
  (byte), root file id, offset, length, num keys, num tree bytes, num
  indirect value bytes, commit time (u64 LE)), then references to version
  tree nodes (generation, file id, offset, length, num generations,
  commit time, height) that hold the older versions. The newest version
  is always among the manifest's own, so the reader takes the highest
  generation there and never reads a version tree node.
* Data file table: count, common-prefix length with the previous path
  (count - 1 of them), suffix lengths, base path lengths, then the
  suffixes; a path is relative to the database root.
* B-tree node body: height (byte), a data file table, the entry count,
  key prefix lengths (count - 1, shared with the previous key), key suffix
  lengths, then for an interior node the subtree common prefix lengths,
  then the key suffixes. A leaf follows with value lengths, value kinds (0
  inline, 1 indirect), the indirect values' file ids and offsets, and the
  inline values back to back. An interior node follows with each child's
  file id, offset, length, num keys, num tree bytes and num indirect value
  bytes; a child's keys omit its subtree common prefix.

Each file's magic, length and checksum are checked, and a body must be
consumed exactly; anything else raises :class:`OcdbtError`.

:func:`write` writes one version into a fresh directory: the manifest
(orbax's config: 1024 inline bytes, 100 MB nodes, single manifest, zstd
level 0), one leaf node under ``d/`` holding every key, and one value data
file for the values too large to inline. Its files carry compression
byte 0 (uncompressed): tensorstore reads any file by its own compression
byte whatever the config says, and nothing is gained by wrapping the
bodies in raw zstd frames.
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from collections.abc import Mapping

from shadow_removal_istd_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MAX_INLINE = 1024
MAX_NODE_BYTES = 100_000_000
_U64_MAX = (1 << 64) - 1


class OcdbtError(ValueError):
    """A database the reader refuses: bad magic, length, checksum or
    structure."""


def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the files' trailers carry it."""
    c = 0xFFFFFFFF
    table = _CRC
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ----------------------------------------------------------- byte readers


class _Body:
    def __init__(self, data: bytes, what: str):
        self.d = data
        self.i = 0
        self.what = what

    def fail(self, msg: str):
        raise OcdbtError(f"{self.what}: {msg}")

    def varint(self) -> int:
        v = shift = 0
        while True:
            if self.i >= len(self.d):
                self.fail("truncated varint")
            c = self.d[self.i]
            self.i += 1
            v |= (c & 0x7F) << shift
            shift += 7
            if c < 0x80:
                return v
            if shift > 63:
                self.fail("varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.d):
            self.fail("truncated")
        out = self.d[self.i:self.i + n]
        self.i += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def u64s(self, n: int) -> list[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def end(self) -> None:
        if self.i != len(self.d):
            self.fail(f"{len(self.d) - self.i} bytes after the end")


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _unframe(data: bytes, magic: int, what: str) -> bytes:
    """The body of a framed file, its header and checksum checked."""
    if len(data) < 18:
        raise OcdbtError(f"{what}: {len(data)} bytes is too short")
    got = struct.unpack(">I", data[:4])[0]
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    (length,) = struct.unpack("<Q", data[4:12])
    if length != len(data):
        raise OcdbtError(f"{what}: header says {length} bytes, has "
                         f"{len(data)}")
    (crc,) = struct.unpack("<I", data[-4:])
    if crc32c(data[:-4]) != crc:
        raise OcdbtError(f"{what}: checksum mismatch")
    head = _Body(data[12:-4], what)
    if head.varint() != 0:
        head.fail("unknown format version")
    comp = head.varint()
    body = data[12 + head.i:-4]
    if comp == 0:
        return body
    if comp == 1:
        return zstd.decompress(body)
    raise OcdbtError(f"{what}: unknown compression {comp}")


def _frame(body: bytes, magic: int) -> bytes:
    """A framed file around ``body``, uncompressed."""
    head = struct.pack(">I", magic)
    rest = _varint(0) + _varint(0) + body
    data = head + struct.pack("<Q", 12 + len(rest) + 4) + rest
    return data + struct.pack("<I", crc32c(data))


def _read_table(b: _Body) -> list[str]:
    n = b.varint()
    prefix = [0] + b.varints(n - 1) if n else []
    suffix = b.varints(n)
    base = b.varints(n)
    paths, prev = [], b""
    for k in range(n):
        if prefix[k] > len(prev) or base[k] > prefix[k] + suffix[k]:
            b.fail("bad data file table")
        path = prev[:prefix[k]] + b.take(suffix[k])
        paths.append(path.decode())
        prev = path
    return paths


def _write_table(paths: list[str]) -> bytes:
    raw = [p.encode() for p in paths]
    prefix = [os.path.commonprefix([a, b]).__len__()
              for a, b in zip(raw, raw[1:])]
    out = [_varint(len(raw))]
    out += [_varint(p) for p in prefix]
    out += [_varint(len(r) - p) for r, p in zip(raw, [0] + prefix)]
    out += [_varint(0) for _ in raw]
    out += [r[p:] for r, p in zip(raw, [0] + prefix)]
    return b"".join(out)


def _read_keys(b: _Body, n: int, interior: bool):
    prefix = [0] + b.varints(n - 1) if n else []
    suffix = b.varints(n)
    common = b.varints(n) if interior else None
    keys, prev = [], b""
    for k in range(n):
        if prefix[k] > len(prev):
            b.fail("bad key prefix")
        key = prev[:prefix[k]] + b.take(suffix[k])
        keys.append(key)
        prev = key
    return keys, common


# ----------------------------------------------------------------- reader


class Reader:
    """The newest version of the database at ``root``: :meth:`keys`,
    :meth:`get`, :meth:`items`. Values stay in their files until read."""

    def __init__(self, root: str):
        self.root = os.fspath(root)
        data = self._read_file("manifest.ocdbt", 0, None)
        b = _Body(_unframe(data, MANIFEST_MAGIC, "manifest.ocdbt"),
                  "manifest.ocdbt")
        b.take(16)                     # the database's uuid
        if b.varint() != 0:
            b.fail("only the single-file manifest kind is supported")
        b.varints(2)                   # max inline value, max node bytes
        b.byte()                       # version tree arity log2
        comp = b.varint()
        if comp == 1:
            b.take(4)                  # the zstd level, an i32
        elif comp != 0:
            b.fail(f"unknown compression {comp}")
        files = _read_table(b)
        n = b.varint()
        gen = b.varints(n)
        height = list(b.take(n))
        fid, off, length = b.varints(n), b.varints(n), b.varints(n)
        b.varints(3 * n)               # num keys, tree bytes, indirect bytes
        b.u64s(n)                      # commit times
        m = b.varint()                 # version tree node references
        b.varints(m)
        ref_fid = b.varints(m)
        b.varints(3 * m)
        b.u64s(m)
        b.take(m)
        b.end()
        if any(f >= len(files) for f in fid + ref_fid):
            b.fail("data file id out of range")
        if not n:
            b.fail("no version")
        k = max(range(n), key=gen.__getitem__)
        self.generation = gen[k]
        self._entries: dict[bytes, object] = {}
        if length[k] != _U64_MAX:      # else the empty initial version
            self._walk(files[fid[k]], off[k], length[k], height[k], b"")

    def _read_file(self, rel: str, offset: int, length: int | None) -> bytes:
        path = os.path.join(self.root, rel)
        if os.path.isabs(rel) or ".." in rel.split("/"):
            raise OcdbtError(f"data file path {rel!r} leaves the database")
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read() if length is None else f.read(length)
        if length is not None and len(data) != length:
            raise OcdbtError(f"{rel}: {len(data)} bytes at {offset}, "
                             f"expected {length}")
        return data

    def _walk(self, rel: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        what = f"{rel}@{offset}"
        b = _Body(_unframe(self._read_file(rel, offset, length), NODE_MAGIC,
                           what), what)
        if b.byte() != height:
            b.fail(f"node height does not match its reference ({height})")
        files = _read_table(b)
        n = b.varint()
        keys, common = _read_keys(b, n, height > 0)
        if height > 0:
            fid, off, ln = b.varints(n), b.varints(n), b.varints(n)
            b.varints(3 * n)
            b.end()
            for k in range(n):
                if fid[k] >= len(files) or common[k] > len(keys[k]):
                    b.fail("bad child reference")
                self._walk(files[fid[k]], off[k], ln[k], height - 1,
                           prefix + keys[k][:common[k]])
            return
        lengths = b.varints(n)
        kinds = b.varints(n)
        indirect = [k for k in range(n) if kinds[k] == 1]
        if any(v > 1 for v in kinds):
            b.fail("unknown value kind")
        fid, off = b.varints(len(indirect)), b.varints(len(indirect))
        refs = dict(zip(indirect, zip(fid, off)))
        for k in range(n):
            if k in refs:
                f, o = refs[k]
                if f >= len(files):
                    b.fail("data file id out of range")
                value = (files[f], o, lengths[k])
            else:
                value = b.take(lengths[k])
            self._entries[prefix + keys[k]] = value
        b.end()

    def keys(self) -> list[str]:
        return sorted(k.decode() for k in self._entries)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._entries

    def get(self, key: str) -> bytes:
        """The value of ``key``; raises ``KeyError`` when absent."""
        value = self._entries[key.encode()]
        if isinstance(value, tuple):
            return self._read_file(*value)
        return value

    def items(self):
        for k in self.keys():
            yield k, self.get(k)


# ----------------------------------------------------------------- writer


def write(root: str, items: Mapping[str, bytes]) -> None:
    """Write ``items`` as the one version of a new database at ``root``
    (created; must not hold a manifest yet). Values over
    :data:`MAX_INLINE` bytes go to one value data file under ``d/``."""
    root = os.fspath(root)
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    if os.path.exists(os.path.join(root, "manifest.ocdbt")):
        raise FileExistsError(f"{root} already holds an OCDBT database")
    entries = sorted((k.encode(), v) for k, v in items.items())
    value_file = f"d/{uuid.uuid4().hex}"
    node_file = f"d/{uuid.uuid4().hex}"
    big = [(k, v) for k, v in entries if len(v) > MAX_INLINE]
    offsets, pos = {}, 0
    if big:
        with open(os.path.join(root, value_file), "wb") as f:
            for k, v in big:
                offsets[k] = pos
                f.write(v)
                pos += len(v)
    keys = [k for k, _ in entries]
    prefix = [len(os.path.commonprefix([a, b]))
              for a, b in zip(keys, keys[1:])]
    body = [bytes([0]), _write_table([value_file] if big else []),
            _varint(len(keys))]
    body += [_varint(p) for p in prefix]
    body += [_varint(len(k) - p) for k, p in zip(keys, [0] + prefix)]
    body += [k[p:] for k, p in zip(keys, [0] + prefix)]
    body += [_varint(len(v)) for _, v in entries]
    body += [_varint(int(k in offsets)) for k in keys]
    body += [_varint(0) for k in keys if k in offsets]
    body += [_varint(offsets[k]) for k in keys if k in offsets]
    body += [v for k, v in entries if k not in offsets]
    body = b"".join(body)
    if len(body) > MAX_NODE_BYTES:
        raise ValueError(f"{len(keys)} keys need {len(body)} bytes in one "
                         f"node, over {MAX_NODE_BYTES}")
    node = _frame(body, NODE_MAGIC)
    with open(os.path.join(root, node_file), "wb") as f:
        f.write(node)
    config = (uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE)
              + _varint(MAX_NODE_BYTES) + bytes([4]) + _varint(1)
              + struct.pack("<i", 0))
    version = (_varint(1) + _varint(1) + bytes([0]) + _varint(0)
               + _varint(0) + _varint(len(node)) + _varint(len(keys))
               + _varint(len(node)) + _varint(pos)
               + struct.pack("<Q", time.time_ns()))
    manifest = _frame(config + _write_table([node_file]) + version
                      + _varint(0), MANIFEST_MAGIC)
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(manifest)
