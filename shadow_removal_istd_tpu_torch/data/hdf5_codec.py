"""HDF5 files in numpy and ``struct``, without h5py (which the card's
host lacks): the subset of the format that ``data/h5.py`` reads and
writes.

Supported, as h5py writes it for ``build_h5`` (default library bounds):

- superblock version 0 at byte 0, 8-byte offsets and lengths;
- symbol-table groups (v1 B-tree, local heap, symbol-table nodes) with
  hard links;
- version 1 object headers, with continuation blocks;
- simple (or scalar) dataspaces;
- datatypes: little-endian IEEE floats (16, 32, 64 bit), little-endian
  integers (8-64 bit, signed or not), fixed-length strings (read as
  numpy ``S<n>``) and variable-length strings, whose bytes live in the
  global heap (read as an object array of ``bytes``, as h5py does);
- contiguous storage with no filter, read with one ``np.fromfile`` at
  its offset (a row of the first axis alone for ``dataset[i]``).

Anything else raises :class:`UnsupportedHDF5`, whose message names the
feature: another superblock version, version 2 object headers,
link-message groups, soft links, shared messages, chunked, compact or
virtual layouts, any filter (deflate, shuffle, ...), external storage,
big-endian, compound, enum, array, reference or other datatypes. Wrong
bytes are never returned.

:func:`write_file` writes nested dicts of numpy arrays in that subset
(superblock v0, one symbol-table node per group); h5py opens the result
with the same names, shapes, dtypes and values. ``str`` (or object)
arrays become variable-length UTF-8 strings, ``S<n>`` arrays
fixed-length null-padded ones.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
FREE_NULL = 1            # a local heap's "no free block"
GROUP_INTERNAL_K = 16    # the library's default B-tree rank
GCOL_MIN = 4096          # the library's smallest global heap collection
GCOL_MAX_OBJECTS = 0xFFFF

# message types of a v1 object header
DATASPACE, LINK_INFO, DATATYPE, FILL, LINK, EXTERNAL, LAYOUT = (
    1, 2, 3, 5, 6, 7, 8)
FILTERS, CONTINUATION, SYMBOL_TABLE = 11, 16, 17

# IEEE little-endian floats by size: (bit field, bit offset, precision,
# exponent location, exponent size, mantissa location, mantissa size,
# exponent bias)
_IEEE = {2: (0x0F20, 0, 16, 10, 5, 0, 10, 15),
         4: (0x1F20, 0, 32, 23, 8, 0, 23, 127),
         8: (0x3F20, 0, 64, 52, 11, 0, 52, 1023)}
_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum", 10: "array"}
_LAYOUT_NAMES = {0: "compact", 2: "chunked", 3: "virtual"}
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
                 5: "nbit", 6: "scaleoffset"}
_VLEN_REF = np.dtype([("n", "<u4"), ("heap", "<u8"), ("index", "<u4")])


class UnsupportedHDF5(ValueError):
    """The file uses an HDF5 feature outside this codec's subset."""

    def __init__(self, path: str, feature: str):
        super().__init__(f"{path}: unsupported HDF5 feature: {feature}")
        self.feature = feature


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class File:
    """An HDF5 file opened for reading; ``file[name]`` is a
    :class:`Group` or a :class:`Dataset` of the root group."""

    def __init__(self, path: str):
        self.path = str(path)
        self._f = open(self.path, "rb")
        self._heaps: dict[int, dict[int, bytes]] = {}
        try:
            self.root = Group(self, "/", self._superblock())
        except BaseException:
            self._f.close()
            raise

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __getitem__(self, name: str):
        return self.root[name]

    def __contains__(self, name: str) -> bool:
        return name in self.root

    def keys(self) -> list[str]:
        return self.root.keys()

    # -------------------------------------------------------- low level
    def unsupported(self, feature: str) -> UnsupportedHDF5:
        return UnsupportedHDF5(self.path, feature)

    def read(self, addr: int, n: int) -> bytes:
        self._f.seek(addr)
        b = self._f.read(n)
        if len(b) != n:
            raise ValueError(f"{self.path}: truncated: {n} bytes at "
                             f"{addr}, {len(b)} there")
        return b

    def read_array(self, addr: int, dtype: np.dtype, count: int
                   ) -> np.ndarray:
        self._f.seek(addr)
        a = np.fromfile(self._f, dtype=dtype, count=count)
        if a.size != count:
            raise ValueError(f"{self.path}: truncated: {count} x {dtype} "
                             f"at {addr}, {a.size} there")
        return a

    def _superblock(self) -> int:
        """Check the superblock; the root group's object header."""
        b = self.read(0, 96) if self._size() >= 96 else b""
        if b[:8] != SIGNATURE:
            raise ValueError(f"{self.path}: not an HDF5 file (no signature "
                             "at byte 0)")
        if b[8] != 0:
            raise self.unsupported(f"superblock version {b[8]}")
        if (b[13], b[14]) != (8, 8):
            raise self.unsupported(f"{b[13]}-byte offsets and {b[14]}-byte "
                                   "lengths")
        base, _, _, vfd_info = struct.unpack_from("<4Q", b, 24)
        if base != 0:
            raise self.unsupported(f"base address {base}")
        if vfd_info != UNDEF:
            raise self.unsupported("file-layer (VFD) information block")
        return struct.unpack_from("<Q", b, 64)[0]

    def _size(self) -> int:
        self._f.seek(0, 2)
        return self._f.tell()

    def messages(self, addr: int) -> list[tuple[int, int, bytes]]:
        """(type, flags, body) of a v1 object header's messages."""
        h = self.read(addr, 16)
        if h[:4] == b"OHDR":
            raise self.unsupported("version 2 object header")
        if h[0] != 1:
            raise self.unsupported(f"object header version {h[0]}")
        n_msgs = struct.unpack_from("<H", h, 2)[0]
        size = struct.unpack_from("<I", h, 8)[0]
        blocks, out = [(addr + 16, size)], []
        while blocks and len(out) < n_msgs:
            start, length = blocks.pop(0)
            data = self.read(start, length)
            p = 0
            while p + 8 <= length and len(out) < n_msgs:
                mtype, msize, mflags = struct.unpack_from("<HHB", data, p)
                body = data[p + 8:p + 8 + msize]
                p += 8 + msize
                if mflags & 0x02:
                    raise self.unsupported(f"shared message (type {mtype})")
                if mtype == CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", body))
                out.append((mtype, mflags, body))
        return out

    def symbol_table(self, btree: int, heap: int) -> dict[str, int]:
        """Link name -> object header address of a symbol-table group."""
        h = self.read(heap, 32)
        if h[:4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap}")
        seg_size, _, seg_addr = struct.unpack_from("<3Q", h, 8)
        names = self.read(seg_addr, seg_size)
        links = {}
        for snod in self._btree_children(btree):
            s = self.read(snod, 8)
            if s[:4] != b"SNOD":
                raise ValueError(f"{self.path}: no symbol table node at "
                                 f"{snod}")
            n = struct.unpack_from("<H", s, 6)[0]
            entries = self.read(snod + 8, 40 * n)
            for i in range(n):
                name_off, obj, cache = struct.unpack_from("<QQI", entries,
                                                          40 * i)
                if cache == 2:
                    raise self.unsupported("soft link")
                end = names.index(b"\0", name_off)
                links[names[name_off:end].decode()] = obj
        return links

    def _btree_children(self, addr: int) -> list[int]:
        """The symbol-table nodes under a group B-tree node."""
        h = self.read(addr, 24)
        if h[:4] != b"TREE" or h[4] != 0:
            raise ValueError(f"{self.path}: no group B-tree node at {addr}")
        level, used = h[5], struct.unpack_from("<H", h, 6)[0]
        body = self.read(addr + 24, 16 * used + 8)
        kids = [struct.unpack_from("<Q", body, 8 + 16 * i)[0]
                for i in range(used)]
        if level == 0:
            return kids
        return [s for k in kids for s in self._btree_children(k)]

    def heap_object(self, addr: int, index: int) -> bytes:
        """Object ``index`` of the global heap collection at ``addr``."""
        if addr not in self._heaps:
            h = self.read(addr, 16)
            if h[:4] != b"GCOL":
                raise ValueError(f"{self.path}: no global heap collection "
                                 f"at {addr}")
            size = struct.unpack_from("<Q", h, 8)[0]
            data = self.read(addr, size)
            objs, p = {}, 16
            while p + 16 <= size:
                idx, _, _, osize = struct.unpack_from("<HHIQ", data, p)
                if idx == 0:          # the free space closes the list
                    break
                objs[idx] = data[p + 16:p + 16 + osize]
                p += 16 + _pad8(osize)
            self._heaps[addr] = objs
        return self._heaps[addr][index]


class Group:
    """A symbol-table group: ``keys()``, ``name in group``,
    ``group[name]`` (a ``/``-separated path descends)."""

    def __init__(self, file: File, name: str, addr: int,
                 msgs: list | None = None):
        self.file, self.name = file, name
        msgs = file.messages(addr) if msgs is None else msgs
        tables = [b for t, _, b in msgs if t == SYMBOL_TABLE]
        if not tables:
            raise file.unsupported(f"link-message group ({name})")
        self._links = file.symbol_table(*struct.unpack_from("<QQ",
                                                            tables[0]))

    def keys(self) -> list[str]:
        return list(self._links)

    def __contains__(self, name: str) -> bool:
        head, _, rest = name.strip("/").partition("/")
        if head not in self._links:
            return False
        return not rest or rest in self[head]

    def __getitem__(self, name: str):
        head, _, rest = name.strip("/").partition("/")
        if head not in self._links:
            raise KeyError(f"{self.file.path}: no object {name!r} in "
                           f"{self.name}")
        path = f"{self.name.rstrip('/')}/{head}"
        msgs = self.file.messages(self._links[head])
        types = {t for t, _, _ in msgs}
        if types & {SYMBOL_TABLE, LINK_INFO, LINK}:
            obj = Group(self.file, path, self._links[head], msgs)
        elif LAYOUT in types:
            obj = Dataset(self.file, path, msgs)
        else:
            raise self.file.unsupported(f"object {path} is neither a group "
                                        "nor a dataset")
        return obj[rest] if rest else obj


class Dataset:
    """A contiguous dataset: ``shape``, ``dtype`` (``object`` for
    variable-length strings), ``read()`` and ``dataset[i]`` (one row of
    the first axis, or ``dataset[:]``)."""

    def __init__(self, file: File, name: str, msgs: list):
        self.file, self.name = file, name
        by_type = {t: b for t, _, b in msgs}
        if FILTERS in by_type:
            raise file.unsupported(
                f"filter pipeline ({self._filters(by_type[FILTERS])}) on "
                f"{name}")
        if EXTERNAL in by_type:
            raise file.unsupported(f"external storage of {name}")
        self.shape = self._dataspace(by_type[DATASPACE])
        self._vlen = False
        self.dtype = self._datatype(by_type[DATATYPE])
        lay = by_type[LAYOUT]
        if lay[0] != 3:
            raise file.unsupported(f"data layout message version {lay[0]} "
                                   f"({name})")
        if lay[1] != 1:
            raise file.unsupported(
                f"{_LAYOUT_NAMES.get(lay[1], f'class {lay[1]}')} layout "
                f"({name})")
        self._addr, size = struct.unpack_from("<QQ", lay, 2)
        self._item = _VLEN_REF if self._vlen else self.dtype
        want = int(np.prod(self.shape)) * self._item.itemsize
        if want and self._addr == UNDEF:
            raise file.unsupported(f"unallocated storage ({name})")
        if size != want:
            raise ValueError(f"{file.path}: {name} stores {size} bytes for "
                             f"{self.shape} x {self._item}")

    def _filters(self, body: bytes) -> str:
        version, n = body[0], body[1]
        p, ids = (8 if version == 1 else 2), []
        for _ in range(n):
            fid, = struct.unpack_from("<H", body, p)
            ids.append(_FILTER_NAMES.get(fid, f"filter {fid}"))
            if version == 1:
                name_len, _, n_vals = struct.unpack_from("<HHH", body, p + 2)
                p += 8 + _pad8(name_len) + 4 * (n_vals + n_vals % 2)
            else:
                name_len = (struct.unpack_from("<H", body, p + 2)[0]
                            if fid >= 256 else 0)
                p += 2 + (2 if fid >= 256 else 0)
                _, n_vals = struct.unpack_from("<HH", body, p)
                p += 4 + name_len + 4 * n_vals
        return ", ".join(ids)

    def _dataspace(self, body: bytes) -> tuple[int, ...]:
        version, rank = body[0], body[1]
        if version == 1:
            off = 8
        elif version == 2:
            if body[3] == 2:
                raise self.file.unsupported(f"null dataspace ({self.name})")
            off = 4
        else:
            raise self.file.unsupported(f"dataspace version {version}")
        return struct.unpack_from(f"<{rank}Q", body, off)

    def _datatype(self, body: bytes) -> np.dtype:
        cls = body[0] & 0x0F
        bits = body[1] | body[2] << 8 | body[3] << 16
        size = struct.unpack_from("<I", body, 4)[0]
        if cls in (0, 1) and bits & 0x01:
            raise self.file.unsupported(f"big-endian datatype ({self.name})")
        if cls == 0:
            offset, precision = struct.unpack_from("<HH", body, 8)
            if (bits & ~0x08 or offset or precision != 8 * size
                    or size not in (1, 2, 4, 8)):
                raise self.file.unsupported(
                    f"{precision}-bit integer at bit {offset} of {size} "
                    f"bytes ({self.name})")
            return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1:
            if (bits, *struct.unpack_from("<HHBBBBI", body, 8)) != _IEEE.get(
                    size):
                raise self.file.unsupported(
                    f"non-IEEE or VAX-order float ({self.name})")
            return np.dtype(f"<f{size}")
        if cls == 3:
            return np.dtype(f"S{size}")
        if cls == 9:
            if bits & 0x0F != 1:
                raise self.file.unsupported(
                    f"variable-length sequence datatype ({self.name})")
            self._vlen = True
            return np.dtype(object)
        raise self.file.unsupported(
            f"{_CLASS_NAMES.get(cls, f'class {cls}')} datatype "
            f"({self.name})")

    def __len__(self) -> int:
        return self.shape[0]

    def _decode(self, refs: np.ndarray) -> np.ndarray:
        out = np.empty(refs.shape, dtype=object)
        flat = out.reshape(-1)
        for i, r in enumerate(refs.reshape(-1)):
            flat[i] = (self.file.heap_object(int(r["heap"]),
                                             int(r["index"]))[:int(r["n"])]
                       if r["n"] else b"")
        return out

    def read(self) -> np.ndarray:
        """The whole dataset."""
        a = self.file.read_array(self._addr, self._item,
                                 int(np.prod(self.shape))).reshape(
                                     self.shape)
        return self._decode(a) if self._vlen else a

    def __getitem__(self, key):
        if isinstance(key, slice) and key == slice(None):
            return self.read()
        if not isinstance(key, (int, np.integer)):
            raise TypeError(f"{self.name}: index by an int or [:], got "
                            f"{key!r}")
        n = self.shape[0]
        i = int(key) + n if key < 0 else int(key)
        if not 0 <= i < n:
            raise IndexError(f"{self.name}: index {key} of {n}")
        count = int(np.prod(self.shape[1:]))
        a = self.file.read_array(self._addr + i * count * self._item.itemsize,
                                 self._item, count).reshape(self.shape[1:])
        if self._vlen:
            a = self._decode(a)
        return a[()] if a.ndim == 0 else a


# ------------------------------------------------------------------ writer
def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\0" * (_pad8(len(body)) - len(body))
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype_message(a: np.ndarray) -> tuple[bytes, bytes]:
    """(datatype body, fill value body) of an array, as h5py writes
    them."""
    dt, fill = a.dtype, bytes([2, 2, 2, 1, 0, 0, 0, 0])
    if dt.kind == "f" and dt.itemsize in _IEEE:
        bits, *props = _IEEE[dt.itemsize]
        head = struct.pack("<I", 0x11 | bits << 8)
        return head + struct.pack("<I", dt.itemsize) + struct.pack(
            "<HHBBBBI", *props), fill
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        head = struct.pack("<I", 0x10 | (0x08 if dt.kind == "i" else 0) << 8)
        return head + struct.pack("<IHH", dt.itemsize, 0,
                                  8 * dt.itemsize), fill
    if dt.kind == "S":
        return struct.pack("<II", 0x13 | 0x01 << 8, dt.itemsize), fill
    if dt.kind in "OU":
        base = struct.pack("<IIHH", 0x10, 1, 0, 8)        # u8 characters
        return (struct.pack("<II", 0x19 | 0x0101 << 8, 16) + base,
                bytes([2, 2, 0, 1, 0, 0, 0, 0]))
    raise ValueError(f"write_file: no HDF5 datatype for {dt}")


class _Writer:
    def __init__(self, f, leaf_k: int):
        self.f, self.leaf_k, self.pos = f, leaf_k, 96

    def put(self, data) -> int:
        """Write bytes or an array at the next 8-byte boundary."""
        addr = self.pos
        self.f.seek(addr)
        if isinstance(data, np.ndarray):
            data.tofile(self.f)
            n = data.nbytes
        else:
            self.f.write(data)
            n = len(data)
        self.pos = _pad8(addr + n)
        return addr

    def strings(self, a: np.ndarray) -> np.ndarray:
        """Global heap collections holding ``a``'s strings (UTF-8); the
        array of references to them."""
        data = [s.encode() if isinstance(s, str) else bytes(s)
                for s in a.reshape(-1)]
        refs = np.zeros(len(data), _VLEN_REF)
        for lo in range(0, len(data), GCOL_MAX_OBJECTS):
            chunk = data[lo:lo + GCOL_MAX_OBJECTS]
            body = b"".join(
                struct.pack("<HHIQ", i + 1, 0, 0, len(s)) + s
                + b"\0" * (_pad8(len(s)) - len(s))
                for i, s in enumerate(chunk))
            used = 16 + len(body)
            size = max(GCOL_MIN, used)
            if size - used >= 16:           # the free space object
                body += struct.pack("<HHIQ", 0, 0, 0, size - used)
            addr = self.put(b"GCOL" + bytes([1, 0, 0, 0])
                            + struct.pack("<Q", size) + body
                            + b"\0" * (size - 16 - len(body)))
            for i, s in enumerate(chunk):
                if s:
                    refs[lo + i] = (len(s), addr, i + 1)
        return refs.reshape(a.shape)

    def dataset(self, a: np.ndarray) -> int:
        dtype_body, fill = _datatype_message(a)
        if a.dtype.kind in "OU":
            stored = self.strings(a)
        else:
            stored = np.ascontiguousarray(a, a.dtype.newbyteorder("<"))
        addr = self.put(stored) if stored.nbytes else UNDEF
        dims = struct.pack(f"<{a.ndim}Q", *a.shape)
        space = struct.pack("<BBBB4x", 1, a.ndim, 1, 0) + dims + dims
        layout = struct.pack("<BBQQ", 3, 1, addr, stored.nbytes)
        return self.put(_object_header([
            _message(DATASPACE, space), _message(DATATYPE, dtype_body, 1),
            _message(FILL, fill, 1), _message(LAYOUT, layout)]))

    def group(self, tree: dict) -> tuple[int, int, int]:
        """Children first, then the group's heap, symbol-table node,
        B-tree and object header; (header, B-tree, heap)."""
        names = sorted(tree, key=lambda k: k.encode())
        entries = []
        for name in names:
            if "/" in name or not name:
                raise ValueError(f"write_file: bad link name {name!r}")
            v = tree[name]
            if isinstance(v, dict):
                oh, bt, hp = self.group(v)
                entries.append((oh, 1, struct.pack("<QQ", bt, hp)))
            else:
                entries.append((self.dataset(np.asarray(v)), 0, bytes(16)))
        heap, offsets = bytearray(8), []
        for name in names:
            offsets.append(len(heap))
            b = name.encode() + b"\0"
            heap += b + b"\0" * (_pad8(len(b)) - len(b))
        seg = self.put(bytes(heap))
        hp = self.put(b"HEAP" + bytes(4) + struct.pack(
            "<QQQ", len(heap), FREE_NULL, seg))
        snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + b"".join(
            struct.pack("<QQII", off, oh, cache, 0) + scratch
            for off, (oh, cache, scratch) in zip(offsets, entries))
        snod += bytes(8 + 2 * self.leaf_k * 40 - len(snod))
        kids = [self.put(snod)] if names else []
        node = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(kids), UNDEF,
                                     UNDEF) + struct.pack("<Q", 0)
        if kids:
            node += struct.pack("<QQ", kids[0], offsets[-1])
        k2 = 2 * GROUP_INTERNAL_K
        node += bytes(24 + (k2 + 1) * 8 + k2 * 8 - len(node))
        bt = self.put(node)
        oh = self.put(_object_header([_message(
            SYMBOL_TABLE, struct.pack("<QQ", bt, hp))]))
        return oh, bt, hp


def _most_links(tree: dict) -> int:
    return max([len(tree)] + [_most_links(v) for v in tree.values()
                              if isinstance(v, dict)])


def write_file(path: str, tree: dict) -> None:
    """Write ``tree`` (dicts are groups, arrays datasets) as an HDF5
    file in this module's subset; every group's links fit one
    symbol-table node (its K grows with the largest group)."""
    leaf_k = max(4, -(-_most_links(tree) // 2))
    with open(path, "wb") as f:
        w = _Writer(f, leaf_k)
        root, bt, hp = w.group(tree)
        eof = f.seek(0, 2)
        f.seek(0)
        f.write(SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                + struct.pack("<HHI", leaf_k, GROUP_INTERNAL_K, 0)
                + struct.pack("<4Q", 0, UNDEF, eof, UNDEF)
                + struct.pack("<QQII", 0, root, 1, 0)
                + struct.pack("<QQ", bt, hp))
