"""The msgpack subset that ``flax.serialization`` writes, without the
``msgpack`` package (a CUDA host may lack it).

Types: nil, bool, integers, float32/64, str, bin, array and map in every
width, and flax's two extension types: 1, an ndarray packed as the
msgpack array ``(shape, dtype name, C-order bytes)``, and 3, a numpy
scalar in the same form. ``bfloat16`` (which numpy lacks) decodes to a
``torch.bfloat16`` tensor, and such a tensor encodes back under that
name. Arrays of 2**30 bytes or more, which flax writes as
``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``
maps, are joined back on read.

The encoder picks the smallest form of each value, as the ``msgpack``
package does, so a tree with the same key order and leaves encodes to
the bytes flax writes. It writes no chunked form: larger arrays raise.
"""

from __future__ import annotations

import struct
from collections.abc import Mapping

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------- encoding

def _head(out: list, n: int, fix: int | None, fix_max: int,
          codes: tuple[int, int, int]) -> None:
    """Type byte and length: the fix form below ``fix_max``, else the
    8-, 16- or 32-bit length form (``codes``; 0 = no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
    elif codes[0] and n < 0x100:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 0x10000:
        out.append(struct.pack(">BH", codes[1], n))
    elif n < 0x100000000:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack object of {n} items/bytes is too large")


def _pack_int(out: list, n: int) -> None:
    if 0 <= n < 0x80:
        out.append(bytes((n,)))
    elif -32 <= n < 0:
        out.append(struct.pack(">b", n))
    elif n >= 0:
        for code, fmt, top in ((0xcc, ">BB", 0xff), (0xcd, ">BH", 0xffff),
                               (0xce, ">BI", 0xffffffff),
                               (0xcf, ">BQ", 0xffffffffffffffff)):
            if n <= top:
                out.append(struct.pack(fmt, code, n))
                return
        raise OverflowError(f"integer {n} does not fit in 64 bits")
    else:
        for code, fmt, low in ((0xd0, ">Bb", -0x80), (0xd1, ">Bh", -0x8000),
                               (0xd2, ">Bi", -0x80000000),
                               (0xd3, ">Bq", -0x8000000000000000)):
            if n >= low:
                out.append(struct.pack(fmt, code, n))
                return
        raise OverflowError(f"integer {n} does not fit in 64 bits")


def _pack_array(out: list, code: int, arr: np.ndarray | torch.Tensor
                ) -> None:
    """flax's ndarray extension: the packed ``(shape, dtype name,
    bytes)``, the bytes appended without another copy."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype != torch.bfloat16:
            return _pack_array(out, code, t.numpy())
        name, raw = "bfloat16", t.view(torch.int16).numpy().tobytes()
    else:
        if arr.dtype.hasobject or arr.dtype.fields is not None:
            raise ValueError(f"dtype {arr.dtype} cannot be serialized")
        name, raw = arr.dtype.name, arr.tobytes("C")
    if len(raw) >= MAX_CHUNK_SIZE:
        raise ValueError(f"array of {len(raw)} bytes: the chunked form "
                         "(>= 2**30 bytes) is read, not written")
    head: list = [b"\x93"]                       # fixarray of 3
    _pack(head, list(arr.shape))
    _pack(head, name)
    _head(head, len(raw), None, 0, (0xc4, 0xc5, 0xc6))
    prefix = b"".join(head)
    n = len(prefix) + len(raw)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        out.append(bytes((fixext[n],)))
    else:
        _head(out, n, None, 0, (0xc7, 0xc8, 0xc9))
    out += [struct.pack(">b", code), prefix, raw]


def _pack(out: list, obj) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.generic):     # before float: np.float64 is one
        _pack_array(out, EXT_NPSCALAR, np.asarray(obj))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xcb, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _head(out, len(data), None, 0, (0xc4, 0xc5, 0xc6))
        out.append(data)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_array(out, EXT_NDARRAY, obj)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (0, 0xdc, 0xdd))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, Mapping):
        _head(out, len(obj), 0x80, 16, (0, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def to_bytes(obj) -> bytes:
    """Encode ``obj`` as flax's ``msgpack_serialize`` writes a nested dict
    of arrays; dicts in their own key order."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)


# ------------------------------------------------------------- decoding

_FIXED = {  # type byte -> (struct format, size)
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def num(self, fmt: str, size: int):
        return struct.unpack(fmt, self.take(size))[0]

    def length(self, width: int) -> int:
        return self.num(_LEN[width], width)

    def value(self):
        b = self.num(">B", 1)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.num(*_FIXED[b])
        if 0xc4 <= b <= 0xc6:                      # bin 8/16/32
            return bytes(self.take(self.length(1 << (b - 0xc4))))
        if 0xc7 <= b <= 0xc9:                      # ext 8/16/32
            return self.ext(self.length(1 << (b - 0xc7)))
        if 0xd4 <= b <= 0xd8:                      # fixext 1..16
            return self.ext(1 << (b - 0xd4))
        if 0xd9 <= b <= 0xdb:                      # str 8/16/32
            return self.str(self.length(1 << (b - 0xd9)))
        if b in (0xdc, 0xdd):                      # array 16/32
            return [self.value() for _ in range(self.length(2 << (b & 1)))]
        if b in (0xde, 0xdf):                      # map 16/32
            return self.map(self.length(2 << (b & 1)))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.num(">b", 1)
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not supported")
        arr = _array_from_payload(data)
        return arr[()] if code == EXT_NPSCALAR else arr


def _array_from_payload(data: memoryview):
    inner = _Reader(data)
    shape, name, raw = inner.value()
    if inner.pos != len(data):
        raise ValueError("trailing bytes in an ndarray payload")
    if isinstance(name, bytes):
        name = name.decode("ascii")
    if name == "bfloat16":
        bits = np.frombuffer(raw, np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, np.dtype(name)).reshape(shape)


def _unchunk(node):
    """Join flax's chunked-array maps back into arrays, bottom up."""
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def unpackb(data: bytes):
    """Decode one msgpack object; ndarray leaves are read-only views of
    ``data`` (bf16 leaves are torch tensors)."""
    reader = _Reader(data)
    obj = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


def from_bytes(data: bytes):
    """flax's ``msgpack_restore``: the nested dicts, chunked arrays
    joined."""
    return _unchunk(unpackb(data))
