"""TensorBoard event files without the ``tensorboard`` or ``tensorboardX``
packages (a host may have neither).

:class:`SummaryWriter` has the surface the trainer calls on
``tensorboardX.SummaryWriter`` (``add_scalar``, ``add_image``, ``flush``,
``close``) and writes ``<logdir>/events.out.tfevents.<time>.<host>``:
TFRecord framing (little-endian u64 length, masked CRC-32C of the
length, the record, masked CRC-32C of the record), the first record a
``file_version: "brain.Event:2"`` event, then one ``Event{wall_time,
step, summary{value{tag, simple_value | image}}}`` per call. The
handful of protobuf fields it needs are encoded by hand.

Images are encoded as tensorboardX encodes them: a float image in
[0, 1] times 255, clipped to [0, 255] and truncated to uint8, then PNG
(``utils/image_io.png_encode``). The caller's thread makes the uint8
copy; PNG, CRCs and file writes run in call order on the writer's own
thread (zlib and numpy release the GIL), so a training loop goes on
while an image is encoded. :meth:`SummaryWriter.flush` waits for them,
as tensorboardX's does. :class:`NullWriter` stands in on the ranks other
than 0 of a data-parallel run.

:func:`read_events` decodes such a file back, checking every CRC: the
same framing read without TensorBoard.
"""

from __future__ import annotations

import functools
import os
import socket
import struct
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from shadow_removal_istd_tpu_torch.utils.image_io import png_encode


def _crc32c_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()
_CRC_NP = np.array(_CRC_TABLE, np.uint32)
_CHUNK = 1024


@functools.cache
def _zero_shift() -> tuple[list[int], ...]:
    """Four byte tables of the linear map "run ``_CHUNK`` zero bytes
    through the register": ``shift(r)`` is the XOR of
    ``t[k][(r >> 8k) & 0xFF]``."""
    r = (np.arange(256, dtype=np.uint32)[None, :]
         << (8 * np.arange(4, dtype=np.uint32))[:, None]).ravel()
    for _ in range(_CHUNK):
        r = _CRC_NP[r & 0xFF] ^ (r >> 8)
    return tuple(r.reshape(4, 256).tolist())


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames use it. Records of a
    PNG's size are cut into 1 KiB chunks whose registers numpy advances
    side by side (the register update is linear over GF(2)); the chunks
    are then chained by the zero-run map."""
    crc = 0xFFFFFFFF
    if len(data) < 16 * _CHUNK:
        for b in data:
            crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF
    buf = np.frombuffer(data, np.uint8).copy()
    buf[:4] ^= 0xFF            # the initial register, folded into the data
    m = len(buf) // _CHUNK
    cols = np.ascontiguousarray(buf[:m * _CHUNK].reshape(m, _CHUNK).T)
    regs = np.zeros(m, np.uint32)
    for col in cols:
        regs = _CRC_NP[(regs ^ col) & 0xFF] ^ (regs >> 8)
    t0, t1, t2, t3 = _zero_shift()
    crc = 0
    for c in regs.tolist():
        crc = (t0[crc & 0xFF] ^ t1[(crc >> 8) & 0xFF]
               ^ t2[(crc >> 16) & 0xFF] ^ t3[crc >> 24] ^ c)
    for b in buf[m * _CHUNK:].tolist():
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame(record: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the record, its masked CRC."""
    head = struct.pack("<Q", len(record))
    return (head + struct.pack("<I", masked_crc(head)) + record
            + struct.pack("<I", masked_crc(record)))


# -- protobuf wire format: varints, fixed-width and length-delimited fields

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1               # int64: negatives as 10 bytes
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _int_field(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _event(step: int, wall_time: float, *,
           file_version: bytes | None = None,
           value: bytes | None = None) -> bytes:
    """``Event``: wall_time (1, double), step (2, int64), file_version (3)
    or summary (5) holding one ``Summary.Value`` (1)."""
    out = _key(1, 1) + struct.pack("<d", wall_time) + _int_field(2, step)
    if file_version is not None:
        out += _bytes_field(3, file_version)
    if value is not None:
        out += _bytes_field(5, _bytes_field(1, value))
    return out


def to_uint8_hwc(img, dataformats: str = "HWC") -> np.ndarray:
    """An image as (H, W, C) uint8 the way tensorboardX makes it: one
    channel (or an HW image) repeated to three, float values in [0, 1]
    scaled by 255, clipped and truncated; uint8 kept."""
    img = np.asarray(img)
    fmt = dataformats.upper()
    if fmt not in ("HWC", "CHW", "HW"):
        raise ValueError(f"dataformats must be HWC, CHW or HW, got "
                         f"{dataformats!r}")
    if img.ndim != len(fmt):
        raise ValueError(f"a {fmt} image needs {len(fmt)} dims, got "
                         f"{img.shape}")
    if fmt == "HW":
        img = img[..., None]
    elif fmt == "CHW":
        img = img.transpose(1, 2, 0)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    if img.shape[2] not in (3, 4):
        raise ValueError(f"an image has 1, 3 or 4 channels, got "
                         f"{img.shape[2]}")
    if img.dtype != np.uint8:
        img = np.clip(img.astype(np.float32) * np.float32(255.0), 0.0,
                      255.0).astype(np.uint8)
    return np.ascontiguousarray(img)


class NullWriter:
    """The writer of a data-parallel run's other ranks: the surface of
    :class:`SummaryWriter`, writing nothing (rank 0 writes the event
    files, as the JAX trainer's process 0 does)."""

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def add_image(self, tag: str, img, step: int,
                  dataformats: str = "HWC") -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class SummaryWriter:
    """Scalars and images into one event file under ``logdir``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time()):010d}."
                f"{socket.gethostname()}")
        path, k = os.path.join(logdir, name), 0
        while True:      # two writers of one second each get a file
            try:
                self._f = open(path, "xb")
                break
            except FileExistsError:
                k += 1
                path = os.path.join(logdir, f"{name}.{k}")
        self.path = path
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: list[Future] = []
        self._f.write(frame(_event(0, time.time(),
                                   file_version=b"brain.Event:2")))
        self._f.flush()

    def _submit(self, step: int, value) -> None:
        """Queue one event; ``value`` is the ``Summary.Value`` bytes or a
        callable making them on the writer's thread."""
        wall = time.time()

        def write():
            v = value() if callable(value) else value
            self._f.write(frame(_event(step, wall, value=v)))

        done = [f for f in self._pending if f.done()]
        for f in done:
            f.result()                 # raise a failed write here
        self._pending = [f for f in self._pending if not f.done()]
        self._pending.append(self._pool.submit(write))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        """``Summary.Value{tag (1), simple_value (2, float)}``."""
        self._submit(int(step), _bytes_field(1, tag.encode()) + _key(2, 5)
                     + struct.pack("<f", float(value)))

    def add_image(self, tag: str, img, step: int,
                  dataformats: str = "HWC") -> None:
        """``Summary.Value{tag (1), image (4): Image{height (1), width
        (2), colorspace (3), encoded_image_string (4): PNG}}``."""
        u8 = to_uint8_hwc(img, dataformats)

        def value() -> bytes:
            h, w, c = u8.shape
            image = (_int_field(1, h) + _int_field(2, w) + _int_field(3, c)
                     + _bytes_field(4, png_encode(u8)))
            return _bytes_field(1, tag.encode()) + _bytes_field(4, image)

        self._submit(int(step), value)

    def flush(self) -> None:
        """Wait for every queued event, then flush the file."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self.flush()
            self._pool.shutdown()
            self._f.close()


# -- reading back ------------------------------------------------------

def _fields(buf: bytes):
    """(field, wire type, value) of one protobuf message; value is an int
    for varints, bytes otherwise."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            val, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def read_records(path: str) -> list[bytes]:
    """The records of a TFRecord file; raises ``ValueError`` on a bad CRC
    or a truncated frame."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        if i + 12 > len(data):
            raise ValueError(f"{path}: truncated frame header at {i}")
        head = data[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        if crc != masked_crc(head):
            raise ValueError(f"{path}: bad length CRC at {i}")
        rec = data[i + 12:i + 12 + n]
        if len(rec) != n or i + 16 + n > len(data):
            raise ValueError(f"{path}: truncated record at {i}")
        (crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if crc != masked_crc(rec):
            raise ValueError(f"{path}: bad record CRC at {i}")
        out.append(rec)
        i += 16 + n
    return out


def read_events(path: str) -> list[dict]:
    """Each event as ``{"wall_time", "step", "file_version"}`` or
    ``{"wall_time", "step", "tag", "value"}`` (a float for a scalar, an
    ``{"height", "width", "colorspace", "png"}`` dict for an image)."""
    events = []
    for rec in read_records(path):
        ev: dict = {"step": 0}
        for field, wire, val in _fields(rec):
            if field == 1 and wire == 1:
                ev["wall_time"] = struct.unpack("<d", val)[0]
            elif field == 2 and wire == 0:
                ev["step"] = val - (1 << 64) if val >> 63 else val
            elif field == 3 and wire == 2:
                ev["file_version"] = val.decode()
            elif field == 5 and wire == 2:
                for f, w, value in _fields(val):
                    if f == 1 and w == 2:
                        ev.update(_value(value))
        events.append(ev)
    return events


def _value(buf: bytes) -> dict:
    out: dict = {}
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 2:
            out["tag"] = val.decode()
        elif field == 2 and wire == 5:
            out["value"] = struct.unpack("<f", val)[0]
        elif field == 4 and wire == 2:
            img = {}
            names = {1: "height", 2: "width", 3: "colorspace", 4: "png"}
            for f, _, v in _fields(val):
                if f in names:
                    img[names[f]] = v
            out["value"] = img
    return out
