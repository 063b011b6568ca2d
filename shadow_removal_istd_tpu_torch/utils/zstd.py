"""zstd frames (RFC 8878): a hand-written decoder and a raw-block writer.

:func:`decompress` runs ``csrc/zstd_decode.cpp``, a decode-only frame
decoder in host C++ (every block and literal type, the four sequence
table modes, repeat offsets, the content checksum, concatenated and
skippable frames), built by ``g++`` at first use into
``shadow_removal_istd_tpu_torch/_build/`` (``ops/_build.build_host``) and
called through ``ctypes``. There is no fallback: without a compiler, or
when the build fails, the call raises, and a corrupt frame raises
:class:`ZstdError`, never a truncated result.

:func:`frame_raw` writes a valid frame of raw (stored) blocks. The port
never compresses: orbax's zarr chunks and OCDBT files only need frames
that any zstd decoder reads.
"""

from __future__ import annotations

import ctypes
import struct
import threading

from shadow_removal_istd_tpu_torch.ops import _build

SOURCE = _build.CSRC_DIR / "zstd_decode.cpp"
MAGIC = b"\x28\xb5\x2f\xfd"
BLOCK_MAX = 128 << 10          # a block's largest size

_lock = threading.Lock()
_lib = None


class ZstdError(ValueError):
    """A frame the decoder refuses (corrupt, truncated, or a dictionary)."""


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_host(SOURCE, "srit_zstd")[0]))
            lib.srit_zstd_content_size.argtypes = [ctypes.c_char_p,
                                                   ctypes.c_size_t]
            lib.srit_zstd_content_size.restype = ctypes.c_int64
            lib.srit_zstd_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
                ctypes.c_size_t]
            lib.srit_zstd_decompress.restype = ctypes.c_int
            lib.srit_zstd_free.argtypes = [ctypes.c_void_p]
            lib.srit_zstd_free.restype = None
            _lib = lib
        return _lib


def decompress(data: bytes) -> bytes | bytearray:
    """The content of every frame in ``data``, concatenated (skippable
    frames skipped). When every frame states its content size, the
    decoder writes straight into the returned ``bytearray``. Raises
    :class:`ZstdError` on a corrupt input."""
    lib = _load()
    data = bytes(data)
    out = ctypes.c_void_p()
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    size = lib.srit_zstd_content_size(data, len(data))
    dst = bytearray(max(size, 0))
    buf = (ctypes.c_char * len(dst)).from_buffer(dst) if dst else None
    rc = lib.srit_zstd_decompress(
        data, len(data), ctypes.addressof(buf) if buf is not None else None,
        len(dst), ctypes.byref(out), ctypes.byref(n), err, len(err))
    del buf                  # the export would pin dst's size
    try:
        if rc != 0:
            raise ZstdError(f"zstd: {err.value.decode()}")
        if size >= 0:
            if n.value != size:
                raise ZstdError(f"zstd: {n.value} bytes decoded, the "
                                f"headers state {size}")
            return dst
        return ctypes.string_at(out.value, n.value) if n.value else b""
    finally:
        if out.value:
            lib.srit_zstd_free(out)


def frame_raw(data: bytes) -> bytes:
    """One zstd frame holding ``data`` in raw blocks: single-segment, the
    content size in the header, no checksum."""
    data = memoryview(data).cast("B")
    n = len(data)
    if n < 256:
        head = bytes([0x20]) + struct.pack("<B", n)
    elif n < 65536 + 256:
        head = bytes([0x60]) + struct.pack("<H", n - 256)
    elif n < 1 << 32:
        head = bytes([0xA0]) + struct.pack("<I", n)
    else:
        head = bytes([0xE0]) + struct.pack("<Q", n)
    parts = [MAGIC, head]
    pos = 0
    while True:
        size = min(BLOCK_MAX, n - pos)
        last = pos + size == n
        parts.append(struct.pack("<I", (size << 3) | int(last))[:3])
        parts.append(data[pos:pos + size])
        pos += size
        if last:
            return b"".join(parts)
