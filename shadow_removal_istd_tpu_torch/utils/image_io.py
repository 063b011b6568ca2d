"""Image files and bytes <-> uint8 arrays in the reference's BGR
convention.

Port of ``imread_color``/``imread_gray``/``imwrite``/``imdecode_color``/
``imencode_png`` from ``shadow_removal_istd_tpu/utils/image_io.py``.
Decoding goes through cv2, or else PIL, when one is importable (both
decode in C). A host may have neither, so 8-bit gray/RGB/RGBA
non-interlaced PNG is also read and written by the small stdlib
(``zlib``) + numpy codec below, which is what such a host decodes with.
Encoding always uses that codec.

Gray reads: a gray PNG decodes to its own bytes on every path. A color
PNG read as gray has a bit-exact decode only through cv2 (its RGB ->
gray rounding is its own); PIL and the stdlib codec refuse it.
"""

from __future__ import annotations

import functools
import io
import struct
import zlib
from typing import Callable, Sequence

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # PNG color type -> channels
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _predict(f: np.ndarray, a: np.ndarray, b: np.ndarray,
             d: np.ndarray) -> np.ndarray:
    """PNG filter predictor of type ``f`` (per row, broadcast) from the
    left ``a``, upper ``b`` and upper-left ``d`` bytes, as int16."""
    p = a + b - d
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - d)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, d))
    return np.choose(f, (np.zeros_like(a), a, b, (a + b) >> 1, paeth))


def png_encode(img: np.ndarray, filters: int | Sequence[int] = 0) -> bytes:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 -> PNG bytes
    (8-bit, non-interlaced, zlib level 1 as cv2's default PNG compression:
    serving favours encode time over size). ``filters`` is the PNG row
    filter type (0 None .. 4 Paeth), one for all rows or one per row."""
    if img.dtype != np.uint8:
        raise ValueError(f"PNG encode takes uint8, got {img.dtype}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    if img.ndim not in (2, 3) or c not in _COLOR_TYPE:
        raise ValueError(f"PNG encode takes gray/RGB/RGBA, got {img.shape}")
    f = np.broadcast_to(np.asarray(filters, np.int16), (h,))
    if f.min(initial=0) < 0 or f.max(initial=0) > 4:
        raise ValueError("PNG filter types are 0..4")
    res = img
    if f.any():
        x = img.reshape(h, w, c).astype(np.int16)
        a, b, d = (np.zeros_like(x) for _ in range(3))
        a[:, 1:], b[1:], d[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
        res = (x - _predict(f[:, None, None], a, b, d)) & 0xFF
    raw = np.empty((h, w * c + 1), np.uint8)
    raw[:, 0] = f
    raw[:, 1:] = res.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _chunk(b"IEND", b""))


def _unfilter(f: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Undo the row filters ``f`` (H,) of filtered bytes (H, W, C)."""
    h, w, c = data.shape
    if f.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {f.max()}")
    if f.max(initial=0) <= 2:       # None, Sub, Up: one vector op per row
        out = np.empty_like(data)
        prev = np.zeros((w, c), np.uint8)
        for y in range(h):
            if f[y] == 0:
                out[y] = data[y]
            elif f[y] == 1:         # running sum along the row, mod 256
                out[y] = np.cumsum(data[y], axis=0, dtype=np.uint8)
            else:
                out[y] = data[y] + prev
            prev = out[y]
        return out
    # Average and Paeth predict from the left pixel of the same row, so
    # decode along anti-diagonals x + y = k instead: a pixel needs only
    # the two diagonals before its own. Skewed layout t[k + 2, y + 1] =
    # out[y, k - y]; all else stays 0, PNG's value off the image.
    t = np.zeros((h + w + 1, h + 1, c), np.int16)
    ys, xs = np.indices((h, w))
    skew = np.zeros((h + w - 1, h, c), np.int16)
    skew[ys + xs, ys] = data
    fs = f.astype(np.int16)[:, None]
    for k in range(h + w - 1):
        y0, y1 = max(0, k - w + 1), min(h, k + 1)
        pred = _predict(fs[y0:y1], t[k + 1, y0 + 1:y1 + 1], t[k + 1, y0:y1],
                        t[k, y0:y1])
        t[k + 2, y0 + 1:y1 + 1] = (skew[k, y0:y1] + pred) & 0xFF
    return t[ys + xs + 2, ys + 1].astype(np.uint8)


def png_decode(data: bytes) -> np.ndarray | None:
    """PNG bytes -> (H, W, C) uint8 in file channel order (gray, RGB or
    RGBA). Returns None for PNG variants this codec does not read
    (bit depth != 8, palette, gray+alpha, interlaced); raises ValueError
    on a malformed file."""
    if not data.startswith(_SIG):
        raise ValueError("not a PNG")
    try:
        pos, hdr, idat = len(_SIG), None, []
        while True:
            length, kind = struct.unpack(">I4s", data[pos:pos + 8])
            body = data[pos + 8:pos + 8 + length]
            (crc,) = struct.unpack(">I", data[pos + 8 + length:
                                              pos + 12 + length])
            if len(body) != length or zlib.crc32(kind + body) != crc:
                raise ValueError(f"corrupt PNG chunk {kind!r}")
            if kind == b"IHDR":
                hdr = struct.unpack(">IIBBBBB", body)
            elif kind == b"IDAT":
                idat.append(body)
            elif kind == b"IEND":
                break
            pos += 12 + length
        if hdr is None:
            raise ValueError("PNG without IHDR")
        w, h, depth, color, comp, filt, interlace = hdr
        if (depth != 8 or color not in _CHANNELS or interlace
                or comp or filt):
            return None
        c = _CHANNELS[color]
        raw = zlib.decompress(b"".join(idat))
    except (struct.error, zlib.error) as exc:
        raise ValueError(f"malformed PNG: {exc}") from exc
    if len(raw) != h * (w * c + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = np.frombuffer(raw, np.uint8).reshape(h, w * c + 1)
    return _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, c))


_NO_GRAY = ("no bit-exact gray decode of a color PNG without cv2 (its "
            "RGB -> gray rounding is its own); store the stream as gray "
            "PNGs or install cv2")


@functools.cache
def _library_decoder() -> Callable[[bytes, bool], np.ndarray] | None:
    """cv2's, else PIL's, ``decode(data, gray)``: HxWx3 uint8 BGR, or
    HxW uint8 when ``gray``; None with neither library."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        def decode(data: bytes, gray: bool = False) -> np.ndarray:
            img = cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_GRAYSCALE if gray
                               else cv2.IMREAD_COLOR)
            if img is None:
                raise ValueError("could not decode image bytes")
            return img
        return decode
    try:
        from PIL import Image, UnidentifiedImageError
    except ImportError:
        return None

    def decode(data: bytes, gray: bool = False) -> np.ndarray:
        try:
            img = Image.open(io.BytesIO(data))
            if gray:
                if img.mode != "L":
                    raise ValueError(f"{_NO_GRAY} (PIL mode {img.mode})")
                return np.asarray(img).copy()
            img = np.asarray(img.convert("RGB"))
        except (UnidentifiedImageError, OSError) as exc:
            raise ValueError("could not decode image bytes") from exc
        return img[..., ::-1].copy()  # RGB -> BGR
    return decode


def decodes_in_c() -> bool:
    """Whether cv2 or PIL decodes. Their C code releases the GIL, so
    decodes overlap on threads; the stdlib codec's Average/Paeth
    unfilter is thousands of small numpy calls that hold it, and threads
    only contend (3x slower than one thread at 480x640 on an 8-core
    H100 host, ``chip_smoke.py``)."""
    return _library_decoder() is not None


def _png_only(data: bytes) -> np.ndarray:
    img = png_decode(data) if data.startswith(_SIG) else None
    if img is None:
        raise ValueError("could not decode image bytes: without cv2 or PIL "
                         "only 8-bit gray/RGB/RGBA non-interlaced PNG is read")
    return img


def imdecode_color(data: bytes) -> np.ndarray:
    """Decode encoded image bytes to HxWx3 uint8 BGR (cv2's
    ``IMREAD_COLOR``: gray replicated, alpha dropped)."""
    decode = _library_decoder()
    if decode is not None:
        return decode(data)
    img = _png_only(data)
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return img[..., 2::-1].copy()          # RGB(A) -> BGR


def imdecode_gray(data: bytes) -> np.ndarray:
    """Decode encoded image bytes to HxW uint8 (cv2's
    ``IMREAD_GRAYSCALE``); see the module note on color files."""
    decode = _library_decoder()
    if decode is not None:
        return decode(data, gray=True)
    img = _png_only(data)
    if img.shape[2] != 1:
        raise ValueError(f"{_NO_GRAY} ({img.shape[2]}-channel PNG)")
    return img[..., 0]


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def imread_color(path: str) -> np.ndarray:
    """Read an image file as HxWx3 uint8 in BGR order (cv2 convention)."""
    return imdecode_color(_read(path))


def imread_gray(path: str) -> np.ndarray:
    """Read an image file as HxW uint8 grayscale."""
    return imdecode_gray(_read(path))


def imwrite(path: str, img: np.ndarray,
            filters: int | Sequence[int] = 0) -> None:
    """Write a uint8 image as PNG; 3-channel input is interpreted as BGR.
    ``filters``: the PNG row filter types, as :func:`png_encode`."""
    data = imencode_png(img, filters)
    with open(path, "wb") as f:
        f.write(data)


def imencode_png(img: np.ndarray,
                 filters: int | Sequence[int] = 0) -> bytes:
    """Encode a uint8 image (3-channel interpreted as BGR) to PNG bytes."""
    if img.ndim == 3 and img.shape[2] == 3:
        img = np.ascontiguousarray(img[..., ::-1])  # BGR -> RGB
    return png_encode(img, filters)


def normalize_percentile(array: np.ndarray, lower: float = 3.0,
                         upper: float = 97.0) -> np.ndarray:
    """Percentile contrast stretch to uint8 (reference
    ``normalize_ndarray``, src/utils.py:70-74): map the [p_lower,
    p_upper] range of ``array`` onto [0, 255] and clip. A constant input
    is divided by 1e-12, not by zero. Useful for visualising unbounded
    float maps (e.g. sp arrays)."""
    lo = np.percentile(array, lower)
    hi = np.percentile(array, upper)
    img = (array.astype(np.float64) - lo) / max(hi - lo, 1e-12)
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
