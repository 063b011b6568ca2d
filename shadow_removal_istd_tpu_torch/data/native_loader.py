"""ctypes binding of the native batch PNG decoder; port of
``shadow_removal_istd_tpu/data/native_loader.py``.

The repository's ``native/png_decoder.cpp`` (8-bit gray/RGB/RGBA
non-interlaced PNG over zlib, a ``std::thread`` pool) decodes a whole
file list straight into one contiguous uint8 batch buffer, BGR like
cv2, through its C ABI ``srit_png_probe`` / ``srit_png_decode_batch``.
:func:`build` compiles it with ``g++ -O3 -fPIC -std=c++17 -shared -lz
-pthread`` into ``shadow_removal_istd_tpu_torch/_build/`` under a name
keyed by the source's hash (``ops/_build.build_host``); nothing is
written into ``native/``.

:func:`is_available` is False when the library cannot be built (no
compiler or no ``zlib.h``); ``data/istd.py`` then decodes with the
image library.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from pathlib import Path

import numpy as np

from shadow_removal_istd_tpu_torch.ops import _build

logger = logging.getLogger(__name__)

SOURCE = _build.PKG_DIR.parent / "native" / "png_decoder.cpp"

_lock = threading.Lock()
_lib = None
_error: str | None = None


def build() -> Path:
    """Compile the decoder (reused when up to date); raises on failure."""
    return _build.build_host(SOURCE, "srit_png")[0]


def _load():
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError) as exc:
            _error = str(exc)     # don't rerun a failing build every call
            logger.warning("native PNG loader unavailable: %s", exc)
            return None
        c_int_p = ctypes.POINTER(ctypes.c_int)
        lib.srit_png_probe.argtypes = [ctypes.c_char_p, c_int_p, c_int_p,
                                       c_int_p]
        lib.srit_png_probe.restype = ctypes.c_int
        lib.srit_png_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, c_int_p]
        lib.srit_png_decode_batch.restype = ctypes.c_int
        _lib = lib
        return lib


def is_available() -> bool:
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    return lib


def probe(path: str) -> tuple[int, int, int]:
    """(height, width, source channels) of a PNG; ``IOError`` when the
    file is missing or not a PNG the decoder reads."""
    lib = _require()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.srit_png_probe(os.fsencode(path), ctypes.byref(h),
                            ctypes.byref(w), ctypes.byref(c))
    if rc != 0:
        raise IOError(f"probe failed ({rc}): {path}")
    return h.value, w.value, c.value


def decode_batch(paths: list[str], gray: bool = False,
                 n_threads: int | None = None) -> np.ndarray:
    """Decode PNGs into one stacked (N, H, W, C) uint8 array: BGR for
    color (cv2's order), C = 1 for ``gray``, which takes gray PNGs only
    (an RGB file read as gray is refused: cv2's RGB -> gray rounding is
    not reproduced). All files must share the first one's size; any
    failure raises ``IOError`` naming the files."""
    lib = _require()
    if not paths:
        raise ValueError("empty path list")
    h, w, _ = probe(paths[0])
    out = np.empty((len(paths), h, w, 1 if gray else 3), np.uint8)
    status = (ctypes.c_int * len(paths))()
    names = (ctypes.c_char_p * len(paths))(*map(os.fsencode, paths))
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    failures = lib.srit_png_decode_batch(
        names, len(paths), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, out.shape[3], 1, n_threads, status)
    if failures:
        bad = [(paths[i], status[i]) for i in range(len(paths))
               if status[i] != 0]
        raise IOError(f"{failures} PNGs failed to decode: {bad[:5]}")
    return out
