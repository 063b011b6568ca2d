"""zarr v2 arrays on a key-value store (the OCDBT of an orbax checkpoint).

An array ``name`` is the JSON ``name/.zarray`` (``shape``, ``chunks``,
``dtype``, ``order``, ``compressor``, ``fill_value``,
``dimension_separator``) and one value per chunk, keyed by the chunk's
grid index joined by the separator (``name/0.0``; ``name/0`` for a 0-d
array). A chunk is always stored at the full chunk shape; the reader clips
the edge chunks and fills the chunks the store lacks with ``fill_value``
(``null`` reads as zeros, as tensorstore reads it). Compressors: ``zstd``
(``utils/zstd.py``) or ``null``; the array is little-endian (or
byte-sized) in C or F order.

:func:`encode` writes what orbax writes for a single-device array: one
chunk spanning the array, ``{"id": "zstd", "level": 1}`` with a raw-block
frame inside (``zstd.frame_raw``), ``fill_value: null``, separator ".",
and its JSON in orbax's form (sorted keys, no spaces).
"""

from __future__ import annotations

import itertools
import json
import math
from collections.abc import Callable

import numpy as np

from shadow_removal_istd_tpu_torch.utils import zstd


class ZarrError(ValueError):
    """An array whose metadata or chunks the reader refuses."""


def _dtype(spec) -> np.dtype:
    if not isinstance(spec, str):
        raise ZarrError(f"structured dtype {spec!r} is not supported")
    try:
        dt = np.dtype(spec)
    except TypeError as exc:
        raise ZarrError(f"dtype {spec!r} is not supported") from exc
    if dt.byteorder == ">":
        raise ZarrError(f"big-endian dtype {spec!r} is not supported")
    return dt


def _fill(value, dt: np.dtype):
    if value is None:
        return 0
    if value in ("NaN", "Infinity", "-Infinity"):
        return float(value.replace("Infinity", "inf"))
    return np.array(value).astype(dt)


def read(get: Callable[[str], bytes | None], name: str) -> np.ndarray:
    """The array ``name``; ``get(key)`` returns a value or None when the
    store lacks the key."""
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"no zarr array {name!r}")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ZarrError(f"{name}: zarr_format {meta.get('zarr_format')}")
    if meta.get("filters"):
        raise ZarrError(f"{name}: filters are not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ZarrError(f"{name}: compressor {comp.get('id')!r} is not "
                        "supported")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ZarrError(f"{name}: order {order!r}")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ZarrError(f"{name}: dimension_separator {sep!r}")
    dt = _dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ZarrError(f"{name}: chunks {chunks} for shape {shape}")
    grid = [range(math.ceil(s / c)) for s, c in zip(shape, chunks)]
    n_chunk = math.prod(chunks)
    out = None
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = get(key)
        if data is not None:
            if comp is not None:
                data = zstd.decompress(data)
            if len(data) != n_chunk * dt.itemsize:
                raise ZarrError(f"{key}: {len(data)} bytes, expected "
                                f"{n_chunk * dt.itemsize}")
            chunk = np.frombuffer(data, dt).reshape(chunks, order=order)
            if chunks == shape:      # one chunk: the array itself
                return chunk
        if out is None:
            out = np.full(shape, _fill(meta.get("fill_value"), dt), dt)
        if data is not None:
            sl = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
            out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    if out is None:                  # a zero-size array has no chunk
        out = np.full(shape, _fill(meta.get("fill_value"), dt), dt)
    return out


def encode(name: str, arr: np.ndarray) -> dict[str, bytes]:
    """The store entries of ``arr`` as orbax writes a single-device array:
    ``name/.zarray`` and one chunk."""
    arr = np.asarray(arr, order="C")
    dt = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else \
        arr.dtype
    meta = {"chunks": [max(d, 1) for d in arr.shape],
            "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dt.str,
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(arr.shape), "zarr_format": 2}
    key = ".".join(["0"] * arr.ndim) if arr.ndim else "0"
    items = {f"{name}/.zarray": json.dumps(meta, separators=(",", ":"),
                                           sort_keys=True).encode()}
    if arr.size:                     # a zero-size array has no chunk
        items[f"{name}/{key}"] = zstd.frame_raw(
            arr.astype(dt, copy=False).reshape(-1).view(np.uint8))
    return items
