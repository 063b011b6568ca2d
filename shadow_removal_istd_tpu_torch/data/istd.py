"""ISTD directory dataset; port of ``shadow_removal_istd_tpu/data/istd.py``.

Layout (reference src/dataset.py:43-46):
``<root>/<subset>/<subset>_A``       shadow images (BGR)
``<root>/<subset>/<subset>_B``       binary shadow masks (gray)
``<root>/<subset>/<subset>_matte``   shadow mattes (gray)
``<root>/<subset>/<subset>_C_fixed`` color-fixed shadow-free targets (BGR)

Files are aligned by sorting on the stem; sample tuples are ordered by
*sorted stream name* (img, matte, target), the convention the engine
unpacks. :meth:`ISTDDataset.load_all` stacks a split into one uint8
array per stream. An all-PNG stream goes through the native batch
decoder (``data/native_loader.py``: one contiguous buffer, decoded on a
C++ thread pool, byte-identical to cv2); a stream it refuses (a gray
stream stored as RGB, whose cv2 gray conversion it does not reproduce)
or a host where it cannot be built decodes through the image library,
on a thread pool when cv2 or PIL decodes (in C, without the GIL) and on
one thread with the stdlib codec.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from shadow_removal_istd_tpu_torch.data import native_loader
from shadow_removal_istd_tpu_torch.utils.image_io import (
    decodes_in_c,
    imread_color,
    imread_gray,
)

STREAM_DIRS = {
    "img": "{s}_A",
    "mask": "{s}_B",
    "matte": "{s}_matte",
    "target": "{s}_C_fixed",
}
GRAY_STREAMS = {"mask", "matte"}


def _list_aligned(directory: str) -> list[str]:
    return sorted(os.listdir(directory),
                  key=lambda f: os.path.splitext(f)[0])


@dataclass
class ISTDDataset:
    """Aligned multi-stream ISTD reader."""

    root_dir: str
    subset: str = "train"
    datas: tuple[str, ...] = ("img", "mask", "target")
    name: str | None = None
    _files: dict = field(init=False, default_factory=dict)

    def __post_init__(self):
        if self.subset not in ("train", "test"):
            raise ValueError(f"subset must be train or test, got "
                             f"{self.subset!r}")
        base = os.path.join(self.root_dir, self.subset)
        counts = set()
        for stream in self.datas:
            d = os.path.join(base, STREAM_DIRS[stream].format(s=self.subset))
            files = _list_aligned(d)
            self._files[stream] = [os.path.join(d, f) for f in files]
            counts.add(len(files))
        if len(counts) != 1:
            raise ValueError(
                f"misaligned ISTD streams under {base}: sizes {counts}")
        self.streams = tuple(sorted(self.datas))

    def _read(self, stream: str, idx: int) -> np.ndarray:
        path = self._files[stream][idx]
        if stream in GRAY_STREAMS:
            return imread_gray(path)[..., None]
        return imread_color(path)

    def __len__(self) -> int:
        return len(self._files[self.datas[0]])

    def filename(self, idx: int) -> str:
        """The sample's stem, prefixed by ``name/`` when named."""
        files = next(iter(self._files.values()))
        stem = os.path.splitext(os.path.basename(files[idx]))[0]
        return os.path.join(self.name, stem) if self.name else stem

    def __getitem__(self, idx: int):
        """(filename, *streams): uint8 HWC arrays, sorted-stream order."""
        return (self.filename(idx),
                *(self._read(s, idx) for s in self.streams))

    def load_all(self, native: bool = True) -> dict[str, np.ndarray]:
        """Every stream stacked into one (N, H, W, C) uint8 array; the
        decoder each stream went through lands in ``self.decoded_by``
        (``"native"`` or ``"library"``)."""
        out = {}
        self.decoded_by = {}
        native_ok = native and native_loader.is_available()
        workers = os.cpu_count() if decodes_in_c() else 1
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for stream in self.streams:
                files = self._files[stream]
                if native_ok and all(f.lower().endswith(".png")
                                     for f in files):
                    try:
                        out[stream] = native_loader.decode_batch(
                            files, gray=stream in GRAY_STREAMS)
                        self.decoded_by[stream] = "native"
                        continue
                    except IOError:
                        pass    # e.g. a gray stream stored as RGB PNGs
                items = list(pool.map(lambda i, s=stream: self._read(s, i),
                                      range(len(self))))
                out[stream] = np.stack(items, axis=0)
                self.decoded_by[stream] = "library"
        return out
