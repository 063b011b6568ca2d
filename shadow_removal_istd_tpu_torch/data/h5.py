"""HDF5 ISTD dataset variant; port of ``shadow_removal_istd_tpu/data/h5.py``
on the port's own HDF5 codec (``data/hdf5_codec.py``: no h5py, which the
card's host lacks).

The reference's STCGAN/dataset_h5.py layout: groups ``<subset>`` with
datasets ``input_img``, ``target_img`` (BGR in [0, 1], f32), ``sp``
(shadow parameters, f32) and ``filename``; per-sample normalization
with the dataset's B, G, R statistics mean=(.54,.57,.57),
std=(.14,.14,.14) (dataset_h5.py:16-18, 47-48). :func:`build_h5` writes
the file from the ISTD directory layout and adds ``matte`` and ``mask``
(uint8) where their directories exist, so the trainer's
matte-conditioned pipeline can train from it (``--data-h5``).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from shadow_removal_istd_tpu_torch.data import hdf5_codec

# B, G, R (reference dataset_h5.py:16-18)
ISTD_MEAN = np.array([0.54, 0.57, 0.57], dtype=np.float32)
ISTD_STD = np.array([0.14, 0.14, 0.14], dtype=np.float32)

logger = logging.getLogger(__name__)


def _name(n) -> str:
    return n.decode() if isinstance(n, bytes) else str(n)


class ISTDH5Dataset:
    """Reader for the HDF5 layout; returns float32 normalized arrays.
    Holds the file open until :meth:`close`."""

    def __init__(self, file: str, subset: str = "train"):
        if subset not in ("train", "test"):
            raise ValueError(f"subset must be train or test, got "
                             f"{subset!r}")
        self._file = hdf5_codec.File(file)
        try:
            self._h5 = self._file[subset]
        except BaseException:
            self._file.close()
            raise

    def close(self) -> None:
        self._file.close()

    def __len__(self) -> int:
        return self._h5["filename"].shape[0]

    def __getitem__(self, idx: int):
        """(filename, input_img, target_img, sp): HWC float32, the images
        mean/std normalized (reference dataset_h5.py:42-65)."""
        img = np.asarray(self._h5["input_img"][idx], dtype=np.float32)
        target = np.asarray(self._h5["target_img"][idx], dtype=np.float32)
        sp = np.asarray(self._h5["sp"][idx], dtype=np.float32)
        name = _name(self._h5["filename"][idx])
        img = (img - ISTD_MEAN) / ISTD_STD
        target = (target - ISTD_MEAN) / ISTD_STD
        return name, img, target, sp

    def _f32(self, key: str) -> np.ndarray:
        return np.asarray(self._h5[key].read(), dtype=np.float32)

    def load_all(self) -> dict[str, np.ndarray]:
        imgs, targets = self._f32("input_img"), self._f32("target_img")
        imgs = (imgs - ISTD_MEAN) / ISTD_STD
        targets = (targets - ISTD_MEAN) / ISTD_STD
        return {"img": imgs, "target": targets, "sp": self._f32("sp")}

    def filenames(self) -> list[str]:
        return [_name(n) for n in self._h5["filename"].read()]

    def load_streams(self, datas=("img", "matte", "target")
                     ) -> dict[str, np.ndarray]:
        """Bulk-load trainer-format streams: uint8 (N, H, W, C) per key.

        ``img``/``target`` invert :func:`build_h5`'s /255 exactly; ``matte``/
        ``mask`` come from the datasets :func:`build_h5` adds (a file with
        only the reference's fields cannot feed the matte-conditioned D1
        and raises ``KeyError``); ``sp`` (float32) is selectable too."""
        out: dict[str, np.ndarray] = {}
        for key in datas:
            if key in ("img", "target"):
                a = self._f32("input_img" if key == "img" else "target_img")
                out[key] = np.round(a * 255.0).astype(np.uint8)
            elif key in ("matte", "mask"):
                if key not in self._h5:
                    raise KeyError(
                        f"HDF5 file has no {key!r} dataset — rebuild it "
                        "with shadow_removal_istd_tpu_torch.data.h5."
                        "build_h5 (the reference's dataset_h5 layout "
                        "carries only input_img/target_img/sp)")
                out[key] = np.asarray(self._h5[key].read(), dtype=np.uint8)
            elif key == "sp":
                out[key] = self._f32("sp")
            else:
                raise KeyError(f"unknown stream {key!r}")
        return out


def _sp_file(sp_dir: str, subset: str, stem: str) -> str | None:
    # tools/preprocess.py writes <root>/<subset>/sp/<stem>.npy; the flat
    # <sp_dir>/<subset>/<stem>.npy layout is accepted too
    for cand in (os.path.join(sp_dir, subset, "sp", f"{stem}.npy"),
                 os.path.join(sp_dir, subset, f"{stem}.npy")):
        if os.path.isfile(cand):
            return cand
    return None


def build_h5(out_path: str, root_dir: str, subsets=("train", "test"),
             sp_dir: str | None = None) -> None:
    """Build the HDF5 file from the ISTD directory layout.

    ``sp`` is loaded from ``<sp_dir>/<subset>/sp/<stem>.npy`` when
    present, else computed as shadowless / shadowed (reference
    src/utils.py:45-47)."""
    from shadow_removal_istd_tpu_torch.data.istd import ISTDDataset
    from shadow_removal_istd_tpu_torch.tools.preprocess import compute_sp

    tree = {}
    for subset in subsets:
        extra = [s for s in ("matte", "mask") if os.path.isdir(os.path.join(
            root_dir, subset,
            f"{subset}_{'matte' if s == 'matte' else 'B'}"))]
        ds = ISTDDataset(root_dir, subset=subset,
                         datas=tuple(["img", "target"] + extra))
        data = ds.load_all()
        sps, n_loaded = [], 0
        for i in range(len(ds)):
            stem = os.path.basename(ds.filename(i))
            npy = _sp_file(sp_dir, subset, stem) if sp_dir else None
            if npy is not None:
                n_loaded += 1
                sps.append(np.load(npy).astype(np.float32))
            else:
                sps.append(compute_sp(data["img"][i], data["target"][i]))
        if sp_dir is not None and n_loaded < len(ds):
            logger.warning(
                "build_h5: %d/%d sp files found under %s for subset %s; "
                "the rest were recomputed from %s_C_fixed (run "
                "tools/preprocess.py, or check the layout "
                "<sp_dir>/<subset>/sp/<stem>.npy)",
                n_loaded, len(ds), sp_dir, subset, subset)
        tree[subset] = {
            "input_img": data["img"].astype(np.float32) / 255.0,
            "target_img": data["target"].astype(np.float32) / 255.0,
            "sp": np.stack(sps),
            **{s: data[s] for s in extra},
            "filename": np.array([ds.filename(i) for i in range(len(ds))],
                                 dtype=object)}
    hdf5_codec.write_file(out_path, tree)
