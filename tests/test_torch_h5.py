"""The port's HDF5 dataset (``data/h5.py``) on its own HDF5 codec
(``data/hdf5_codec.py``), against the JAX package's h5py-based one.

On files that the JAX package's ``build_h5`` writes (through h5py) and on
a reference-layout file with ``S8`` names, the port's ``ISTDH5Dataset``
gives the JAX one's ``__getitem__``, ``load_all``, ``filenames`` and
``load_streams`` byte for byte, and the same ``KeyError`` for a missing
matte; files h5py writes outside the codec's subset (chunked, deflate,
shuffle, compact, the latest superblock, big-endian, compound) raise
``UnsupportedHDF5`` naming the feature. The codec's writer and h5py read
each other's files (nested groups, ints, floats, fixed and
variable-length strings). The port's ``build_h5`` writes a
file that h5py opens with the JAX-built file's names, shapes, dtypes and
values; the JAX reader's ``load_streams`` on it equals the port's. A
CPU ``Trainer`` trains and validates from ``RunConfig(data_h5=...)``,
and its ``--eval-metrics`` masks come from the file (or the matte proxy
when the file has none).
"""
import logging
import os
import shutil
import subprocess
import sys

import h5py
import numpy as np
import pytest

from shadow_removal_istd_tpu.data.h5 import ISTDH5Dataset as JDataset
from shadow_removal_istd_tpu.data.h5 import build_h5 as j_build_h5
from shadow_removal_istd_tpu_torch.data import hdf5_codec
from shadow_removal_istd_tpu_torch.data.h5 import (
    ISTDH5Dataset,
    build_h5,
)
from shadow_removal_istd_tpu_torch.data.istd import ISTDDataset
from shadow_removal_istd_tpu_torch.data.synthetic import write_istd_layout
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer

STREAMS = (("img", "matte", "target"), ("img", "mask", "target"),
           ("sp",))


@pytest.fixture(scope="module")
def istd_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("istd")
    write_istd_layout(str(root), n_train=4, n_test=2, h=64, w=64)
    return str(root)


@pytest.fixture(scope="module")
def jax_file(istd_root, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("h5") / "jax.h5")
    j_build_h5(path, istd_root)
    return path


@pytest.fixture(scope="module")
def ref_file(tmp_path_factory):
    """The reference's layout (no matte or mask), names as ``S8``."""
    path = str(tmp_path_factory.mktemp("h5") / "ref_only.h5")
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        g = f.create_group("train")
        for k in ("input_img", "target_img", "sp"):
            g.create_dataset(k, data=rng.random((3, 8, 8, 3),
                                                dtype=np.float32))
        g.create_dataset("filename", data=np.array(["a", "bc", "d-0001"],
                                                   dtype="S8"))
    return path


def _same(got, want):
    """Equal values of equal dtypes and shapes, dict by dict."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        if want.dtype == object:        # variable-length strings
            assert got.tolist() == want.tolist()
        else:
            assert got.tobytes() == want.tobytes()
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("which", ["jax_file", "ref_file"])
def test_reader_equals_jax_reader(which, request):
    path = request.getfixturevalue(which)
    for subset in ("train", "test") if which == "jax_file" else ("train",):
        got, want = ISTDH5Dataset(path, subset), JDataset(path, subset)
        assert len(got) == len(want) > 0
        for i in range(len(want)):
            _same(got[i], want[i])
        _same(got.load_all(), want.load_all())
        _same(got.filenames(), want.filenames())
        streams = STREAMS if which == "jax_file" else (("img", "target",
                                                        "sp"),)
        for datas in streams:
            _same(got.load_streams(datas), want.load_streams(datas))
        got.close()


def test_missing_matte_raises_the_jax_error(ref_file):
    with pytest.raises(KeyError, match="matte") as want:
        JDataset(ref_file, "train").load_streams(("img", "matte", "target"))
    with pytest.raises(KeyError, match="matte") as got:
        ISTDH5Dataset(ref_file, "train").load_streams(
            ("img", "matte", "target"))
    assert (str(got.value).replace("_torch", "")
            == str(want.value))


def _compact_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


@pytest.mark.parametrize("kw,libver,match", [
    (dict(chunks=True), None, "chunked layout"),
    (dict(compression="gzip"), None, r"filter pipeline \(deflate\)"),
    (dict(shuffle=True), None, r"filter pipeline \(shuffle\)"),
    (dict(dcpl="compact"), None, "compact layout"),
    ({}, "latest", "superblock version 3"),
    (dict(dtype=">f4"), None, "big-endian datatype"),
    (dict(dtype=[("a", "<f4"), ("b", "u1")]), None, "compound datatype"),
])
def test_unsupported_features_raise_by_name(kw, libver, match, tmp_path):
    path = str(tmp_path / "x.h5")
    kw = dict(kw)
    if kw.get("dcpl") == "compact":
        kw["dcpl"] = _compact_dcpl()
    data = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    if "dtype" in kw and kw["dtype"] != ">f4":
        data = np.zeros(4, dtype=kw.pop("dtype"))
    with h5py.File(path, "w", libver=libver) as f:
        f.create_group("train").create_dataset("input_img", data=data,
                                               **kw)
    with pytest.raises(hdf5_codec.UnsupportedHDF5, match=match):
        with hdf5_codec.File(path) as f:
            f["train/input_img"].read()


def test_port_build_h5_opens_in_h5py(istd_root, jax_file, tmp_path):
    path = str(tmp_path / "port.h5")
    build_h5(path, istd_root)
    with h5py.File(path, "r") as got, h5py.File(jax_file, "r") as want:
        assert sorted(got) == sorted(want) == ["test", "train"]
        for subset in want:
            assert sorted(got[subset]) == sorted(want[subset])
            for k in want[subset]:
                g, w = got[subset][k], want[subset][k]
                assert (g.shape, g.dtype) == (w.shape, w.dtype), k
                _same(g[()], w[()])
            assert got[subset]["filename"].dtype == h5py.string_dtype()
    for subset in ("train", "test"):
        for datas in STREAMS:
            _same(ISTDH5Dataset(path, subset).load_streams(datas),
                  JDataset(path, subset).load_streams(datas))
        _same(ISTDH5Dataset(path, subset).load_streams(("img", "matte",
                                                        "target")),
              ISTDDataset(istd_root, subset,
                          datas=("img", "matte", "target")).load_all())


def _tree():
    rng = np.random.default_rng(1)
    return {"a": {"f32": rng.random((3, 4, 5, 3), dtype=np.float32),
                  "u8": rng.integers(0, 256, (3, 4, 5, 1), np.uint8),
                  "names": np.array(["x.png", "é-2.png", ""], object),
                  "inner": {"f64": rng.random(7),
                            "i16": np.arange(-3, 3, dtype=np.int16)}},
            "b": {"fixed": np.array([b"ab", b"cdefgh"], "S8"),
                  "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
                  "many": np.array([f"n{i}" for i in range(70000)],
                                   object)}}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("writer", ["codec", "h5py"])
def test_codec_round_trip_with_h5py(writer, tmp_path):
    """Each writer's file read by the other side and by itself: names,
    shapes, dtypes and values of f32, f64, u8, i16, i64, fixed and
    variable-length UTF-8 strings (70000 of them: more than one global
    heap collection) in nested groups."""
    path = str(tmp_path / "t.h5")
    tree = _tree()
    if writer == "codec":
        hdf5_codec.write_file(path, tree)
    else:
        with h5py.File(path, "w") as f:
            for name, v in _leaves(tree):
                if v.dtype == object:
                    v = v.astype(h5py.string_dtype())
                f.create_dataset(name, data=v)
    with h5py.File(path, "r") as h, hdf5_codec.File(path) as c:
        assert sorted(c.keys()) == sorted(h.keys()) == ["a", "b"]
        for name, v in _leaves(tree):
            got, want = c[name].read(), h[name][()]
            assert c[name].shape == v.shape == want.shape, name
            if v.dtype == object:
                assert h[name].dtype == h5py.string_dtype()
                assert got.tolist() == want.tolist() == [
                    s.encode() for s in v.tolist()], name
            else:
                _same(got, want)
                _same(got, v)
            assert name.rsplit("/", 1)[-1] in c[name.rsplit("/", 1)[0]]
        assert c["a/names"][1] == "é-2.png".encode()
        _same(c["a/f32"][-1], tree["a"]["f32"][-1])


def _trainer(tmp_path, path, **run):
    cfg = TrainConfig(ngf=4, ndf=4, image_size=32, batch_size=2,
                      droprate=0.0, use_visual_loss=False, lambda4=0.0,
                      lambda5=0.0)
    return Trainer(cfg, RunConfig(
        data_h5=path, logs_dir=str(tmp_path / "logs"),
        weights_dir=str(tmp_path / "w"),
        checkpoint_path=str(tmp_path / "ckpt.msgpack"), log_every=1,
        valid_every=1, vis_every=10, save_every=10, **run), device="cpu")


def test_trainer_trains_from_h5(istd_root, tmp_path):
    """``RunConfig(data_h5=...)``: the file's streams feed the device
    cache, its test split's names the validation."""
    path = str(tmp_path / "istd.h5")
    build_h5(path, istd_root)
    tr = _trainer(tmp_path, path, device_cache=True)
    assert len(tr.train_pipe) == 2          # 4 samples / batch 2
    assert tr.valid_names == ISTDH5Dataset(path, "test").filenames()
    assert tr.valid_names == ["000-test", "001-test"]
    tr.train(1)
    assert np.isfinite(tr.history[0]["G"])
    assert np.isfinite(tr.last_valid["total"])


@pytest.mark.parametrize("with_mask", [True, False])
def test_eval_metrics_masks_from_h5(with_mask, istd_root, tmp_path, caplog):
    """``--eval-metrics``: the test split's binary masks from the file;
    without a ``mask`` dataset, JAX's warning and the matte proxy."""
    root = tmp_path / "istd"
    shutil.copytree(istd_root, root)
    if not with_mask:       # build_h5 adds a mask where test_B exists
        shutil.rmtree(root / "test" / "test_B")
    path = str(tmp_path / "istd.h5")
    build_h5(path, str(root))
    assert ("mask" in hdf5_codec.File(path)["test"]) == with_mask
    with caplog.at_level(logging.WARNING):
        tr = _trainer(tmp_path, path, eval_metrics=True)
    want = ISTDDataset(istd_root, "test", datas=("mask",)).load_all()
    if with_mask:
        _same(tr._valid_masks, want["mask"])
    else:
        assert tr._valid_masks is None
        assert "HDF5 file carries no mask stream" in caplog.text
    tr.train(1)
    assert tr.last_eval and all(np.isfinite(v) for v in
                                tr.last_eval.values())
    assert all(k.startswith("Eval/" if with_mask else "EvalProxy/")
               for k in tr.last_eval)


def test_nothing_imports_h5py_on_the_read_path(jax_file):
    """The codec reads with h5py absent (the card's host has none)."""
    code = ("import sys; sys.modules['h5py'] = None; "
            "from shadow_removal_istd_tpu_torch.data.h5 import "
            "ISTDH5Dataset; "
            f"print(ISTDH5Dataset({jax_file!r}, 'train').filenames())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert "000-train" in out.stdout
