"""The port's ISTD directory reader, host batch pipeline and image file IO
(``data/istd.py``, ``data/pipeline.py``, ``data/synthetic.py``,
``utils/image_io.py``) against the JAX package's on the same files.

Directories are 64x64 with 4 train and 2 test triplets. Each decode path
the port has is run: cv2, PIL (cv2 made unimportable) and the stdlib PNG
codec (no library), by replacing ``image_io._library_decoder``, with
the native PNG loader off (``load_all(native=False)``; it has its own
tests in tests/test_torch_host.py).
"""
import sys

import cv2
import numpy as np
import pytest

from shadow_removal_istd_tpu.data.istd import ISTDDataset as JDataset
from shadow_removal_istd_tpu.data.pipeline import BatchPipeline as JPipeline
from shadow_removal_istd_tpu.data.synthetic import (
    write_istd_layout as j_write_layout,
)
from shadow_removal_istd_tpu_torch.data.istd import ISTDDataset
from shadow_removal_istd_tpu_torch.data.pipeline import BatchPipeline
from shadow_removal_istd_tpu_torch.data.synthetic import write_istd_layout
from shadow_removal_istd_tpu_torch.utils import image_io

STREAMS = ("img", "mask", "matte", "target")


def _use_decoder(monkeypatch, path: str) -> None:
    """Route the port's decoding through ``path``: cv2, pil or stdlib."""
    if path == "pil":
        monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 fails
        decode = image_io._library_decoder.__wrapped__()
        monkeypatch.setattr(image_io, "_library_decoder", lambda: decode)
    elif path == "stdlib":
        monkeypatch.setattr(image_io, "_library_decoder", lambda: None)


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("istd_jax")
    j_write_layout(str(root), n_train=4, n_test=2, h=64, w=64, seed=3)
    return str(root)


@pytest.mark.parametrize("decoder", ["cv2", "pil", "stdlib"])
@pytest.mark.parametrize("subset", ["train", "test"])
def test_load_all_equals_jax_loader(jax_dir, subset, decoder, monkeypatch):
    """Byte for byte, same dtype, stream names and file names."""
    _use_decoder(monkeypatch, decoder)
    got = ISTDDataset(jax_dir, subset, datas=STREAMS, name="istd")
    want = JDataset(jax_dir, subset, datas=STREAMS, name="istd")
    a, b = got.load_all(native=False), want.load_all(native=False)
    assert list(a) == list(b) == sorted(STREAMS)
    for k in b:
        assert a[k].dtype == b[k].dtype == np.uint8
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got.streams == want.streams
    assert ([got.filename(i) for i in range(len(got))]
            == [want.filename(i) for i in range(len(want))])
    name, *arrays = got[1]
    assert name == want.filename(1)
    for arr, k in zip(arrays, got.streams):
        np.testing.assert_array_equal(arr, b[k][1])


@pytest.mark.parametrize("decoder", ["cv2", "stdlib"])
def test_port_layout_has_the_jax_pixels(tmp_path, jax_dir, decoder,
                                        monkeypatch):
    """The port's writer (its own PNG encoder, rows in all five filter
    types) stores the JAX writer's pixels under the same names."""
    _use_decoder(monkeypatch, decoder)
    write_istd_layout(str(tmp_path), n_train=4, n_test=2, h=64, w=64,
                      seed=3)
    for subset in ("train", "test"):
        a = ISTDDataset(str(tmp_path), subset, datas=STREAMS)
        b = JDataset(jax_dir, subset, datas=STREAMS)
        assert a._files["img"][0].endswith(f"000-{subset}.png")
        got, want = a.load_all(native=False), b.load_all(native=False)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(a._files["img"][0], "rb") as f:
        data = f.read()
    assert data.startswith(b"\x89PNG")


def test_misaligned_streams_raise(tmp_path):
    write_istd_layout(str(tmp_path), n_train=3, n_test=2, h=32, w=32)
    (tmp_path / "train" / "train_matte" / "000-train.png").unlink()
    with pytest.raises(ValueError, match="misaligned ISTD streams"):
        ISTDDataset(str(tmp_path), "train", datas=("img", "matte"))
    ISTDDataset(str(tmp_path), "train", datas=("img", "target"))
    with pytest.raises(ValueError, match="subset"):
        ISTDDataset(str(tmp_path), "valid")


@pytest.mark.parametrize("decoder", ["pil", "stdlib"])
def test_gray_stream_stored_as_color_needs_cv2(tmp_path, decoder,
                                               monkeypatch):
    """cv2's RGB -> gray rounding has no bit-exact twin: without cv2 a
    color PNG in a gray stream raises, as the JAX native loader refuses
    it; with cv2 it decodes to what the JAX loader reads."""
    write_istd_layout(str(tmp_path), n_train=2, n_test=1, h=32, w=32)
    path = tmp_path / "train" / "train_matte" / "000-train.png"
    gray = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    color = np.stack([gray, gray // 2, 255 - gray], -1)
    cv2.imwrite(str(path), color)
    want = JDataset(str(tmp_path), "train",
                    datas=("matte",)).load_all(native=False)["matte"]
    got = ISTDDataset(str(tmp_path), "train", datas=("matte",)).load_all()
    np.testing.assert_array_equal(got["matte"], want)
    _use_decoder(monkeypatch, decoder)
    with pytest.raises(ValueError, match="gray decode of a color PNG"):
        ISTDDataset(str(tmp_path), "train", datas=("matte",)).load_all()


@pytest.mark.parametrize("c", [1, 3])
def test_imwrite_imread_round_trip(tmp_path, c, monkeypatch):
    img = np.random.default_rng(c).integers(0, 256, (13, 21, c), np.uint8)
    path = str(tmp_path / "x.png")
    image_io.imwrite(path, img[..., 0] if c == 1 else img,
                     filters=np.arange(13) % 5)
    read = image_io.imread_gray if c == 1 else image_io.imread_color
    want = cv2.imread(path, cv2.IMREAD_GRAYSCALE if c == 1
                      else cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(want.reshape(img.shape), img)
    np.testing.assert_array_equal(read(path).reshape(img.shape), img)
    monkeypatch.setattr(image_io, "_library_decoder", lambda: None)
    np.testing.assert_array_equal(read(path).reshape(img.shape), img)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False),
                                               (False, True)])
def test_batch_pipeline_equals_jax(shuffle, drop_last):
    rng = np.random.default_rng(0)
    streams = {k: rng.integers(0, 256, (7, 4, 4, c), np.uint8)
               for k, c in (("target", 3), ("img", 3), ("matte", 1))}
    got = BatchPipeline(streams, 3, shuffle=shuffle, drop_last=drop_last,
                        seed=11)
    want = JPipeline(streams, 3, shuffle=shuffle, drop_last=drop_last,
                     seed=11)
    assert len(got) == len(want) == (2 if drop_last else 3)
    # the stateful stream twice, then pure functions of (seed, epoch)
    for epoch in (None, None, 5, 0):
        a, b = list(got.epoch(epoch)), list(want.epoch(epoch))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert len(x) == 3
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
    # resume determinism: epoch 5 is the same batch order every time
    first = [x[0] for x in got.epoch(5)]
    again = [x[0] for x in BatchPipeline(streams, 3, shuffle=shuffle,
                                         drop_last=drop_last,
                                         seed=11).epoch(5)]
    for u, v in zip(first, again):
        np.testing.assert_array_equal(u, v)


def test_batch_pipeline_rejects_misaligned_streams():
    with pytest.raises(ValueError, match="misaligned"):
        BatchPipeline({"img": np.zeros((3, 2, 2, 3), np.uint8),
                       "matte": np.zeros((2, 2, 2, 1), np.uint8)}, 2)
