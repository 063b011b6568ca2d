"""The port's TensorBoard event-file writer (``utils/tb_writer.py``),
read back by ``tensorboard``'s ``EventAccumulator`` and by the port's own
CRC-checking reader, against ``tensorboardX``'s writer on the same
arrays: scalars exact in f32, image PNGs decoding to the same pixels.
"""
import os

import numpy as np
import pytest
import tensorboardX
from PIL import Image
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator,
)

from shadow_removal_istd_tpu_torch.utils import tb_writer
from shadow_removal_istd_tpu_torch.utils.tb_writer import (
    SummaryWriter,
    crc32c,
    read_events,
)


def _accumulate(logdir):
    ea = EventAccumulator(str(logdir), size_guidance={"scalars": 0,
                                                      "images": 0})
    ea.Reload()
    return ea


def _pixels(encoded: bytes) -> np.ndarray:
    import io
    return np.asarray(Image.open(io.BytesIO(encoded)))


def _images():
    rng = np.random.default_rng(0)
    return {
        "rgb_float": (rng.uniform(0, 1, (12, 20, 3)).astype(np.float32),
                      "HWC"),
        "gray_float": (rng.uniform(0, 1, (9, 7, 1)).astype(np.float32),
                       "HWC"),
        "chw_float": (rng.uniform(0, 1, (3, 10, 6)).astype(np.float32),
                      "CHW"),
        "rgb_uint8": (rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
                      "HWC"),
    }


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The same scalars and images through the port's writer and through
    tensorboardX's, each into its own directory."""
    root = tmp_path_factory.mktemp("tb")
    scalars = [("Loss/G", 0.1234567891, 0), ("Loss/G", -3.5e-7, 1),
               ("perf/images_per_sec", 51.9, 2), ("D1_output/diff", 1e30, 3)]
    for name, cls in (("port", SummaryWriter),
                      ("tbx", tensorboardX.SummaryWriter)):
        w = cls(str(root / name))
        for tag, v, step in scalars:
            w.add_scalar(tag, v, step)
        for tag, (img, fmt) in _images().items():
            w.add_image(tag, img, 7, dataformats=fmt)
        w.flush()
        w.close()
    return root, scalars


@pytest.fixture(scope="module")
def accumulated(written):
    root, _ = written
    return _accumulate(root / "port"), _accumulate(root / "tbx")


def test_event_accumulator_reads_the_scalars_exactly(written, accumulated):
    _, scalars = written
    port, tbx = accumulated
    assert set(port.Tags()["scalars"]) == {t for t, _, _ in scalars}
    for tag in {t for t, _, _ in scalars}:
        want = [(s, float(np.float32(v))) for t, v, s in scalars if t == tag]
        got = [(e.step, e.value) for e in port.Scalars(tag)]
        assert got == want, tag
        assert got == [(e.step, e.value) for e in tbx.Scalars(tag)], tag


@pytest.mark.parametrize("tag", sorted(_images()))
def test_images_decode_to_tensorboardx_pixels(accumulated, tag):
    port, tbx = accumulated
    (got,), (want,) = port.Images(tag), tbx.Images(tag)
    assert (got.step, got.height, got.width) == (want.step, want.height,
                                                 want.width)
    a, b = _pixels(got.encoded_image_string), _pixels(
        want.encoded_image_string)
    np.testing.assert_array_equal(a, b)
    img, fmt = _images()[tag]
    np.testing.assert_array_equal(a, tb_writer.to_uint8_hwc(img, fmt))


def test_file_name_first_record_and_own_reader(written):
    root, scalars = written
    (name,) = os.listdir(root / "port")
    assert name.startswith("events.out.tfevents.")
    events = read_events(str(root / "port" / name))
    assert events[0]["file_version"] == "brain.Event:2"
    got = [(e["tag"], e["value"], e["step"]) for e in events[1:5]]
    assert got == [(t, float(np.float32(v)), s) for t, v, s in scalars]
    img = events[5]["value"]
    assert (img["height"], img["width"], img["colorspace"]) == (12, 20, 3)
    assert img["png"].startswith(b"\x89PNG")


def test_reader_rejects_a_corrupt_record(written, tmp_path):
    root, _ = written
    (name,) = os.listdir(root / "port")
    data = bytearray((root / "port" / name).read_bytes())
    data[-10] ^= 0x01
    bad = tmp_path / "bad"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_events(str(bad))
    bad.write_bytes(bytes(data[:-3]))
    with pytest.raises(ValueError, match="truncated"):
        read_events(str(bad))


@pytest.mark.parametrize("n", [0, 9, 16 * 1024 - 1, 16 * 1024, 70001])
def test_crc32c_chunked_equals_bytewise(n):
    """The chunked CRC (records of 16 KiB and up) against the byte loop;
    "123456789" gives the CRC-32C check value."""
    assert crc32c(b"123456789") == 0xE3069283
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tb_writer._CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    assert crc32c(data) == crc ^ 0xFFFFFFFF


def test_float_images_are_clipped():
    img = np.array([[[-0.5], [0.999], [1.5]]], np.float32)
    np.testing.assert_array_equal(tb_writer.to_uint8_hwc(img)[0],
                                  [[0] * 3, [254] * 3, [255] * 3])


def test_two_writers_in_one_second_get_two_files(tmp_path):
    a, b = SummaryWriter(str(tmp_path)), SummaryWriter(str(tmp_path))
    assert a.path != b.path
    a.close()
    b.close()
    assert len(os.listdir(tmp_path)) == 2
