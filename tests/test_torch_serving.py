"""The port's serving path on the CPU: engine, HTTP daemon, PNG codec.

The port's f32 ``InferenceEngine(device="cpu")`` is held to the JAX
``InferenceEngine(dtype="float32")`` given the same weights (<= 1 gray
level: conv reassociation only), and mirrors the JAX serving tests'
bucket/crop/padding cases (tests/test_serving.py).
"""
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import cv2
import jax
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.models.mnet import MNet as JaxMNet
from shadow_removal_istd_tpu.serving import (
    InferenceEngine as JaxInferenceEngine,
)
from shadow_removal_istd_tpu_torch.serving import (
    InferenceEngine,
    MicroBatcher,
    ServerStats,
    ShadowRemovalServer,
)
from shadow_removal_istd_tpu_torch.serving.server import main as serve_main
from shadow_removal_istd_tpu_torch.utils import image_io
from shadow_removal_istd_tpu_torch.utils.image_io import (
    imdecode_color,
    imencode_png,
    png_decode,
    png_encode,
)

ENGINE_KW = dict(ngf=4, dtype="float32", max_batch=4, device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _img(h, w, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (h, w, 3), dtype=np.uint8)


def _np_tree(v):
    return jax.tree.map(np.asarray, v)


def _save_npz(path, variables):
    """A JAX variable tree as the port's .npz weight file."""
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    np.savez(path, **{"/".join(k.key for k in p): np.asarray(a)
                      for p, a in flat})


_JIT_INIT = jax.jit(JaxMNet.init, static_argnums=0)


def _jax_engine(seed=0):
    """The JAX f32 engine at ngf 4. It runs flax init op by op (~24 s on
    the CPU); the same init under jit, compiled once per net, gives
    equally valid weights, and the tests compare engines given the same
    weights."""
    with mock.patch.object(JaxMNet, "init", _JIT_INIT):
        return JaxInferenceEngine("mnet", ngf=4, dtype="float32",
                                  max_batch=4, seed=seed)


@pytest.fixture(scope="module")
def jax_engine():
    return _jax_engine()


@pytest.fixture(scope="module")
def engine(jax_engine):
    eng = InferenceEngine(**ENGINE_KW)
    eng.set_variables(_np_tree(jax_engine.v1), _np_tree(jax_engine.v2))
    return eng


class TestEngine:
    @pytest.mark.parametrize("sizes", [[(40, 56)], [(64, 64)],
                                       [(32, 32)] * 3])
    def test_matches_jax_engine(self, engine, jax_engine, sizes):
        imgs = [_img(h, w, seed=s) for s, (h, w) in enumerate(sizes)]
        for (gm, gy), (wm, wy) in zip(engine.infer_group(imgs),
                                      jax_engine.infer_group(imgs)):
            assert gm.shape == wm.shape and gy.shape == wy.shape
            assert np.abs(gm.astype(np.int16) - wm).max() <= 1
            assert np.abs(gy.astype(np.int16) - wy).max() <= 1

    def test_bucket_rounding(self, engine):
        assert engine.bucket_of(40, 56) == (64, 64)
        assert engine.bucket_of(64, 64) == (64, 64)
        assert engine.bucket_of(65, 64) == (96, 64)

    def test_output_shapes_and_crop(self, engine):
        (matte, clean), = engine.infer_group([_img(40, 56)])
        assert matte.shape == (40, 56) and matte.dtype == np.uint8
        assert clean.shape == (40, 56, 3) and clean.dtype == np.uint8

    def test_batch_padding_does_not_leak(self, engine):
        imgs = [_img(32, 32, seed=s) for s in range(3)]
        grouped = engine.infer_group(imgs)
        for img, (gm, gy) in zip(imgs, grouped):
            (sm, sy), = engine.infer_group([img])
            np.testing.assert_array_equal(gm, sm)
            np.testing.assert_array_equal(gy, sy)

    def test_mixed_buckets_rejected(self, engine):
        with pytest.raises(ValueError, match="mixed buckets"):
            engine.infer_group([_img(32, 32), _img(96, 96)])

    def test_bf16_engine_casts_every_leaf(self, jax_engine):
        eng = InferenceEngine(ngf=4, dtype="bfloat16", max_batch=2,
                              device="cpu")
        eng.set_variables(_np_tree(jax_engine.v1), _np_tree(jax_engine.v2))
        tensors = [*eng.g1.parameters(), *eng.g1.buffers(),
                   *eng.g2.parameters(), *eng.g2.buffers()]
        assert {t.dtype for t in tensors} == {torch.bfloat16}
        (matte, clean), = eng.infer_group([_img(32, 32)])
        assert clean.shape == (32, 32, 3)

    def test_load_weights_npz(self, tmp_path, engine, jax_engine):
        _save_npz(tmp_path / "g1.npz", jax_engine.v1)
        _save_npz(tmp_path / "g2.npz", jax_engine.v2)
        fresh = InferenceEngine(seed=7, **ENGINE_KW)
        img = _img(32, 32, seed=21)
        before = fresh.infer_group([img])[0][1]
        fresh.load_weights(str(tmp_path / "g1.npz"), str(tmp_path / "g2.npz"))
        want = engine.infer_group([img])[0][1]
        assert not np.array_equal(before, want)
        np.testing.assert_array_equal(fresh.infer_group([img])[0][1], want)

    def test_load_weights_msgpack(self, tmp_path, engine, jax_engine):
        """The JAX package's per-network weight files (flax msgpack, as
        its ``save_model_weights`` writes them) load as the .npz route
        does."""
        from flax import serialization

        paths = []
        for name, v in (("G1", jax_engine.v1), ("G2", jax_engine.v2)):
            path = tmp_path / f"{name}_MNet_best.msgpack"
            path.write_bytes(serialization.to_bytes(
                {"params": v["params"], "batch_stats": v["batch_stats"]}))
            paths.append(str(path))
        fresh = InferenceEngine(seed=7, **ENGINE_KW)
        img = _img(32, 32, seed=23)
        fresh.load_weights(*paths)
        for (m, y), (wm, wy) in zip(fresh.infer_group([img]),
                                    engine.infer_group([img])):
            np.testing.assert_array_equal(m, wm)
            np.testing.assert_array_equal(y, wy)

    def test_load_weights_is_atomic(self, tmp_path, jax_engine):
        _save_npz(tmp_path / "g1.npz", jax_engine.v1)
        _save_npz(tmp_path / "g2.npz", jax_engine.v1)  # G1 tree for G2
        eng = InferenceEngine(seed=7, **ENGINE_KW)
        g1, g2 = eng.g1, eng.g2
        with pytest.raises(ValueError):
            eng.load_weights(str(tmp_path / "g1.npz"),
                             str(tmp_path / "g2.npz"))
        assert eng.g1 is g1 and eng.g2 is g2

    @pytest.mark.parametrize("devices", [2, ["cpu", "cpu", "cpu"]])
    def test_devices_replicas_answer_as_one_device(self, tmp_path,
                                                   jax_engine, devices):
        """``devices``: a replica per device, each taking an equal slice
        of the coalesced batch (3 images pad to 4 over 2 replicas, to 6
        over 3): the answers equal the one-device engine's, in order;
        int8 stays single-device, as in JAX."""
        _save_npz(tmp_path / "g1.npz", jax_engine.v1)
        _save_npz(tmp_path / "g2.npz", jax_engine.v2)
        one = InferenceEngine(**ENGINE_KW)
        many = InferenceEngine(**ENGINE_KW, devices=devices)
        for e in (one, many):
            e.load_weights(str(tmp_path / "g1.npz"),
                           str(tmp_path / "g2.npz"))
        assert len(many.replicas) == len(many.devices) == (
            devices if isinstance(devices, int) else len(devices))
        imgs = [_img(40, 56, seed=s) for s in range(3)]
        for (m, y), (wm, wy) in zip(many.infer_group(imgs),
                                    one.infer_group(imgs)):
            np.testing.assert_array_equal(m, wm)
            np.testing.assert_array_equal(y, wy)
        with pytest.raises(ValueError, match="single-device"):
            InferenceEngine(ngf=4, dtype="int8", devices=2, device="cpu")

    @pytest.mark.parametrize("kw", [dict(net_g="unet"),
                                    dict(nn_upconv=False),
                                    dict(use_selu=True)])
    def test_int8_refuses_other_configurations(self, kw):
        """int8 serving takes the MNet nearest-upsample configuration
        only, with the JAX engine's message."""
        with pytest.raises(ValueError, match="MNet nearest-upsample"):
            InferenceEngine(ngf=4, dtype="int8", device="cpu", **kw)
        with pytest.raises(ValueError, match="MNet nearest-upsample"):
            JaxInferenceEngine(ngf=4, dtype="int8", **kw)


class TestMicroBatcher:
    def test_coalesces_concurrent_requests(self, engine):
        stats = ServerStats()
        b = MicroBatcher(engine, window_ms=300.0, stats=stats)
        try:
            futs = [b.submit(_img(32, 32, seed=s)) for s in range(4)]
            outs = [f.result(timeout=120) for f in futs]
            assert all(o[1].shape == (32, 32, 3) for o in outs)
            snap = stats.snapshot()
            assert snap["images"] == 4 and snap["max_batch"] >= 2
        finally:
            b.close()


def _post(srv, body, path="/v1/unshadow"):
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=300)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _get(srv, path):
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def server(engine):
    srv = ShadowRemovalServer(engine, port=0, window_ms=20.0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()


class TestHTTP:
    def test_healthz_reports_torch_device(self, server):
        status, body = _get(server, "/healthz")
        info = json.loads(body)
        assert status == 200 and info["status"] == "ok"
        assert info["platform"] == "cpu" and info["dtype"] == "float32"

    def test_roundtrip_equals_infer_group(self, server, engine):
        img = _img(40, 56, seed=11)
        status, headers, body = _post(server, imencode_png(img))
        assert status == 200 and headers["Content-Type"] == "image/png"
        np.testing.assert_array_equal(imdecode_color(body),
                                      engine.infer_group([img])[0][1])
        status, _, body = _post(server, imencode_png(img),
                                path="/v1/unshadow?output=matte")
        assert status == 200
        np.testing.assert_array_equal(png_decode(body)[..., 0],
                                      engine.infer_group([img])[0][0])

    def test_concurrent_requests_and_stats(self, server):
        imgs = [imencode_png(_img(32, 32, seed=s)) for s in range(4)]
        with ThreadPoolExecutor(max_workers=4) as pool:
            results = list(pool.map(lambda b: _post(server, b), imgs))
        assert all(r[0] == 200 for r in results)
        status, body = _get(server, "/stats")
        snap = json.loads(body)
        assert status == 200 and snap["requests"] >= 4
        assert snap["batches"] >= 1 and "latency_ms" in snap

    def test_bad_requests(self, server):
        assert _post(server, b"not an image")[0] == 400
        assert _post(server, imencode_png(_img(8, 8)),
                     path="/v1/unshadow?output=bogus")[0] == 400
        assert _post(server, b"")[0] == 411
        assert _get(server, "/nope")[0] == 404

    def test_hot_reload_npz(self, tmp_path, engine, jax_engine):
        donor = _jax_engine(seed=7)
        _save_npz(tmp_path / "g1.npz", donor.v1)
        _save_npz(tmp_path / "g2.npz", donor.v2)
        own = InferenceEngine(**ENGINE_KW)
        own.set_variables(_np_tree(jax_engine.v1), _np_tree(jax_engine.v2))
        srv = ShadowRemovalServer(own, port=0, window_ms=0.0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            img = _img(32, 32, seed=41)
            before = _post(srv, imencode_png(img))[2]
            status, _, _ = _post(srv, json.dumps(
                {"g1": str(tmp_path / "g1.npz"),
                 "g2": str(tmp_path / "g2.npz")}).encode(),
                path="/admin/reload")
            assert status == 200
            after = imdecode_color(_post(srv, imencode_png(img))[2])
            assert not np.array_equal(after, imdecode_color(before))
            want = donor.infer_group([img])[0][1]
            assert np.abs(after.astype(np.int16) - want).max() <= 1
            assert _post(srv, b"{}", path="/admin/reload")[0] == 400
            assert _post(srv, json.dumps({"g1": "/nope.npz",
                                          "g2": "/nope.npz"}).encode(),
                         path="/admin/reload")[0] == 400
            assert _post(srv, json.dumps({"g1": "/nope.msgpack",
                                          "g2": "/nope.msgpack"}).encode(),
                         path="/admin/reload")[0] == 400
        finally:
            srv.shutdown()


class _GatedEngine:
    """Fake engine that serves nothing until its gate opens: the
    saturation test fills the queue whatever the host's speed."""

    dtype = "float32"
    device = torch.device("cpu")
    max_batch = 2

    def __init__(self):
        self.gate = threading.Event()

    def bucket_of(self, h, w):
        return (64, 64)

    def infer_group(self, imgs):
        self.gate.wait(timeout=120)
        return [(np.zeros(im.shape[:2], np.uint8),
                 np.zeros(im.shape[:2] + (3,), np.uint8)) for im in imgs]


def test_full_queue_answers_503_with_retry_after():
    engine = _GatedEngine()
    srv = ShadowRemovalServer(engine, port=0, window_ms=1.0, max_queue=3)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        png = imencode_png(_img(32, 32))
        with ThreadPoolExecutor(max_workers=32) as ex:
            futs = [ex.submit(lambda: _post(srv, png)[:2])
                    for _ in range(32)]
            deadline = time.monotonic() + 120
            while (srv.stats.snapshot()["shed"] == 0
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            engine.gate.set()
            outcomes = [f.result() for f in futs]
        statuses = [st for st, _ in outcomes]
        assert set(statuses) <= {200, 503}
        assert statuses.count(200) >= 1 and statuses.count(503) >= 1
        assert all(hdr.get("Retry-After") == "1"
                   for st, hdr in outcomes if st == 503)
        snap = json.loads(_get(srv, "/stats")[1])
        assert snap["shed"] == statuses.count(503) and snap["max_queue"] == 3
    finally:
        srv.shutdown()


def _serve_once(flags, img):
    """``python -m shadow_removal_istd_tpu_torch.serving --device cpu
    --warmup '' *flags`` on a free port: once /healthz answers, POST
    ``img`` as a PNG (HTTP 200 asserted) and read /stats, then SIGTERM
    (exit 0 asserted). Returns the reply image and the /stats JSON."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "shadow_removal_istd_tpu_torch.serving",
         "--device", "cpu", "--port", str(port), "--warmup", "", *flags],
        cwd=REPO)
    try:
        deadline, up = time.time() + 60, False
        while time.time() < deadline and not up:
            assert proc.poll() is None, "server process died"
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=5)
                conn.request("GET", "/healthz")
                up = conn.getresponse().status == 200
                conn.close()
            except OSError:
                time.sleep(0.2)
        assert up, "daemon never became healthy"
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/unshadow", body=imencode_png(img))
        resp = conn.getresponse()
        assert resp.status == 200
        got = imdecode_color(resp.read())
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    return got, stats


def test_serving_module_entry_point(tmp_path, jax_engine):
    """``python -m shadow_removal_istd_tpu_torch.serving --device cpu``
    starts, answers on loaded .npz weights, exits 0 on SIGTERM."""
    _save_npz(tmp_path / "g1.npz", jax_engine.v1)
    _save_npz(tmp_path / "g2.npz", jax_engine.v2)
    got, _ = _serve_once(
        ["--ngf", "4", "--dtype", "float32",
         "--load-weights-g1", str(tmp_path / "g1.npz"),
         "--load-weights-g2", str(tmp_path / "g2.npz")], _img(32, 32))
    assert got.shape == (32, 32, 3)


def test_daemon_serves_on_two_devices(tmp_path, jax_engine):
    """``--devices 2`` (two CPU replicas with ``--device cpu``): the
    daemon answers as the one-device engine does."""
    _save_npz(tmp_path / "g1.npz", jax_engine.v1)
    _save_npz(tmp_path / "g2.npz", jax_engine.v2)
    img = _img(32, 48, seed=5)
    got, stats = _serve_once(
        ["--ngf", "4", "--dtype", "float32", "--devices", "2",
         "--load-weights-g1", str(tmp_path / "g1.npz"),
         "--load-weights-g2", str(tmp_path / "g2.npz")], img)
    engine = InferenceEngine(**ENGINE_KW)
    engine.load_weights(str(tmp_path / "g1.npz"), str(tmp_path / "g2.npz"))
    np.testing.assert_array_equal(got, engine.infer_group([img])[0][1])
    assert stats["requests"] >= 1


def test_daemon_serves_int8_with_calibration(tmp_path, jax_engine):
    """``--dtype int8 --int8-calib DIR``: the daemon calibrates on DIR's
    images, answers a request as an int8 engine calibrated on the same
    images does, and reports ``dtype: int8``; an image-less DIR is a usage
    error."""
    _save_npz(tmp_path / "g1.npz", jax_engine.v1)
    _save_npz(tmp_path / "g2.npz", jax_engine.v2)
    calib_dir = tmp_path / "calib"
    calib_dir.mkdir()
    calib = [_img(32, 32, seed=s) for s in (50, 51)]
    for i, im in enumerate(calib):
        image_io.imwrite(str(calib_dir / f"{i}.png"), im)
    (tmp_path / "empty").mkdir()
    weights = ["--load-weights-g1", str(tmp_path / "g1.npz"),
               "--load-weights-g2", str(tmp_path / "g2.npz")]
    with pytest.raises(SystemExit) as exc:
        serve_main(["--device", "cpu", "--ngf", "4", "--dtype", "int8",
                    "--int8-calib", str(tmp_path / "empty"), *weights])
    assert exc.value.code == 2
    want = InferenceEngine(ngf=4, dtype="int8", max_batch=1, device="cpu",
                           calib_images=calib)
    want.load_weights(str(tmp_path / "g1.npz"), str(tmp_path / "g2.npz"))
    img = _img(32, 32, seed=52)
    got, stats = _serve_once(
        ["--ngf", "4", "--dtype", "int8", "--int8-calib", str(calib_dir),
         "--max-batch", "1", *weights], img)
    np.testing.assert_array_equal(got, want.infer_group([img])[0][1])
    assert stats["dtype"] == "int8"


def _smooth(h, w, c):
    """A gradient image: libpng picks Sub/Up/Average/Paeth filters."""
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [(xx * (k + 1) + yy * (3 - k) + (xx * yy) % (7 + k)) % 256
              for k in range(c)]
    return np.stack(planes, -1).astype(np.uint8)


class TestPNG:
    @pytest.mark.parametrize("c", [1, 3, 4])
    def test_roundtrip_exact(self, c):
        img = np.random.default_rng(c).integers(0, 256, (17, 23, c),
                                                dtype=np.uint8)
        arg = img[..., 0] if c == 1 else img
        np.testing.assert_array_equal(png_decode(png_encode(arg)), img)
        if c < 4:  # the BGR serving surface: gray is replicated
            np.testing.assert_array_equal(imdecode_color(imencode_png(arg)),
                                          np.repeat(img, 3 // c, -1))

    @pytest.mark.parametrize("c", [1, 3, 4])
    @pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"])
    def test_roundtrip_every_filter(self, filters, c):
        """Each PNG row filter type, and all five mixed row by row, read
        back exactly by the stdlib codec and by cv2."""
        img = np.random.default_rng(c).integers(0, 256, (13, 19, c),
                                                dtype=np.uint8)
        f = np.arange(13) % 5 if filters == "mixed" else filters
        data = png_encode(img[..., 0] if c == 1 else img, f)
        np.testing.assert_array_equal(png_decode(data), img)
        want = cv2.imdecode(np.frombuffer(data, np.uint8),
                            cv2.IMREAD_UNCHANGED).reshape(img.shape)
        np.testing.assert_array_equal(
            want, img[..., [2, 1, 0, 3][:c]] if c > 1 else img)

    @pytest.mark.parametrize("c", [1, 3, 4])
    @pytest.mark.parametrize("kind", ["noise", "smooth"])
    def test_decode_equals_cv2(self, kind, c, monkeypatch):
        """cv2's own PNGs (libpng's adaptive filters) decode to cv2's
        pixels through the library and through the stdlib codec."""
        img = (_smooth(24, 40, c) if kind == "smooth"
               else np.random.default_rng(c).integers(
                   0, 256, (24, 40, c), dtype=np.uint8))
        ok, buf = cv2.imencode(".png", img.squeeze())
        assert ok
        data = buf.tobytes()
        want = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(imdecode_color(data), want)
        monkeypatch.setattr(image_io, "_library_decoder", lambda: None)
        np.testing.assert_array_equal(imdecode_color(data), want)

    def test_other_formats_use_the_library(self, monkeypatch):
        ok, buf = cv2.imencode(".jpg", _smooth(16, 16, 3))
        assert ok
        np.testing.assert_array_equal(
            imdecode_color(buf.tobytes()),
            cv2.imdecode(buf, cv2.IMREAD_COLOR))
        monkeypatch.setattr(image_io, "_library_decoder", lambda: None)
        with pytest.raises(ValueError, match="without cv2 or PIL"):
            imdecode_color(buf.tobytes())

    def test_malformed_png_raises_value_error(self, monkeypatch):
        data = png_encode(_img(8, 8))
        with pytest.raises(ValueError):
            imdecode_color(data[:40])
        monkeypatch.setattr(image_io, "_library_decoder", lambda: None)
        with pytest.raises(ValueError):
            imdecode_color(data[:40])


@pytest.mark.parametrize("flags,droprate", [
    (["--use-selu"], 0.0),
    (["--use-selu", "--droprate", "0.5"], 0.5),
])
def test_server_cli_serves_a_selu_unet(flags, droprate, tmp_path,
                                       monkeypatch):
    """``--use-selu`` (a SELU UNet: no BatchNorm leaves in its weight
    files) and ``--droprate`` (the identity in eval) reach the engine:
    ``serve_main``, run as ``python -m shadow_removal_istd_tpu_torch.
    serving``, answers a 32x32 request within 1 gray level of the JAX
    ``InferenceEngine`` given the same weights. The JAX engine's own
    random init (op by op, slow here) is replaced by zeros shaped by
    ``eval_shape``: ``set_variables`` replaces them before any use."""
    import flax.linen as nn

    from test_torch_train_models import random_variables

    init = nn.Module.init
    monkeypatch.setattr(nn.Module, "init", lambda self, *a, **k: jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda *a: init(self, *a, **k), *a)))
    je = JaxInferenceEngine("unet", ngf=4, use_selu=True, droprate=droprate,
                            dtype="float32")
    monkeypatch.undo()
    v = [random_variables(g, c, seed=90 + c, size=32)
         for g, c in ((je.g1, 3), (je.g2, 4))]
    assert not any("batch_stats" in t and t["batch_stats"] for t in v)
    je.set_variables(*v)
    _save_npz(tmp_path / "g1.npz", v[0])
    _save_npz(tmp_path / "g2.npz", v[1])
    img = _img(32, 32, seed=5)
    with jax.default_matmul_precision("highest"):
        (_, want), = je.infer_group([img])
    got, _ = _serve_once(
        ["--net-G", "unet", "--ngf", "4", *flags, "--dtype", "float32",
         "--load-weights-g1", str(tmp_path / "g1.npz"),
         "--load-weights-g2", str(tmp_path / "g2.npz")], img)
    assert got.shape == want.shape == (32, 32, 3)
    assert np.abs(got.astype(int) - want).max() <= 1
