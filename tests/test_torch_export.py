"""Serving export on the CPU: the port's ``torch.export`` artifact
(``tools/export.py``) against the port's ``infer_step``, the JAX
package's ``make_infer_step`` and the JAX package's own StableHLO
artifact on the same weights; the decoder steps as the registered op
``srit::decoder_upsample`` in the graph; ``ArtifactEngine`` and the
daemon's ``--artifact``; the standalone export CLI and the training
CLI's ``--export-stablehlo``.

The cases mirror tests/test_export.py. Weights are the JAX
``init_state(key(0))`` generators (ngf 4) converted by
``tools/convert.py``; artifacts are exported once per module.
"""
import functools
import http.client
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.engine import TrainConfig as JConfig
from shadow_removal_istd_tpu.engine import build_models as j_build_models
from shadow_removal_istd_tpu.engine import init_state as j_init_state
from shadow_removal_istd_tpu.engine import make_infer_step
from shadow_removal_istd_tpu.engine.checkpoint import (
    save_checkpoint as j_save_checkpoint,
)
from shadow_removal_istd_tpu.tools.export import (
    export_stacked_inference as j_export,
)
from shadow_removal_istd_tpu.tools.export import load_exported as j_load
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.state import build_models
from shadow_removal_istd_tpu_torch.engine.steps import infer_step
from shadow_removal_istd_tpu_torch.serving import (
    ArtifactEngine,
    InferenceEngine,
)
from shadow_removal_istd_tpu_torch.tools import export as texport
from shadow_removal_istd_tpu_torch.tools.convert import flax_tree_to_torch
from shadow_removal_istd_tpu_torch.utils.image_io import (
    imdecode_color,
    imencode_png,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OP = "srit.decoder_upsample.default"
J_KW = dict(ngf=4, ndf=4, image_size=32, batch_size=2,
            use_visual_loss=False, droprate=0.0, steps_per_epoch=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs several workers on few cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@functools.cache
def _jax_pair(nn_upconv: bool, seed: int = 0):
    """The JAX models and ``init_state(key(seed))`` at ngf 4."""
    cfg = JConfig(nn_upconv=nn_upconv, **J_KW)
    models = j_build_models(cfg)
    return models, j_init_state(jax.random.key(seed), cfg, models)


def _port_models(jstate, nn_upconv: bool):
    """The port's f32 CPU G pair holding the JAX state's generators."""
    models = build_models(TrainConfig(ngf=4, ndf=4, nn_upconv=nn_upconv))
    for k in ("g1", "g2"):
        flax_tree_to_torch({"params": _np(jstate.g_params[k]),
                            "batch_stats": _np(jstate.batch_stats[k])},
                           getattr(models, k))
    return models


@pytest.fixture(scope="module")
def art_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("artifacts")


@functools.cache
def _artifact(art_dir, nn_upconv: bool, batch, hw=(32, 32)) -> str:
    """The port's artifact of the JAX key(0) pair (exported once)."""
    _, jstate = _jax_pair(nn_upconv)
    path = str(art_dir / f"port_{nn_upconv}_{batch}_{hw[0]}x{hw[1]}.pt2")
    nbytes = texport.export_stacked_inference(
        path, None, _port_models(jstate, nn_upconv), image_shape=hw,
        batch_size=batch)
    assert nbytes == os.path.getsize(path) > 0
    assert not os.path.exists(path + ".tmp")
    return path


def _x(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _port_infer(models, x):
    g1, g2 = models.g1.eval(), models.g2.eval()
    with torch.no_grad():
        m, y = infer_step(g1, g2, torch.from_numpy(x).permute(0, 3, 1, 2))
    return (m.permute(0, 2, 3, 1).numpy(), y.permute(0, 2, 3, 1).numpy())


def _run(path, x):
    m, y = texport.load_exported(path, device="cpu")(torch.from_numpy(x))
    return m.numpy(), y.numpy()


@pytest.mark.parametrize("nn_upconv", [False, True],
                         ids=["convtranspose", "nearest"])
def test_roundtrip_matches_infer_step_and_jax(art_dir, tmp_path, nn_upconv):
    """Pinned batch 2: the artifact equals the port's ``infer_step``
    (1e-6), JAX's ``make_infer_step`` and JAX's own exported artifact
    (1e-5), in both decoder forms."""
    jmodels, jstate = _jax_pair(nn_upconv)
    path = _artifact(art_dir, nn_upconv, 2)
    x = _x((2, 32, 32, 3), 1)
    m, y = _run(path, x)
    assert m.shape == (2, 32, 32, 1) and y.shape == (2, 32, 32, 3)
    assert m.dtype == y.dtype == np.float32
    pm, py = _port_infer(_port_models(jstate, nn_upconv), x)
    np.testing.assert_allclose(m, pm, atol=1e-6, rtol=0)
    np.testing.assert_allclose(y, py, atol=1e-6, rtol=0)
    jm, jy = make_infer_step(jmodels)(jstate.g_params, jstate.batch_stats,
                                      jnp.asarray(x))
    np.testing.assert_allclose(m, np.asarray(jm), atol=1e-5, rtol=0)
    np.testing.assert_allclose(y, np.asarray(jy), atol=1e-5, rtol=0)
    jpath = str(tmp_path / "jax.shlo")
    j_export(jpath, jstate, jmodels, image_shape=(32, 32), batch_size=2,
             platforms=("cpu",))
    am, ay = j_load(jpath)(jnp.asarray(x))
    np.testing.assert_allclose(m, np.asarray(am), atol=1e-5, rtol=0)
    np.testing.assert_allclose(y, np.asarray(ay), atol=1e-5, rtol=0)


@pytest.mark.parametrize("nn_upconv", [False, True],
                         ids=["convtranspose", "nearest"])
def test_graph_holds_the_decoder_op(art_dir, nn_upconv):
    """An MNet pair's graph calls ``srit::decoder_upsample`` 10 times and
    holds no plain decomposition of a decoder step: its only convs are
    the 10 encoder convs and its only pads their reflect pads."""
    ep = texport.load_program(_artifact(art_dir, nn_upconv, 2), "cpu")
    calls = [n for n in ep.graph.nodes if n.op == "call_function"]
    targets = [str(n.target) for n in calls]
    assert targets.count(OP) == 10
    assert targets.count("aten.conv2d.default") == 10
    assert not [t for t in targets if "replication_pad" in t
                or "constant_pad" in t or "convolution" in t
                or "conv_transpose" in t]
    pads = [n for n in calls if str(n.target) == "aten.pad.default"]
    assert len(pads) == 10
    assert all(n.args[2] == "reflect" for n in pads)
    steps = [n.args for n in calls if str(n.target) == OP]
    assert all(a[5] == (not nn_upconv) for a in steps)      # zero_pad
    assert [a[4] for a in steps].count(False) == 2   # the final steps


def test_symbolic_batch_serves_any_batch(art_dir):
    """``batch_size=None``: one artifact serves batches 1 and 3, each
    equal to ``infer_step``."""
    path = _artifact(art_dir, False, None)
    (b, h, w, c), dtype = texport.input_signature(
        texport.load_program(path, "cpu"))
    assert not isinstance(b, int) and (h, w, c) == (32, 32, 3)
    assert dtype == torch.float32
    models = _port_models(_jax_pair(False)[1], False)
    for n in (1, 3):
        x = _x((n, 32, 32, 3), n)
        m, y = _run(path, x)
        pm, py = _port_infer(models, x)
        assert m.shape == (n, 32, 32, 1)
        np.testing.assert_allclose(m, pm, atol=1e-6, rtol=0)
        np.testing.assert_allclose(y, py, atol=1e-6, rtol=0)


def test_gated_resolution_matches_jax(art_dir, tmp_path):
    """256x320 with the nearest decoder (JAX
    ``TestExportGatedFusedPath``): the artifact equals JAX's
    ``make_infer_step`` and JAX's artifact within 1e-5."""
    jmodels, jstate = _jax_pair(True)
    path = _artifact(art_dir, True, 1, (256, 320))
    x = _x((1, 256, 320, 3), 0)
    m, y = _run(path, x)
    jm, jy = make_infer_step(jmodels)(jstate.g_params, jstate.batch_stats,
                                      jnp.asarray(x))
    np.testing.assert_allclose(m, np.asarray(jm), atol=1e-5, rtol=0)
    np.testing.assert_allclose(y, np.asarray(jy), atol=1e-5, rtol=0)
    jpath = str(tmp_path / "jax_big.shlo")
    j_export(jpath, jstate, jmodels, image_shape=(256, 320), batch_size=1,
             platforms=("cpu",))
    am, ay = j_load(jpath)(jnp.asarray(x))
    np.testing.assert_allclose(m, np.asarray(am), atol=1e-5, rtol=0)
    np.testing.assert_allclose(y, np.asarray(ay), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint written by JAX ``save_checkpoint`` from ``key(42)``:
    not ``key(0)``, so that an export that silently dropped the load
    would not match (the reason at tests/test_export.py)."""
    jmodels, jstate = _jax_pair(False, seed=42)
    path = str(tmp_path_factory.mktemp("ckpt") / "checkpoint.msgpack")
    j_save_checkpoint(jstate, path, epoch=7)
    return path, jmodels, jstate


def test_standalone_export_cli(jax_checkpoint, tmp_path, caplog):
    """``tools.export.main`` on a JAX-written checkpoint: the artifact
    equals JAX's ``make_infer_step`` on that state; ``--platforms``
    warns and does not fail."""
    ckpt, jmodels, jstate = jax_checkpoint
    out = str(tmp_path / "served.pt2")
    with caplog.at_level(logging.WARNING):
        texport.main(["--load-checkpoint", ckpt, "--out", out, "--shape",
                      "32", "32", "--batch", "1", "--ngf", "4",
                      "--platforms", "cpu", "--device", "cpu"])
    assert "--platforms cpu has no meaning" in caplog.text
    x = _x((1, 32, 32, 3), 5)
    m, y = _run(out, x)
    jm, jy = make_infer_step(jmodels)(jstate.g_params, jstate.batch_stats,
                                      jnp.asarray(x))
    np.testing.assert_allclose(m, np.asarray(jm), atol=1e-5, rtol=0)
    np.testing.assert_allclose(y, np.asarray(jy), atol=1e-5, rtol=0)
    # the key(0) pair answers otherwise: the weights came from the file
    k0 = _port_infer(_port_models(_jax_pair(False)[1], False), x)[0]
    assert np.abs(m - k0).max() > 1e-3


def test_export_without_card_raises(jax_checkpoint, art_dir, tmp_path,
                                   monkeypatch):
    """The CLI, ``load_exported`` and ``ArtifactEngine`` default to the
    card and raise without one."""
    path = _artifact(art_dir, False, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.main(["--load-checkpoint", jax_checkpoint[0], "--out",
                      str(tmp_path / "a.pt2"), "--ngf", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.load_exported(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArtifactEngine(path)


def test_artifact_is_self_contained(art_dir):
    """A process that imports only ``torch`` and the op library loads
    and runs the artifact; the port's model classes are never imported,
    by ``torch.export.load`` nor by ``load_exported``."""
    path = _artifact(art_dir, False, 2)
    code = f"""
import sys, torch
import shadow_removal_istd_tpu_torch.ops.decoder
ep = torch.export.load({path!r})
m, y = ep.module()(torch.zeros(2, 32, 32, 3))
assert m.shape == (2, 32, 32, 1) and y.shape == (2, 32, 32, 3)
assert torch.isfinite(m).all() and torch.isfinite(y).all()
from shadow_removal_istd_tpu_torch.tools.export import load_exported
m2, _ = load_exported({path!r}, device="cpu")(torch.zeros(2, 32, 32, 3))
assert torch.equal(m, m2)
bad = [k for k in sys.modules if k.startswith(
    ("shadow_removal_istd_tpu_torch.models",
     "shadow_removal_istd_tpu_torch.engine", "jax", "flax"))]
assert not bad, bad
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


@pytest.fixture(scope="module")
def engine_pair(art_dir):
    """The f32 serving engine (split-skip, nearest) on the JAX key(0)
    nearest pair's weights, and its symbolic-batch 64x64 artifact."""
    _, jstate = _jax_pair(True)
    engine = InferenceEngine(ngf=4, dtype="float32", max_batch=4,
                             device="cpu")
    engine.set_variables(
        *({"params": _np(jstate.g_params[k]),
           "batch_stats": _np(jstate.batch_stats[k])} for k in ("g1", "g2")))
    path = str(art_dir / "engine_64.pt2")
    texport.export_stacked_inference(path, None, engine,
                                     image_shape=(64, 64))
    return engine, path


def _imgs(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in shapes]


def test_artifact_engine_replies_as_inference_engine(engine_pair):
    """uint8 replies equal ``InferenceEngine``'s on the same weights (f32),
    a smaller image padded and cropped back; the bucket is the exported
    (H, W) and a larger image is refused with JAX's message."""
    engine, path = engine_pair
    art = ArtifactEngine(path, max_batch=4, device="cpu")
    assert (art.height, art.width, art.fixed_batch, art.max_batch,
            art.dtype) == (64, 64, None, 4, "float32")
    assert not hasattr(art, "load_weights")
    for shapes in ([(64, 64)], [(40, 56), (64, 64), (33, 64)]):
        imgs = _imgs(shapes, seed=len(shapes))
        got, want = art.infer_group(imgs), engine.infer_group(imgs)
        for (m, y), (wm, wy), im in zip(got, want, imgs):
            assert m.shape == im.shape[:2] and y.shape == im.shape
            np.testing.assert_array_equal(m, wm)
            np.testing.assert_array_equal(y, wy)
    with pytest.raises(ValueError, match="exceeds the artifact's exported "
                                         "64x64; re-export"):
        art.bucket_of(64, 96)


def test_pinned_batch_fixes_max_batch(art_dir):
    art = ArtifactEngine(_artifact(art_dir, False, 2), max_batch=8,
                         device="cpu")
    assert art.fixed_batch == art.max_batch == 2
    (m, y), = art.infer_group(_imgs([(20, 30)]))
    assert m.shape == (20, 30) and y.shape == (20, 30, 3)
    with pytest.raises(ValueError, match="pinned batch 2"):
        art.infer_group(_imgs([(32, 32)] * 3))


def _daemon(flags):
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "shadow_removal_istd_tpu_torch.serving",
         "--device", "cpu", "--port", str(port), *flags], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    deadline = time.time() + 90
    while time.time() < deadline:
        assert proc.poll() is None, "server process died"
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            conn.request("GET", "/healthz")
            if conn.getresponse().status == 200:
                conn.close()
                return proc, port
        except OSError:
            time.sleep(0.2)
    proc.kill()
    raise AssertionError("daemon never became healthy")


def test_daemon_serves_an_artifact(engine_pair):
    """``--artifact --device cpu``: a PNG request answers as
    ``infer_group`` does, and a weight reload answers 501."""
    engine, path = engine_pair
    img = _imgs([(48, 64)], seed=9)[0]
    proc, port = _daemon(["--artifact", path, "--warmup", "64x64"])
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/unshadow", body=imencode_png(img))
        resp = conn.getresponse()
        assert resp.status == 200
        got = imdecode_color(resp.read())
        conn.request("POST", "/admin/reload",
                     body=json.dumps({"g1": "a", "g2": "b"}))
        resp = conn.getresponse()
        assert resp.status == 501
        assert b"--artifact" in resp.read()
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    np.testing.assert_array_equal(got, engine.infer_group([img])[0][1])
    assert health["dtype"] == "float32"


def test_cli_export_stablehlo_matches_jax(jax_checkpoint, tmp_path,
                                          monkeypatch):
    """``--tasks infer --export-stablehlo PATH --export-shape 32 32`` from
    a checkpoint: the port's CLI writes a ``torch.export`` artifact that
    ``load_exported(..., device="cpu")`` runs, equal within 1e-5 to the
    artifact the JAX CLI writes with the same flags."""
    from shadow_removal_istd_tpu.cli.main import build_parser as j_parser
    from shadow_removal_istd_tpu.cli.main import main as j_main
    from shadow_removal_istd_tpu_torch.cli.main import build_parser, main
    from shadow_removal_istd_tpu_torch.data.synthetic import (
        write_istd_layout,
    )

    monkeypatch.setenv("SRIT_COMPILE_CACHE", "")
    ckpt = jax_checkpoint[0]
    root = str(tmp_path / "istd")
    write_istd_layout(root, n_train=2, n_test=2, h=32, w=32)

    def argv(base, out):
        return ["--tasks", "infer", "--data-dir", root, "--ngf", "4",
                "--ndf", "4", "--image-size", "32", "--batch-size", "2",
                "--load-checkpoint", ckpt, "--weights", f"{base}/w",
                "--logs", f"{base}/l", "--infered", f"{base}/o",
                "--export-stablehlo", out, "--export-shape", "32", "32"]

    port_out, jax_out = str(tmp_path / "port.pt2"), str(tmp_path / "j.shlo")
    main(build_parser().parse_args(
        argv(str(tmp_path / "p"), port_out) + ["--devices", "cpu"]))
    j_main(j_parser().parse_args(argv(str(tmp_path / "j"), jax_out)))
    x = _x((3, 32, 32, 3), 7)
    m, y = _run(port_out, x)
    jm, jy = j_load(jax_out)(jnp.asarray(x))
    assert m.shape == (3, 32, 32, 1) and y.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(m, np.asarray(jm), atol=1e-5, rtol=0)
    np.testing.assert_allclose(y, np.asarray(jy), atol=1e-5, rtol=0)
