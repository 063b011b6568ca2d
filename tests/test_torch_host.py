"""The trainer's host side in the port on the CPU, against the JAX
package where it has a counterpart: the host-pipeline epoch
(``RunConfig(device_cache=False)``), ``prefetch_to_device``, the
TensorBoard scalars and image grids, the SIGTERM preemption save, the
profiler trace and the native PNG loader.

Held: the host epoch equals the fused epoch run on the pipeline's batch
order bit for bit (sums, parameters, BatchNorm statistics), and the JAX
trainer's host epoch on injected augmentation parameters (metrics
relative 1e-4, parameters 1e-5, as tests/test_torch_train.py holds the
fused epoch); the pipeline's order is the JAX ``BatchPipeline``'s;
``_log_scalars`` equals JAX's (relative 1e-6) and ``_log_images``' grids
JAX's (1e-5, one uint8 level after the PNG); a SIGTERM to a CLI training
process leaves a checkpoint from which the resumed run ends with the
files of an uninterrupted run, byte for byte; ``decode_batch`` equals
cv2 (tests/test_native_loader.py's cases).
"""
import json
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.data.pipeline import BatchPipeline as JPipeline
from shadow_removal_istd_tpu.engine import loop as jloop
from shadow_removal_istd_tpu.engine.config import TrainConfig as JConfig
from shadow_removal_istd_tpu.engine.state import build_models as j_build
from shadow_removal_istd_tpu.engine.steps import make_infer_step
from shadow_removal_istd_tpu.ops import pallas_shear as jshear
from shadow_removal_istd_tpu_torch.cli.main import build_parser, main
from shadow_removal_istd_tpu_torch.data import native_loader as nl
from shadow_removal_istd_tpu_torch.data.istd import ISTDDataset
from shadow_removal_istd_tpu_torch.data.synthetic import (
    synthetic_triplets,
    write_istd_layout,
)
from shadow_removal_istd_tpu_torch.engine import epoch as epoch_mod
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.epoch import RngStreams
from shadow_removal_istd_tpu_torch.engine.loop import (
    RunConfig,
    Trainer,
    _read_back,
)
from shadow_removal_istd_tpu_torch.engine.steps import METRIC_KEYS
from shadow_removal_istd_tpu_torch.parallel.prefetch import (
    prefetch_to_device,
)
from shadow_removal_istd_tpu_torch.tools.convert import flax_tree_to_torch
from shadow_removal_istd_tpu_torch.utils.preemption import PreemptionGuard
from shadow_removal_istd_tpu_torch.utils.tb_writer import (
    read_events,
    to_uint8_hwc,
)

from test_torch_train import (
    BASE,
    NETS,
    _close_metrics,
    _close_trees,
    _jax_state,
    _jax_tree,
    _torch_tree,
    _variables,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUFFIX = "_lr0.00050_SGAN"
TINY = ["--ngf", "4", "--ndf", "4", "--image-size", "32", "--batch-size",
        "2", "--allow-missing-vgg", "--devices", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread (see tests/test_torch_train.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Recorder:
    """A writer with the trainer's ``add_scalar``/``add_image`` surface."""

    def __init__(self):
        self.scalars, self.images = {}, {}

    def add_scalar(self, tag, value, step):
        self.scalars[tag] = float(value)

    def add_image(self, tag, img, step, dataformats="HWC"):
        assert dataformats == "HWC"
        self.images[tag] = np.asarray(img, np.float32)

    def flush(self):
        pass


def _dirs(tmp_path, name="t", **kw):
    return dict(weights_dir=str(tmp_path / name / "w"),
                logs_dir=str(tmp_path / name / "l"),
                checkpoint_path=str(tmp_path / name / "c.msgpack"), **kw)


# ------------------------------------------------------------ preemption

def test_guard_flag_set_on_signal_and_handlers_restored():
    old = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        # delivery is synchronous for a self-signal on the main thread
        assert guard.requested
    assert signal.getsignal(signal.SIGTERM) is old


def test_guard_noop_without_signal():
    with PreemptionGuard() as guard:
        pass
    assert not guard.requested


# -------------------------------------------------------------- prefetch

@pytest.mark.parametrize("n,batch", [(7, 3), (6, 3), (0, 3)])
def test_prefetch_yields_every_batch_in_order(n, batch):
    """Batches of a pipeline in order, the short last one included; an
    empty iterator yields nothing."""
    streams = {"a": np.arange(n * 6, dtype=np.uint8).reshape(n, 2, 3, 1),
               "b": np.arange(n, dtype=np.uint8).reshape(n, 1, 1, 1)}
    batches = [(streams["a"][i:i + batch], streams["b"][i:i + batch])
               for i in range(0, n, batch)]
    got = list(prefetch_to_device(iter(batches), 2, "cpu"))
    assert len(got) == len(batches) == -(-n // batch)
    for g, want in zip(got, batches):
        assert all(isinstance(t, torch.Tensor) for t in g)
        for t, a in zip(g, want):
            np.testing.assert_array_equal(t.numpy(), a)


# ------------------------------------------------------------ host epoch

KW = {**{k: v for k, v in BASE.items() if k != "steps_per_epoch"},
      "use_visual_loss": False}


def _params_and_buffers(t):
    return [x for net in t.state.models.all()
            for x in (*net.parameters(), *net.buffers())]


def test_host_epoch_is_the_fused_epoch_on_its_order(tmp_path):
    """The host pipeline's epoch 1 against the fused epoch run on the
    index matrix of the pipeline's order, from the same initial state:
    bit-identical sums, parameters and BatchNorm statistics."""
    cfg = TrainConfig(**{**KW, "image_size": 32})
    streams = synthetic_triplets(6, 48, 64, seed=4)
    host = Trainer(cfg, RunConfig(**_dirs(tmp_path, "h", seed=3)),
                   train_streams=streams, device="cpu")
    fused = Trainer(cfg, RunConfig(**_dirs(tmp_path, "f", seed=3),
                                   device_cache=True),
                    train_streams=streams, device="cpu")
    assert host.cache is None and fused.cache is not None
    for a, b in zip(_params_and_buffers(host), _params_and_buffers(fused)):
        assert torch.equal(a, b)
    host.run_train_epoch(1)
    b = cfg.batch_size
    steps = host.cfg.steps_per_epoch
    idx = host.train_pipe.order(1)[:steps * b].reshape(steps, b)
    _, sums = fused.epoch_fn(fused.state, fused.cache.arrays,
                             torch.from_numpy(idx), RngStreams(3, 1, "cpu"))
    sums = _read_back(sums)
    assert host.history[-1] == {k: v / steps for k, v in sums.items()}
    assert host.state.step == fused.state.step == steps
    for a, b in zip(_params_and_buffers(host), _params_and_buffers(fused)):
        assert torch.equal(a, b)


def test_pipeline_order_is_the_jax_pipelines():
    streams = synthetic_triplets(7, 8, 8, seed=5)
    ours = Trainer(TrainConfig(**{**KW, "image_size": 8}),
                   RunConfig(seed=11, tasks=("infer",)),
                   train_streams=streams, device="cpu").train_pipe
    theirs = JPipeline({k: streams[k] for k in ("img", "matte", "target")},
                       2, shuffle=True, drop_last=True, seed=11)
    for epoch in (0, 5):
        got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_host_epoch_matches_the_jax_host_epoch(tmp_path, monkeypatch):
    """``Trainer(device_cache=False).run_train_epoch`` in both packages
    from the same variables, each step's augmentation parameters
    injected into both (the frameworks draw different numbers): the
    epoch's ``Loss/*`` and ``D*_output/*`` scalars and every parameter
    and statistic after it."""
    rng = np.random.default_rng(30)
    n, h, w = 4, 72, 88
    streams = {k: rng.integers(0, 256, (n, h, w, c), dtype=np.uint8)
               for k, c in (("img", 3), ("matte", 1), ("target", 3))}
    params = [{"scale": rng.uniform(0.95, 1.05, 2).astype(np.float32),
               "angle": rng.uniform(-15, 15, 2).astype(np.float32),
               "flip": np.array([s == 0, True]),
               "row_off": rng.integers(0, h - 64, 2).astype(np.int32),
               "col_off": rng.integers(0, w - 64, 2).astype(np.int32)}
              for s in range(2)]
    jm = j_build(JConfig(**KW))
    variables = _variables(jm, seed=40)
    monkeypatch.setattr(jloop, "init_state",
                        lambda key, cfg, models: _jax_state(cfg, variables))
    jt = jloop.Trainer(JConfig(**KW), jloop.RunConfig(
        **_dirs(tmp_path, "j", seed=0)), train_streams=streams)
    jaug = jax.jit(lambda s, p: jshear.fused_augment_shear(
        s, p, 64, max_angle_deg=15.0, interpret=True))
    jcalls = []

    def jax_augment(key, raw):
        out = jaug(jnp.concatenate(raw, -1),
                   {k: jnp.asarray(v) for k, v in params[len(jcalls)].items()})
        jcalls.append(1)
        return out[..., :3], out[..., 3:4], out[..., 4:]

    jt._augment = jax_augment
    jt._writers["train"] = jrec = Recorder()
    with jax.default_matmul_precision("highest"):
        jt.run_train_epoch(0, log_scalars=True)

    t = Trainer(TrainConfig(**KW), RunConfig(**_dirs(tmp_path, "t", seed=0)),
                train_streams=streams, device="cpu")
    for k in NETS:
        flax_tree_to_torch(variables[k], getattr(t.state.models, k))
    orig, tcalls, drawn = epoch_mod.augment_batch, [], params

    def torch_augment(gen, raw, cfg, params=None):
        p = {k: torch.from_numpy(v) for k, v in drawn[len(tcalls)].items()}
        tcalls.append(1)
        return orig(None, raw, cfg, params=p)

    monkeypatch.setattr(epoch_mod, "augment_batch", torch_augment)
    t._writers["train"] = rec = Recorder()
    t.run_train_epoch(0, log_scalars=True)
    assert len(jcalls) == len(tcalls) == 2 and t.state.step == 2
    assert rec.scalars.keys() == jrec.scalars.keys()
    _close_metrics(rec.scalars, jrec.scalars, 1e-4, keys=jrec.scalars)
    _close_trees(_torch_tree(t.state, "params"), _jax_tree(jt.state, "params"),
                 1e-5)
    _close_trees(_torch_tree(t.state, "batch_stats"),
                 _jax_tree(jt.state, "batch_stats"), 1e-5)


@pytest.mark.parametrize("shape,p", [((2, 3, 5, 7), 1), ((1, 1, 3, 6), 1),
                                     ((1, 2, 6, 4), 2), ((1, 1, 4, 4), 3)])
def test_reflect_pad_backward_folds_the_border(shape, p):
    """The models' reflect pad (``layers.reflect_pad``), whose backward
    folds the border's gradient with slices (deterministic on the card,
    where torch's own scatters by atomic adds): the same values and, in
    float64, the same gradient as ``F.pad(mode="reflect")``."""
    import torch.nn.functional as F

    from shadow_removal_istd_tpu_torch.models.layers import reflect_pad

    gen = torch.Generator().manual_seed(p)
    x = torch.randn(shape, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    g = torch.randn(shape[0], shape[1], shape[2] + 2 * p, shape[3] + 2 * p,
                    dtype=torch.float64, generator=gen)
    ours = reflect_pad(x, p)
    torchs = F.pad(x, (p, p, p, p), mode="reflect")
    assert torch.equal(ours, torchs)
    (a,), (b,) = (torch.autograd.grad(y, x, g) for y in (ours, torchs))
    torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


# ------------------------------------------------------------ TensorBoard

def test_log_scalars_and_images_match_jax(tmp_path):
    """The port's ``_log_scalars``/``_log_images`` against the JAX
    trainer's methods (called on a stand-in with its ``_writer``,
    ``infer_step`` and state), from the same sums, weights and batch."""
    cfg = TrainConfig(**{**KW, "image_size": 64})
    jm = j_build(JConfig(**KW))
    variables = _variables(jm, seed=60)
    t = Trainer(cfg, RunConfig(**_dirs(tmp_path)), device="cpu")
    for k in NETS:
        flax_tree_to_torch(variables[k], getattr(t.state.models, k))
    rng = np.random.default_rng(61)
    sums = {k: float(rng.uniform(-3, 3)) for k in METRIC_KEYS}
    t._writers["train"] = rec = Recorder()
    t._log_scalars("train", 4, sums, 3)
    jrec = Recorder()
    stand_in = SimpleNamespace(
        _writer=lambda which: jrec, infer_step=make_infer_step(jm),
        state=SimpleNamespace(
            g_params={k: variables[k]["params"] for k in ("g1", "g2")},
            batch_stats={k: variables[k]["batch_stats"] for k in NETS}))
    jloop.Trainer._log_scalars(
        stand_in, "train", 4, {k: sums[k] for k in METRIC_KEYS[:10]},
        {k: sums[k] for k in METRIC_KEYS[10:]}, 3)
    assert rec.scalars.keys() == jrec.scalars.keys()
    assert len(rec.scalars) == 17
    for k, v in jrec.scalars.items():
        assert rec.scalars[k] == pytest.approx(v, rel=1e-6, abs=1e-12), k

    batch = tuple(rng.uniform(-1, 1, (10, 64, 64, c)).astype(np.float32)
                  for c in (3, 1, 3))
    t._writers["valid"] = rec
    t._log_images("valid", 4, tuple(torch.from_numpy(a).permute(0, 3, 1, 2)
                                    for a in batch))
    with jax.default_matmul_precision("highest"):
        jloop.Trainer._log_images(stand_in, "valid", 4,
                                  tuple(map(jnp.asarray, batch)))
    assert rec.images.keys() == jrec.images.keys() == {"input", "matte",
                                                       "output"}
    for tag, want in jrec.images.items():
        got = rec.images[tag]
        assert got.shape == want.shape == (128, 256, 3), tag
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=tag)
        diff = np.abs(to_uint8_hwc(got).astype(int)
                      - to_uint8_hwc(want).astype(int))
        assert diff.max() <= 1, tag


def test_cli_writes_the_jax_tag_set(tmp_path):
    """``--epochs 2 --log-every 1 --vis-every 1 --eval-metrics``: both
    event files carry every tag the JAX trainer writes, at both epochs,
    with finite values."""
    write_istd_layout(str(tmp_path / "istd"), n_train=4, n_test=2, h=64,
                      w=64)
    main(build_parser().parse_args([
        "--tasks", "train", "--data-dir", str(tmp_path / "istd"), *TINY,
        "--epochs", "2", "--log-every", "1", "--vis-every", "1",
        "--valid-every", "1", "--eval-metrics", "--weights",
        str(tmp_path / "w"), "--logs", str(tmp_path / "l")]))
    losses = {f"Loss/{k}" for k in (*jloop._METRIC_KEYS, "total")}
    outs = {f"{d}_output/{k}" for d in ("D1", "D2")
            for k in ("real", "fake", "diff")}
    images = {"input", "matte", "output"}
    evals = {f"Eval/{k}" for k in ("rmse", "rmse_non", "rmse_all", "mae",
                                   "mae_non", "mae_all")}
    want = {"train": losses | outs | images | {"perf/images_per_sec"},
            "valid": losses | outs | images | evals}
    for which, tags in want.items():
        d = tmp_path / f"l{SUFFIX}" / which
        (name,) = os.listdir(d)
        events = read_events(str(d / name))
        assert events[0]["file_version"] == "brain.Event:2"
        by_tag = {}
        for e in events[1:]:
            by_tag.setdefault(e["tag"], []).append(e)
        assert set(by_tag) == tags, which
        for tag, evs in by_tag.items():
            assert [e["step"] for e in evs] == [0, 1], (which, tag)
            for e in evs:
                if tag in images:
                    assert e["value"]["png"].startswith(b"\x89PNG")
                else:
                    assert np.isfinite(e["value"]), (which, tag)


def test_profile_dir_traces_the_second_epoch(tmp_path):
    """``RunConfig(profile_dir=...)``: a Chrome trace of epoch 1 whose
    events include the train step's convolutions, backward and Adam."""
    prof = tmp_path / "prof"
    t = Trainer(TrainConfig(**{**KW, "image_size": 32}),
                RunConfig(**_dirs(tmp_path, seed=0), profile_dir=str(prof)),
                train_streams=synthetic_triplets(4, 48, 64, seed=0),
                device="cpu")
    t.train(1)
    assert not prof.exists()              # only the second epoch is traced
    t.train(2)
    (name,) = os.listdir(prof)
    assert name.endswith(f".{os.getpid()}.pt.trace.json")
    names = {e.get("name") for e in json.loads(
        (prof / name).read_text())["traceEvents"]}
    for op in ("aten::convolution_backward", "Optimizer.step#Adam.step"):
        assert op in names, op


# --------------------------------------------------------------- SIGTERM

def _wait_for(proc, text, deadline, seen):
    for line in iter(proc.stdout.readline, ""):
        seen.append(line)
        if text in line:
            return
        assert time.monotonic() < deadline, "".join(seen[-20:])
    raise AssertionError(f"process ended before {text!r}:\n"
                         + "".join(seen[-40:]))


def test_sigterm_checkpoints_and_the_resume_is_bit_exact(tmp_path):
    """A real SIGTERM to ``cli.main --tasks train infer`` after its second
    epoch: it exits 0 with the checkpoint of its last complete epoch E
    and the ``latest`` weights, skipping ``infer``. Resumed for one more
    epoch, the run's 9 weight and checkpoint files equal those of an
    uninterrupted run of E + 1 epochs, byte for byte (the process runs
    one torch thread, as this one does: reductions split over threads
    round otherwise). Every wait is bounded: a hang fails within a
    minute."""
    istd = str(tmp_path / "istd")
    write_istd_layout(istd, n_train=4, n_test=2, h=64, w=64)
    common = ["--data-dir", istd, *TINY, "--log-every", "1",
              "--valid-every", "100000", "--vis-every", "100000"]
    a = str(tmp_path / "a")
    proc = subprocess.Popen(
        [sys.executable, "-m", "shadow_removal_istd_tpu_torch.cli.main",
         "--tasks", "train", "infer", "--epochs", "100000",
         "--save-every", "100000", *common, "--weights", f"{a}/w",
         "--logs", f"{a}/l", "--infered", f"{a}/out"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
    seen = []
    try:
        deadline = time.monotonic() + 50
        # the guard is live once "start training" is logged; wait for a
        # complete epoch past the first so that the epoch-0 save (every
        # --save-every) is not the checkpoint found
        _wait_for(proc, "start training", deadline, seen)
        _wait_for(proc, "train epoch 1:", deadline, seen)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(seen) + out
    assert proc.returncode == 0, out[-3000:]
    assert "preemption checkpoint written after epoch" in out, out[-3000:]
    assert "preempted: skipping remaining tasks" in out
    assert not os.path.exists(f"{a}/out/shadowless")
    wa = f"{a}/w{SUFFIX}"
    from shadow_removal_istd_tpu_torch.utils.msgpack_codec import from_bytes
    with open(f"{wa}/checkpoint.msgpack", "rb") as f:
        epochs = int(from_bytes(f.read())["epoch"])
    assert epochs >= 2
    assert len(os.listdir(wa)) == 9

    def run(base, *extra):
        main(build_parser().parse_args([
            "--tasks", "train", "--save-every", "1", *common, "--weights",
            f"{base}/w", "--logs", f"{base}/l", *extra]))

    run(a, "--epochs", str(epochs + 1), "--load-checkpoint",
        f"{wa}/checkpoint.msgpack")
    b = str(tmp_path / "b")
    run(b, "--epochs", str(epochs + 1))
    wb = f"{b}/w{SUFFIX}"
    files = sorted(os.listdir(wb))
    assert files == sorted(os.listdir(wa)) and len(files) == 9
    for f in files:
        with open(f"{wa}/{f}", "rb") as fa, open(f"{wb}/{f}", "rb") as fb:
            assert fa.read() == fb.read(), f


# ----------------------------------------------------------- native PNG

@pytest.fixture(scope="module")
def built():
    if not nl.is_available():
        pytest.skip("native loader could not be built (no g++/zlib)")
    return True


def test_native_color_matches_cv2(built, tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(5):
        p = str(tmp_path / f"{i}.png")
        cv2.imwrite(p, rng.integers(0, 256, (40, 56, 3), np.uint8))
        paths.append(p)
    ref = np.stack([cv2.imread(p, cv2.IMREAD_COLOR) for p in paths])
    np.testing.assert_array_equal(nl.decode_batch(paths), ref)


def test_native_gray_matches_cv2(built, tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"g{i}.png")
        cv2.imwrite(p, rng.integers(0, 256, (32, 24), np.uint8))
        paths.append(p)
    ref = np.stack([cv2.imread(p, cv2.IMREAD_GRAYSCALE)[..., None]
                    for p in paths])
    np.testing.assert_array_equal(nl.decode_batch(paths, gray=True), ref)


def test_native_refuses_gray_from_rgb_and_load_all_falls_back(built,
                                                              tmp_path):
    """cv2's PNG RGB -> gray is libpng's own rounding: the native decoder
    refuses, and ``load_all`` reads that stream through cv2."""
    rng = np.random.default_rng(2)
    mdir = tmp_path / "ds" / "test" / "test_B"
    mdir.mkdir(parents=True)
    for i in range(2):
        cv2.imwrite(str(mdir / f"{i}.png"),
                    rng.integers(0, 256, (16, 16, 3), np.uint8))
    with pytest.raises(IOError):
        nl.decode_batch([str(mdir / "0.png")], gray=True)
    ds = ISTDDataset(str(tmp_path / "ds"), "test", datas=("mask",))
    got = ds.load_all()["mask"]
    assert ds.decoded_by == {"mask": "library"}
    ref = np.stack([cv2.imread(str(mdir / f"{i}.png"),
                               cv2.IMREAD_GRAYSCALE)[..., None]
                    for i in range(2)])
    np.testing.assert_array_equal(got, ref)


def test_native_probe(built, tmp_path):
    p = str(tmp_path / "x.png")
    cv2.imwrite(p, np.random.default_rng(3).integers(0, 256, (17, 23, 3),
                                                     np.uint8))
    assert nl.probe(p) == (17, 23, 3)


def test_native_missing_and_corrupt_files_are_reported(built, tmp_path):
    good = str(tmp_path / "ok.png")
    cv2.imwrite(good, np.random.default_rng(4).integers(0, 256, (8, 8, 3),
                                                        np.uint8))
    with pytest.raises(IOError, match="missing.png"):
        nl.decode_batch([good, str(tmp_path / "missing.png")])
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    with pytest.raises(IOError):
        nl.decode_batch([str(bad)])


def test_load_all_uses_native(built, tmp_path):
    """``load_all`` on an all-PNG directory written by the port (rows in
    all five filter types) decodes every stream natively, equal to the
    image library's decode."""
    write_istd_layout(str(tmp_path), n_train=3, n_test=1, h=24, w=32)
    ds = ISTDDataset(str(tmp_path), "train", datas=("img", "matte",
                                                    "target"))
    fast = ds.load_all()
    assert ds.decoded_by == dict.fromkeys(("img", "matte", "target"),
                                          "native")
    slow = ds.load_all(native=False)
    assert ds.decoded_by == dict.fromkeys(("img", "matte", "target"),
                                          "library")
    for k in fast:
        np.testing.assert_array_equal(fast[k], slow[k])
