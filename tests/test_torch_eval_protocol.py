"""The port's in-training ISTD evaluation protocol (``Trainer`` with
``RunConfig(eval_metrics=True)``) against the JAX package's ``Trainer``
from the same weight files (written by the port, read by both), on one
port-written ISTD directory (2 train + 3 test triplets, 32x64; MNet ngf
8, PatchGAN ndf 8, batch 2, visual loss off).

Held: ``Eval/*`` equal to the JAX trainer's (rtol 5e-4, the JAX
package's own slack between two compiled graphs: a prediction within
float noise of a uint8 boundary may land one level apart), also with
``valid_resize`` and on the matte proxy; ``Eval/*`` equal to the port's
offline ``metrics/eval_cli.all_metrics`` on the PNGs its ``infer`` wrote
(rtol 1e-5: the same forward, only the sums grouped otherwise); the
proxy when ``test_B`` is missing or the streams are injected; and
``infer_resize`` honoured by ``infer``, PNGs within 1 gray level of the
JAX trainer's.
"""
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.engine.config import TrainConfig as JConfig
from shadow_removal_istd_tpu.engine.loop import RunConfig as JRunConfig
from shadow_removal_istd_tpu.engine.loop import Trainer as JTrainer
from shadow_removal_istd_tpu_torch.data.synthetic import (
    synthetic_triplets,
    write_istd_layout,
)
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.loop import (
    EVAL_KEYS,
    RunConfig,
    Trainer,
)
from shadow_removal_istd_tpu_torch.metrics.eval_cli import all_metrics
from shadow_removal_istd_tpu_torch.utils.image_io import (
    imread_color,
    imread_gray,
)

CFG = dict(ngf=8, ndf=8, image_size=32, batch_size=2, droprate=0.0,
           lambda4=0.0, lambda5=0.0)
JAX_RTOL = 5e-4


class Capture:
    """A writer hook with TensorBoard's ``add_scalar`` surface."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, epoch):
        self.scalars[tag] = float(value)

    def add_image(self, *a, **k):
        pass

    def flush(self):
        pass


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The ISTD directory, and weight files of a port trainer after one
    epoch (trained BatchNorm statistics)."""
    root = tmp_path_factory.mktemp("protocol")
    istd = str(root / "istd")
    write_istd_layout(istd, n_train=2, n_test=3, h=32, w=64)
    t = Trainer(TrainConfig(**CFG), RunConfig(
        data_dirs=(istd,), seed=0, weights_dir=str(root / "w"),
        logs_dir=str(root / "l"), checkpoint_path=str(root / "ck.msgpack"),
        device_cache=True), device="cpu")
    t.train(1)
    w = {k: str(root / "w" / f"{k.upper()}_{c}_latest.msgpack")
         for k, c in (("g1", "MNet"), ("g2", "MNet"), ("d1", "PatchGAN"),
                      ("d2", "PatchGAN"))}
    return {"root": root, "istd": istd, "weights": w}


def _port(setup, tmp, data_dirs=None, cfg=None, **run):
    t = Trainer(TrainConfig(**CFG, **(cfg or {})), RunConfig(
        data_dirs=data_dirs or (setup["istd"],), eval_metrics=True,
        weights_dir=f"{tmp}/w", logs_dir=f"{tmp}/l",
        infered_dir=f"{tmp}/infered", **run), device="cpu")
    t.load_weights(**setup["weights"])
    return t


def _jax(setup, tmp, cfg=None):
    jt = JTrainer(JConfig(**CFG, use_visual_loss=False, **(cfg or {})),
                  JRunConfig(data_dirs=(setup["istd"],), eval_metrics=True,
                             weights_dir=f"{tmp}/jw", logs_dir=f"{tmp}/jl",
                             infered_dir=f"{tmp}/jinfered"))
    jt.load_weights(**setup["weights"])
    jt._writers["valid"] = Capture()
    return jt


@pytest.fixture(scope="module")
def jax_trainer(setup):
    """One JAX trainer, with ``infer_resize`` (which validation does not
    read)."""
    return _jax(setup, setup["root"], cfg={"infer_resize": (24, 32)})


def _eval(t, tag="Eval"):
    return {k: t[f"{tag}/{k}"] for k in EVAL_KEYS}


def _close(got, want, rtol):
    for k in EVAL_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def test_eval_matches_the_jax_trainer(setup, jax_trainer, tmp_path):
    t = _port(setup, tmp_path)
    assert t._has_protocol_masks()
    cap = Capture()
    t.eval_writer = cap                   # the hook a caller may replace
    t.run_valid_epoch(3)
    jax_trainer.run_valid_epoch(3)
    want = jax_trainer._writers["valid"].scalars
    assert set(cap.scalars) == {f"Eval/{k}" for k in EVAL_KEYS}
    assert all(np.isfinite(v) and v > 0 for v in cap.scalars.values())
    _close(_eval(cap.scalars), _eval(want), JAX_RTOL)
    # the matte-threshold proxy, both trainers without their masks
    masks = jax_trainer._valid_masks
    t._valid_masks = jax_trainer._valid_masks = None
    try:
        t.run_valid_epoch(4)
        jax_trainer.run_valid_epoch(4)
    finally:
        jax_trainer._valid_masks = masks
    _close(_eval(cap.scalars, "EvalProxy"), _eval(want, "EvalProxy"),
           JAX_RTOL)


def test_eval_equals_the_offline_cli_on_the_infer_pngs(setup, tmp_path):
    """The counterpart of the JAX package's TestEvalBitAlignment."""
    t = _port(setup, tmp_path)
    t.run_valid_epoch(0)                  # the default hook: last_eval
    assert set(t.last_eval) == {f"Eval/{k}" for k in EVAL_KEYS}
    assert t.infer() == 3
    test = os.path.join(setup["istd"], "test")
    offline = all_metrics(os.path.join(test, "test_C_fixed"),
                          f"{tmp_path}/infered/shadowless/istd",
                          maskdir=os.path.join(test, "test_B"),
                          device="cpu")
    _close(_eval(t.last_eval), offline, 1e-5)


def test_valid_resize_runs_and_matches_jax(setup, tmp_path):
    """64 -> 96 columns: the interpolated targets and masks are thirds of
    uint8 steps, never half-way ties that f32 noise could round either
    way (a 2x shrink averages pairs, and their odd sums tie)."""
    size = (32, 96)
    t = _port(setup, tmp_path, cfg={"valid_resize": size})
    x, m, y = next(t.valid_batches())
    assert x.shape == (2, 3, *size) and m.shape == (2, 1, *size)
    total = t.run_valid_epoch(0)
    assert np.isfinite(total)
    jt = _jax(setup, tmp_path, cfg={"valid_resize": size})
    np.testing.assert_allclose(total, jt.run_valid_epoch(0), rtol=1e-4)
    _close(_eval(t.last_eval), _eval(jt._writers["valid"].scalars),
           JAX_RTOL)


def test_proxy_when_test_B_is_absent(setup, tmp_path, caplog):
    istd = str(tmp_path / "istd")
    shutil.copytree(setup["istd"], istd)
    shutil.rmtree(os.path.join(istd, "test", "test_B"))
    with caplog.at_level(logging.WARNING):
        t = _port(setup, tmp_path, data_dirs=(istd,))
    assert "no binary mask directory (test_B)" in caplog.text
    assert not t._has_protocol_masks()
    t.run_valid_epoch(0)
    assert set(t.last_eval) == {f"EvalProxy/{k}" for k in EVAL_KEYS}
    full = _port(setup, tmp_path)
    full._valid_masks = None
    full.run_valid_epoch(0)
    assert full.last_eval == t.last_eval


def test_injected_streams_use_the_proxy(caplog, tmp_path):
    streams = synthetic_triplets(2, 32, 64, seed=3)
    logs = str(tmp_path / "l")            # the event files
    with caplog.at_level(logging.WARNING):
        t = Trainer(TrainConfig(**CFG), RunConfig(eval_metrics=True,
                                                  logs_dir=logs),
                    train_streams=streams, valid_streams=streams,
                    device="cpu")
    assert "no aligned mask stream" in caplog.text
    t.run_valid_epoch(0)
    assert set(t.last_eval) == {f"EvalProxy/{k}" for k in EVAL_KEYS}
    # the datas carry the binary mask itself: the protocol's masks
    t = Trainer(TrainConfig(**CFG, train_datas=("img", "mask", "target")),
                RunConfig(eval_metrics=True, logs_dir=logs),
                train_streams=streams,
                valid_streams=streams, device="cpu")
    assert t._has_protocol_masks()
    t.run_valid_epoch(0)
    assert set(t.last_eval) == {f"Eval/{k}" for k in EVAL_KEYS}


def test_infer_resize_matches_jax(setup, jax_trainer, tmp_path):
    """``infer_resize`` resizes the outputs before they are written, as
    the JAX trainer does (it was ignored: 32x64 PNGs where JAX wrote
    24x32 ones)."""
    t = _port(setup, tmp_path, cfg={"infer_resize": (24, 32)})
    assert t.infer() == 3
    jax_trainer.run.infered_dir = str(tmp_path / "jax")
    assert jax_trainer.infer() == 3
    for sub, read, shape in (("shadowless", imread_color, (24, 32, 3)),
                             ("matte", imread_gray, (24, 32))):
        names = sorted(os.listdir(tmp_path / "jax" / sub / "istd"))
        assert sorted(os.listdir(
            tmp_path / "infered" / sub / "istd")) == names
        for f in names:
            got = read(str(tmp_path / "infered" / sub / "istd" / f))
            want = read(str(tmp_path / "jax" / sub / "istd" / f))
            assert got.shape == want.shape == shape
            assert np.abs(got.astype(np.int16) - want).max() <= 1, (sub, f)
    # without the option the outputs keep the input's size
    t = _port(setup, tmp_path / "native")
    t.infer()
    assert imread_gray(str(tmp_path / "native" / "infered" / "matte"
                           / "istd" / names[0])).shape == (32, 64)


def test_eval_metrics_logs_the_jax_line(setup, tmp_path, caplog):
    t = _port(setup, tmp_path)
    with caplog.at_level(logging.INFO):
        t.run_valid_epoch(7)
    assert "eval protocol @ epoch 7: RMSE shadow" in caplog.text
    assert torch.isfinite(torch.tensor(list(t.last_eval.values()))).all()
