"""The port's training options and the legacy STCGAN tree against the
JAX package: BEGAN k-balance, SoftAdapt, the plateau schedule, DCGAN
init, checkpoints carrying their state, the legacy CLI and serving every
generator key.

Steps run as tests/test_torch_train.py runs them (G MNet ngf 4, droprate
0, 64x64 crops, batch 2, Adam eps 1e-3, same numpy variables and
batches, JAX's ``_unjitted_train_step`` jitted under "highest"
precision), at its step tolerances: metrics relative 1e-4, parameters
and running statistics 1e-5; BEGAN's k1/k2 and the SoftAdapt weights and
previous losses within 1e-6. The BEGAN step starts from k1 = 0.3 and k2
= 0.6 so that the D loss uses k and the update stays off the clip
bounds. The plateau scale is held as JAX applies it (to the Adam
updates) against the port's rate ``base * scale``: the same up to f32
rounding, within the same 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from shadow_removal_istd_tpu.engine import checkpoint as jck
from shadow_removal_istd_tpu.engine.config import TrainConfig as JConfig
from shadow_removal_istd_tpu.engine.loop import RunConfig as JRunConfig
from shadow_removal_istd_tpu.engine.loop import Trainer as JTrainer
from shadow_removal_istd_tpu.engine.schedules import (
    ReduceLROnPlateau as JPlateau,
)
from shadow_removal_istd_tpu.engine.state import build_models as j_build
from shadow_removal_istd_tpu.engine.steps import (
    _unjitted_train_step,
    make_eval_step,
)
from shadow_removal_istd_tpu.losses.softadapt import (
    softadapt_init as j_softadapt_init,
)
from shadow_removal_istd_tpu.serving.engine import (
    InferenceEngine as JEngine,
)
from shadow_removal_istd_tpu_torch.cli import stcgan_main
from shadow_removal_istd_tpu_torch.data.synthetic import (
    synthetic_triplets,
    write_istd_layout,
)
from shadow_removal_istd_tpu_torch.engine import config as config_mod
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer
from shadow_removal_istd_tpu_torch.engine.schedules import ReduceLROnPlateau
from shadow_removal_istd_tpu_torch.engine.steps import eval_step
from shadow_removal_istd_tpu_torch.models import get_generator
from shadow_removal_istd_tpu_torch.models.layers import (
    BatchNorm,
    apply_dcgan_init_,
    init_weights_,
)
from shadow_removal_istd_tpu_torch.serving import InferenceEngine
from shadow_removal_istd_tpu_torch.tools.convert import (
    flatten_tree,
    torch_to_flax_tree,
    train_state_to_flax,
)
from shadow_removal_istd_tpu_torch.utils.image_io import (
    imread_color,
    imread_gray,
)

from test_torch_checkpoint import _assert_trees_equal, _jax_tree
from test_torch_train import (
    BASE,
    _batches,
    _close_metrics,
    _close_trees,
    _jax_state,
    _jax_tree as _jax_params,
    _nchw,
    _run_jax,
    _run_torch,
    _torch_state,
    _torch_tree,
    _variables,
)
from test_torch_train_models import random_variables

STEP = {**BASE, "use_visual_loss": False}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in tests/test_torch_train.py: reproducible torch reductions."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair_states(kw, seed, k=(0.0, 0.0)):
    """JAX and port states of one configuration from the same variables
    (and k1/k2; SoftAdapt initialised as each package does)."""
    jcfg, tcfg = JConfig(**kw), TrainConfig(**kw)
    jm = j_build(jcfg)
    variables = _variables(jm, seed=seed)
    js = _jax_state(jcfg, variables).replace(
        k1=jnp.float32(k[0]), k2=jnp.float32(k[1]))
    if jcfg.softadapt:
        js = js.replace(softadapt=j_softadapt_init(
            3, init_weights=[1.0, jcfg.lambda1, jcfg.lambda2]))
    ts = _torch_state(tcfg, variables, None)
    ts.k1, ts.k2 = torch.tensor(k[0]), torch.tensor(k[1])
    return jcfg, jm, js, ts


@pytest.fixture(scope="module")
def began_run():
    kw = {**STEP, "net_d": "began"}
    jcfg, jm, js, ts = _pair_states(kw, seed=40, k=(0.3, 0.6))
    batches = _batches(1, seed=41)
    js, jmet = _run_jax(jax.jit(_unjitted_train_step(jm, jcfg, None)), js,
                        batches)
    ts, tmet = _run_torch(ts, batches)
    return dict(jcfg=jcfg, jm=jm, js=js, ts=ts, jmet=jmet, tmet=tmet)


def test_began_train_step_matches_jax(began_run):
    js, ts = began_run["js"], began_run["ts"]
    _close_metrics(began_run["tmet"][0], began_run["jmet"][0], 1e-4)
    _close_trees(_torch_tree(ts, "params"), _jax_params(js, "params"), 1e-5)
    _close_trees(_torch_tree(ts, "batch_stats"),
                 _jax_params(js, "batch_stats"), 1e-5)
    for k, start in (("k1", 0.3), ("k2", 0.6)):
        got, want = float(getattr(ts, k)), float(getattr(js, k))
        assert abs(got - want) <= 1e-6, (k, got, want)
        assert got != start and 0.0 < got < 1.0
    # k stays a device tensor: no host sync in the step
    assert isinstance(ts.k1, torch.Tensor) and ts.k1.dtype == torch.float32


def test_began_eval_step_matches_jax(began_run):
    batch = _batches(1, seed=42)[0]
    jeval = make_eval_step(began_run["jm"], began_run["jcfg"], None)
    with jax.default_matmul_precision("highest"):
        want = {k: float(v) for k, v in
                jeval(began_run["js"], tuple(map(jnp.asarray, batch))).items()}
    got = {k: float(v) for k, v in
           eval_step(began_run["ts"], _nchw(batch)).items()}
    assert got.keys() == want.keys()
    _close_metrics(got, want, 1e-4, keys=want.keys())


def test_softadapt_steps_match_jax():
    """Two steps: the second combines with the weights the first
    updated."""
    kw = {**STEP, "softadapt": True}
    jcfg, jm, js, ts = _pair_states(kw, seed=50)
    w0 = ts.softadapt.weights.numpy()
    np.testing.assert_allclose(w0, np.array([1, 5, 0.5]) / 6.5, rtol=1e-6)
    batches = _batches(2, seed=51)
    js, jmet = _run_jax(jax.jit(_unjitted_train_step(jm, jcfg, None)), js,
                        batches)
    ts, tmet = _run_torch(ts, batches)
    for i in range(2):
        _close_metrics(tmet[i], jmet[i], 1e-4)
    _close_trees(_torch_tree(ts, "params"), _jax_params(js, "params"), 1e-5)
    for f in ("weights", "prev_loss"):
        np.testing.assert_allclose(getattr(ts.softadapt, f).numpy(),
                                   np.asarray(getattr(js.softadapt, f)),
                                   atol=1e-6, rtol=0, err_msg=f)
    assert not np.allclose(ts.softadapt.weights.numpy(), w0)


def test_plateau_scale_and_constant_rate_match_jax():
    """Under the plateau schedule the rate is the constant base rate (no
    per-epoch decay, although decay is 0.5 and each step is an epoch)
    times the controller's scale: two steps at scales 1.0 then 0.8."""
    kw = {**STEP, "lr_schedule": "plateau", "decay": 0.5, "lr_g": 1e-2,
          "lr_d": 1e-2}
    jcfg, jm, js, ts = _pair_states(kw, seed=60)
    step = jax.jit(_unjitted_train_step(jm, jcfg, None))
    batches = _batches(2, seed=61)
    with jax.default_matmul_precision("highest"):
        for b, scale in zip(batches, (1.0, 0.8)):
            js, _ = step(js, tuple(map(jnp.asarray, b)), jax.random.key(0),
                         scale, scale)
    for b, scale in zip(batches, (1.0, 0.8)):
        ts.lr_scale_g = ts.lr_scale_d = scale
        _run_torch(ts, [b])
    assert ts.opt_g.param_groups[0]["lr"] == pytest.approx(0.8e-2, rel=1e-12)
    _close_trees(_torch_tree(ts, "params"), _jax_params(js, "params"), 1e-5)


def test_reduce_lr_on_plateau_matches_jax():
    rng = np.random.default_rng(7)
    series = [float(v) for v in np.concatenate([
        np.linspace(10, 6, 5), [6.0] * 20, rng.uniform(5.9, 6.1, 15)])]
    assert len(series) == 40
    kw = dict(base_lr=2e-4, patience=3, cooldown=2, factor=0.5)
    ours, ref = ReduceLROnPlateau(**kw), JPlateau(**kw)
    reductions = 0
    for m in series:
        before = ours.current_lr
        assert ours.step(m) == ref.step(m)
        assert ours.state_dict() == ref.state_dict()
        reductions += ours.current_lr < before
    assert reductions >= 2
    again = ReduceLROnPlateau(base_lr=2e-4)
    again.load_state_dict(ours.state_dict())
    assert again.state_dict() == ours.state_dict()
    assert again.scale == ours.scale == ref.scale
    # the defaults are the legacy tree's: factor 0.8, cooldown 10
    d = ReduceLROnPlateau(1.0)
    assert (d.factor, d.patience, d.threshold, d.cooldown, d.min_lr) == (
        0.8, 10, 1e-4, 10, 1e-7)


def _dirs(tmp_path, name):
    """Every file a trainer writes goes under ``tmp_path``."""
    return dict(weights_dir=str(tmp_path / name / "w"),
                logs_dir=str(tmp_path / name / "l"),
                infered_dir=str(tmp_path / name / "out"),
                checkpoint_path=str(tmp_path / name / "c.msgpack"))


def test_trainer_plateau_rates_after_three_epochs_match_jax(tmp_path):
    """Both trainers on the same streams, 3 epochs of plateau with decay
    0.1: the rates equal the JAX trainer's (the constant base rates:
    the default controllers reduce after 11 bad epochs), and each
    controller stepped on its epoch's SUMMED losses (the port's history
    keeps means)."""
    kw = dict(ngf=4, ndf=4, droprate=0.0, batch_size=2, image_size=32,
              decay=0.1, lr_schedule="plateau", use_visual_loss=False)
    streams = synthetic_triplets(4, 48, 64, seed=0)
    run = dict(seed=0, valid_every=100, save_every=100, log_every=100)
    jt = JTrainer(JConfig(**kw), JRunConfig(**run, **_dirs(tmp_path, "j"),
                                            preempt_save=False),
                  train_streams={k: streams[k] for k in
                                 JConfig().train_datas})
    jt.train(3)
    t = Trainer(TrainConfig(**kw), RunConfig(**run, **_dirs(tmp_path, "t")),
                train_streams=streams, device="cpu")
    seen = []
    orig = t.plateau_g.step
    t.plateau_g.step = lambda m: seen.append(m) or orig(m)
    t.train(3)
    assert t.cfg.steps_per_epoch == 2 and len(seen) == 3
    for (opt, ctl, jctl, base) in ((t.state.opt_g, t.plateau_g,
                                    jt.plateau_g, 5e-4),
                                   (t.state.opt_d, t.plateau_d,
                                    jt.plateau_d, 1e-4)):
        assert opt.param_groups[0]["lr"] == jctl.current_lr == base
        assert ctl.state_dict().keys() == jctl.state_dict().keys()
        assert ctl.current_lr == base
    replay = JPlateau(5e-4)
    for m, h in zip(seen, t.history):
        replay.step(m)
        assert m == pytest.approx(2 * h["G"], rel=1e-12)   # sums, not means
    assert replay.state_dict() == t.plateau_g.state_dict()


@pytest.mark.parametrize("bn_mean", [1.0, 0.0])
def test_dcgan_init_statistics(bn_mean):
    """As the JAX package's TestDCGANInit: kernels N(0, .02), biases 0,
    BN scales N(bn_mean, .02) (0.0 = the reference's compat mode); BN
    running statistics untouched. MNet ngf 16 and a pix2pix (transposed
    convs, the outermost up-conv's bias)."""
    gen = torch.Generator().manual_seed(1)
    for net in (get_generator("mnet", in_channels=3, out_channels=1,
                              ngf=16),
                get_generator("stcgan", in_channels=3, out_channels=1,
                              ngf=8, num_downs=5)):
        init_weights_(net, gen)
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, BatchNorm):
                    m.running_mean.fill_(0.5)
        apply_dcgan_init_(net, gen, bn_mean)
        kernels, scales, biases = [], [], []
        for name, p in net.named_parameters():
            bn = isinstance(net.get_submodule(name.rsplit(".", 1)[0]),
                            BatchNorm)
            if name.endswith("weight") and not bn:
                kernels.append(p.detach().ravel())
            elif name.endswith("weight"):
                scales.append(p.detach().ravel())
            else:
                biases.append(p.detach())
        big = torch.cat(kernels)
        assert abs(float(big.mean())) < 0.005
        assert abs(float(big.std()) - 0.02) < 0.005
        s = torch.cat(scales)
        assert abs(float(s.mean()) - bn_mean) < 0.01
        assert biases and all(torch.all(b == 0) for b in biases)
        assert all(torch.all(m.running_mean == 0.5) for m in net.modules()
                   if isinstance(m, BatchNorm))


def test_checkpoint_with_began_softadapt_plateau_crosses_both_ways(
        tmp_path):
    """A JAX checkpoint with k1/k2, a SoftAdapt state and both plateau
    controllers loads into the port's Trainer (weights, k's, SoftAdapt,
    controllers and their scales on the rates); the port saves it and
    the JAX package restores the same tree and host section."""
    kw = {**STEP, "net_d": "began", "softadapt": True,
          "lr_schedule": "plateau"}
    jcfg, _, js, _ = _pair_states(kw, seed=70, k=(0.125, 0.875))
    js = js.replace(softadapt=js.softadapt._replace(
        weights=jnp.asarray([0.5, 0.25, 0.25], jnp.float32),
        prev_loss=jnp.asarray([2.0, 1.5, 0.5], jnp.float32)))
    jg, jd = JPlateau(5e-4), JPlateau(1e-4)
    for m in [5.0, 4.0] + [4.5] * 12:
        jg.step(m)
        jd.step(m / 2)
    assert jg.scale < 1.0
    host = {"best_loss": 0.75, "plateau_g": jg.state_dict(),
            "plateau_d": jd.state_dict()}
    src = str(tmp_path / "jax.msgpack")
    jck.save_checkpoint(js, src, epoch=14, host=host)

    t = Trainer(TrainConfig(**kw), RunConfig(
        seed=0, checkpoint_path=str(tmp_path / "port.msgpack"),
        tasks=("infer",)), device="cpu")
    t.load(src)
    assert t.start_epoch == 14 and t.best_loss == 0.75
    assert float(t.state.k1) == 0.125 and float(t.state.k2) == 0.875
    _assert_trees_equal(train_state_to_flax(t.state), _jax_tree(js))
    assert t.plateau_g.state_dict() == jg.state_dict()
    assert t.plateau_d.state_dict() == jd.state_dict()
    assert t.state.lr_scale_g == jg.scale and t.state.lr_scale_d == jd.scale

    t.save(14)
    restored, epoch, back = jck.load_checkpoint(js, t.run.checkpoint_path)
    assert epoch == 14 and back == host
    _assert_trees_equal(_jax_tree(restored), _jax_tree(js))


def _small_legacy_config(monkeypatch):
    """The legacy CLI fixes ngf = ndf = 64; the CPU test cuts the widths
    to 4 (the architecture, depth and every other option as the CLI
    sets them)."""
    full = config_mod.TrainConfig
    monkeypatch.setattr(config_mod, "TrainConfig", lambda **kw: full(
        **{**kw, "ngf": 4, "ndf": 4}))


@pytest.fixture(scope="module")
def legacy_run(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    _small_legacy_config(mp)
    base = tmp_path_factory.mktemp("legacy")
    root = str(base / "istd")
    write_istd_layout(root, n_train=4, n_test=2, h=64, w=64)
    args = stcgan_main.build_parser().parse_args([
        "--tasks", "train", "infer", "--devices", "cpu", "--data-dir", root,
        "--epochs", "2", "--batch-size", "2", "--image-size", "32",
        "--log-every", "1", "--valid-every", "1",
        "--weights", str(base / "w"), "--logs", str(base / "l"),
        "--infered", str(base / "out")])
    try:
        stcgan_main.main(args)
    finally:
        mp.undo()
    return base


def test_legacy_cli_trains_and_infers_192x256(legacy_run):
    names = sorted(os.listdir(legacy_run / "out" / "shadowless" / "istd"))
    assert names == ["000-test.png", "001-test.png"]
    for f in names:
        assert imread_color(str(legacy_run / "out" / "shadowless" / "istd"
                                / f)).shape == (192, 256, 3)
        assert imread_gray(str(legacy_run / "out" / "matte" / "istd"
                               / f)).shape == (192, 256)
    files = sorted(os.listdir(legacy_run / "w"))
    assert files == sorted(
        [f"{n}_{c}_{s}.msgpack" for n, c in
         (("G1", "Pix2PixUNet"), ("G2", "Pix2PixUNet"),
          ("D1", "NLayerDiscriminator"), ("D2", "NLayerDiscriminator"))
         for s in ("best", "latest")] + ["checkpoint.msgpack"])
    from shadow_removal_istd_tpu_torch.utils.msgpack_codec import from_bytes
    with open(legacy_run / "w" / "checkpoint.msgpack", "rb") as f:
        ck = from_bytes(f.read())
    assert ck["epoch"] == 2
    assert set(ck["host"]) == {"best_loss", "plateau_g", "plateau_d"}
    assert ck["host"]["plateau_g"]["current_lr"] == 5e-5
    text = "".join(open(legacy_run / "l" / f).read()
                   for f in os.listdir(legacy_run / "l")
                   if f.endswith(".log"))
    assert "train epoch 1:" in text and "valid epoch 1:" in text


def test_jax_trainer_reads_the_legacy_weight_files(legacy_run, tmp_path):
    jt = JTrainer(JConfig(net_g="stcgan", net_d="stcgan", ngf=4, ndf=4,
                          image_size=32, batch_size=2,
                          use_visual_loss=False),
                  JRunConfig(tasks=("infer",), **_dirs(tmp_path, "j")))
    w = legacy_run / "w"
    paths = {k: str(w / f"{k.upper()}_{c}_latest.msgpack") for k, c in
             (("g1", "Pix2PixUNet"), ("g2", "Pix2PixUNet"),
              ("d1", "NLayerDiscriminator"), ("d2", "NLayerDiscriminator"))}
    jt.load_weights(**paths)
    from shadow_removal_istd_tpu_torch.utils.msgpack_codec import from_bytes
    for k, path in paths.items():
        group = "g_params" if k[0] == "g" else "d_params"
        with open(path, "rb") as f:
            want = from_bytes(f.read())
        got = {"params": jax.device_get(getattr(jt.state, group)[k]),
               "batch_stats": jax.device_get(jt.state.batch_stats[k])}
        fg, fw = flatten_tree(got), flatten_tree(want)
        assert fg.keys() == fw.keys() and fw
        for p in fw:
            np.testing.assert_array_equal(np.asarray(fg[p]), fw[p])


def test_legacy_cli_refuses_no_batch_norm_flags(tmp_path):
    for flag in ("--no-batch-norm-D", "--no-batch-norm-G"):
        args = stcgan_main.build_parser().parse_args(
            ["--tasks", "train", flag, "--devices", "cpu",
             "--logs", str(tmp_path / "l")])
        with pytest.raises(SystemExit, match="not.*implemented"):
            stcgan_main.main(args)
    assert not os.path.exists(tmp_path / "l")


def test_legacy_parser_matches_jax():
    from shadow_removal_istd_tpu.cli.stcgan_main import (
        build_parser as j_parser,
    )

    def actions(p):
        return {a.dest: (a.default, a.choices, a.nargs) for a in p._actions
                if a.dest != "help"}

    got, want = actions(stcgan_main.build_parser()), actions(j_parser())
    assert got.keys() == want.keys()
    for k in want:
        if k == "devices":
            assert got[k][0] == ["cuda"] and want[k][0] == ["tpu"]
            continue
        assert got[k] == want[k], k


@pytest.mark.parametrize("net_g", ["unet", "denseunet", "stcgan"])
def test_inference_engine_matches_jax(net_g, monkeypatch):
    """``InferenceEngine`` in f32 on the same weights: uint8 outputs
    within 1 gray level at two bucket sizes (30x40 takes DenseUNet's
    bottleneck to one pixel, whose reflect pad repeats it); the bucket
    multiple is the generator's own. The JAX engine's own random init
    (op by op, 10-30 s here) is replaced by zeros shaped by
    ``eval_shape``: ``set_variables`` replaces them before any use."""
    init = nn.Module.init
    monkeypatch.setattr(nn.Module, "init", lambda self, *a, **k: jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda *a: init(self, *a, **k), *a)))
    je = JEngine(net_g, ngf=4, dtype="float32")
    monkeypatch.undo()
    te = InferenceEngine(net_g, ngf=4, dtype="float32", device="cpu")
    assert te.pad_multiple == je.pad_multiple == {
        "unet": 16, "denseunet": 32, "stcgan": 32}[net_g]
    v = [random_variables(g, c, seed=80 + c, size=32)
         for g, c in ((je.g1, 3), (je.g2, 4))]
    je.set_variables(*v)
    te.set_variables(*v)
    rng = np.random.default_rng(81)
    for h, w in ((30, 40), (64, 64)):
        imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                for _ in range(2)]
        with jax.default_matmul_precision("highest"):
            want = je.infer_group(imgs)
        got = te.infer_group(imgs)
        for (gm, gy), (wm, wy) in zip(got, want):
            assert gm.shape == wm.shape == (h, w)
            assert gy.shape == wy.shape == (h, w, 3)
            assert np.abs(gm.astype(int) - wm).max() <= 1
            assert np.abs(gy.astype(int) - wy).max() <= 1
