"""The port's adversarial training (``engine/``) against the JAX
package's, from identical weights and batches.

G1/G2 (MNet, ngf 4, droprate 0) and D1/D2 (PatchGAN, ndf 4) start from
the same numpy variables (random BatchNorm affines and statistics), with
the visual loss on through shared random VGG weights, the ConvTranspose
decoder (the CLI's training default) and a per-epoch decay of 0.1 with
one step per epoch, so that three steps cross three learning rates.
JAX runs ``_unjitted_train_step`` jitted under "highest" matmul
precision. Crops are 64x64, batch 2: at 32x32 G's innermost BatchNorm
normalises two values per channel, where f32 cancellation alone moves
either framework ~1e-4 off a float64 forward (see
tests/test_torch_train_models.py).

Adam's eps is 1e-3 here (the default 1e-8 is held by the learning-rate
and first-moment checks): Adam divides each gradient element by its own
magnitude plus eps, so with eps 1e-8 any element whose gradient lies
below the two frameworks' f32 noise (~1e-6 here) moves by +-lr with
either sign, and parameters may part by 2*lr per step whatever the
gradients' agreement. With eps 1e-3 that spread is bounded by
lr * noise / eps, ~5e-7 per step.

Held: after 1 step the 14 metrics (relative 1e-4) and Adam's first
moments, which after one step are 0.5*grad in both (beta1 0.5; within
1e-4 of each leaf's largest); after 3 steps every parameter and running
statistic (1e-5); ``eval_step``'s 15 metrics after those steps (1e-4);
the nearest decoder without the visual loss (1 step); one bf16 compute
step (metrics, relative 2e-2); and a 2-step epoch through
``engine/epoch.py`` with an injected index matrix and augmentation
parameters against a JAX loop of take -> ``fused_augment_shear`` ->
train step.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.engine.config import TrainConfig as JConfig
from shadow_removal_istd_tpu.engine.state import TrainState as JState
from shadow_removal_istd_tpu.engine.state import build_models as j_build
from shadow_removal_istd_tpu.engine.state import (
    make_optimizers as j_optimizers,
)
from shadow_removal_istd_tpu.engine.steps import (
    _unjitted_train_step,
    make_eval_step,
)
from shadow_removal_istd_tpu.models.vgg import VGG19Features as JVGG
from shadow_removal_istd_tpu.ops import pallas_shear as jshear
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.epoch import RngStreams, make_epoch
from shadow_removal_istd_tpu_torch.engine.state import (
    TrainState,
    build_models,
    learning_rate,
    make_optimizers,
)
from shadow_removal_istd_tpu_torch.engine.steps import (
    METRIC_KEYS,
    eval_step,
    train_step,
)
from shadow_removal_istd_tpu_torch.losses import make_adversarial_loss
from shadow_removal_istd_tpu_torch.models.vgg import VGG19Features
from shadow_removal_istd_tpu_torch.ops.augment import (
    AugmentConfig,
    augment_batch,
)
from shadow_removal_istd_tpu_torch.tools.convert import (
    flatten_tree,
    flax_tree_to_torch,
    torch_to_flax_tree,
)

from test_torch_train_models import random_variables

NETS = ("g1", "g2", "d1", "d2")
IN_CH = {"g1": 3, "g2": 4, "d1": 4, "d2": 7}
BASE = dict(ngf=4, ndf=4, droprate=0.0, batch_size=2, image_size=64,
            decay=0.1, steps_per_epoch=1, aug_method="shear", adam_eps=1e-3)


def _variables(jmodels, seed):
    return {k: random_variables(getattr(jmodels, k), IN_CH[k],
                                seed=seed + i, size=64)
            for i, k in enumerate(NETS)}


def _jax_state(cfg, variables):
    g = {k: variables[k]["params"] for k in ("g1", "g2")}
    d = {k: variables[k]["params"] for k in ("d1", "d2")}
    tx_g, tx_d = j_optimizers(cfg)
    to_j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    return JState(step=jnp.zeros((), jnp.int32), g_params=to_j(g),
                  d_params=to_j(d),
                  batch_stats=to_j({k: variables[k]["batch_stats"]
                                    for k in NETS}),
                  opt_g=tx_g.init(to_j(g)), opt_d=tx_d.init(to_j(d)),
                  k1=jnp.zeros(()), k2=jnp.zeros(()))


def _torch_state(cfg, variables, vgg):
    models = build_models(cfg)
    for k in NETS:
        flax_tree_to_torch(variables[k], getattr(models, k))
    opt_g, opt_d = make_optimizers(cfg, models)
    return TrainState(cfg=cfg, models=models, opt_g=opt_g, opt_d=opt_d,
                      adv=make_adversarial_loss(cfg.d_loss_fn, cfg.d_type,
                                                cfg.loss_mode), vgg=vgg)


def _batches(n, seed, size=64):
    rng = np.random.default_rng(seed)
    return [tuple(rng.uniform(-1, 1, (2, size, size, c)).astype(np.float32)
                  for c in (3, 1, 3)) for _ in range(n)]


def _nchw(batch):
    return tuple(torch.from_numpy(a).permute(0, 3, 1, 2) for a in batch)


def _run_jax(step, state, batches):
    metrics = []
    with jax.default_matmul_precision("highest"):
        for b in batches:
            state, m = step(state, tuple(map(jnp.asarray, b)),
                            jax.random.key(0))
            metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _run_torch(state, batches):
    return state, [{k: float(v) for k, v in
                    train_step(state, _nchw(b)).items()} for b in batches]


def _close_metrics(got, want, rel, keys=METRIC_KEYS):
    for k in keys:
        assert abs(got[k] - want[k]) <= rel * max(1.0, abs(want[k])), (
            k, got[k], want[k])


def _torch_tree(state, which):
    return {k: torch_to_flax_tree(getattr(state.models, k))[which]
            for k in NETS}


def _jax_tree(state, which):
    if which == "batch_stats":
        return jax.tree.map(np.asarray, state.batch_stats)
    return jax.tree.map(np.asarray, {**state.g_params, **state.d_params})


def _close_trees(got, want, atol):
    g, w = flatten_tree(got), flatten_tree(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0,
                                   err_msg="/".join(k))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's multi-threaded CPU kernels, sharing the cores with XLA's
    thread pool, were seen to split their reductions differently from
    run to run (up to 7e-4 of a gradient leaf's largest element at
    128x128); one thread keeps the torch side reproducible."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def vgg_pair():
    v = random_variables(JVGG(), 3, seed=99, size=64)
    return v, flax_tree_to_torch(v, VGG19Features())


@pytest.fixture(scope="module")
def f32_run(vgg_pair):
    """Three f32 steps on both sides; first-step metrics and moments."""
    vv, tvgg = vgg_pair
    jcfg, tcfg = JConfig(**BASE), TrainConfig(**BASE)
    jm = j_build(jcfg)
    variables = _variables(jm, seed=0)
    jstep = jax.jit(_unjitted_train_step(jm, jcfg, vv))
    batches = _batches(3, seed=1)
    js, jmet = _run_jax(jstep, _jax_state(jcfg, variables), batches[:1])
    ts = _torch_state(tcfg, variables, tvgg)
    ts, tmet = _run_torch(ts, batches[:1])
    moments = (jax.tree.map(np.asarray,
                            {**js.opt_g[0].mu, **js.opt_d[0].mu}),
               _adam_moments(ts))
    js, jmet3 = _run_jax(jstep, js, batches[1:])
    ts, tmet3 = _run_torch(ts, batches[1:])
    return dict(jm=jm, jcfg=jcfg, vv=vv, variables=variables, jstep=jstep,
                jstate=js, tstate=ts, jmet=jmet + jmet3,
                tmet=tmet + tmet3, moments=moments)


def _adam_moments(state):
    """Adam's first moments as flax ``params`` trees (OIHW -> HWIO)."""
    out = {}
    for k, opt in (("g1", state.opt_g), ("g2", state.opt_g),
                   ("d1", state.opt_d), ("d2", state.opt_d)):
        net = getattr(state.models, k)
        twin = copy.deepcopy(net)
        with torch.no_grad():
            for p, q in zip(net.parameters(), twin.parameters()):
                q.copy_(opt.state[p]["exp_avg"])
        out[k] = torch_to_flax_tree(twin)["params"]
    return out


def test_first_step_metrics_match_jax(f32_run):
    _close_metrics(f32_run["tmet"][0], f32_run["jmet"][0], 1e-4)
    assert f32_run["tmet"][0]["vis2"] > 0     # the visual terms ran


def test_first_step_adam_moments_match_jax(f32_run):
    want, got = f32_run["moments"]
    g, w = flatten_tree(got), flatten_tree(want)
    assert g.keys() == w.keys()
    for k in w:
        tol = 1e-4 * max(float(np.abs(w[k]).max()), 1e-12)
        np.testing.assert_allclose(g[k], w[k], atol=tol, rtol=0,
                                   err_msg="/".join(k))


def test_three_steps_params_and_stats_match_jax(f32_run):
    for i in (1, 2):
        _close_metrics(f32_run["tmet"][i], f32_run["jmet"][i], 1e-4)
    js, ts = f32_run["jstate"], f32_run["tstate"]
    assert ts.step == 3 and int(js.step) == 3
    _close_trees(_torch_tree(ts, "params"), _jax_tree(js, "params"), 1e-5)
    _close_trees(_torch_tree(ts, "batch_stats"),
                 _jax_tree(js, "batch_stats"), 1e-5)


def test_eval_step_matches_jax_after_training(f32_run):
    js, ts = f32_run["jstate"], f32_run["tstate"]
    batch = _batches(1, seed=7)[0]
    jeval = make_eval_step(f32_run["jm"], f32_run["jcfg"], f32_run["vv"])
    with jax.default_matmul_precision("highest"):
        want = {k: float(v) for k, v in
                jeval(js, tuple(map(jnp.asarray, batch))).items()}
    got = {k: float(v) for k, v in eval_step(ts, _nchw(batch)).items()}
    assert got.keys() == want.keys() == {*METRIC_KEYS, "total"}
    _close_metrics(got, want, 1e-4, keys=want.keys())


def test_learning_rate_decays_per_epoch():
    """``learning_rate`` against optax's schedule in the JAX package's
    Adam (default betas, eps 0): one update of a unit gradient moves a
    parameter by -lr, up to optax's f32 bias corrections (6.4e-6
    relative: 1 - 0.999 rounds in f32)."""
    cfg = dict(lr_g=5e-4, decay=0.1, steps_per_epoch=3)
    tx, _ = j_optimizers(JConfig(**cfg, adam_eps=0.0))
    p = jnp.zeros(())
    s = tx.init(p)
    for i in range(8):
        u, s = tx.update(jnp.ones(()), s, p)
        want = -float(u)
        got = learning_rate(5e-4, TrainConfig(**cfg), i)
        assert abs(got - want) <= 1e-5 * want, (i, got, want)
        assert got == 5e-4 * 0.9 ** (i // 3)


def test_nearest_decoder_without_visual_loss(f32_run):
    kw = {**BASE, "nn_upconv": True, "use_visual_loss": False}
    jcfg, tcfg = JConfig(**kw), TrainConfig(**kw)
    jm = j_build(jcfg)
    variables = _variables(jm, seed=20)
    batches = _batches(1, seed=21)
    js, jmet = _run_jax(jax.jit(_unjitted_train_step(jm, jcfg, None)),
                        _jax_state(jcfg, variables), batches)
    ts, tmet = _run_torch(_torch_state(tcfg, variables, None), batches)
    assert tmet[0]["vis1"] == tmet[0]["vis2"] == 0.0
    _close_metrics(tmet[0], jmet[0], 1e-4)
    _close_trees(_torch_tree(ts, "params"), _jax_tree(js, "params"), 1e-5)


def test_bf16_compute_step(f32_run, vgg_pair):
    vv, tvgg = vgg_pair
    kw = {**BASE, "compute_dtype": "bfloat16"}
    jcfg, tcfg = JConfig(**kw), TrainConfig(**kw)
    jm = j_build(jcfg)
    batches = _batches(1, seed=1)
    _, jmet = _run_jax(jax.jit(_unjitted_train_step(jm, jcfg, vv)),
                       _jax_state(jcfg, f32_run["variables"]), batches)
    ts = _torch_state(tcfg, f32_run["variables"], tvgg)
    ts, tmet = _run_torch(ts, batches)
    assert ts.models.g1.stem.weight.dtype == torch.float32   # f32 params
    _close_metrics(tmet[0], jmet[0], 2e-2)


def test_two_step_epoch_matches_jax_loop(f32_run):
    """``make_epoch`` with injected indices and augmentation parameters
    against take -> fused_augment_shear -> train step in JAX."""
    rng = np.random.default_rng(30)
    n, h, w = 4, 72, 88
    arrays = tuple(rng.integers(0, 256, (n, h, w, c), dtype=np.uint8)
                   for c in (3, 1, 3))                   # img, matte, target
    idx = np.array([[2, 0], [3, 1]])
    params = [{"scale": rng.uniform(0.95, 1.05, 2).astype(np.float32),
               "angle": rng.uniform(-15, 15, 2).astype(np.float32),
               "flip": np.array([s == 0, True]),
               "row_off": rng.integers(0, h - 64, 2).astype(np.int32),
               "col_off": rng.integers(0, w - 64, 2).astype(np.int32)}
              for s in range(2)]
    variables, jcfg = f32_run["variables"], f32_run["jcfg"]

    jaug = jax.jit(lambda s, p: jshear.fused_augment_shear(
        s, p, 64, max_angle_deg=15.0, interpret=True))
    js = _jax_state(jcfg, variables)
    jsum = dict.fromkeys(METRIC_KEYS, 0.0)
    with jax.default_matmul_precision("highest"):
        for step in range(2):
            raw = jnp.concatenate([jnp.asarray(a[idx[step]])
                                   for a in arrays], -1)
            out = jaug(raw, {k: jnp.asarray(v)
                             for k, v in params[step].items()})
            batch = (out[..., :3], out[..., 3:4], out[..., 4:])
            js, m = f32_run["jstep"](js, batch, jax.random.key(0))
            for k in METRIC_KEYS:
                jsum[k] += float(m[k])

    ts = _torch_state(TrainConfig(**BASE), variables, f32_run["tstate"].vgg)
    epoch_fn = make_epoch(
        AugmentConfig(crop_size=64, method="shear"),
        param_source=lambda s: {k: torch.from_numpy(v)
                                for k, v in params[s].items()})
    ts, sums = epoch_fn(ts, tuple(map(torch.from_numpy, arrays)),
                        torch.from_numpy(idx), RngStreams(0, 0))
    assert ts.step == 2
    _close_metrics({k: float(v) for k, v in sums.items()}, jsum, 1e-4)
    _close_trees(_torch_tree(ts, "params"), _jax_tree(js, "params"), 1e-5)


def test_rng_streams_are_pure_functions_of_seed_epoch_step():
    def draw(seed, epoch, step, stream):
        g = RngStreams(seed, epoch).generator(stream, step)
        return torch.rand(4, generator=g)

    assert torch.equal(draw(3, 1, 2, "augment"), draw(3, 1, 2, "augment"))
    for other in ((4, 1, 2, "augment"), (3, 2, 2, "augment"),
                  (3, 1, 3, "augment"), (3, 1, 2, "dropout_g1")):
        assert not torch.equal(draw(3, 1, 2, "augment"), draw(*other))


def _tiny_trainer(tmp_path=None, run=None, **kw):
    from shadow_removal_istd_tpu_torch.data.synthetic import (
        synthetic_triplets,
    )
    from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer

    cfg = TrainConfig(**{**BASE, "image_size": 32, **kw.pop("cfg", {})})
    dirs = {} if tmp_path is None else dict(
        weights_dir=str(tmp_path / "w"), logs_dir=str(tmp_path / "l"),
        checkpoint_path=str(tmp_path / "w" / "checkpoint.msgpack"))
    run = {"device_cache": True, **(run or {})}      # the fused epoch
    return Trainer(cfg, RunConfig(seed=0, **dirs, **run, **kw),
                   train_streams=synthetic_triplets(4, 48, 64, seed=0),
                   valid_streams=synthetic_triplets(3, 64, 64, seed=1),
                   device="cpu")


def test_trainer_trains_and_validates_on_the_cpu(tmp_path):
    run = dict(valid_every=1, log_every=1, save_every=1)
    t = _tiny_trainer(tmp_path, run, cfg={"use_visual_loss": False})
    assert t.cfg.steps_per_epoch == 2
    t.train(2)
    assert len(t.history) == 2 and t.state.step == 4
    assert all(np.isfinite(v) for h in t.history for v in h.values())
    assert set(t.last_valid) == {*METRIC_KEYS, "total"}
    assert t.best_loss <= t.last_valid["total"]
    # same seed, same run: randomness is a function of (seed, epoch, step)
    t2 = _tiny_trainer(tmp_path, run, cfg={"use_visual_loss": False})
    t2.train(2)
    assert t2.history == t.history


def test_trainer_vgg_rule():
    with pytest.raises(ValueError, match="no VGG weights"):
        _tiny_trainer()
    t = _tiny_trainer(allow_missing_vgg=True)
    assert t.state.vgg is None
    with pytest.raises(FileNotFoundError):
        _tiny_trainer(vgg_weights="/nonexistent/vgg19_bn.npz")
    # an inference-only run needs no VGG
    assert _tiny_trainer(tasks=("infer",)).state.vgg is None


def test_remat_option_builds():
    """``remat`` no longer raises (tests/test_torch_remat.py runs it)."""
    assert TrainConfig(remat=True).remat


@pytest.mark.parametrize("field,value", [("aug_resize", (300, 400)),
                                         ("valid_resize", (240, 320))])
def test_resize_options_run_and_match_jax(field, value, tmp_path):
    """The legacy tree's resizes: the resized streams equal the JAX
    package's (the augmentation's resize through ``augment_batch`` with
    explicit parameters, the validation streams through its ``resize`` +
    ``normalize_batch``), and the trainer trains with the augmentation's.
    (MNet takes no 240x320 input, in either package: a validation at
    ``valid_resize`` runs in tests/test_torch_eval_protocol.py.)"""
    from shadow_removal_istd_tpu.ops import augment as jaugment
    from shadow_removal_istd_tpu.ops.resize import resize as j_resize

    from test_torch_warp import jax_augment

    t = _tiny_trainer(tmp_path, cfg={field: value,
                                     "use_visual_loss": False})
    raw = next(t.valid_pipe.epoch())          # 2 of the 64x64 triplets
    if field == "valid_resize":
        got = next(t.valid_batches())
        want = jaugment.normalize_batch(tuple(
            j_resize(jnp.asarray(a, jnp.float32), value) for a in raw))
        for g, w_ in zip(got, want):
            assert g.shape == (raw[0].shape[0], w_.shape[-1], *value)
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(w_), atol=1e-5, rtol=0)
        return
    rng = np.random.default_rng(31)
    p = {"scale": rng.uniform(0.95, 1.05, 2).astype(np.float32),
         "angle": rng.uniform(-15, 15, 2).astype(np.float32),
         "flip": np.array([True, False]),
         "row_off": rng.integers(0, value[0] - 32, 2).astype(np.int32),
         "col_off": rng.integers(0, value[1] - 32, 2).astype(np.int32)}
    want = jax_augment(raw, p, jaugment.AugmentConfig(crop_size=32,
                                                      resize=value))
    got = augment_batch(None, tuple(map(torch.from_numpy, raw)), t.aug_cfg,
                        params={k: torch.from_numpy(v) for k, v in p.items()})
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w_,
                                   atol=1e-3, rtol=0)
    t.train(1)
    assert all(np.isfinite(v) for v in t.history[0].values())
    assert np.isfinite(t.last_valid["total"])


def test_trainer_trains_with_the_gather_augmentation(monkeypatch,
                                                     tmp_path):
    """``TrainConfig``'s default ``aug_method="gather"`` trains, reaches
    no ``hshear`` call, and draws its parameters from the same
    (seed, epoch, step) streams: two runs are bit-identical."""
    from shadow_removal_istd_tpu_torch.ops import shear

    monkeypatch.setattr(shear, "hshear", None)      # must not be reached
    runs = []
    for _ in range(2):
        t = _tiny_trainer(tmp_path, cfg={"aug_method": "gather",
                                         "use_visual_loss": False})
        assert t.aug_cfg.method == "gather"
        t.train(2)
        runs.append((t.history, [p.detach().clone() for p in
                                 t.state.models.g2.parameters()]))
    assert all(np.isfinite(v) for h in runs[0][0] for v in h.values())
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
