"""The rematerialized train step (``TrainConfig(remat=True)``).

Port against port: from one initial state, two remat steps on the same
batches and dropout generators (droprate 0.05) equal two plain steps bit
for bit: the 14 metrics, every parameter, every BatchNorm running
statistic, both Adam states, BEGAN's k1/k2, the SoftAdapt state and each
dropout generator's state afterwards. Cases: MNet + PatchGAN with the
ConvTranspose and the nearest decoder, UNet + BEGAN, DenseUNet + the
dummy D + SoftAdapt, and bf16 compute. Under remat each BatchNorm's
running statistics move once per forward (once a step in G1 and G2,
four times in D1 and D2) although the backward replays the forwards;
the bytes that autograd holds for the backward when the G phase's loss
is formed are fewer with remat than without.

Port against JAX: one remat step against ``_unjitted_train_step`` with
``TrainConfig(remat=True)`` from the same weights and batch, droprate 0,
in tests/test_torch_train.py's configuration and at its tolerances.

Port against port: ngf = ndf = 8, 64x64 crops, batch 2, a seeded random
VGG; torch runs on one thread (tests/test_torch_train.py's reason:
reproducible CPU reductions).
"""
import dataclasses
import weakref

import jax
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.engine.config import TrainConfig as JConfig
from shadow_removal_istd_tpu.engine.state import build_models as j_build
from shadow_removal_istd_tpu.engine.steps import _unjitted_train_step
from shadow_removal_istd_tpu.models.vgg import VGG19Features as JVGG
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.state import init_state
from shadow_removal_istd_tpu_torch.engine.steps import (
    METRIC_KEYS,
    train_step,
)
from shadow_removal_istd_tpu_torch.models.layers import BatchNorm
from shadow_removal_istd_tpu_torch.models.vgg import VGG19Features, init_vgg_
from shadow_removal_istd_tpu_torch.tools.convert import flax_tree_to_torch

from test_torch_train import (
    _adam_moments,
    _batches,
    _close_metrics,
    _jax_state,
    _nchw,
    _run_jax,
    _torch_state,
    _variables,
)
from test_torch_train_models import random_variables

BASE = dict(ngf=8, ndf=8, droprate=0.05, batch_size=2, image_size=64)
CASES = {
    "mnet_convtranspose": {},
    "mnet_nn_upconv": dict(nn_upconv=True),
    "unet_began": dict(net_g="unet", net_d="began"),
    "denseunet_dummy_softadapt": dict(net_g="denseunet", net_d="dummy",
                                      softadapt=True),
    "mnet_bfloat16": dict(compute_dtype="bfloat16"),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def vgg():
    return init_vgg_(VGG19Features(), torch.Generator().manual_seed(0))


def _state(cfg: TrainConfig, vgg):
    state = init_state(cfg, torch.Generator().manual_seed(3), "cpu",
                       vgg=vgg)
    if cfg.began:       # k away from 0, so that k * L_fake counts
        state.k1, state.k2 = torch.tensor(0.5), torch.tensor(0.25)
    return state


def _gens(step: int):
    return (torch.Generator().manual_seed(100 + step),
            torch.Generator().manual_seed(200 + step))


def _steps(state, n=2, mark=None):
    """``n`` steps on seeded batches; the metrics and the generators."""
    metrics, gens = [], []
    for s, b in enumerate(_batches(n, seed=11)):
        g = _gens(s)
        kw = {"mark": mark} if mark is not None else {}
        metrics.append(train_step(state, _nchw(b), g, **kw))
        gens.append(g)
    return metrics, gens


def _state_tensors(state) -> dict:
    """Every tensor the step updates, by name."""
    out = {}
    for name, net in zip(("g1", "g2", "d1", "d2"), state.models.all()):
        out.update({f"{name}.{k}": v for k, v in net.state_dict().items()})
    for which, opt in (("opt_g", state.opt_g), ("opt_d", state.opt_d)):
        for i, p in enumerate(opt.param_groups[0]["params"]):
            for k, v in opt.state[p].items():
                out[f"{which}.{i}.{k}"] = v
    out["k1"], out["k2"] = state.k1, state.k2
    if state.softadapt is not None:
        for k, v in state.softadapt._asdict().items():
            out[f"softadapt.{k}"] = v
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_remat_steps_equal_plain_steps_bit_for_bit(case, vgg):
    cfg = TrainConfig(**BASE, **CASES[case])
    plain, remat = _state(cfg, vgg), _state(
        dataclasses.replace(cfg, remat=True), vgg)
    assert remat.cfg.remat and not plain.cfg.remat
    want_m, want_g = _steps(plain)
    got_m, got_g = _steps(remat)
    for want, got in zip(want_m, got_m):
        assert got.keys() == want.keys() == set(METRIC_KEYS)
        for k in METRIC_KEYS:
            assert torch.equal(got[k], want[k]), (k, got[k], want[k])
            assert torch.isfinite(got[k])
    want_t, got_t = _state_tensors(plain), _state_tensors(remat)
    assert got_t.keys() == want_t.keys()
    for k in want_t:
        assert torch.equal(got_t[k], want_t[k]), k
    for wg, gg in zip(want_g, got_g):
        for w, g in zip(wg, gg):
            assert torch.equal(g.get_state(), w.get_state())
    if cfg.began:
        assert not torch.equal(remat.k1, torch.tensor(0.5))
    if cfg.softadapt:
        assert abs(float(remat.softadapt.weights.sum()) - 1.0) < 1e-6


def test_remat_moves_batchnorm_statistics_once_per_forward(vgg):
    """Hooks on every BatchNorm count its train forwards and those that
    moved its running mean: the backward replays forwards (more calls
    than moves), and each module moves once per forward of the plain
    step (G1 and G2 once, D1 and D2 twice in the D phase and twice in
    the G phase)."""
    state = _state(TrainConfig(**BASE, remat=True), vgg)
    counts, handles = {}, []
    for name, net in zip(("g1", "g2", "d1", "d2"), state.models.all()):
        for mod_name, mod in net.named_modules():
            if not isinstance(mod, BatchNorm):
                continue
            key = f"{name}.{mod_name}"
            counts[key] = [0, 0]

            def pre(mod, args, key=key):
                mod._before = mod.running_mean.clone()

            def post(mod, args, out, key=key):
                counts[key][0] += 1
                counts[key][1] += int(not torch.equal(mod._before,
                                                      mod.running_mean))

            handles += [mod.register_forward_pre_hook(pre),
                        mod.register_forward_hook(post)]
    try:
        _steps(state, n=1)
    finally:
        for h in handles:
            h.remove()
    assert counts
    for key, (calls, moves) in counts.items():
        assert moves == (1 if key[:2] in ("g1", "g2") else 4), (key, moves)
        assert calls >= moves
    assert sum(c for c, _ in counts.values()) > sum(
        m for _, m in counts.values())


def _saved_bytes_at_g_loss(cfg, vgg) -> int:
    """Bytes of the distinct storages that autograd holds for the
    backward (``saved_tensors_hooks``) when the step marks "g_visual",
    just before ``g_total`` is summed and its backward starts. The
    remat step's checkpoints keep their inputs (the batch and the two
    predictions) outside these hooks."""
    live = weakref.WeakSet()

    class Saved:
        def __init__(self, t):
            self.t = t

    def pack(t):
        s = Saved(t)
        live.add(s)
        return s

    seen = []

    def mark(name):
        if name == "g_visual":
            storages = {s.t.untyped_storage().data_ptr():
                        s.t.untyped_storage().nbytes() for s in live}
            seen.append(sum(storages.values()))

    state = _state(cfg, vgg)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda s: s.t):
        _steps(state, n=1, mark=mark)
    (nbytes,) = seen
    return nbytes


def test_remat_holds_fewer_bytes_for_the_backward(vgg):
    cfg = TrainConfig(**BASE)
    plain = _saved_bytes_at_g_loss(cfg, vgg)
    remat = _saved_bytes_at_g_loss(dataclasses.replace(cfg, remat=True),
                                   vgg)
    print(f"saved for the backward at the G loss: plain {plain} bytes, "
          f"remat {remat} bytes")
    assert remat < plain


def test_remat_step_matches_jax_remat_step():
    """One remat step of each package from the same variables and batch,
    in tests/test_torch_train.py's configuration (ngf = ndf = 4, droprate
    0, Adam eps 1e-3) and at its tolerances: the 14 metrics within 1e-4
    relative, Adam's first moments within 1e-4 of each leaf's largest.
    (At ngf 8 the plain step as well as the remat step puts 6 of the
    65536 moments of one G2 kernel 3.2e-6 off, against a bound of
    2.7e-6: those tolerances were set at ngf 4.)"""
    from test_torch_train import BASE as TRAIN_BASE

    base = {**TRAIN_BASE, "remat": True}
    jcfg, tcfg = JConfig(**base), TrainConfig(**base)
    vv = random_variables(JVGG(), 3, seed=99, size=64)
    jm = j_build(jcfg)
    variables = _variables(jm, seed=0)
    jstep = jax.jit(_unjitted_train_step(jm, jcfg, vv))
    batches = _batches(1, seed=1)
    js, jmet = _run_jax(jstep, _jax_state(jcfg, variables), batches)
    ts = _torch_state(tcfg, variables,
                      flax_tree_to_torch(vv, VGG19Features()))
    tmet = [{k: float(v) for k, v in train_step(ts, _nchw(batches[0])
                                                ).items()}]
    _close_metrics(tmet[0], jmet[0], 1e-4)
    assert tmet[0]["vis2"] > 0
    want = jax.tree.map(np.asarray, {**js.opt_g[0].mu, **js.opt_d[0].mu})
    got = _adam_moments(ts)
    from shadow_removal_istd_tpu_torch.tools.convert import flatten_tree
    g, w = flatten_tree(got), flatten_tree(want)
    assert g.keys() == w.keys()
    for k in w:
        tol = 1e-4 * max(float(np.abs(w[k]).max()), 1e-12)
        np.testing.assert_allclose(g[k], w[k], atol=tol, rtol=0,
                                   err_msg="/".join(k))
