"""The port's data parallelism (``parallel/mesh.py``) and two-stage
pipeline (``parallel/pipeline.py``) on the CPU.

Two gloo CPU ranks run as subprocesses of ``tests/torch_dp_ranks.py``
(torch and the port only; this module imports JAX), one torch thread
each, rendezvousing at a file in ``tmp_path`` so that parallel test
workers never share a port. Every rank starts from the same numpy
variables and takes its contiguous half of every global batch.

Held:
- a 2-rank train-mode ``BatchNorm`` forward and backward equals one
  rank's on the whole batch within 1e-6 (outputs, input and parameter
  gradients, running statistics with the global count);
- 2 steps of the 2-rank train step against the JAX step on a 2-device
  mesh (``make_mesh(2)`` of conftest's 8 virtual devices), MNet +
  PatchGAN with ``D_type`` normal and ``rel_avg`` (the global
  relativistic mean), at ``tests/test_torch_train.py``'s size and
  tolerances (64x64, ngf/ndf 4, Adam eps 1e-3; metrics relative 1e-4,
  parameters and BN statistics 1e-5, Adam moments 1e-4 of each leaf's
  largest); the 2-rank step against the 1-rank port step within 1e-5
  for both and for BEGAN D with SoftAdapt;
  every rank ends with the same state, bit for bit (k1/k2 and SoftAdapt
  included);
- a 2-rank, 2-process ``Trainer`` (fused epoch and host pipeline, both
  with dropout and the shear augmentation drawn for the global batch):
  metrics equal on both ranks and within 1e-5 of one rank's, the ragged
  validation batch dropped, files from rank 0 only, ``infer`` raising as
  the JAX trainer does in a multi-process run;
- ``StackedPipeline`` on ``["cpu", "cpu"]`` equals ``infer_step`` bit
  for bit (and its stream, in order, and a ragged batch on a 4-device
  split), and ``overlap`` as the JAX tests hold it.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from shadow_removal_istd_tpu.engine.config import TrainConfig as JConfig
from shadow_removal_istd_tpu.engine.state import build_models as j_build
from shadow_removal_istd_tpu.engine.steps import _unjitted_train_step
from shadow_removal_istd_tpu.parallel.mesh import make_mesh as j_mesh
from shadow_removal_istd_tpu.parallel.mesh import shard_batch as j_shard
from shadow_removal_istd_tpu.parallel.mesh import shard_state as j_place
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.state import build_models
from shadow_removal_istd_tpu_torch.engine.steps import infer_step
from shadow_removal_istd_tpu_torch.models.layers import init_weights_
from shadow_removal_istd_tpu_torch.parallel import StackedPipeline, overlap
from shadow_removal_istd_tpu_torch.parallel.mesh import make_mesh

import torch_dp_ranks as ranks
from test_torch_train import _jax_state, _variables

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
STEP_KW = dict(ngf=4, ndf=4, droprate=0.0, batch_size=4, image_size=64,
               decay=0.1, steps_per_epoch=1, adam_eps=1e-3,
               use_visual_loss=False)
CFGS = {"normal": STEP_KW,
        "rel_avg": {**STEP_KW, "d_type": "rel_avg"},
        "began": {**STEP_KW, "net_d": "began", "softadapt": True}}
JAX_CFGS = ("normal", "rel_avg")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ranks(case: str, d: Path, inputs: dict, config: dict) -> list:
    """Run ``case`` on 2 gloo CPU ranks in ``d``; each rank's outputs."""
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / "inputs.npz", **inputs)
    (d / "config.json").write_text(json.dumps(config))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_dp_ranks.py"), case,
         str(r), str(WORLD), str(d)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(d / f"out{r}.npz")) for r in range(WORLD)]


def _one_rank(case: str, inputs: dict, config: dict) -> dict:
    """The same case on one rank, in this process."""
    return ranks.CASES[case](make_mesh("cpu"), inputs, config)


def _ranks_agree(outs: list) -> None:
    """Every rank's outputs are rank 0's, bit for bit."""
    assert outs[0].keys() == outs[1].keys()
    for k, v in outs[0].items():
        np.testing.assert_array_equal(outs[1][k], v, err_msg=k)


def _close(got: dict, want: dict, prefix: str, atol: float = 0.0,
           rtol: float = 0.0, rel_leaf: float | None = None) -> int:
    """Compare the entries of ``want`` under ``prefix``; returns how
    many were compared. ``rel_leaf``: the tolerance is that share of
    each leaf's largest magnitude, and no less than 1e-6 of the whole
    tree's (the f32 noise of a leaf whose exact value is 0: under the
    relativistic average, D's last BatchNorm bias, whose shift of D's
    output cancels, gets gradients of ~1e-8 in either framework against
    a tree's 0.36)."""
    keys = [k for k in want if k.startswith(prefix)]
    tree = max((float(np.abs(want[k]).max(initial=0.0)) for k in keys),
               default=0.0)
    for k in keys:
        w = np.asarray(want[k], np.float64)
        tol = atol
        if rel_leaf is not None:
            tol = max(rel_leaf * float(np.abs(w).max(initial=0.0)),
                      1e-6 * tree)
        np.testing.assert_allclose(np.asarray(got[k], np.float64), w,
                                   atol=tol, rtol=rtol, err_msg=k)
    return len(keys)


# ---------------------------------------------------------------- BatchNorm

def test_global_batchnorm_matches_one_rank(tmp_path):
    rng = np.random.default_rng(0)
    inputs = {"x": (rng.standard_normal((4, 3, 5, 6)) * 2 + 1
                    ).astype(np.float32),
              "g": rng.standard_normal((4, 3, 5, 6)).astype(np.float32),
              "weight": rng.uniform(0.5, 1.5, 3).astype(np.float32),
              "bias": rng.standard_normal(3).astype(np.float32)}
    outs = _ranks("bn", tmp_path, inputs, {})
    want = _one_rank("bn", inputs, {})
    for k, w in want.items():
        if k in ("y", "x_grad"):          # this rank's rows
            got = np.concatenate([o[k] for o in outs])
        else:
            got = outs[0][k]
            np.testing.assert_array_equal(outs[1][k], got, err_msg=k)
        # (the running variance's unbiased factor is the global batch's
        # 120/119; a rank's 60/59 would put it ~1e-4 off)
        np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6, err_msg=k)


# ------------------------------------------------------------ train steps

@pytest.fixture(scope="module")
def dp_steps(tmp_path_factory):
    """2 steps of each configuration: the 2 ranks' outputs, one rank's,
    and the JAX step's on a 2-device mesh (metrics and state tree)."""
    rng = np.random.default_rng(1)
    inputs, variables = {}, {}
    for s in range(2):
        for i, c in enumerate((3, 1, 3)):
            inputs[f"batch{s}_{i}"] = rng.uniform(
                -1, 1, (4, 64, 64, c)).astype(np.float32)
    for name, kw in CFGS.items():
        variables[name] = _variables(j_build(JConfig(**kw)), seed=10)
        inputs.update({f"{name}.vars/{k}": v
                       for k, v in ranks.flat(variables[name]).items()})
    config = {"steps": 2, "cfgs": CFGS}
    outs = _ranks("steps", tmp_path_factory.mktemp("steps"), inputs, config)
    one = _one_rank("steps", inputs, config)

    jax_out = {}
    mesh = j_mesh(2)
    batches = [tuple(jnp.asarray(inputs[f"batch{s}_{i}"]) for i in range(3))
               for s in range(2)]
    for name in JAX_CFGS:
        jcfg = JConfig(**CFGS[name])
        step = jax.jit(_unjitted_train_step(j_build(jcfg), jcfg, None))
        state = j_place(mesh, _jax_state(jcfg, variables[name]))
        with jax.default_matmul_precision("highest"):
            for s, b in enumerate(batches):
                state, m = step(state, j_shard(mesh, b), jax.random.key(0))
                jax_out.update({f"{name}.metrics{s}/{k}": float(v)
                                for k, v in m.items()})
        tree = jax.tree.map(np.asarray, serialization.to_state_dict(state))
        jax_out.update({f"{name}.state/{k}": v
                        for k, v in ranks.flat(tree).items()})
    return outs, one, jax_out


def test_every_rank_holds_the_same_state(dp_steps):
    outs, _, _ = dp_steps
    _ranks_agree(outs)
    assert any(k.startswith("began.state/k1") for k in outs[0])
    assert any(k.startswith("began.state/softadapt/") for k in outs[0])


@pytest.mark.parametrize("name", JAX_CFGS)
def test_two_rank_step_matches_jax_mesh(dp_steps, name):
    outs, _, want = dp_steps
    got = outs[0]
    for s in range(2):
        for k in (k for k in want if k.startswith(f"{name}.metrics{s}/")):
            w = want[k]
            assert abs(float(got[k]) - w) <= 1e-4 * max(1.0, abs(w)), (
                k, float(got[k]), w)
    for part in ("g_params", "d_params", "batch_stats"):
        assert _close(got, want, f"{name}.state/{part}/", atol=1e-5) > 0
    for opt in ("opt_g", "opt_d"):
        for moment in ("mu", "nu"):
            assert _close(got, want, f"{name}.state/{opt}/0/{moment}/",
                          rel_leaf=1e-4) > 0
    assert int(got[f"{name}.state/step"]) == 2


@pytest.mark.parametrize("name", sorted(CFGS))
def test_two_rank_step_matches_one_rank(dp_steps, name):
    outs, one, _ = dp_steps
    got = outs[0]
    for k in (k for k in one if k.startswith(f"{name}.metrics")):
        assert abs(float(got[k]) - float(one[k])) <= 1e-5 * max(
            1.0, abs(float(one[k]))), (k, float(got[k]), float(one[k]))
    assert _close(got, one, f"{name}.state/", atol=1e-5) > 0


def test_began_k_and_softadapt_moved(dp_steps):
    """BEGAN's k and SoftAdapt's weights took their global updates."""
    outs, one, _ = dp_steps
    for key in ("began.state/k1", "began.state/k2"):
        assert float(outs[0][key]) != 0.5           # moved from 0.5
        assert abs(float(outs[0][key]) - float(one[key])) <= 1e-7
    w = outs[0]["began.state/softadapt/weights"]
    assert abs(float(w.sum()) - 1.0) < 1e-6
    np.testing.assert_allclose(w, one["began.state/softadapt/weights"],
                               atol=1e-7)


# ---------------------------------------------------------------- Trainer

TRAINER_CFG = dict(ngf=4, ndf=4, droprate=0.05, batch_size=4,
                   image_size=32, adam_eps=1e-3, aug_method="shear",
                   use_visual_loss=False)
TRAINER_RUNS = {"fused": True, "host": False}


@pytest.fixture(scope="module")
def dp_trainer(tmp_path_factory):
    """2 epochs of a 2-rank, 2-process ``Trainer`` per epoch path, and
    one rank's on the validation split without its ragged batch."""
    rng = np.random.default_rng(2)
    streams = {}
    for split, n in (("train", 8), ("valid", 6)):
        for k, c in (("img", 3), ("matte", 1), ("target", 3)):
            streams[f"{split}/{k}"] = rng.integers(
                0, 256, (n, 64, 64, c), dtype=np.uint8)
    d = tmp_path_factory.mktemp("trainer")
    config = {"dir": str(d), "runs": TRAINER_RUNS, "cfg": TRAINER_CFG,
              "epochs": 2}
    outs = _ranks("trainer", d / "ranks", streams, config)
    full = {k: (v[:4] if k.startswith("valid/") else v)
            for k, v in streams.items()}
    one = _one_rank("trainer", full, {**config, "dir": str(d / "one")})
    return d, outs, one


@pytest.mark.parametrize("name", sorted(TRAINER_RUNS))
def test_trainer_two_ranks_match_one(dp_trainer, name):
    _, outs, one = dp_trainer
    _ranks_agree(outs)
    got, want = outs[0], one
    keys = [k for k in want if k.startswith(
        tuple(f"{name}.{p}" for p in ("history", "valid/", "eval/")))]
    assert {k.split("/")[0] for k in keys} >= {
        f"{name}.history0", f"{name}.history1", f"{name}.valid",
        f"{name}.eval"}
    for k in keys:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= 1e-5 * max(1.0, abs(w)), (
            k, float(got[k]), w)
    assert _close(got, want, f"{name}.state/", atol=1e-5) > 0


@pytest.mark.parametrize("name", sorted(TRAINER_RUNS))
def test_trainer_rank0_writes_and_ragged_batch_dropped(dp_trainer, name):
    d, outs, _ = dp_trainer
    assert [int(o[f"{name}.valid_batches"]) for o in outs] == [1, 1]
    for o in outs:
        assert "single-process" in str(o[f"{name}.infer_raised"])
    files = {r: sorted(str(p.relative_to(d / f"rank{r}" / name))
                       for p in (d / f"rank{r}" / name).rglob("*")
                       if p.is_file())
             for r in range(WORLD)}
    assert files[1] == []
    assert "weights/checkpoint.msgpack" in files[0]
    assert "weights/G1_MNet_latest.msgpack" in files[0]
    assert "weights/G2_MNet_best.msgpack" in files[0]
    for which in ("train", "valid"):
        assert any(f.startswith(f"logs/{which}/events.out.tfevents")
                   for f in files[0])


# --------------------------------------------------------------- pipeline

def _generators(seed: int = 0):
    cfg = TrainConfig(ngf=4, droprate=0.0, nn_upconv=True)
    models = build_models(cfg)
    gen = torch.Generator().manual_seed(seed)
    for net in (models.g1, models.g2):
        init_weights_(net, gen)
        net.eval()
    return models.g1, models.g2


def _images(n: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 3, 32, 32), generator=g) * 2 - 1


@torch.no_grad()
def test_pipeline_matches_fused_infer():
    g1, g2 = _generators()
    x = _images(4, 1)
    m_ref, y_ref = infer_step(g1, g2, x)
    pipe = StackedPipeline(g1, g2, ["cpu", "cpu"])
    m, y = pipe(x)
    assert torch.equal(m, m_ref) and torch.equal(y, y_ref)


@torch.no_grad()
def test_pipeline_stream_keeps_order():
    g1, g2 = _generators()
    xs = [_images(2, s) for s in range(5)]
    refs = [infer_step(g1, g2, x) for x in xs]
    pipe = StackedPipeline(g1, g2, ["cpu", "cpu"], depth=2)
    outs = list(pipe.stream(iter(xs)))
    assert len(outs) == 5
    for (m, y), (m_ref, y_ref) in zip(outs, refs):
        assert torch.equal(m, m_ref) and torch.equal(y, y_ref)


@torch.no_grad()
def test_pipeline_ragged_batch_on_split_stages():
    """Four devices: two per stage. An even batch splits over a stage's
    devices; a batch of 3 runs whole on each stage's first device."""
    g1, g2 = _generators()
    pipe = StackedPipeline(g1, g2, ["cpu"] * 4)
    assert pipe._slices(4) == [slice(0, 2), slice(2, 4)]
    for n in (3, 4):
        x = _images(n, 7)
        m_ref, y_ref = infer_step(g1, g2, x)
        m, y = pipe(x)
        torch.testing.assert_close(m, m_ref, rtol=0, atol=2e-6)
        torch.testing.assert_close(y, y_ref, rtol=0, atol=2e-6)


def test_overlap_yields_all_in_order_with_dispatch_ahead():
    calls = []

    def fn(x):
        calls.append(x)
        return x * 10

    seen = []
    for out in overlap(fn, range(5), depth=2):
        seen.append(out)
        # when result i is yielded, batch i+1 was already dispatched
        if len(seen) < 5:
            assert len(calls) >= len(seen) + 1
    assert seen == [0, 10, 20, 30, 40]


def test_overlap_short_input_drains():
    assert list(overlap(lambda x: x, [7], depth=4)) == [7]
    assert list(overlap(lambda x: x, [], depth=2)) == []
