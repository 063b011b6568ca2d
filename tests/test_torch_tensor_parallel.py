"""The port's tensor parallelism (``parallel/tensor.py``) and the composed
(data x spatial x model) mesh on the CPU.

Gloo CPU ranks run as subprocesses of ``tests/torch_shard_ranks.py``
(torch and the port only), one torch thread each, one spawn per mesh
shared by the module's tests. ``shard_state`` leaves each rank's modules
holding their out-channel shard by the JAX ``model_sharding`` rule.

Held, at the tolerances of the JAX package's ``tests/test_parallel.py``:
- the rule against JAX's spec on its own test shapes and on every leaf
  of a state, the torch dim mapped (dim 0 of OIHW is HWIO's trailing);
- 2 train steps on 1x2 and 2x2 (data x model) meshes against the JAX
  single-device step: MNet + PatchGAN with ``D_type`` normal and
  ``rel_avg`` (64x64, ngf 4, Adam eps 1e-3, as
  ``tests/test_torch_parallel.py``) and pix2pix + NLayer (32x32, ngf 8);
  metrics relative 2e-4, parameters and BatchNorm statistics 1e-4;
- a planted "no all-reduce before a split conv" and a planted "gather
  backward sums" each fail that tolerance;
- per-rank parameter, statistics and Adam bytes at model 2 (ngf 8) at
  most 0.6x one rank's;
- the other generator and discriminator keys one step against one rank;
- the TP forward (K1 on the Co shards) and the 1x2x2 forward against
  JAX's ``infer_step`` within 2e-5, and ``Trainer.run_valid_epoch`` on
  1x2x2 against one rank (rtol 1e-4, atol 1e-5);
- the weight files of a TP run load into the JAX package
  (``engine/checkpoint.load_model_weights``) and equal a one-rank run's
  leaves within 1e-4.
"""
import logging
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.engine.checkpoint import (
    load_model_weights as j_load_weights,
)
from shadow_removal_istd_tpu.engine.config import TrainConfig as JConfig
from shadow_removal_istd_tpu.engine.state import build_models as j_build
from shadow_removal_istd_tpu.engine.steps import (
    _unjitted_train_step,
    make_infer_step,
)
from shadow_removal_istd_tpu.parallel import mesh as jmesh
from shadow_removal_istd_tpu_torch.data.synthetic import synthetic_triplets
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.state import build_models
from shadow_removal_istd_tpu_torch.parallel.mesh import (
    Mesh,
    _warn_if_tp_ineffective,
    make_mesh,
    model_sharding,
)
from shadow_removal_istd_tpu_torch.tools.convert import targets

import torch_shard_ranks as ranks
from test_torch_train import _jax_state, _variables

STEP_KW = dict(ngf=4, ndf=4, droprate=0.0, batch_size=4, image_size=64,
               decay=0.1, steps_per_epoch=1, adam_eps=1e-3,
               use_visual_loss=False)
CFGS = {"normal": STEP_KW,
        "rel_avg": {**STEP_KW, "d_type": "rel_avg"},
        "stcgan": {**STEP_KW, "net_g": "stcgan", "net_d": "stcgan",
                   "ngf": 8, "ndf": 8, "image_size": 32}}
OTHER = {"unet-patchgan": ("unet", "patchgan"),
         "denseunet-dummy": ("denseunet", "dummy"),
         "mnet-began": ("mnet", "began")}
FAULTS = ("no_reduce", "gather_sums")
FWD_KW = dict(ngf=8, ndf=8, nn_upconv=True, use_visual_loss=False,
              droprate=0.0)
TRAINER_CFG = dict(ngf=8, ndf=8, image_size=32, batch_size=4,
                   use_visual_loss=False, droprate=0.0, adam_eps=1e-3,
                   aug_method="shear")
MESHES = {"1x2": (1, 1, 2), "2x2": (2, 1, 2), "3d": (1, 2, 2)}


def _flat(prefix: str, tree) -> dict:
    return {f"{prefix}/{k}": v for k, v in ranks.flat(tree).items()}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _train(name: str, **kw) -> dict:
    size = CFGS.get(name, STEP_KW)["image_size"]
    return {"case": "train", "vars": name, "batch": f"b{size}_",
            "steps": 2, "cfg": CFGS.get(name, STEP_KW), **kw}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Each mesh's rank outputs, one rank's port results and the JAX
    single-device references."""
    rng = np.random.default_rng(7)
    inputs, want, variables = {}, {}, {}
    for size in (64, 32):
        for s in range(2):
            for i, c in enumerate((3, 1, 3)):
                inputs[f"b{size}_{s}_{i}"] = rng.uniform(
                    -1, 1, (4, size, size, c)).astype(np.float32)
    for name, kw in CFGS.items():
        variables[name] = _variables(j_build(JConfig(**kw)), seed=30)
        inputs.update(_flat(f"{name}.vars", variables[name]))
    for name, (g, d) in OTHER.items():
        inputs.update(_flat(f"{name}.vars", _variables(
            j_build(JConfig(**{**STEP_KW, "net_g": g, "net_d": d})),
            seed=31)))
    bytes_kw = {**STEP_KW, "ngf": 8, "ndf": 8}
    inputs.update(_flat("bytes.vars", _variables(
        j_build(JConfig(**bytes_kw)), seed=32)))
    fwd_vars = _variables(j_build(JConfig(**FWD_KW)), seed=33)
    inputs.update(_flat("fwd.vars", fwd_vars))
    inputs["x64"] = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    inputs["x256"] = rng.uniform(-1, 1, (2, 256, 320, 3)).astype(np.float32)
    data = synthetic_triplets(8, 32, 32)
    for split in ("train", "valid"):
        for k in ("img", "matte", "target"):
            inputs[f"{split}/{k}"] = data[k]

    base = tmp_path_factory.mktemp("tp")
    trainer = {"case": "trainer", "cfg": TRAINER_CFG}
    cases = {
        "1x2": {**{n: _train(n) for n in CFGS},
                **{f: _train("normal", fault=f) for f in FAULTS},
                **{n: _train(n, cfg={**STEP_KW, "net_g": g, "net_d": d},
                             steps=1) for n, (g, d) in OTHER.items()},
                "bytes": _train("bytes", cfg=bytes_kw, steps=1),
                "fwd": {"case": "infer", "vars": "fwd", "cfg": FWD_KW,
                        "x": "x64"},
                "reduce": _train("normal", form="reduce"),
                "fwd_reduce": {"case": "infer", "vars": "fwd",
                               "cfg": FWD_KW, "x": "x64", "form": "reduce"},
                "files": {**trainer, "epochs": 1,
                          "dir": str(base / "files_tp")}},
        "2x2": {n: _train(n) for n in CFGS},
        "3d": {"fwd": {"case": "infer", "vars": "fwd", "cfg": FWD_KW,
                       "x": "x256", "split_skip": True},
               "valid": {**trainer, "dir": str(base / "valid_3d")}},
    }
    pool = ThreadPoolExecutor(len(MESHES))
    running = {m: pool.submit(ranks.spawn, base / m, MESHES[m], inputs,
                              cases[m]) for m in MESHES}
    # the ranks run while JAX computes the references
    with jax.default_matmul_precision("highest"):
        for name in CFGS:
            jcfg = JConfig(**CFGS[name])
            step = jax.jit(_unjitted_train_step(j_build(jcfg), jcfg, None))
            state = _jax_state(jcfg, variables[name])
            size = CFGS[name]["image_size"]
            for s in range(2):
                b = tuple(jnp.asarray(inputs[f"b{size}_{s}_{i}"])
                          for i in range(3))
                state, m = step(state, b, jax.random.key(0))
                want.update({f"{name}/metrics{s}/{k}": float(v)
                             for k, v in m.items()})
            tree = jax.tree.map(np.asarray, {
                "g_params": state.g_params, "d_params": state.d_params,
                "batch_stats": state.batch_stats})
            want.update(_flat(f"{name}/state", tree))
        infer = make_infer_step(j_build(JConfig(**FWD_KW)))
        for x in ("x64", "x256"):
            m, y = infer({k: fwd_vars[k]["params"] for k in ("g1", "g2")},
                         {k: fwd_vars[k]["batch_stats"]
                          for k in ("g1", "g2")}, jnp.asarray(inputs[x]))
            want[f"fwd/{x}/m"] = np.asarray(m).transpose(0, 3, 1, 2)
            want[f"fwd/{x}/y"] = np.asarray(y).transpose(0, 3, 1, 2)

    outs = {m: f.result() for m, f in running.items()}
    pool.shutdown()
    one_cases = {**{n: cases["1x2"][n] for n in (*OTHER, "bytes")},
                 "files": {**trainer, "epochs": 1,
                           "dir": str(base / "files_one")},
                 "valid": {**trainer, "dir": str(base / "valid_one")}}
    one = ranks.run_cases(make_mesh("cpu"), inputs, {"cases": one_cases})
    return inputs, outs, one, want, variables


def _state_diff(got: dict, want: dict, name: str) -> float:
    """The largest difference over the parameters and BatchNorm
    statistics of ``name``'s final state."""
    keys = [k for k in want if k.startswith(f"{name}/state/")]
    assert keys
    return max(float(np.abs(np.asarray(got[k]) - want[k]).max())
               for k in keys)


def _metrics_off(got: dict, want: dict, name: str) -> list:
    out = []
    for k in (k for k in want if k.startswith(f"{name}/metrics")):
        if abs(float(got[k]) - want[k]) > 2e-4 * max(1.0, abs(want[k])):
            out.append((k, float(got[k]), want[k]))
    return out


@pytest.mark.parametrize("mesh,name", [(m, n) for m in ("1x2", "2x2")
                                       for n in CFGS])
def test_tp_step_matches_jax(tp_runs, mesh, name):
    _, outs, _, want, _ = tp_runs
    for o in outs[mesh]:
        assert _metrics_off(o, want, name) == []
        assert _state_diff(o, want, name) <= 1e-4


def test_reduce_form_matches_native(tp_runs):
    """The gathers as gloo runs them for CUDA tensors (each rank's slot
    of a zero-filled buffer, all-reduced) give the native all-gather's
    step and forward, bit for bit."""
    _, outs, _, _, _ = tp_runs
    for o in outs["1x2"]:
        for a, b in (("reduce", "normal"), ("fwd_reduce", "fwd")):
            keys = [k for k in o if k.startswith(f"{b}/")
                    and not k.endswith("/bytes")]
            assert keys
            for k in keys:
                np.testing.assert_array_equal(
                    o[k.replace(f"{b}/", f"{a}/", 1)], o[k], err_msg=k)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_backward_fault_fails(tp_runs, fault):
    _, outs, _, want, _ = tp_runs
    got = {k.replace(f"{fault}/", "normal/", 1): v
           for k, v in outs["1x2"][0].items() if k.startswith(f"{fault}/")}
    assert _metrics_off(got, want, "normal") != []
    assert _state_diff(got, want, "normal") > 1e-4


def test_model_sharding_rule_matches_jax():
    jm = jmesh.make_mesh_tp(2, 4)
    cpu = torch.device("cpu")
    tm = Mesh(8, 0, cpu, (cpu,), shape=(2, 1, 4),
              axis_names=("data", "model"))
    # JAX's own cases, its HWIO kernels as the port's OIHW
    for leaf, torch_shape in (
            (np.zeros((4, 4, 8, 16), np.float32), (16, 8, 4, 4)),
            (np.zeros((16,), np.float32), (16,)),
            (np.zeros((4, 4, 8, 3), np.float32), (3, 8, 4, 4)),
            (np.zeros((6,), np.float32), (6,)),
            (np.float32(0.7), ())):
        spec = tuple(jmesh.model_sharding(jm, leaf).spec)
        dim = model_sharding(tm, torch.zeros(torch_shape))
        assert (dim == 0) == ("model" in spec), (leaf.shape, spec)
    # every leaf of the nets (ngf 8 at model 2): the same leaves split
    jm2 = jmesh.make_mesh_tp(1, 2)
    tm2 = Mesh(2, 0, cpu, (cpu,), shape=(1, 1, 2),
               axis_names=("data", "model"))
    jcfg = JConfig(**{**STEP_KW, "ngf": 8, "ndf": 8})
    v = _variables(j_build(jcfg), seed=0)
    models = build_models(TrainConfig(**{**STEP_KW, "ngf": 8, "ndf": 8}))
    n = 0
    for k in ("g1", "g2", "d1", "d2"):
        for path, t in targets(getattr(models, k)).items():
            leaf = v[k]
            for p in path:
                leaf = leaf[p]
            spec = tuple(jmesh.model_sharding(jm2, leaf).spec)
            assert (model_sharding(tm2, t) == 0) == ("model" in spec), path
            n += 1
    assert n > 50


def test_per_rank_state_bytes_drop(tp_runs):
    _, outs, one, _, _ = tp_runs
    single = int(one["bytes/bytes"])
    for o in outs["1x2"]:
        assert int(o["bytes/bytes"]) <= 0.6 * single, (
            int(o["bytes/bytes"]), single)


@pytest.mark.parametrize("name", sorted(OTHER))
def test_other_keys_step_matches_one_rank(tp_runs, name):
    """One step of each remaining key under TP against one rank: metrics
    relative 2e-4; parameters and statistics 1e-4 (Adam moments follow
    the gradients' f32 summation order, which the model all-reduce
    changes)."""
    _, outs, one, _, _ = tp_runs
    for o in outs["1x2"]:
        for k in (k for k in one if k.startswith(f"{name}/metrics")):
            w = float(one[k])
            assert abs(float(o[k]) - w) <= 2e-4 * max(1.0, abs(w)), k
        keys = [k for k in one if k.startswith(f"{name}/state/")
                and "/opt_" not in k]
        assert keys
        for k in keys:
            np.testing.assert_allclose(o[k], one[k], atol=1e-4, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("mesh,x", [("1x2", "x64"), ("3d", "x256")])
def test_forward_matches_jax(tp_runs, mesh, x):
    """The TP forward runs K1 on each rank's Co shard of the phase
    kernel; the composed mesh's gathers every weight (ZeRO-3) and runs
    the split-skip MNets on row slabs."""
    _, outs, _, want, _ = tp_runs
    for k in ("m", "y"):
        got = ranks.assemble(outs[mesh], f"fwd/{k}")
        np.testing.assert_allclose(got, want[f"fwd/{x}/{k}"], atol=2e-5,
                                   rtol=0, err_msg=k)


def test_valid_epoch_on_composed_mesh_matches_one_rank(tp_runs):
    _, outs, one, _, _ = tp_runs
    keys = [k for k in one if k.startswith("valid/valid")]
    assert keys
    for o in outs["3d"]:
        for k in keys:
            np.testing.assert_allclose(float(o[k]), float(one[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_tp_weight_files_load_into_jax(tp_runs):
    """Rank 0 of a TP run writes the single-device flax files; the JAX
    package loads them and they equal a one-rank run's within 1e-4."""
    _, outs, one, _, _ = tp_runs
    from pathlib import Path

    jcfg = JConfig(**TRAINER_CFG)
    target = _jax_state(jcfg, _variables(j_build(jcfg), seed=0))
    tp_dir = Path(str(outs["1x2"][0]["files/weights"]))
    one_dir = Path(str(one["files/weights"]))
    assert not list((tp_dir.parent.parent / "rank1").rglob("*.msgpack"))
    n = 0
    for net in ("G1", "G2", "D1", "D2"):
        name = next(p.name for p in tp_dir.glob(f"{net}_*_latest.msgpack"))
        got = j_load_weights(target, net, str(tp_dir / name))
        ref = j_load_weights(target, net, str(one_dir / name))
        for a, b in zip(jax.tree.leaves((got.g_params, got.d_params,
                                         got.batch_stats)),
                        jax.tree.leaves((ref.g_params, ref.d_params,
                                         ref.batch_stats))):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-4, rtol=0)
            n += 1
    assert n > 50
    for o in outs["1x2"]:
        for k in (k for k in one if k.startswith("files/history")):
            np.testing.assert_allclose(float(o[k]), float(one[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_warns_when_tp_shards_little(caplog):
    """A model size that divides no width leaves the state replicated:
    JAX's warning (below half of the state's bytes split)."""
    from shadow_removal_istd_tpu_torch.engine.state import (
        TrainState,
        make_optimizers,
    )
    from shadow_removal_istd_tpu_torch.losses import make_adversarial_loss

    cfg = TrainConfig(**STEP_KW)
    models = build_models(cfg)
    opt_g, opt_d = make_optimizers(cfg, models)
    state = TrainState(cfg=cfg, models=models, opt_g=opt_g, opt_d=opt_d,
                       adv=make_adversarial_loss(cfg.d_loss_fn, cfg.d_type,
                                                 cfg.loss_mode))
    cpu = torch.device("cpu")
    mesh = Mesh(3, 0, cpu, (cpu,), shape=(1, 1, 3),
                axis_names=("data", "model"))
    with caplog.at_level(logging.WARNING):
        _warn_if_tp_ineffective(mesh, state)
    assert any("shards only 0% of state bytes" in r.message
               for r in caplog.records)
