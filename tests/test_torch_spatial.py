"""The port's spatial row sharding (``parallel/spatial.py``) on the CPU.

Gloo CPU ranks run as subprocesses of ``tests/torch_shard_ranks.py``
(torch and the port only), one torch thread each; every rank builds the
same state from numpy variables and takes its block of each batch
(``shard_images``: data rows, then its spatial coordinate's image rows).
One spawn per mesh, shared by the module's tests.

Held against the JAX package on one device, at the tolerances of its
``tests/test_parallel.py`` spatial tests:
- ``infer_step`` of split-skip MNets (ngf 8, 256x320, nearest decoder)
  on 1x2 and 2x2 (data x spatial) meshes within 2e-5;
- ngf 4 at 32x32 over 4 spatial ranks, where each generator's level of
  4 rows (1 a rank) cannot take its stride-2 conv and is gathered: one
  gather a generator, counted, within 2e-5;
- ``eval_step``'s metrics with the VGG visual loss (whose pools gather
  at 32x32 over 4 ranks) and the PatchGAN Ds, rtol 1e-4, atol 1e-5;
- the other generator and discriminator keys' ``eval_step`` at 32x32
  over 4 spatial ranks against one rank (predictions 2e-5; metrics
  rtol 1e-4, atol 1e-5);
- the halo exchange and the row gather in both collective forms (the
  NCCL form's ``all_gather`` and gloo-on-CUDA's zero-filled
  ``all_reduce``), and a slab that requires grad refused;
- ``Trainer``'s fallback when the spatial ranks do not divide the image
  height: a warning and data-only rows, as JAX's ``_place``.
"""
import logging
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.engine.config import TrainConfig as JConfig
from shadow_removal_istd_tpu.engine.state import build_models as j_build
from shadow_removal_istd_tpu.engine.steps import (
    make_eval_step,
    make_infer_step,
)
from shadow_removal_istd_tpu.models.vgg import VGG19Features as JVGG
from shadow_removal_istd_tpu.parallel import mesh as jmesh
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer
from shadow_removal_istd_tpu_torch.parallel.mesh import (
    Mesh,
    image_sharding,
    make_mesh,
    train_batch_sharding,
)

import torch_shard_ranks as ranks
from test_torch_train import _jax_state, _variables
from test_torch_train_models import random_variables

INFER_KW = dict(ngf=8, ndf=8, nn_upconv=True, use_visual_loss=False,
                droprate=0.0)
DEEP_KW = dict(ngf=4, ndf=4, nn_upconv=True, use_visual_loss=False,
               droprate=0.0)
EVAL_KW = dict(ngf=4, ndf=4, nn_upconv=True, droprate=0.0, batch_size=4)
MESHES = {"1x2": (1, 2, 1), "2x2": (2, 2, 1), "1x4": (1, 4, 1)}
# the other registry keys' eval steps (G and D) on row slabs, held
# against one rank of the port
OTHER = {"unet-began": ("unet", "began"), "stcgan": ("stcgan", "stcgan"),
         "denseunet-dummy": ("denseunet", "dummy")}


def _flat(prefix: str, tree) -> dict:
    return {f"{prefix}/{k}": v for k, v in ranks.flat(tree).items()}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def spatial_runs(tmp_path_factory):
    """Each mesh's rank outputs and the JAX single-device references."""
    rng = np.random.default_rng(5)
    inputs, want = {}, {}
    for name, kw in (("infer", INFER_KW), ("deep", DEEP_KW),
                     ("eval", EVAL_KW)):
        v = _variables(j_build(JConfig(**kw)), seed=20)
        inputs.update(_flat(f"{name}.vars", v))
        want[f"{name}.vars"] = v
    for name, (g, d) in OTHER.items():
        kw = {**DEEP_KW, "net_g": g, "net_d": d, "batch_size": 4}
        inputs.update(_flat(f"{name}.vars", _variables(
            j_build(JConfig(**kw)), seed=21)))
    vgg = random_variables(JVGG(), 3, seed=99, size=64)
    inputs.update(_flat("eval.vgg", vgg))
    inputs["x256"] = rng.uniform(-1, 1, (2, 256, 320, 3)).astype(np.float32)
    inputs["x32"] = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    for size in (64, 32):
        for i, c in enumerate((3, 1, 3)):
            inputs[f"b{size}_{i}"] = rng.uniform(
                -1, 1, (4, size, size, c)).astype(np.float32)
    inputs["halo_x"] = rng.standard_normal((2, 3, 8, 5)).astype(np.float32)

    infer = {"case": "infer", "vars": "infer", "cfg": INFER_KW,
             "x": "x256", "split_skip": True}
    cases = {
        "1x2": {"infer": infer,
                "eval": {"case": "eval", "vars": "eval", "cfg": EVAL_KW,
                         "batch": "b64"},
                "halo_native": {"case": "halo", "form": "native"},
                "halo_reduce": {"case": "halo", "form": "reduce"}},
        "2x2": {"infer": infer,
                "eval": {"case": "eval", "vars": "eval", "cfg": EVAL_KW,
                         "batch": "b64"}},
        "1x4": {"infer": {"case": "infer", "vars": "deep", "cfg": DEEP_KW,
                          "x": "x32"},
                "eval": {"case": "eval", "vars": "eval", "cfg": EVAL_KW,
                         "batch": "b32"},
                **{name: {"case": "eval", "vars": name, "batch": "b32",
                          "cfg": {**DEEP_KW, "net_g": g, "net_d": d,
                                  "batch_size": 4}}
                   for name, (g, d) in OTHER.items()}},
    }
    one = ranks.run_cases(make_mesh("cpu"), inputs, {"cases": {
        name: cases["1x4"][name] for name in OTHER}})
    base = tmp_path_factory.mktemp("spatial")
    pool = ThreadPoolExecutor(len(MESHES))
    running = {m: pool.submit(ranks.spawn, base / m, MESHES[m], inputs,
                              cases[m]) for m in MESHES}
    # the ranks run while JAX computes the references
    with jax.default_matmul_precision("highest"):
        for name, kw, x in (("infer", INFER_KW, "x256"),
                            ("deep", DEEP_KW, "x32")):
            v = want[f"{name}.vars"]
            infer = make_infer_step(j_build(JConfig(**kw)))
            m, y = infer({k: v[k]["params"] for k in ("g1", "g2")},
                         {k: v[k]["batch_stats"] for k in ("g1", "g2")},
                         jnp.asarray(inputs[x]))
            want[f"{name}/m"], want[f"{name}/y"] = (
                np.asarray(m).transpose(0, 3, 1, 2),
                np.asarray(y).transpose(0, 3, 1, 2))
        jcfg = JConfig(**EVAL_KW)
        step = jax.jit(make_eval_step(j_build(jcfg), jcfg, vgg))
        state = _jax_state(jcfg, want["eval.vars"])
        for size in (64, 32):
            batch = tuple(jnp.asarray(inputs[f"b{size}_{i}"])
                          for i in range(3))
            want[f"eval{size}"] = {k: float(v)
                                   for k, v in step(state, batch).items()}

    outs = {m: f.result() for m, f in running.items()}
    pool.shutdown()
    want["one"] = one
    return inputs, outs, want


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_split_skip_infer_matches_jax(spatial_runs, mesh):
    _, outs, want = spatial_runs
    for k in ("m", "y"):
        got = ranks.assemble(outs[mesh], f"infer/{k}")
        np.testing.assert_allclose(got, want[f"infer/{k}"], atol=2e-5,
                                   rtol=0, err_msg=k)
    # 256 rows over 2 ranks split down to the deepest level: no gather
    assert [int(o["infer/gathers"]) for o in outs[mesh]] == [0] * len(
        outs[mesh])


def test_deep_levels_gather_and_match_jax(spatial_runs):
    _, outs, want = spatial_runs
    for k in ("m", "y"):
        got = ranks.assemble(outs["1x4"], f"infer/{k}")
        np.testing.assert_allclose(got, want[f"deep/{k}"], atol=2e-5,
                                   rtol=0, err_msg=k)
    # 32 rows over 4 ranks: the 4-row level (1 a rank) gathers once in
    # each generator, G1 and G2
    assert [int(o["infer/gathers"]) for o in outs["1x4"]] == [2] * 4


@pytest.mark.parametrize("mesh,size", [("1x2", 64), ("2x2", 64),
                                       ("1x4", 32)])
def test_eval_metrics_match_jax(spatial_runs, mesh, size):
    _, outs, want = spatial_runs
    ref = want[f"eval{size}"]
    assert ref["vis1"] > 0 and ref["vis2"] > 0
    for o in outs[mesh]:
        for k, w in ref.items():
            np.testing.assert_allclose(float(o[f"eval/metrics/{k}"]), w,
                                       rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", sorted(OTHER))
def test_other_keys_eval_on_slabs_match_one_rank(spatial_runs, name):
    """UNet + BEGAN (max pools, the bottleneck's nearest upsampling
    joined to slabs), pix2pix + NLayer (odd levels padded whole, the
    stride-1 4x4 convs gathered) and DenseUNet + dummy (average pools,
    2x2 transposed convs) at 32x32 over 4 spatial ranks: every metric
    and both predictions as one rank computes them."""
    _, outs, want = spatial_runs
    one = want["one"]
    for k in ("m", "y"):
        np.testing.assert_allclose(ranks.assemble(outs["1x4"],
                                                  f"{name}/{k}"),
                                   one[f"{name}/{k}"], atol=2e-5, rtol=0)
    for o in outs["1x4"]:
        for k in (k for k in one if k.startswith(f"{name}/metrics/")):
            np.testing.assert_allclose(float(o[k]), float(one[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("form", ["native", "reduce"])
def test_halo_exchange_and_gather(spatial_runs, form):
    inputs, outs, _ = spatial_runs
    x = inputs["halo_x"]                    # 8 rows, 4 a rank
    for r, o in enumerate(outs["1x2"]):
        lo, hi = max(0, 4 * r - 2), min(8, 4 * r + 4 + 1)
        np.testing.assert_array_equal(o[f"halo_{form}/halo"],
                                      x[:, :, lo:hi])
        assert (int(o[f"halo_{form}/above"]),
                int(o[f"halo_{form}/below"])) == ((0, 1) if r == 0
                                                  else (2, 0))
        np.testing.assert_array_equal(o[f"halo_{form}/whole"], x)
        assert bool(o[f"halo_{form}/refused"])


def test_mesh_axes_and_batch_axes():
    """Ranks sit row-major on (data, spatial, model), model innermost, as
    in JAX's ``make_mesh_3d``; forward batches split over data x spatial,
    training batches over data, as JAX's two shardings."""
    cpu = torch.device("cpu")
    m = Mesh(8, 5, cpu, (cpu,), shape=(2, 2, 2),
             axis_names=("data", "spatial", "model"))
    assert (m.coord("data"), m.coord("spatial"), m.coord("model")) == (
        1, 0, 1)
    assert m.ranks_of("model") == [4, 5]
    assert m.ranks_of("spatial") == [5, 7]
    assert m.ranks_of("data", "spatial") == [1, 3, 5, 7]
    assert m.rows(8) == slice(4, 8)
    jm = jmesh.make_mesh_3d(2, 2, 2)
    assert image_sharding(m) == tuple(jmesh.image_sharding(jm).spec)
    assert train_batch_sharding(m) == tuple(
        jmesh.train_batch_sharding(jm).spec)
    m2 = Mesh(8, 0, cpu, (cpu,), shape=(2, 4, 1),
              axis_names=("data", "spatial"))
    assert image_sharding(m2) == tuple(jmesh.image_sharding(
        jmesh.make_mesh_2d(2, 4)).spec)


def test_indivisible_height_falls_back_to_data_only(tmp_path, caplog):
    """Three spatial ranks do not divide 32 rows: the batch keeps its
    rows whole (data-only) with one warning; 33 rows split (JAX
    ``TestPlaceDivisibilityGuard``)."""
    cpu = torch.device("cpu")
    mesh = Mesh(6, 4, cpu, (cpu,), shape=(2, 3, 1),
                axis_names=("data", "spatial"))
    cfg = TrainConfig(ngf=4, ndf=4, image_size=32, batch_size=2,
                      use_visual_loss=False, droprate=0.0)
    tr = Trainer(cfg, RunConfig(logs_dir=str(tmp_path)), device="cpu")
    tr._dp = mesh
    batch = tuple(torch.zeros(2, c, 32, 32) for c in (3, 1, 3))
    with caplog.at_level(logging.WARNING):
        placed, rows = tr._place_rows(batch, mesh)
        tr._place_rows(batch, mesh)
    assert rows is None and placed[0].shape[2] == 32
    assert sum("falling back to data-only" in r.message
               for r in caplog.records) == 1
    batch33 = tuple(torch.zeros(2, c, 33, 32) for c in (3, 1, 3))
    placed, rows = tr._place_rows(batch33, mesh)
    assert rows == slice(11, 22) and placed[0].shape[2] == 11
