"""The port's reference checkpoint interop (``tools/torch_bridge.py``,
``tools/export_torch.py``) against the JAX package's tools of the same
names.

The reference's model classes come from the stand-in
(``tests/reference_standin.py``): MNet and PatchGAN from plain torch
layers, registered out of execution order. Held, at ngf/ndf 8 with
numpy inputs from a seed: the port's layer order equals the JAX
package's ``flax_layer_order`` for every network of the zoo; the four
``.pt`` files the port exports equal the JAX tool's, key for key, dtype
for dtype and tensor for tensor (``torch.equal``), as do the files of
both CLIs on one checkpoint; a ``.pt`` file loaded by the port equals
the JAX package's variables exactly, and the port's stacked f32 forward
(K1's plain version on the CPU) lies within 1e-5 of JAX's; the stand-in
reference's own forward equals the port's after the load; mismatched
kinds or shapes raise and leave the destination as it was; a wrapped
``{"state_dict": ...}`` file loads; a frozen eval MNet serves the new
weights after a load and a re-freeze. The check against the real
reference's classes skips unless ``SRIT_REFERENCE_PATH`` names the
root of a checkout of it (the directory holding ``src/``).

Both packages' ``_import_reference`` put the root on ``sys.path`` and
``src`` and a ``torchvision`` stand-in into ``sys.modules``: the
``reference_root`` fixture undoes both after each test.
"""
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.engine import TrainConfig as JConfig
from shadow_removal_istd_tpu.engine import build_models as j_build
from shadow_removal_istd_tpu.engine.steps import make_infer_step
from shadow_removal_istd_tpu.models import get_discriminator as j_disc
from shadow_removal_istd_tpu.models import get_generator as j_gen
from shadow_removal_istd_tpu.tools import export_torch as j_export
from shadow_removal_istd_tpu.tools import torch_bridge as j_bridge
from shadow_removal_istd_tpu_torch.engine import checkpoint as ck
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.state import (
    build_models,
    init_state,
)
from shadow_removal_istd_tpu_torch.engine.steps import infer_step
from shadow_removal_istd_tpu_torch.models import (
    get_discriminator,
    get_generator,
)
from shadow_removal_istd_tpu_torch.models import layers as L
from shadow_removal_istd_tpu_torch.tools import export_torch
from shadow_removal_istd_tpu_torch.tools.convert import (
    flatten_tree,
    flax_tree_to_torch,
    torch_to_flax_tree,
)
from shadow_removal_istd_tpu_torch.tools.torch_bridge import (
    load_torch_checkpoint,
    port_layer_order,
    port_to_reference,
    reference_to_port,
)

from reference_standin import write_reference
from test_torch_train_models import random_variables

NETS = ("g1", "g2", "d1", "d2")
IN_CH = {"g1": 3, "g2": 4, "d1": 4, "d2": 7}
FILES = ["D1_PatchGAN_best.pt", "D2_PatchGAN_best.pt", "G1_MNet_best.pt",
         "G2_MNet_best.pt"]
SIZE = 64
REAL_REFERENCE = os.environ.get("SRIT_REFERENCE_PATH", "")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs several workers on few cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _imported_by_reference(name: str) -> bool:
    return any(name == root or name.startswith(root + ".")
               for root in ("src", "torchvision"))


@pytest.fixture
def reference_root(tmp_path, monkeypatch):
    """The stand-in reference's root; ``sys.path`` and the ``src`` and
    ``torchvision`` modules are restored after the test."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    for name in [n for n in sys.modules if _imported_by_reference(n)]:
        monkeypatch.delitem(sys.modules, name)
    yield str(write_reference(tmp_path / "reference"))
    # monkeypatch (set up before this fixture) restores the originals
    # after this removes what the test imported
    for name in [n for n in sys.modules if _imported_by_reference(n)]:
        del sys.modules[name]


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


# ----------------------------------------------------------- layer order

# name -> (generator?, registry key, kwargs, in channels, trace size)
ZOO = {
    "mnet_nearest": (True, "mnet", dict(out_channels=1, ngf=8,
                                        no_conv_t=True), 3, 64),
    "mnet_convt": (True, "mnet", dict(out_channels=3, ngf=8,
                                      no_conv_t=False), 4, 64),
    "unet_nearest": (True, "unet", dict(out_channels=3, ngf=8,
                                        no_conv_t=True), 4, 32),
    "unet_convt": (True, "unet", dict(out_channels=1, ngf=8,
                                      no_conv_t=False), 3, 32),
    "unet_selu": (True, "unet", dict(out_channels=3, ngf=8, use_selu=True),
                  4, 32),
    "denseunet_convt": (True, "denseunet", dict(out_channels=3, ngf=8),
                        4, 64),
    "denseunet_nearest": (True, "denseunet", dict(out_channels=1, ngf=8,
                                                  no_conv_t=True), 3, 64),
    "pix2pix": (True, "stcgan", dict(out_channels=3, ngf=8), 4, 256),
    "pix2pix_5": (True, "stcgan", dict(out_channels=1, ngf=8, num_downs=5),
                  3, 64),
    "patchgan": (False, "patchgan", dict(ndf=8), 7, 64),
    "patchgan_selu": (False, "patchgan", dict(ndf=8, use_selu=True), 4, 64),
    "nlayer": (False, "stcgan", dict(ndf=8), 7, 64),
    "began": (False, "began", dict(out_channels=1, ndf=8), 4, 32),
    "began_selu": (False, "began", dict(out_channels=3, ndf=8,
                                        use_selu=True), 7, 32),
    "dummy": (False, "dummy", dict(out_channels=3), 7, 16),
}


@pytest.mark.parametrize("name", list(ZOO))
def test_layer_order_matches_flax(name):
    gen, key, kw, in_ch, size = ZOO[name]
    jfn, pfn = (j_gen, get_generator) if gen else (j_disc, get_discriminator)
    want = j_bridge.flax_layer_order(jfn(key, in_channels=in_ch, **kw),
                                     np.zeros((1, size, size, in_ch),
                                              np.float32))
    got = port_layer_order(pfn(key, in_channels=in_ch, **kw))
    assert got == [(tuple(p), k) for p, k in want]


# ---------------------------------------------------------------- export

def _seeded_pair(nn_upconv: bool, seed: int = 0):
    """The same seeded variables as a JAX state (what its export reads)
    and in the port's models; the two configurations."""
    kw = dict(ngf=8, ndf=8, nn_upconv=nn_upconv, use_visual_loss=False,
              droprate=0.0)
    jcfg, cfg = JConfig(**kw), TrainConfig(**kw)
    jmodels, models = j_build(jcfg), build_models(cfg)
    v = {k: random_variables(getattr(jmodels, k), IN_CH[k], seed=seed + i,
                             size=SIZE) for i, k in enumerate(NETS)}
    for k in NETS:
        flax_tree_to_torch(v[k], getattr(models, k))
    jstate = types.SimpleNamespace(
        g_params={k: v[k]["params"] for k in ("g1", "g2")},
        d_params={k: v[k]["params"] for k in ("d1", "d2")},
        batch_stats={k: v[k].get("batch_stats", {}) for k in NETS})
    return jstate, jmodels, jcfg, types.SimpleNamespace(models=models), cfg


def _assert_same_files(dir_a, dir_b, names=FILES):
    assert sorted(os.listdir(dir_a)) == sorted(os.listdir(dir_b)) == names
    for f in names:
        a = torch.load(os.path.join(dir_a, f), weights_only=True)
        b = torch.load(os.path.join(dir_b, f), weights_only=True)
        assert list(a) == list(b), f
        for key in a:
            assert a[key].dtype == b[key].dtype, (f, key)
            assert a[key].device.type == b[key].device.type == "cpu"
            assert torch.equal(a[key], b[key]), (f, key)


@pytest.mark.parametrize("nn_upconv", [True, False],
                         ids=["nearest", "convtranspose"])
def test_export_matches_jax(tmp_path, reference_root, nn_upconv):
    jstate, jmodels, jcfg, state, cfg = _seeded_pair(nn_upconv)
    want = j_export.export_reference_weights(
        jstate, jmodels, jcfg, str(tmp_path / "jax"), reference_root,
        "best")
    got = export_torch.export_reference_weights(
        state, cfg, str(tmp_path / "port"), reference_root, "best")
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    _assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_cli_matches_jax(tmp_path, reference_root):
    """Both CLIs on one port checkpoint write the same four files."""
    state = init_state(TrainConfig(ngf=8, ndf=8, use_visual_loss=False),
                       torch.Generator().manual_seed(3), device="cpu")
    ckpt = str(tmp_path / "checkpoint.msgpack")
    ck.save_checkpoint(state, ckpt, epoch=1)
    argv = ["--load-checkpoint", ckpt, "--reference-path", reference_root,
            "--ngf", "8", "--ndf", "8", "--suffix", "best"]
    j_export.main([*argv, "--out-dir", str(tmp_path / "jax")])
    written = export_torch.main([*argv, "--out-dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    assert sorted(os.path.basename(p) for p in written) == FILES
    _assert_same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
    # the files hold the checkpoint's weights
    rn = export_torch._import_reference(reference_root)
    ref = rn.get_generator("mnet", in_channels=3, out_channels=1, ngf=8,
                           drop_rate=0.0, no_conv_t=False, use_selu=False,
                           activation="tanh")
    g1 = get_generator("mnet", in_channels=3, out_channels=1, ngf=8,
                       no_conv_t=False)
    load_torch_checkpoint(str(tmp_path / "port" / "G1_MNet_best.pt"), ref,
                          g1, _x((1, SIZE, SIZE, 3)))
    _assert_trees_equal(torch_to_flax_tree(g1),
                        torch_to_flax_tree(state.models.g1))


def test_cli_without_card_raises(tmp_path, reference_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_torch.main(["--load-checkpoint", str(tmp_path / "none"),
                           "--out-dir", str(tmp_path / "out"),
                           "--reference-path", reference_root])
    assert not (tmp_path / "out").exists()


# ------------------------------------------------------------------ load

def _ref_mnet(rn, in_ch, out_ch, nn_upconv, ngf=8):
    return rn.get_generator("mnet", in_channels=in_ch, out_channels=out_ch,
                            ngf=ngf, drop_rate=0.0, no_conv_t=nn_upconv,
                            use_selu=False, activation="tanh")


def _seed_reference(model, seed):
    """DCGAN-like conv weights and random BatchNorm affines and running
    statistics, from numpy."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith(("running_var", "weight")) and t.ndim == 1:
                v = rng.uniform(0.5, 1.5, t.shape)
            else:
                v = rng.standard_normal(t.shape) * (
                    0.1 if t.ndim == 1 else 1 / np.sqrt(t[0].numel()))
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    return model


def _assert_trees_equal(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert sorted(fa) == sorted(fb)
    for path in fa:
        np.testing.assert_array_equal(np.asarray(fa[path]),
                                      np.asarray(fb[path]), err_msg=path)


@pytest.mark.parametrize("nn_upconv", [True, False],
                         ids=["nearest", "convtranspose"])
def test_load_matches_jax(tmp_path, reference_root, nn_upconv):
    rn = export_torch._import_reference(reference_root)
    jcfg = JConfig(ngf=8, ndf=8, nn_upconv=nn_upconv, use_visual_loss=False,
                   droprate=0.0)
    jmodels = j_build(jcfg)
    variables, ports = {}, {}
    for k, (in_ch, out_ch) in (("g1", (3, 1)), ("g2", (4, 3))):
        path = str(tmp_path / f"{k}.pt")
        torch.save(_seed_reference(
            _ref_mnet(rn, in_ch, out_ch, nn_upconv), seed=7 + in_ch)
            .state_dict(), path)
        x = _x((1, SIZE, SIZE, in_ch))
        variables[k] = j_bridge.load_torch_checkpoint(
            path, _ref_mnet(rn, in_ch, out_ch, nn_upconv),
            getattr(jmodels, k), x)
        ports[k] = load_torch_checkpoint(
            path, _ref_mnet(rn, in_ch, out_ch, nn_upconv),
            get_generator("mnet", in_channels=in_ch, out_channels=out_ch,
                          ngf=8, no_conv_t=nn_upconv), x)
        _assert_trees_equal(torch_to_flax_tree(ports[k]),
                            jax.tree.map(np.asarray, variables[k]))

    x = _x((2, SIZE, SIZE, 3), seed=5)
    with jax.default_matmul_precision("highest"):
        jm, jy = make_infer_step(jmodels)(
            {k: variables[k]["params"] for k in ("g1", "g2")},
            {k: variables[k]["batch_stats"] for k in ("g1", "g2")},
            jnp.asarray(x))
    with torch.no_grad():
        m, y = infer_step(ports["g1"].eval(), ports["g2"].eval(),
                          torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(m.permute(0, 2, 3, 1).numpy(), np.asarray(jm),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(jy),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("nn_upconv", [True, False],
                         ids=["nearest", "convtranspose"])
def test_standin_forward_matches_port(reference_root, nn_upconv):
    """The stand-in reference's own eval forward equals the port's after
    the load (the transposed conv's flip included), and the weights go
    back to a fresh reference model bit for bit."""
    rn = export_torch._import_reference(reference_root)
    ref = _seed_reference(_ref_mnet(rn, 4, 3, nn_upconv), seed=2).eval()
    port = get_generator("mnet", in_channels=4, out_channels=3, ngf=8,
                         no_conv_t=nn_upconv).eval()
    reference_to_port(ref, port, _x((1, SIZE, SIZE, 4)))
    x = torch.from_numpy(_x((2, SIZE, SIZE, 4), seed=4)).permute(0, 3, 1, 2)
    with torch.no_grad():
        np.testing.assert_allclose(port(x).numpy(), ref(x).numpy(),
                                   atol=1e-5, rtol=0)
    back = port_to_reference(port, _ref_mnet(rn, 4, 3, nn_upconv),
                             _x((1, SIZE, SIZE, 4)))
    for key, t in ref.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(back.state_dict()[key], t), key


# -------------------------------------------------------------- failures

@pytest.mark.parametrize("factory,name", [("get_generator", "unet"),
                                          ("get_discriminator", "began")])
def test_standin_other_names_raise(reference_root, factory, name):
    rn = export_torch._import_reference(reference_root)
    with pytest.raises(ValueError, match="stand-in reference builds"):
        getattr(rn, factory)(name, in_channels=3)


def _mismatch(rn, which):
    """A port MNet and a reference model that do not pair: another
    upsample form (kinds) or another width (shapes)."""
    port = get_generator("mnet", in_channels=3, out_channels=1, ngf=8,
                         no_conv_t=True)
    ref = _ref_mnet(rn, 3, 1, nn_upconv=which != "kinds",
                     ngf=8 if which == "kinds" else 4)
    return port, _seed_reference(ref, seed=1)


@pytest.mark.parametrize("direction", ["to_port", "to_reference"])
@pytest.mark.parametrize("which,match", [("kinds", "layer sequences"),
                                         ("shapes", "shape mismatch")])
def test_mismatch_raises_unchanged(reference_root, which, match, direction):
    rn = export_torch._import_reference(reference_root)
    port, ref = _mismatch(rn, which)
    before_port = torch_to_flax_tree(port)
    before_ref = {k: t.clone() for k, t in ref.state_dict().items()}
    x = _x((1, SIZE, SIZE, 3))
    with pytest.raises(ValueError, match=match):
        if direction == "to_port":
            reference_to_port(ref, port, x)
        else:
            port_to_reference(port, ref, x)
    _assert_trees_equal(torch_to_flax_tree(port), before_port)
    for key, t in ref.state_dict().items():
        assert torch.equal(t, before_ref[key]), key


def test_wrapped_state_dict_loads(tmp_path, reference_root):
    rn = export_torch._import_reference(reference_root)
    sd = _seed_reference(_ref_mnet(rn, 3, 1, True), seed=3).state_dict()
    torch.save(sd, str(tmp_path / "bare.pt"))
    torch.save({"state_dict": sd}, str(tmp_path / "wrapped.pt"))
    trees = []
    for f in ("bare.pt", "wrapped.pt"):
        port = get_generator("mnet", in_channels=3, out_channels=1, ngf=8,
                             no_conv_t=True)
        load_torch_checkpoint(str(tmp_path / f), _ref_mnet(rn, 3, 1, True),
                              port, _x((1, SIZE, SIZE, 3)))
        trees.append(torch_to_flax_tree(port))
    _assert_trees_equal(*trees)


def test_frozen_mnet_serves_loaded_weights(tmp_path, reference_root):
    """A frozen eval MNet drops its decoder kernels on the load; frozen
    again, it serves the loaded weights as a fresh model does."""
    rn = export_torch._import_reference(reference_root)
    path = str(tmp_path / "g1.pt")
    torch.save(_seed_reference(_ref_mnet(rn, 3, 1, True), seed=5)
               .state_dict(), path)
    x = torch.from_numpy(_x((2, SIZE, SIZE, 3), seed=6)).permute(0, 3, 1, 2)

    def frozen_mnet():
        m = get_generator("mnet", in_channels=3, out_channels=1, ngf=8,
                          no_conv_t=True, split_skip=True)
        L.init_weights_(m, torch.Generator().manual_seed(0))
        m.eval().freeze()
        return m

    served = frozen_mnet()
    with torch.no_grad():
        old = served(x)
    load_torch_checkpoint(path, _ref_mnet(rn, 3, 1, True), served,
                          _x((1, SIZE, SIZE, 3)))
    ups = [m for m in served.modules() if isinstance(m, L.Upsample)]
    assert len(ups) == 5 and all(u.frozen is None for u in ups)
    served.freeze()
    fresh = frozen_mnet()
    load_torch_checkpoint(path, _ref_mnet(rn, 3, 1, True), fresh,
                          _x((1, SIZE, SIZE, 3)))
    fresh.freeze()
    with torch.no_grad():
        got, want = served(x), fresh(x)
    assert torch.equal(got, want)
    assert not torch.allclose(got, old)


# ------------------------------------------------------- real reference

def test_checkpoint_to_real_reference_roundtrip(tmp_path, monkeypatch):
    """The CLI against the real reference's classes: a port checkpoint
    to its four ``.pt`` files, and G1 loaded back through the reference
    model equals the checkpoint's weights exactly."""
    if not os.path.isdir(REAL_REFERENCE):
        pytest.skip("the reference is not at hand (SRIT_REFERENCE_PATH)")
    monkeypatch.setattr(sys, "path", list(sys.path))
    for name in [n for n in sys.modules if _imported_by_reference(n)]:
        monkeypatch.delitem(sys.modules, name)
    try:
        state = init_state(TrainConfig(ngf=8, ndf=8, use_visual_loss=False),
                           torch.Generator().manual_seed(42), device="cpu")
        ckpt = str(tmp_path / "checkpoint.msgpack")
        ck.save_checkpoint(state, ckpt, epoch=0)
        out = str(tmp_path / "torch_w")
        export_torch.main(["--load-checkpoint", ckpt, "--out-dir", out,
                           "--reference-path", REAL_REFERENCE, "--ngf", "8",
                           "--ndf", "8", "--suffix", "best",
                           "--device", "cpu"])
        assert sorted(os.listdir(out)) == FILES
        rn = export_torch._import_reference(REAL_REFERENCE)
        g1 = get_generator("mnet", in_channels=3, out_channels=1, ngf=8,
                           no_conv_t=False)
        load_torch_checkpoint(os.path.join(out, "G1_MNet_best.pt"),
                              _ref_mnet(rn, 3, 1, False), g1,
                              _x((1, SIZE, SIZE, 3)))
        _assert_trees_equal(torch_to_flax_tree(g1),
                            torch_to_flax_tree(state.models.g1))
    finally:
        for name in [n for n in sys.modules if _imported_by_reference(n)]:
            del sys.modules[name]
