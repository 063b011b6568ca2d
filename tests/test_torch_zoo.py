"""The port's model zoo against the JAX package's, from the same
variables.

UNet (both up forms), DenseUNet (both), Pix2PixUNet (num_downs 5 at
64x64, every halving even; num_downs 8 at 60x80, whose halvings go odd
at five levels, so the pad/crop branch and the raw-``x`` concat run),
NLayerDiscriminator, BEGAN (n_layers 3, D1 and D2 wiring), DummyNet, and
the SELU variants of UNet, PatchGAN and BEGAN take numpy variables
shaped by ``jax.eval_shape(init)`` (random BatchNorm affines and running
statistics) through ``tools/convert.py``. Held: the eval forward within
1e-5; the train forward within 2e-5 and its updated running statistics
within 1e-6 (as tests/test_torch_train_models.py holds MNet and
PatchGAN); the output dtype under bf16 compute (JAX side by
``eval_shape``); the flax tree through the port and back, exactly, with
the leaf set ``init`` gives (no BatchNorm leaves under SELU); and the
registry's keys and defaults.

Train mode runs at batch 4 where the innermost BatchNorm of a model
would otherwise normalise 8 values or fewer per channel (f32
cancellation alone moves either framework ~1e-4 off float64 there, see
tests/test_torch_train_models.py). One exception to the 2e-5: UNet with
the nearest upsample, whose train forward in JAX's f32 lands 4e-5 to
8e-5 from its float64 value at every size and batch tried (32x32 to
64x64, batch 2 to 8; the port's f32 1.9e-5 to 3.5e-5): held at 1e-4 in
f32, and both UNet forms are held in float64 on both sides (JAX under
``enable_x64``) within 1e-9, where rounding no longer hides a
difference of math.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.models import get_discriminator as j_disc
from shadow_removal_istd_tpu.models import get_generator as j_gen
from shadow_removal_istd_tpu_torch.models import (
    get_discriminator,
    get_generator,
)
from shadow_removal_istd_tpu_torch.models import layers as L
from shadow_removal_istd_tpu_torch.tools.convert import (
    flatten_tree,
    flax_tree_to_torch,
    targets,
    torch_to_flax_tree,
    unflatten_tree,
)

from test_torch_train_models import random_variables

# name -> (generator?, registry key, kwargs, in channels, (H, W), train N)
CASES = {
    "unet_nearest": (True, "unet", dict(out_channels=3, ngf=4,
                                        no_conv_t=True), 4, (32, 48), 4),
    "unet_convt": (True, "unet", dict(out_channels=1, ngf=4,
                                      no_conv_t=False), 3, (32, 48), 4),
    "unet_selu": (True, "unet", dict(out_channels=3, ngf=4, use_selu=True),
                  4, (32, 32), 2),
    "denseunet_convt": (True, "denseunet", dict(out_channels=3, ngf=4),
                        4, (64, 64), 4),
    "denseunet_nearest": (True, "denseunet", dict(out_channels=1, ngf=4,
                                                  no_conv_t=True),
                          3, (64, 64), 4),
    "pix2pix_even": (True, "stcgan", dict(out_channels=3, ngf=4,
                                          num_downs=5), 4, (64, 64), 2),
    "pix2pix_odd": (True, "stcgan", dict(out_channels=1, ngf=4), 3,
                    (60, 80), 4),
    "nlayer": (False, "stcgan", dict(ndf=4), 7, (64, 64), 2),
    "began_d1": (False, "began", dict(out_channels=1, ndf=4), 4, (32, 32),
                 2),
    "began_d2": (False, "began", dict(out_channels=3, ndf=4), 7, (32, 32),
                 2),
    "began_selu": (False, "began", dict(out_channels=3, ndf=4,
                                        use_selu=True), 7, (32, 32), 2),
    "patchgan_selu": (False, "patchgan", dict(ndf=4, use_selu=True), 7,
                      (32, 32), 2),
    "dummy": (False, "dummy", dict(out_channels=3), 7, (16, 16), 2),
}


def _pair(name, dtype=None):
    gen, key, kw, in_ch, _, _ = CASES[name]
    jfn, tfn = (j_gen, get_generator) if gen else (j_disc, get_discriminator)
    jkw = dict(kw, dtype=jnp.bfloat16) if dtype else kw
    tkw = dict(kw, compute_dtype=torch.bfloat16) if dtype else kw
    return (jfn(key, in_channels=in_ch, **jkw),
            tfn(key, in_channels=in_ch, **tkw))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs several workers on few cores,
    where torch's default pool (one thread a core, in every worker)
    oversubscribes them many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def variables():
    """Numpy variables per case, shaped by ``eval_shape`` (nothing
    compiles)."""
    out = {}
    for i, name in enumerate(CASES):
        jm, _ = _pair(name)
        in_ch, hw = CASES[name][3], CASES[name][4]
        shapes = random_variables(jm, in_ch, seed=100 + i, size=hw[0])
        out[name] = shapes
    return out


def _apply(jm, v, x, train):
    """flax ``apply`` jitted (3-6x faster here than op by op), with the
    updated statistics in train mode."""
    if train:
        fn = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                           mutable=["batch_stats"]))
    else:
        fn = jax.jit(lambda v, x: jm.apply(v, x, train=False))
    with jax.default_matmul_precision("highest"):
        return fn(v, jnp.asarray(x))


def _input(name, n, seed):
    in_ch, (h, w) = CASES[name][3], CASES[name][4]
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, h, w, in_ch)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name", CASES)
def test_eval_forward_matches_jax(name, variables):
    jm, tm = _pair(name)
    v = variables[name]
    x = _input(name, 2, seed=1)
    want = np.asarray(_apply(jm, v, x, train=False))
    flax_tree_to_torch(v, tm).eval()
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


TRAIN_TOL = {"unet_nearest": 1e-4}     # see the module docstring


@pytest.mark.parametrize("name", CASES)
def test_train_forward_matches_jax(name, variables):
    jm, tm = _pair(name)
    v = variables[name]
    x = _input(name, CASES[name][5], seed=2)
    want, upd = _apply(jm, v, x, train=True)
    flax_tree_to_torch(v, tm).train()
    got = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want),
                               atol=TRAIN_TOL.get(name, 2e-5), rtol=0)
    jf = flatten_tree(upd.get("batch_stats", {}))
    tf = flatten_tree(torch_to_flax_tree(tm)["batch_stats"])
    assert jf.keys() == tf.keys()
    for k in jf:
        np.testing.assert_allclose(tf[k], np.asarray(jf[k]), atol=1e-6,
                                   rtol=0, err_msg="/".join(k))
    # differentiable end to end
    got.float().sum().backward()
    assert all(p.grad is not None for p in tm.parameters())


@pytest.mark.parametrize("name", ["unet_nearest", "unet_convt"])
def test_unet_train_forward_in_float64_matches_jax(name, variables):
    jm, tm = _pair(name)
    v = variables[name]
    x = _input(name, CASES[name][5], seed=2).astype(np.float64)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        want, upd = _apply(jm, v64, x, train=True)
        want = np.asarray(want)
        assert want.dtype == np.float64
        jf = {k: np.asarray(a) for k, a in
              flatten_tree(upd["batch_stats"]).items()}
    flax_tree_to_torch(v, tm).double().train()
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               want, atol=1e-9, rtol=0)
    stats = {k[1:]: t for k, t in targets(tm).items()
             if k[0] == "batch_stats"}
    assert stats.keys() == jf.keys()
    for k, t in stats.items():
        np.testing.assert_allclose(t.numpy(), jf[k], atol=1e-9, rtol=0,
                                   err_msg="/".join(k))


@pytest.mark.parametrize("name", CASES)
def test_bf16_output_dtype_matches_jax(name, variables):
    jm, tm = _pair(name, dtype=torch.bfloat16)
    v = variables[name]
    x = _input(name, 1, seed=3)
    want = jax.eval_shape(lambda v, x: jm.apply(v, x, train=False), v,
                          jnp.asarray(x))
    flax_tree_to_torch(v, tm).eval()
    with torch.no_grad():
        got = tm(_nchw(x))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (want.shape[0], want.shape[3],
                                *want.shape[1:3])


@pytest.mark.parametrize("name", CASES)
def test_convert_round_trip_is_exact(name, variables):
    _, tm = _pair(name)
    v = variables[name]
    back = torch_to_flax_tree(flax_tree_to_torch(v, tm))
    got, want = flatten_tree(back), flatten_tree(v)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    if CASES[name][2].get("use_selu") or name == "dummy":
        assert back["batch_stats"] == {}
        assert not any("BatchNorm" in "/".join(k) for k in got)
    # a missing leaf is refused before anything is written
    k = next(iter(want))
    short = {p: a for p, a in want.items() if p != k}
    with pytest.raises(ValueError, match="missing"):
        flax_tree_to_torch(unflatten_tree(short), tm)


def test_registry_keys_and_defaults():
    from shadow_removal_istd_tpu.models import registry as jreg
    from shadow_removal_istd_tpu_torch.models import registry as treg

    assert treg.GENERATORS.keys() == jreg.GENERATORS.keys()
    assert treg.DISCRIMINATORS.keys() == jreg.DISCRIMINATORS.keys()
    for table in ("GENERATORS", "DISCRIMINATORS"):
        for key, cls in getattr(treg, table).items():
            assert cls.__name__ == getattr(jreg, table)[key].__name__
    dummy = get_discriminator("DUMMY", in_channels=7)
    assert dummy.conv.weight.shape[0] == 1 == j_disc(
        "dummy", in_channels=7).out_channels
    assert isinstance(get_generator("StcGAN", in_channels=3,
                                    out_channels=1, ngf=2, num_downs=3),
                      treg.Pix2PixUNet)


def test_unet_rejects_indivisible_sizes():
    g = get_generator("unet", in_channels=3, out_channels=1, ngf=2)
    with pytest.raises(ValueError, match="divisible by 16"):
        g(torch.zeros(1, 3, 24, 32))
    d = get_generator("denseunet", in_channels=3, out_channels=1, ngf=2)
    with pytest.raises(ValueError, match="divisible by 32"):
        d(torch.zeros(1, 3, 48, 64))


def test_unet_dropout_on_inner_levels_only():
    """Dropout2d after the three inner decoder levels, from the
    generator; eval and drop_rate 0 draw nothing."""
    g = get_generator("unet", in_channels=3, out_channels=1, ngf=2,
                      drop_rate=0.5)
    L.init_weights_(g, torch.Generator().manual_seed(0))
    calls = []
    orig = g.drop.forward
    g.drop.forward = lambda x, gen=None: calls.append(x.shape[1]) or orig(
        x, gen)
    x = torch.rand(2, 3, 32, 32)
    g.train()(x, generator=torch.Generator().manual_seed(1))
    assert calls == [16, 8, 4]
    with pytest.raises(ValueError, match="generator"):
        g(x)


def test_alpha_dropout_keeps_mean_and_variance():
    drop = L.AlphaDropout(0.2).train()
    x = torch.randn(200_000, generator=torch.Generator().manual_seed(0))
    x = torch.nn.functional.selu(x)
    y = drop(x, torch.Generator().manual_seed(1))
    assert abs(float(y.mean() - x.mean())) < 0.01
    assert abs(float(y.std() - x.std())) < 0.01
    assert torch.equal(drop.eval()(x), x)
    assert L.make_dropout(False, 0) is None
    assert isinstance(L.make_dropout(True, 0.1), L.AlphaDropout)
    assert isinstance(L.make_dropout(False, 0.1), L.Dropout2d)


def test_pools_and_nearest_upsample_match_jax():
    from shadow_removal_istd_tpu.models import layers as JL

    x = np.random.default_rng(4).standard_normal((2, 6, 8, 3)).astype(
        np.float32)
    for jf, tf in ((JL.max_pool, L.max_pool), (JL.avg_pool, L.avg_pool),
                   (JL.upsample_nearest, L.upsample_nearest)):
        want = np.asarray(jf(jnp.asarray(x), 2))
        np.testing.assert_allclose(_nhwc(tf(_nchw(x), 2)), want, atol=1e-7,
                                   rtol=0)
