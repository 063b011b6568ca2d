"""The port's MNet G1, G2 and stacked pair vs the JAX package's MNet.

Numpy variables shaped as JAX ``get_generator("mnet")``'s (LeCun-normal
kernels, random BatchNorm statistics and affines, so the BN paths are
not identities) are carried into the port by
``tools/convert.flax_tree_to_torch``; the
same numpy input goes through both. f32: max abs <= 2e-5. bf16 (every
leaf cast, as the serving engine casts): max abs <= 6e-2 and mean abs
<= 5e-3, where bf16 rounding lands at other places in the two
frameworks (the port's decoder rounds the conv output once, after the
affine).

The JAX package's executed semantics the port reproduces, and where each
is held:
- leaky twice on the link (post-LeakyReLU skip link, LeakyReLU again in
  the next decoder step) and no LeakyReLU/BN on the final layer: the
  G1/G2 parity cases (random BN stats, so neither can hide), plus
  tests/test_torch_decoder.py::test_upsample_module_matches_jax for the
  final-layer form;
- the bf16 engine's dtypes (every leaf cast, BN factor from bf16 stats,
  phase kernel from cast weights, G2 input ``cat(x.astype(m.dtype), m)``):
  the bf16 cases, test_batchnorm_eval_matches_jax and
  tests/test_torch_decoder.py::test_phase_kernel_equals_jax;
- the area gate (>= 4500): the 256x320 cases cross it.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.models import get_generator as jax_generator
from shadow_removal_istd_tpu_torch.engine.steps import infer_step
from shadow_removal_istd_tpu_torch.models import get_generator
from shadow_removal_istd_tpu_torch.models.layers import init_weights_
from shadow_removal_istd_tpu_torch.tools.convert import flax_tree_to_torch

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": None, "bfloat16": jnp.bfloat16}


@functools.lru_cache(maxsize=None)
def _variables(ngf, upconv, in_ch, out_ch, seed):
    """A numpy tree shaped as the flax MNet's variables (traced with
    ``jax.eval_shape``, so no init compiles): LeCun-normal kernels as
    flax draws them, random BN stats and affines."""
    g = jax_generator("mnet", in_channels=in_ch, out_channels=out_ch,
                      ngf=ngf, no_conv_t=upconv)
    shapes = jax.eval_shape(g.init, jax.random.key(seed),
                            jnp.zeros((1, 32, 32, in_ch)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        assert name in ("bias", "mean"), path
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(ngf, split, upconv, dtype, seed=0):
    kw = dict(ngf=ngf, no_conv_t=upconv, split_skip=split)
    nets = []
    for k, (cin, cout) in enumerate(((3, 1), (4, 3))):
        jg = jax_generator("mnet", in_channels=cin, out_channels=cout,
                           dtype=JDT[dtype], **kw)
        v = _variables(ngf, upconv, cin, cout, seed + k)
        tg = get_generator("mnet", in_channels=cin, out_channels=cout, **kw)
        flax_tree_to_torch(v, tg)
        tg.to(TDT[dtype]).eval()
        if dtype == "bfloat16":  # the serving engine's cast of every leaf
            v = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
        nets.append((jg, v, tg))
    return nets


def _t(x_nhwc):
    return torch.from_numpy(np.array(x_nhwc, np.float32)).permute(0, 3, 1, 2)


def _np(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _close(got, want, dtype):
    err = np.abs(got - np.asarray(want, np.float32))
    if dtype == "float32":
        assert err.max() <= 2e-5, err.max()
    else:
        assert err.max() <= 6e-2 and err.mean() <= 5e-3, (err.max(),
                                                          err.mean())


# every (split, upconv) pair once at ngf 8, and the serving default once
# at ngf 4 across the area gate (each case compiles its own JAX program)
CASES = [
    (8, 64, 64, True, True),
    (8, 64, 64, False, False),
    (8, 64, 96, False, True),
    (8, 64, 96, True, False),    # split requested, ConvTranspose: concat
    (4, 256, 320, True, True),   # decoder areas 5120 >= 4500: gate crossed
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ngf,h,w,split,upconv", CASES)
def test_g1_g2_stacked_match_jax(ngf, h, w, split, upconv, dtype):
    (j1, v1, t1), (j2, v2, t2) = _pair(ngf, split, upconv, dtype)
    x = np.random.default_rng(7).uniform(-1, 1, (2, h, w, 3)).astype(
        np.float32)

    @jax.jit
    def stacked(v1, v2, x):
        m = j1.apply(v1, x)
        g2_in = jnp.concatenate([x.astype(m.dtype), m], -1)
        return m, g2_in, j2.apply(v2, g2_in)

    with jax.default_matmul_precision("highest"):
        m, g2_in, y = stacked(v1, v2, jnp.asarray(x))
    m, g2_in, y = (np.asarray(a.astype(jnp.float32)) for a in (m, g2_in, y))
    with torch.inference_mode():
        tm, ty = infer_step(t1, t2, _t(x))
        ty2 = t2(_t(g2_in))                 # G2 alone, on JAX's G2 input
    assert tm.shape == (2, 1, h, w) and ty.shape == (2, 3, h, w)
    assert tm.dtype == TDT[dtype]
    _close(_np(tm), m, dtype)
    _close(_np(ty2), y, dtype)
    _close(_np(ty), y, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split,upconv", [(True, True), (False, False)])
def test_frozen_decoder_equals_unfrozen(split, upconv, dtype):
    """``MNet.freeze`` (phase kernels and affines built once, as the
    serving engine does on adopting weights) changes no output bit."""
    (_, _, net), _ = _pair(8, split, upconv, dtype)
    x = _t(np.random.default_rng(3).uniform(-1, 1, (2, 64, 64, 3)))
    with torch.inference_mode():
        want = net(x)
        net.freeze()
        got = net(x)
    assert net.final.frozen is not None
    assert torch.equal(got, want)


def test_up_numbering_innermost_first():
    """flax numbers _Up_k in creation order: _Up_0 is the innermost
    level (64 features at ngf 8)."""
    g = get_generator("mnet", in_channels=3, out_channels=1, ngf=8)
    assert g.ups[0].up.weight.shape[0] == 64
    assert g.ups[-1].up.weight.shape[0] == 8


def test_divisibility_check():
    g = get_generator("mnet", in_channels=3, out_channels=1, ngf=4).eval()
    with pytest.raises(ValueError, match="divisible by 32"):
        g(torch.zeros(1, 3, 48, 64))


def test_training_forward_not_ported():
    """Kept under its first name: the training forward, which once
    raised "not ported yet", now runs (its parity with JAX is in
    tests/test_torch_train_models.py), and entering training drops the
    frozen eval kernels, so an eval after training uses the new
    weights."""
    g = get_generator("mnet", in_channels=3, out_channels=1, ngf=4)
    init_weights_(g, torch.Generator().manual_seed(0))
    x = torch.zeros(2, 3, 32, 32).uniform_(-1, 1, generator=torch.Generator()
                                           .manual_seed(1))
    g.eval().freeze()
    assert g.final.frozen is not None
    y = g.train()(x)
    assert y.shape == (2, 1, 32, 32) and y.requires_grad
    assert g.final.frozen is None
    assert not torch.equal(g.downs[0].bn.running_mean,
                           torch.zeros_like(g.downs[0].bn.running_mean))
    with torch.no_grad():
        g.stem.weight.mul_(1.5)          # an update after the freeze
        got = g.eval()(x)
        fresh = copy.deepcopy(g)         # unfrozen eval, current weights
        torch.testing.assert_close(got, fresh(x), rtol=0, atol=0)


@pytest.mark.parametrize("key", ["unet", "denseunet", "stcgan", "nope"])
def test_registry_other_keys_not_ported(key):
    """The other generator keys build the JAX package's classes (the
    whole zoo is ported); an unknown key raises KeyError, as the JAX
    registry does."""
    from shadow_removal_istd_tpu.models.registry import GENERATORS

    if key == "nope":
        with pytest.raises(KeyError):
            get_generator(key, in_channels=3, out_channels=1)
        return
    g = get_generator(key, in_channels=3, out_channels=1, ngf=4)
    assert type(g).__name__ == GENERATORS[key].__name__


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_convert_rejects_mismatched_trees(fault):
    v = _variables(4, True, 3, 1, 0)
    v = {k: dict(sub) for k, sub in v.items()}
    if fault == "missing":
        del v["params"]["Upsample_0"]
    elif fault == "extra":
        v["params"]["Bogus_0"] = {"kernel": np.zeros(3)}
    else:
        v["params"]["ConvReflect_0"] = {"Conv_0": {
            "kernel": np.zeros((4, 4, 3, 5), np.float32)}}
    tg = get_generator("mnet", in_channels=3, out_channels=1, ngf=4)
    init_weights_(tg, torch.Generator().manual_seed(0))
    before = tg.stem.weight.clone()
    with pytest.raises(ValueError):
        flax_tree_to_torch(v, tg)
    assert torch.equal(tg.stem.weight, before)  # nothing written


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_eval_matches_jax(dtype):
    """Eval BN in the engine's dtypes (bf16 statistics: the factor
    scale*rsqrt(var+eps) forms in bf16, the affine runs in f32), and the
    phase-tiled affine the decoder op takes gives the same values. XLA's
    CPU backend and torch may round that bf16 factor one ulp apart, so
    bf16 is held to 3e-2; f32 to 1e-6."""
    from shadow_removal_istd_tpu.models.layers import BatchNorm as JBN
    from shadow_removal_istd_tpu_torch.models.layers import BatchNorm

    jdt = JDT[dtype] or jnp.float32
    rng = np.random.default_rng(5)
    c = 16
    raw = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0, .1, c),
           "mean": rng.normal(0, .1, c), "var": rng.uniform(0.5, 1.5, c),
           "x": rng.standard_normal((2, 4, 5, c))}
    j = {k: jnp.asarray(v, jdt) for k, v in raw.items()}
    want = np.asarray(JBN(dtype=JDT[dtype]).apply(
        {"params": {"scale": j["scale"], "bias": j["bias"]},
         "batch_stats": {"mean": j["mean"], "var": j["var"]}},
        j["x"], False).astype(jnp.float32))
    t = {k: torch.from_numpy(np.array(v.astype(jnp.float32)))
         for k, v in j.items()}
    bn = BatchNorm(c).eval()          # modules start in training mode
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            getattr(bn, name).copy_(t[key])
        bn.to(TDT[dtype])
        xt = t["x"].permute(0, 3, 1, 2).to(TDT[dtype])
        scale4, shift4 = bn.affine(tile=4)
        fused = (xt.float() * scale4[:c].view(1, -1, 1, 1)
                 + shift4[:c].view(1, -1, 1, 1)).to(TDT[dtype])
        outs = (bn(xt), fused)
    tol = 1e-6 if dtype == "float32" else 3e-2
    for got in outs:
        np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)
