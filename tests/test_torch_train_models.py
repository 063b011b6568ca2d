"""Training forwards of the port's models against the JAX package's.

PatchGAN D1 (4 inputs) and D2 (7 inputs) and MNet (both decoders,
droprate 0) run one train-mode forward from the same numpy variables
(LeCun-normal kernels, random BatchNorm affines and running statistics)
on the same input: outputs within 2e-5 and the updated running
statistics within 1e-6 of flax ``apply(..., mutable=["batch_stats"])``.
The VGG features match with shared random weights; Dropout2d's mask has
the per-sample, per-channel shape and the 1/(1-p) scale; and
``torch_to_flax_tree`` inverts ``flax_tree_to_torch`` exactly.

MNet runs at 64x64: at 32x32 with batch 2 its innermost BatchNorm
normalises two values per channel, where f32 cancellation puts both
frameworks 4e-5 / 9e-5 from a float64 forward; at 64x64 both are within
2.2e-6 of it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.models import get_discriminator as j_disc
from shadow_removal_istd_tpu.models import get_generator as j_gen
from shadow_removal_istd_tpu.models.vgg import VGG19Features as JVGG
from shadow_removal_istd_tpu_torch.models import (
    get_discriminator,
    get_generator,
)
from shadow_removal_istd_tpu_torch.models.layers import Dropout2d
from shadow_removal_istd_tpu_torch.models.vgg import VGG19Features
from shadow_removal_istd_tpu_torch.tools.convert import (
    flatten_tree,
    flax_tree_to_torch,
    torch_to_flax_tree,
)


def random_variables(module, in_ch, seed, size=32):
    """Numpy variables shaped as ``module.init``'s (``jax.eval_shape``,
    so nothing compiles): LeCun-normal kernels, random affines and
    running statistics."""
    shapes = jax.eval_shape(module.init, jax.random.key(0),
                            jnp.zeros((1, size, size, in_ch)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree.map(np.asarray,
                        jax.tree_util.tree_map_with_path(leaf, shapes))


def _nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def _train_forward_pair(jmod, tmod, v, x):
    with jax.default_matmul_precision("highest"):
        want, upd = jmod.apply(v, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    flax_tree_to_torch(v, tmod)
    tmod.train()
    got = tmod(_nchw(x))
    stats = torch_to_flax_tree(tmod)["batch_stats"]
    return got, np.asarray(want), upd["batch_stats"], stats


def _check(got, want, upd, stats):
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               want, atol=2e-5, rtol=0)
    jf, tf = flatten_tree(upd), flatten_tree(stats)
    assert jf.keys() == tf.keys()
    for k in jf:
        np.testing.assert_allclose(tf[k], np.asarray(jf[k]), atol=1e-6,
                                   rtol=0, err_msg="/".join(k))


@pytest.mark.parametrize("in_ch", [4, 7])
def test_patchgan_train_forward_matches_jax(in_ch):
    jd = j_disc("patchgan", in_channels=in_ch, out_channels=1, ndf=4)
    v = random_variables(jd, in_ch, seed=in_ch)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, in_ch))
    td = get_discriminator("patchgan", in_channels=in_ch, ndf=4)
    got, want, upd, stats = _train_forward_pair(jd, td, v, x)
    assert got.shape == (2, 1, 4, 4)
    _check(got, want, upd, stats)


@pytest.mark.parametrize("upconv", [True, False])
def test_mnet_train_forward_matches_jax(upconv):
    jg = j_gen("mnet", in_channels=4, out_channels=3, ngf=4,
               no_conv_t=upconv, drop_rate=0.0)
    v = random_variables(jg, 4, seed=11 + upconv)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 4))
    tg = get_generator("mnet", in_channels=4, out_channels=3, ngf=4,
                       no_conv_t=upconv)
    got, want, upd, stats = _train_forward_pair(jg, tg, v, x)
    _check(got, want, upd, stats)
    # the training forward is differentiable end to end
    got.sum().backward()
    assert all(p.grad is not None for p in tg.parameters())


def test_vgg_features_match_jax():
    v = random_variables(JVGG(), 3, seed=5)
    x = np.random.default_rng(3).uniform(-2, 2, (2, 32, 32, 3))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JVGG().apply(v, jnp.asarray(x)))
    vgg = flax_tree_to_torch(v, VGG19Features())
    got = vgg(_nchw(x).to(torch.bfloat16))   # promoted to f32, as flax
    assert got.dtype == torch.float32
    got = vgg(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 2, 2, 512)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


def test_dropout2d_mask_shape_and_scale():
    drop = Dropout2d(0.25).train()
    x = torch.ones(64, 32, 5, 6)
    y = drop(x, torch.Generator().manual_seed(0))
    per_map = y.view(64, 32, -1)
    # one draw per (sample, channel): each map is all 0 or all 1/(1-p)
    assert torch.all(per_map.amin(-1) == per_map.amax(-1))
    kept = torch.tensor(1.0) / 0.75                       # in f32, as x
    assert set(per_map[..., 0].unique().tolist()) == {0.0, kept.item()}
    assert 0.7 < (per_map[..., 0] > 0).float().mean() < 0.8
    assert torch.equal(drop.eval()(x), x)
    with pytest.raises(ValueError, match="generator"):
        drop.train()(x)


@pytest.mark.parametrize("kind", ["mnet", "patchgan", "vgg"])
def test_convert_round_trip_is_exact(kind):
    if kind == "mnet":
        jm = j_gen("mnet", in_channels=3, out_channels=1, ngf=4,
                   no_conv_t=False)
        tm, in_ch = get_generator("mnet", in_channels=3, out_channels=1,
                                  ngf=4, no_conv_t=False), 3
    elif kind == "patchgan":
        jm, in_ch = j_disc("patchgan", in_channels=7, out_channels=1,
                           ndf=4), 7
        tm = get_discriminator("patchgan", in_channels=7, ndf=4)
    else:
        jm, tm, in_ch = JVGG(), VGG19Features(), 3
    v = random_variables(jm, in_ch, seed=3)
    back = flatten_tree(torch_to_flax_tree(flax_tree_to_torch(v, tm)))
    want = flatten_tree(v)
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], want[k], err_msg=str(k))
