"""The port's losses against the JAX package's on shared inputs: L1, L2,
every adversarial variant ({standard, leastsquare, and the
reference's "leastsqure" spelling, which turns its BCE branch on} x
{normal, rel, rel_avg} x {reference, corrected}, D and G directions,
within 1e-6 of max(1, |loss|): the f32 means sum in another order, and
one ulp at the largest loss here, ~7, is 4.8e-7), and the visual loss
and its legacy sp-space form with shared random VGG weights (relative
1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.losses import l1_loss as j_l1
from shadow_removal_istd_tpu.losses import l2_loss as j_l2
from shadow_removal_istd_tpu.losses import make_adversarial_loss as j_adv
from shadow_removal_istd_tpu.losses import sp_visual_loss as j_sp_visual
from shadow_removal_istd_tpu.losses import visual_loss as j_visual
from shadow_removal_istd_tpu.models.vgg import VGG19Features as JVGG
from shadow_removal_istd_tpu_torch.losses import (
    l1_loss,
    l2_loss,
    make_adversarial_loss,
    sp_visual_loss,
    visual_loss,
)
from shadow_removal_istd_tpu_torch.models.vgg import VGG19Features
from shadow_removal_istd_tpu_torch.tools.convert import flax_tree_to_torch

from test_torch_train_models import random_variables


def _pair(shape, seed, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape)
         * scale).astype(np.float32)
    return a, torch.from_numpy(a)


def test_l1_loss():
    a, ta = _pair((2, 8, 8, 3), 0)
    b, tb = _pair((2, 8, 8, 3), 1)
    want = float(j_l1(jnp.asarray(a), jnp.asarray(b)))
    assert abs(float(l1_loss(ta, tb)) - want) <= 1e-6
    # bf16 predictions accumulate in f32
    got = l1_loss(ta.to(torch.bfloat16), tb)
    assert got.dtype == torch.float32
    want = float(j_l1(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b)))
    assert abs(float(got) - want) <= 1e-6


def test_l2_loss():
    a, ta = _pair((2, 8, 8, 3), 0)
    b, tb = _pair((2, 8, 8, 3), 1)
    want = float(j_l2(jnp.asarray(a), jnp.asarray(b)))
    assert abs(float(l2_loss(ta, tb)) - want) <= 1e-6 * max(1.0, want)
    # bf16 predictions accumulate in f32
    got = l2_loss(ta.to(torch.bfloat16), tb)
    assert got.dtype == torch.float32
    want = float(j_l2(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b)))
    assert abs(float(got) - want) <= 1e-6 * max(1.0, want)


@pytest.mark.parametrize("mode", ["reference", "corrected"])
@pytest.mark.parametrize("d_type", ["normal", "rel", "rel_avg"])
@pytest.mark.parametrize("d_loss_fn", ["standard", "leastsquare",
                                       "leastsqure"])
def test_adversarial_variants(d_loss_fn, d_type, mode):
    real, t_real = _pair((3, 4, 4, 1), 2, scale=2.0)
    fake, t_fake = _pair((3, 4, 4, 1), 3, scale=2.0)
    jl = j_adv(d_loss_fn, d_type, mode)
    tl = make_adversarial_loss(d_loss_fn, d_type, mode)
    assert (tl.ls, tl.rel, tl.avg) == (jl.ls, jl.rel, jl.avg)
    # NHWC logits on the JAX side, NCHW here: the losses reduce over all
    # elements and average over the batch, so the layouts compare
    tr, tf = t_real.permute(0, 3, 1, 2), t_fake.permute(0, 3, 1, 2)
    for name in ("d_loss", "g_loss"):
        want = float(getattr(jl, name)(jnp.asarray(real), jnp.asarray(fake)))
        got = float(getattr(tl, name)(tr, tf))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (name, got,
                                                               want)


@pytest.mark.parametrize("channels", [1, 3])
def test_visual_loss_matches_jax(channels):
    v = random_variables(JVGG(), 3, seed=21)
    vgg = flax_tree_to_torch(v, VGG19Features())
    pred, t_pred = _pair((2, 32, 32, channels), 4, scale=0.5)
    tgt, t_tgt = _pair((2, 32, 32, channels), 5, scale=0.5)
    with jax.default_matmul_precision("highest"):
        want = float(j_visual(v, jnp.asarray(pred), jnp.asarray(tgt)))
    t_pred = t_pred.permute(0, 3, 1, 2).requires_grad_(True)
    got = visual_loss(vgg, t_pred, t_tgt.permute(0, 3, 1, 2))
    assert abs(float(got.detach()) - want) <= 1e-5 * abs(want)
    got.backward()
    assert t_pred.grad is not None and float(t_pred.grad.abs().sum()) > 0


def test_sp_visual_loss_matches_jax():
    """The legacy sp-space loss on the cases of the JAX package's
    ``test_vgg_parity.py::test_sp_visual_loss_parity`` (normalised
    input, sp in [0, 3), a [0, 1] target), with the same VGG weights on
    both sides; the gradient reaches ``sp_pred`` and not the target."""
    v = random_variables(JVGG(), 3, seed=22)
    vgg = flax_tree_to_torch(v, VGG19Features())
    rng = np.random.default_rng(6)
    x_norm = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    sp = rng.random((2, 32, 32, 3), dtype=np.float32) * 3.0
    target01 = rng.random((2, 32, 32, 3), dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        want = float(j_sp_visual(v, jnp.asarray(x_norm), jnp.asarray(sp),
                                 jnp.asarray(target01)))

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    t_sp = nchw(sp).requires_grad_(True)
    t_tgt = nchw(target01).requires_grad_(True)
    got = sp_visual_loss(vgg, nchw(x_norm), t_sp, t_tgt)
    assert want > 0
    assert abs(float(got.detach()) - want) <= 1e-5 * max(1.0, abs(want))
    got.backward()
    assert float(t_sp.grad.abs().sum()) > 0 and t_tgt.grad is None
