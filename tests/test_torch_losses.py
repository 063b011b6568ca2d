"""The port's losses against the JAX package's on shared inputs: L1,
every adversarial variant ({standard, leastsquare, and the
reference's "leastsqure" spelling, which turns its BCE branch on} x
{normal, rel, rel_avg} x {reference, corrected}, D and G directions,
within 1e-6 of max(1, |loss|): the f32 means sum in another order, and
one ulp at the largest loss here, ~7, is 4.8e-7), and the visual loss
with shared random VGG weights (relative 1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.losses import l1_loss as j_l1
from shadow_removal_istd_tpu.losses import make_adversarial_loss as j_adv
from shadow_removal_istd_tpu.losses import visual_loss as j_visual
from shadow_removal_istd_tpu.models.vgg import VGG19Features as JVGG
from shadow_removal_istd_tpu_torch.losses import (
    l1_loss,
    make_adversarial_loss,
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
