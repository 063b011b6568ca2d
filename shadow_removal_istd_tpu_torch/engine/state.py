"""Train state: the four networks, both Adam optimizers, the step
count, BEGAN's k1/k2 and the SoftAdapt state; port of
``shadow_removal_istd_tpu/engine/state.py``.

The JAX package threads one immutable pytree through a pure step; here
the modules and optimizers are updated in place by ``engine/steps.py``.
k1, k2 and the SoftAdapt tensors stay on the networks' device, so the
step that updates them waits for nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from shadow_removal_istd_tpu_torch import resolve_device
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.losses.adversarial import (
    AdversarialLoss,
    make_adversarial_loss,
)
from shadow_removal_istd_tpu_torch.losses.softadapt import (
    SoftAdaptState,
    softadapt_init,
)
from shadow_removal_istd_tpu_torch.models import (
    get_discriminator,
    get_generator,
)
from shadow_removal_istd_tpu_torch.models.layers import init_weights_
from shadow_removal_istd_tpu_torch.models.vgg import VGG19Features

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


@dataclass
class Models:
    g1: nn.Module
    g2: nn.Module
    d1: nn.Module
    d2: nn.Module

    def all(self) -> tuple[nn.Module, ...]:
        return (self.g1, self.g2, self.d1, self.d2)


@dataclass
class TrainState:
    cfg: TrainConfig
    models: Models
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    adv: AdversarialLoss
    vgg: VGG19Features | None = None
    step: int = 0           # optimiser steps taken (host counter)
    # BEGAN balance terms (f32 0-d tensors; zeros on the networks'
    # device when not given)
    k1: torch.Tensor | None = None
    k2: torch.Tensor | None = None
    # SoftAdapt weights over the (adv, data, visual) groups: with
    # cfg.softadapt, initialised to [1, lambda1, lambda2] normalized
    softadapt: SoftAdaptState | None = None
    # the plateau controllers' scales of the base rates (host floats)
    lr_scale_g: float = 1.0
    lr_scale_d: float = 1.0
    # the data-parallel group (parallel.mesh.Mesh of > 1 rank) whose
    # global batch each step trains on; None: the local batch is global
    mesh: object = None

    def __post_init__(self):
        dev = next(self.models.g1.parameters()).device
        if self.k1 is None:
            self.k1 = torch.zeros((), device=dev)
        if self.k2 is None:
            self.k2 = torch.zeros((), device=dev)
        if self.softadapt is None and self.cfg.softadapt:
            self.softadapt = softadapt_init(
                3, init_weights=[1.0, self.cfg.lambda1, self.cfg.lambda2],
                device=dev)


def build_models(cfg: TrainConfig) -> Models:
    """G1 (3 -> 1), G2 (4 -> 3), D1 (4 in, 1 out), D2 (7 in, 3 out), the
    reference's channel wiring; the out channels matter to the BEGAN
    and dummy Ds, which reconstruct or map per pixel."""
    dt = _DTYPES[cfg.compute_dtype]
    g_kw = dict(ngf=cfg.ngf, drop_rate=cfg.droprate,
                no_conv_t=cfg.nn_upconv, use_selu=cfg.use_selu,
                activation=cfg.activation, compute_dtype=dt)
    d_kw = dict(ndf=cfg.ndf, use_selu=cfg.use_selu, use_sigmoid=False,
                compute_dtype=dt)
    return Models(
        g1=get_generator(cfg.net_g, in_channels=3, out_channels=1, **g_kw),
        g2=get_generator(cfg.net_g, in_channels=3 + 1, out_channels=3,
                         **g_kw),
        d1=get_discriminator(cfg.net_d, in_channels=3 + 1, out_channels=1,
                             **d_kw),
        d2=get_discriminator(cfg.net_d, in_channels=3 + 3 + 1,
                             out_channels=3, **d_kw))


def make_optimizers(cfg: TrainConfig, models: Models
                    ) -> tuple[torch.optim.Optimizer, torch.optim.Optimizer]:
    """Two Adam chains, over G1+G2 and over D1+D2. ``torch.optim.Adam``'s
    update is optax's: eps outside the square root, bias corrections of
    both moments; the learning rate is set per step by
    :func:`set_learning_rates`."""
    def adam(nets, lr):
        return torch.optim.Adam(
            [p for n in nets for p in n.parameters()], lr=lr,
            betas=(cfg.beta1, cfg.beta2), eps=cfg.adam_eps)

    return (adam((models.g1, models.g2), cfg.lr_g),
            adam((models.d1, models.d2), cfg.lr_d))


def learning_rate(base: float, cfg: TrainConfig, i: int) -> float:
    """Rate of optimiser step ``i`` (0-based): ``base * (1 - decay) **
    (i // steps_per_epoch)``, optax's schedule on its update count;
    under ``lr_schedule="plateau"`` the constant ``base`` (the plateau
    controller scales it, ``set_learning_rates``)."""
    if cfg.lr_schedule == "plateau":
        return base
    return base * (1.0 - cfg.decay) ** (i // max(cfg.steps_per_epoch, 1))


def set_learning_rates(state: TrainState) -> None:
    for opt, base, scale in ((state.opt_g, state.cfg.lr_g, state.lr_scale_g),
                             (state.opt_d, state.cfg.lr_d, state.lr_scale_d)):
        for group in opt.param_groups:
            group["lr"] = learning_rate(base, state.cfg, state.step) * scale


def init_state(cfg: TrainConfig, generator: torch.Generator,
               device: str | torch.device = "cuda",
               vgg: VGG19Features | None = None) -> TrainState:
    """Build the four networks with flax's init distributions
    (LeCun-normal truncated kernels, zero biases, identity BN) drawn from
    ``generator`` (a CPU generator) in the order G1, G2, D1, D2, on
    ``device`` in f32, and both optimizers."""
    device = resolve_device(device)
    models = build_models(cfg)
    for net in models.all():
        init_weights_(net, generator)
        net.to(device)
    opt_g, opt_d = make_optimizers(cfg, models)
    return TrainState(cfg=cfg, models=models, opt_g=opt_g, opt_d=opt_d,
                      adv=make_adversarial_loss(cfg.d_loss_fn, cfg.d_type,
                                                cfg.loss_mode),
                      vgg=vgg.to(device) if vgg is not None else None)


def param_count(module: nn.Module) -> int:
    """The number of parameter elements of ``module`` (the JAX package's
    ``param_count`` over a ``params`` tree; BatchNorm statistics are
    buffers here, as they are ``batch_stats`` there, and not counted)."""
    return sum(p.numel() for p in module.parameters())
