"""Weights made on the card from the seed, in a few large calls, and
handed to both sides: the program's modules (by name) and the
reference (as name -> tensor maps).

Each map follows ``reference/nets.py``'s list of (name, shape, kind):
convolutions LeCun-normal (std sqrt(1/fan_in); the VGG's He-normal,
sqrt(2/fan_in), so that its features stay O(1) through 12 ReLU convs),
biases N(0, 0.02), BatchNorm scale 1 + N(0, 0.1), shift N(0, 0.05),
running mean N(0, 0.05) and variance exp(N(0, 0.2)).
"""

from __future__ import annotations

import math

import torch


def make(nets: dict, gen: torch.Generator, device) -> dict:
    """``nets``: name -> leaf list. Returns name -> {leaf: f32 tensor},
    all drawn from one normal sample on ``device``."""
    order = [(n, leaf) for n, leaves in nets.items() for leaf in leaves]
    total = sum(math.prod(shape) for _, (_, shape, _) in order)
    z = torch.randn(total, generator=gen, device=device)
    out = {n: {} for n in nets}
    ofs = 0
    for n, (name, shape, kind) in order:
        k = math.prod(shape)
        t = z[ofs:ofs + k].view(shape)
        ofs += k
        if kind in ("conv", "conv_relu"):
            fan_in = math.prod(shape[1:])
            t = t * math.sqrt((2.0 if kind == "conv_relu" else 1.0) / fan_in)
        elif kind == "bias":
            t = t * 0.02
        elif kind == "bn_weight":
            t = 1.0 + 0.1 * t
        elif kind == "bn_bias":
            t = 0.05 * t
        elif kind == "mean":
            t = 0.05 * t
        elif kind == "var":
            t = torch.exp(0.2 * t)
        else:
            raise ValueError(f"unknown leaf kind {kind!r}")
        out[n][name] = t.contiguous()
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, leaves: dict) -> None:
    """Copy ``leaves`` into the module's parameters and buffers by name
    (cast to each one's dtype); the two sets of names must be equal."""
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    if set(own) != set(leaves):
        raise KeyError(f"leaves differ: program only {sorted(set(own) - set(leaves))}, "
                       f"benchmark only {sorted(set(leaves) - set(own))}")
    for name, t in own.items():
        if tuple(t.shape) != tuple(leaves[name].shape):
            raise ValueError(f"{name}: {tuple(t.shape)} != {tuple(leaves[name].shape)}")
        t.copy_(leaves[name])
