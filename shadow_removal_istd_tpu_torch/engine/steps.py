"""Stacked inference step (port of ``engine/steps.py::make_infer_step``)."""

from __future__ import annotations

import torch
from torch import nn


def infer_step(g1: nn.Module, g2: nn.Module,
               x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``m = G1(x)``, then ``y = G2(cat(x, m))``, both in eval mode.

    ``x`` is an (N, 3, H, W) image in [-1, 1]; it is cast to the matte's
    dtype before the concat, as the JAX serving engine does."""
    m = g1(x)
    y = g2(torch.cat([x.to(m.dtype), m], dim=1))
    return m, y
