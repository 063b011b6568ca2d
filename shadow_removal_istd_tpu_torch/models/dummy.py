"""Dummy 1x1-conv discriminator; port of
``shadow_removal_istd_tpu/models/dummy.py``.

The stand-in D of pure supervised ablations: selecting it zeroes the
adversarial loss weights (``engine/config.py``). One 1x1 conv with a
bias; the other keywords are accepted for the registry and unused, as
in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from shadow_removal_istd_tpu_torch.models import layers as L


class DummyNet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 1,
                 ndf: int = 64, use_selu: bool = False,
                 use_sigmoid: bool = False,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv = L.Conv(in_channels, out_channels, 1, 1, 0, bias=True)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.conv.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.to(self.dtype))
