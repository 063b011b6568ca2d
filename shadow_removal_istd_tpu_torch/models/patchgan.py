"""PatchGAN discriminator.

Port of ``shadow_removal_istd_tpu/models/patchgan.py``: a 4x4s2 stem
conv (zero pad, bias) + LeakyReLU; ``n_layers - 1`` channel-doubling
4x4s2 reflect convs, each followed by ActNorm (LeakyReLU then BN, or
SELU with ``use_selu``); a 3x3 reflect conv tail to twice the channels +
ActNorm; and a final 3x3 reflect conv to a 1-channel logit map (for a
with-logits loss; ``use_sigmoid`` adds the sigmoid). ``out_channels`` is
accepted for the registry and unused (the output has one channel), as in
the JAX package. ``compute_dtype`` as in ``models/mnet.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from shadow_removal_istd_tpu_torch.models import layers as L


class PatchGAN(nn.Module):
    def __init__(self, in_channels: int, ndf: int = 64, n_layers: int = 3,
                 use_selu: bool = False, use_sigmoid: bool = False,
                 out_channels: int | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        self.compute_dtype = compute_dtype
        self.stem = L.Conv(in_channels, ndf, 4, 2, 1)
        convs, norms = [], []
        prev = ndf
        for n in range(1, n_layers):
            # channels double up to n < 4, then stay
            feats = prev * 2 if n < 4 else prev
            convs.append(L.ConvReflect(prev, feats, 4, 2, 1))
            norms.append(L.ActNorm(feats, use_selu))
            prev = feats
        tail = prev * 2 if n_layers < 4 else prev
        convs.append(L.ConvReflect(prev, tail, 3, 1, 1))
        norms.append(L.ActNorm(tail, use_selu))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.final = L.ConvReflect(tail, 1, 3, 1, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.stem.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.stem(x.to(self.dtype)), 0.2)
        for conv, norm in zip(self.convs, self.norms):
            y = norm(conv(y))
        y = self.final(y)
        return torch.sigmoid(y) if self.use_sigmoid else y
