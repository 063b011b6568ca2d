"""Pix2pix U-Net generator and NLayer (70x70 PatchGAN) discriminator.

Port of ``shadow_removal_istd_tpu/models/pix2pix.py`` (the reference's
UnetGenerator with ``num_downs`` 8 and NLayerDiscriminator). All convs
are 4x4 and zero-padded; convs next to a BatchNorm carry no bias, the
outermost up-conv and D's stem and final convs do.

Executed semantics carried over from the JAX package, level by level
from the outermost (level 0) in:

- an odd H or W is zero-padded to even (bottom/right) before the level's
  down-conv, and the level's output cropped back before the concat, so
  the generator runs at ISTD's 480x640;
- down: LeakyReLU(0.2) (not at level 0) -> conv stride 2 -> BN (not at
  the outermost or innermost level); up: ReLU -> ConvTranspose(4, 2, 1)
  -> tanh at level 0, else BN;
- the skip concat is ``[leaky_relu(x), up]`` when the level's input had
  even H and W (the reference's in-place LeakyReLU mutates ``x`` before
  the concat reads it) and ``[x, up]`` when it was padded (the pad
  copied ``x`` first).

The JAX model's ``use_dropout`` (element-wise dropout 0.5 on the middle
levels, set by no caller in either package) is not carried over.

The up-convs run ``F.conv_transpose2d`` in train and eval: the JAX
package computes them outside any Pallas kernel. ``compute_dtype`` as in
``models/mnet.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from shadow_removal_istd_tpu_torch.models import layers as L
from shadow_removal_istd_tpu_torch.parallel import spatial


class Pix2PixUNet(nn.Module):
    """Recursive U-Net, channel plan in -> ngf -> 2ngf -> 4ngf -> 8ngf ->
    [8ngf x (num_downs-5)] -> bottleneck. ``drop_rate``, ``no_conv_t``,
    ``use_selu`` and ``activation`` are accepted for the registry's
    uniform keywords and unused, as in the JAX package (tanh out)."""

    def __init__(self, in_channels: int, out_channels: int, ngf: int = 64,
                 num_downs: int = 8, drop_rate: float = 0.0,
                 no_conv_t: bool = False, use_selu: bool = False,
                 activation: str | None = "tanh",
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.num_downs = num_downs
        self.compute_dtype = compute_dtype
        inner = [ngf, ngf * 2, ngf * 4] + [ngf * 8] * (num_downs - 3)
        last = num_downs - 1
        self.downs = nn.ModuleList(
            L.Conv(in_channels if lv == 0 else inner[lv - 1], inner[lv],
                   4, 2, 1, bias=False) for lv in range(num_downs))
        # BN after the down-conv of levels 1 .. num_downs-2
        self.down_bns = nn.ModuleList(L.BatchNorm(inner[lv])
                                      for lv in range(1, last))
        self.ups = nn.ModuleList(
            L.ConvTranspose(inner[lv] if lv == last else 2 * inner[lv],
                            out_channels if lv == 0 else inner[lv - 1],
                            4, 2, 1, bias=lv == 0)
            for lv in range(num_downs))
        # BN after the up-conv of levels 1 .. num_downs-1
        self.up_bns = nn.ModuleList(L.BatchNorm(inner[lv - 1])
                                    for lv in range(1, num_downs))

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.downs[0].weight.dtype

    def _block(self, x: torch.Tensor, level: int) -> torch.Tensor:
        outermost, innermost = level == 0, level == self.num_downs - 1
        # a row slab pads nothing: its rows split into stride pairs, or
        # the level is gathered and runs whole
        x = spatial.fit_rows(x, 2)
        h, w = x.shape[2], x.shape[3]
        ph, pw = h % 2, w % 2
        y = F.pad(x, (0, pw, 0, ph)) if ph or pw else x
        if not outermost:
            y = F.leaky_relu(y, 0.2)
        y = self.downs[level](y)
        if not outermost and not innermost:
            y = self.down_bns[level - 1](y)
        if not innermost:
            y = self._block(y, level + 1)
        y = self.ups[level](F.relu(y))
        if outermost:
            return torch.tanh(y)
        y = self.up_bns[level - 1](y)
        if ph or pw:
            return torch.cat([x, y[:, :, :h, :w]], dim=1)
        return torch.cat([F.leaky_relu(x, 0.2), y], dim=1)

    def forward(self, x: torch.Tensor, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` is accepted as every generator takes it; this
        one draws nothing."""
        return self._block(x.to(self.dtype), 0)


class NLayerDiscriminator(nn.Module):
    """Classic 70x70 PatchGAN: 4x4s2 stem conv (bias) + LeakyReLU;
    ``n_layers - 1`` 4x4s2 convs to ``ndf * min(2**n, 8)`` + BN +
    LeakyReLU; a 4x4s1 conv + BN + LeakyReLU; a 4x4s1 conv (bias) to one
    logit channel. ``out_channels`` and ``use_selu`` are accepted for the
    registry and unused, as in the JAX package."""

    def __init__(self, in_channels: int, ndf: int = 64, n_layers: int = 3,
                 use_sigmoid: bool = False, use_selu: bool = False,
                 out_channels: int | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        self.compute_dtype = compute_dtype
        mults = [min(2 ** n, 8) for n in range(n_layers + 1)]
        convs = [L.Conv(in_channels, ndf, 4, 2, 1, bias=True)]
        for n in range(1, n_layers + 1):
            convs.append(L.Conv(ndf * mults[n - 1], ndf * mults[n], 4,
                                2 if n < n_layers else 1, 1, bias=False))
        convs.append(L.Conv(ndf * mults[n_layers], 1, 4, 1, 1, bias=True))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(L.BatchNorm(ndf * mults[n])
                                 for n in range(1, n_layers + 1))

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.convs[0].weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.convs[0](x.to(self.dtype)), 0.2)
        for conv, bn in zip(self.convs[1:-1], self.bns):
            y = F.leaky_relu(bn(conv(y)), 0.2)
        y = self.convs[-1](y)
        return torch.sigmoid(y) if self.use_sigmoid else y
