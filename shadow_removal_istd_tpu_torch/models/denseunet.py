"""DenseUNet generator: a U-Net of DenseNet blocks.

Port of ``shadow_removal_istd_tpu/models/denseunet.py``: depth 5, growth
``ngf // 2``, 2 composite layers (BN -> LeakyReLU -> 3x3 reflect conv,
its output concatenated before its input) per dense block; bias-free
1x1 in and out convs; transition down = BN -> 1x1 conv -> avg-pool 2;
transition up = ConvTranspose(2, 2) ('VALID') or, with ``no_conv_t``,
nearest 2x then a 3x3 reflect conv (materialized, as in the JAX
package); each decoder level concatenates the encoder block's output and
runs a dense block, with Dropout2d after every level but the outermost.
Channels: ngf -> 2ngf per encoder block, 4ngf out of the bottleneck
(3 * 2 composite layers) and of each decoder block.

Its convs stay ``F.conv2d`` / ``F.conv_transpose2d``: the JAX package
computes them outside any Pallas kernel. ``use_selu`` is accepted for
the registry and unused, as in the JAX package and the reference.
``compute_dtype`` as in ``models/mnet.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from shadow_removal_istd_tpu_torch.models import layers as L
from shadow_removal_istd_tpu_torch.parallel import spatial


class _DenseBlock(nn.Module):
    """Iterative concat growth: ``x <- cat(conv(leaky(bn(x))), x)``."""

    def __init__(self, cin: int, num_layers: int, growth: int):
        super().__init__()
        chans = [cin + k * growth for k in range(num_layers)]
        self.bns = nn.ModuleList(L.BatchNorm(c) for c in chans)
        self.convs = nn.ModuleList(L.ConvReflect(c, growth, 3, 1, 1)
                                   for c in chans)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for bn, conv in zip(self.bns, self.convs):
            x = torch.cat([conv(F.leaky_relu(bn(x), 0.2)), x], dim=1)
        return x


class _TransDown(nn.Module):
    """BN -> 1x1 conv -> avg-pool 2."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.bn = L.BatchNorm(cin)
        self.conv = L.Conv(cin, cout, 1, 1, 0, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.avg_pool(self.conv(self.bn(x)), 2)


class _TransUp(nn.Module):
    """ConvTranspose(2, 2) or nearest 2x + 3x3 reflect conv."""

    def __init__(self, cin: int, cout: int, no_conv_t: bool = False):
        super().__init__()
        self.no_conv_t = no_conv_t
        self.conv = (L.ConvReflect(cin, cout, 3, 1, 1) if no_conv_t
                     else L.ConvTranspose(cin, cout, 2, 2, 0, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.no_conv_t:
            x = L.upsample_nearest(x, 2)
        return self.conv(x)


class DenseUNet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, ngf: int = 48,
                 drop_rate: float = 0.0, no_conv_t: bool = False,
                 use_selu: bool = False, activation: str | None = "tanh",
                 depth: int = 5, n_composite: int = 2,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.depth = depth
        self.compute_dtype = compute_dtype
        self.activation = L.get_activation(activation)
        self.drop = L.Dropout2d(drop_rate)
        growth, n = ngf // n_composite, n_composite
        self.in_conv = L.Conv(in_channels, ngf, 1, 1, 0, bias=False)
        link = ngf + n * growth
        self.enc = nn.ModuleList(_DenseBlock(ngf, n, growth)
                                 for _ in range(depth))
        self.tdown = nn.ModuleList(_TransDown(link, ngf)
                                   for _ in range(depth))
        self.bottleneck = _DenseBlock(ngf, 3 * n, growth)
        top = ngf + 3 * n * growth             # out of the bottleneck
        dec_out = ngf + link + n * growth      # out of a decoder block
        # creation order = the JAX numbering: tup[0] / dec[0] are the
        # innermost level
        self.tup = nn.ModuleList(
            _TransUp(top if k == 0 else dec_out, ngf, no_conv_t)
            for k in range(depth))
        self.dec = nn.ModuleList(_DenseBlock(ngf + link, n, growth)
                                 for _ in range(depth))
        self.out_conv = L.Conv(dec_out, out_channels, 1, 1, 0, bias=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.in_conv.weight.dtype

    def forward(self, x: torch.Tensor, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` draws the Dropout2d masks (training with
        ``drop_rate > 0`` only)."""
        div = 2 ** self.depth
        h = spatial.global_height(x)
        if h % div or x.shape[3] % div:
            raise ValueError(
                f"DenseUNet(depth={self.depth}) needs H and W divisible "
                f"by {div}; got {h}x{x.shape[3]}. Pad or resize "
                "the input (the pix2pix 'stcgan' generator handles odd "
                "sizes natively).")
        y = self.in_conv(x.to(self.dtype))
        links = []
        for block, down in zip(self.enc, self.tdown):
            links.append(block(y))
            y = down(links[-1])
        y = self.bottleneck(y)
        for k, (up, block) in enumerate(zip(self.tup, self.dec)):
            i = self.depth - 1 - k
            y = block(torch.cat([up(y), links[i]], dim=1))
            if i > 0:
                y = self.drop(y, generator)
        y = self.out_conv(y)
        return self.activation(y) if self.activation is not None else y
