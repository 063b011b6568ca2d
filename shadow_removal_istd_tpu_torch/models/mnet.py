"""M-Net generator in eval mode.

Port of ``shadow_removal_istd_tpu/models/mnet.py``.

A 4x4-stride-2 reflect-conv stem, a depth-4 encoder of (LeakyReLU ->
4x4s2 reflect conv -> BN) blocks with channels capped at 8*ngf, a decoder
of (LeakyReLU -> 2x upsample -> BN) steps whose outputs concatenate the
matching encoder block's input, and a final upsample back to the input
resolution with the output activation. Every decoder step, the final one
included, is one call of the decoder op (``ops/decoder.py``).

Executed semantics carried over from the JAX package:

- the skip link is the encoder block's POST-LeakyReLU activation, and
  the next decoder step applies LeakyReLU to every part again, the link
  included (leaky twice on the link);
- the final upsample has no LeakyReLU and no BN (and no bias), then the
  activation;
- split-skip (eval, nearest-upsample only) carries ``(y, link)`` tuples
  instead of their concat; the op sums per-part kernel slices.

The JAX ``_Up`` takes one of two branches by decoder area (>= 4500);
both compute the same math, which here is the one op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from shadow_removal_istd_tpu_torch.models import layers as L


class _Down(nn.Module):
    """LeakyReLU -> 4x4s2 reflect conv -> BN; also returns the link."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = L.ConvReflect(cin, cout, 4, 2, 1)
        self.bn = L.BatchNorm(cout)

    def forward(self, x):
        a = F.leaky_relu(x, 0.2)
        return self.bn(self.conv(a)), a


class _Up(nn.Module):
    """LeakyReLU -> upsample -> BN as one decoder op, then the link."""

    def __init__(self, cin: int, cout: int, no_conv_t: bool = True):
        super().__init__()
        self.up = L.Upsample(cin, cout, no_conv_t)
        self.bn = L.BatchNorm(cout)

    def forward(self, x, link, split: bool):
        y = self.up(x, leaky=True, bn=self.bn)
        if split:
            return (y, link)
        return torch.cat([y, link], dim=1)


class MNet(nn.Module):
    """Depth-4 encoder-decoder; output at input resolution. Eval only:
    the training forward is not ported yet."""

    def __init__(self, in_channels: int, out_channels: int, ngf: int = 64,
                 no_conv_t: bool = True, activation: str | None = "tanh",
                 depth: int = 4, split_skip: bool = False):
        super().__init__()
        # the JAX MNet's skip-level Dropout2d is the identity in eval and
        # its use_selu is unused, so neither is carried over
        self.depth = depth
        self.split = split_skip and no_conv_t
        self.activation = L.get_activation(activation)
        down_feats = [(2 ** min(i + 1, 3)) * ngf for i in range(depth)]
        up_feats = [(2 ** min(i, 3)) * ngf for i in range(depth)]
        self.stem = L.ConvReflect(in_channels, ngf, 4, 2, 1)
        cins = [ngf] + down_feats[:-1]
        self.downs = nn.ModuleList(
            _Down(cins[i], down_feats[i]) for i in range(depth))
        # creation order = the JAX package's _Up_k numbering: ups[0] is
        # the innermost level (i = depth-1)
        self.ups = nn.ModuleList(
            _Up(down_feats[-1] if i == depth - 1 else 2 * up_feats[i + 1],
                up_feats[i], no_conv_t)
            for i in reversed(range(depth)))
        self.final = L.Upsample(2 * up_feats[0], out_channels, no_conv_t)

    @property
    def dtype(self) -> torch.dtype:
        return self.stem.weight.dtype

    def freeze(self) -> None:
        """Fix every decoder step's phase kernel and affine for the
        current weights, dtype and device (``layers.Upsample.freeze``)."""
        for up in self.ups:
            up.up.freeze(up.bn)
        self.final.freeze()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "MNet training forward is not ported yet; call .eval()")
        div = 2 ** (self.depth + 1)
        if x.shape[2] % div or x.shape[3] % div:
            raise ValueError(
                f"MNet(depth={self.depth}) needs H and W divisible by "
                f"{div}; got {x.shape[2]}x{x.shape[3]}. Pad or resize "
                "the input (ISTD's 480x640 divides).")
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        y = self.stem(x)
        links = []
        for down in self.downs:
            y, link = down(y)
            links.append(link)
        for up, link in zip(self.ups, reversed(links)):
            y = up(y, link, self.split)
        y = self.final(y)
        return self.activation(y) if self.activation is not None else y
