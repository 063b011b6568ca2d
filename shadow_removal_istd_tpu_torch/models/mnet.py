"""M-Net generator.

Port of ``shadow_removal_istd_tpu/models/mnet.py``.

A 4x4-stride-2 reflect-conv stem, a depth-4 encoder of (LeakyReLU ->
4x4s2 reflect conv -> BN) blocks with channels capped at 8*ngf, a decoder
of (LeakyReLU -> 2x upsample -> BN) steps whose outputs concatenate the
matching encoder block's input, and a final upsample back to the input
resolution with the output activation.

Executed semantics carried over from the JAX package:

- the skip link is the encoder block's POST-LeakyReLU activation, and
  the next decoder step applies LeakyReLU to every part again, the link
  included (leaky twice on the link);
- the final upsample has no LeakyReLU and no BN (and no bias), then the
  activation;
- Dropout2d (``drop_rate``) on the concatenated output of every decoder
  step but the outermost, active in training only;
- split-skip (eval, nearest-upsample only) carries ``(y, link)`` tuples
  instead of their concat; the op sums per-part kernel slices.

Eval: every decoder step, the final one included, is one call of the
decoder op (``ops/decoder.py``); the JAX ``_Up`` takes one of two
branches by decoder area (>= 4500), both the same math, which here is
the one op. Train: the unfused differentiable form
(``layers.Upsample.train_forward``) with batch-statistics BN.

``compute_dtype`` (flax's ``dtype``): the input is cast to it and every
layer computes in it while the parameters keep their own dtype; None
computes in the parameter dtype.
``use_selu`` is accepted for the registry's uniform keywords and unused,
as in the JAX package and the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from shadow_removal_istd_tpu_torch.models import layers as L
from shadow_removal_istd_tpu_torch.parallel import spatial


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
    """LeakyReLU -> upsample -> BN, then the link: one decoder op in
    eval, the unfused form in training."""

    def __init__(self, cin: int, cout: int, no_conv_t: bool = True):
        super().__init__()
        self.up = L.Upsample(cin, cout, no_conv_t)
        self.bn = L.BatchNorm(cout)

    def forward(self, x, link, split: bool):
        if self.training:
            y = self.bn(self.up.train_forward(F.leaky_relu(x, 0.2)))
        else:
            y = self.up(x, leaky=True, bn=self.bn)
        if split:
            return (y, link)
        return torch.cat([y, link], dim=1)


class MNet(nn.Module):
    """Depth-4 encoder-decoder; output at input resolution."""

    def __init__(self, in_channels: int, out_channels: int, ngf: int = 64,
                 drop_rate: float = 0.0, no_conv_t: bool = True,
                 activation: str | None = "tanh", depth: int = 4,
                 split_skip: bool = False, use_selu: bool = False,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.depth = depth
        self.split = split_skip and no_conv_t
        self.compute_dtype = compute_dtype
        self.activation = L.get_activation(activation)
        self.drop = L.Dropout2d(drop_rate)
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
        """The compute dtype: ``compute_dtype``, else the parameters'."""
        return self.compute_dtype or self.stem.weight.dtype

    def freeze(self) -> None:
        """Fix every decoder step's eval phase kernel and affine for the
        current weights, dtype and device (``layers.Upsample.freeze``).
        Entering training mode drops them again."""
        for up in self.ups:
            up.up.freeze(self.dtype, up.bn)
        self.final.freeze(self.dtype)

    def train(self, mode: bool = True) -> "MNet":
        if mode:   # weights are about to change: no stale eval kernels
            for up in [*(u.up for u in self.ups), self.final]:
                up.frozen = None
        return super().train(mode)

    def forward(self, x: torch.Tensor, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` draws the Dropout2d masks (training with
        ``drop_rate > 0`` only)."""
        div = 2 ** (self.depth + 1)
        h = spatial.global_height(x)
        if h % div or x.shape[3] % div:
            raise ValueError(
                f"MNet(depth={self.depth}) needs H and W divisible by "
                f"{div}; got {h}x{x.shape[3]}. Pad or resize "
                "the input (ISTD's 480x640 divides).")
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        y = self.stem(x)
        links = []
        for down in self.downs:
            y, link = down(y)
            links.append(link)
        split = self.split and not self.training
        for k, (up, link) in enumerate(zip(self.ups, reversed(links))):
            y = up(y, link, split)
            if k < self.depth - 1:      # every level but the outermost
                y = self.drop(y, generator)
        y = self.final.train_forward(y) if self.training else self.final(y)
        return self.activation(y) if self.activation is not None else y
