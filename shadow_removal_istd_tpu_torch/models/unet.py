"""U-Net generator.

Port of ``shadow_removal_istd_tpu/models/unet.py``: a depth-4 U-Net of
double 3x3 reflect-conv blocks (each conv followed by LeakyReLU + BN, or
SELU), max-pool downsampling, a 2x upsample then a double conv on the
skip concatenation at each decoder level, and a final bias-free 1x1 conv
with the output activation.

The decoder's upsamples are the port's ``layers.Upsample`` (nearest +
3x3 reflect conv with ``no_conv_t``, else ConvTranspose(4, 2, 1)), bias
free and without LeakyReLU or BatchNorm of their own. Eval: each is one
call of the decoder op (``ops/decoder.py``), the K1 kernel on the card;
train: ``Upsample.train_forward``. Dropout2d (``drop_rate``, from the
``generator`` passed to ``forward``) follows every decoder level but the
outermost; it is Dropout2d even under SELU, as in the JAX package and
the reference. ``compute_dtype`` as in ``models/mnet.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from shadow_removal_istd_tpu_torch.models import layers as L
from shadow_removal_istd_tpu_torch.parallel import spatial


class _DoubleConv(nn.Module):
    """conv3x3 -> act/norm -> conv3x3 -> act/norm."""

    def __init__(self, cin: int, cout: int, use_selu: bool = False):
        super().__init__()
        self.conv0 = L.ConvReflect(cin, cout, 3, 1, 1)
        self.norm0 = L.ActNorm(cout, use_selu)
        self.conv1 = L.ConvReflect(cout, cout, 3, 1, 1)
        self.norm1 = L.ActNorm(cout, use_selu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm1(self.conv1(self.norm0(self.conv0(x))))


class UNet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, ngf: int = 64,
                 drop_rate: float = 0.0, no_conv_t: bool = False,
                 use_selu: bool = False, activation: str | None = "tanh",
                 depth: int = 4, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.depth = depth
        self.compute_dtype = compute_dtype
        self.activation = L.get_activation(activation)
        self.drop = L.Dropout2d(drop_rate)
        feats = [ngf * 2 ** i for i in range(depth + 1)]
        self.downs = nn.ModuleList(
            _DoubleConv(in_channels if i == 0 else feats[i - 1], feats[i],
                        use_selu) for i in range(depth))
        self.bottleneck = _DoubleConv(feats[depth - 1], feats[depth],
                                      use_selu)
        # creation order = the JAX numbering: ups[0] / dec[0] are the
        # innermost level (i = depth-1)
        levels = list(reversed(range(depth)))
        self.ups = nn.ModuleList(
            L.Upsample(feats[i + 1], feats[i], no_conv_t) for i in levels)
        self.dec = nn.ModuleList(
            _DoubleConv(2 * feats[i], feats[i], use_selu) for i in levels)
        self.final = L.Conv(feats[0], out_channels, 1, 1, 0, bias=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.final.weight.dtype

    def forward(self, x: torch.Tensor, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` draws the Dropout2d masks (training with
        ``drop_rate > 0`` only)."""
        div = 2 ** self.depth
        h = spatial.global_height(x)
        if h % div or x.shape[3] % div:
            raise ValueError(
                f"UNet(depth={self.depth}) needs H and W divisible by "
                f"{div}; got {h}x{x.shape[3]}. Pad or resize "
                "the input (the pix2pix 'stcgan' generator handles odd "
                "sizes natively).")
        y = x.to(self.dtype)
        links = []
        for down in self.downs:
            y = down(y)
            links.append(y)
            y = L.max_pool(y, 2)
        y = self.bottleneck(y)
        for k, (up, block) in enumerate(zip(self.ups, self.dec)):
            i = self.depth - 1 - k
            y = up.train_forward(y) if self.training else up(y)
            y = block(torch.cat([y, links[i]], dim=1))
            if i > 0:
                y = self.drop(y, generator)
        y = self.final(y)
        return self.activation(y) if self.activation is not None else y
