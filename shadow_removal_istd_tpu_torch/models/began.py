"""BEGAN autoencoder discriminator.

Port of ``shadow_removal_istd_tpu/models/began.py``: a 3x3 conv (bias)
+ ActNorm stem; ``n_layers - 1`` encoder stages of 3x3 conv to ``ndf*n``
channels + ActNorm + max-pool 2; a two-conv bottleneck (no norm); a
decoder of (3x3 conv + ActNorm + nearest 2x) stages, each but the last
followed by the concat ``[bottleneck upsampled to its scale, y]``; a 3x3
out conv to ``out_channels`` (the input's channels when None) with tanh
(or sigmoid). Every conv is zero-padded with a bias. The output has the
input's size; the engine's k-balance scores its L1 reconstruction.
``compute_dtype`` as in ``models/mnet.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from shadow_removal_istd_tpu_torch.models import layers as L


def _conv3(cin: int, cout: int) -> L.Conv:
    return L.Conv(cin, cout, 3, 1, 1, bias=True)


class BEGAN(nn.Module):
    def __init__(self, in_channels: int, out_channels: int | None = None,
                 ndf: int = 64, n_layers: int = 3, use_selu: bool = False,
                 use_sigmoid: bool = False,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        self.compute_dtype = compute_dtype
        self.stem = _conv3(in_channels, ndf)
        self.stem_norm = L.ActNorm(ndf, use_selu)
        enc = [ndf * n for n in range(1, n_layers)]
        self.enc_convs = nn.ModuleList(
            _conv3(([ndf] + enc)[k], c) for k, c in enumerate(enc))
        self.enc_norms = nn.ModuleList(L.ActNorm(c, use_selu) for c in enc)
        self.mid = nn.ModuleList([_conv3(enc[-1] if enc else ndf, ndf),
                                  _conv3(ndf, ndf)])
        n_dec = n_layers - 1
        self.dec_convs = nn.ModuleList(
            _conv3(ndf if i == 0 else 2 * ndf, ndf) for i in range(n_dec))
        self.dec_norms = nn.ModuleList(L.ActNorm(ndf, use_selu)
                                       for _ in range(n_dec))
        self.out = _conv3(ndf, in_channels if out_channels is None
                          else out_channels)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.stem.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.stem_norm(self.stem(x.to(self.dtype)))
        for conv, norm in zip(self.enc_convs, self.enc_norms):
            y = L.max_pool(norm(conv(y)), 2)
        bottleneck = self.mid[1](self.mid[0](y))
        y = bottleneck
        n_dec = len(self.dec_convs)
        for i, (conv, norm) in enumerate(zip(self.dec_convs,
                                             self.dec_norms)):
            y = L.upsample_nearest(norm(conv(y)), 2)
            if i < n_dec - 1:
                skip = L.upsample_nearest(bottleneck, 2 ** (i + 1))
                y = torch.cat([skip, y], dim=1)
        y = self.out(y)
        return torch.sigmoid(y) if self.use_sigmoid else torch.tanh(y)
