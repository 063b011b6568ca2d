"""A stand-in for the reference implementation's model classes.

The torch checkpoint tools (``tools/export_torch.py``,
``tools/torch_bridge.py`` in both packages) import the reference's
``src.networks`` from the repository root the user names. Where that
repository is not at hand, :func:`write_reference` writes a root whose
``src/networks.py`` builds the reference's default pair, MNet
(reference ``src/models/mnet.py``) and PatchGAN
(``src/models/patchgan.py``), from plain ``nn.Conv2d``,
``nn.ConvTranspose2d``, ``nn.BatchNorm2d`` and ``nn.ReflectionPad2d``,
with the reference's factory keywords. Other networks raise.

Every container registers its submodules in another order than its
forward runs them (the decoder before the encoder, the output layer
before the input one), so a bridge that walked the registration order
would pair the wrong layers: only the hook walk of the forward pairs
them right.

Imports ``torch`` only; the CPU tests and ``chip_smoke.py`` load this
one file.
"""

from __future__ import annotations

import importlib
from pathlib import Path

NETWORKS = '''"""Stand-in for the reference's src/networks.py."""
import torch
import torch.nn.functional as F
from torch import nn


def _activation(key):
    if key is None or key == "none":
        return nn.Identity()
    return {"sigmoid": nn.Sigmoid(), "tanh": nn.Tanh(),
            "htanh": nn.Hardtanh()}[key]


def _norm(c, use_selu):
    """SELU, or LeakyReLU(0.2) then BatchNorm."""
    if use_selu:
        return nn.SELU()
    return nn.Sequential(nn.LeakyReLU(0.2), nn.BatchNorm2d(c))


def _upsample(cin, cout, no_conv_t):
    """Nearest 2x + 3x3 reflect conv, or ConvTranspose2d(4, 2, 1)."""
    if no_conv_t:
        return nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"),
                             nn.ReflectionPad2d(1),
                             nn.Conv2d(cin, cout, 3, 1, 0, bias=False))
    return nn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=False)


class _Down(nn.Module):
    """LeakyReLU -> 4x4s2 reflect conv -> BN; the link is the
    activation after the LeakyReLU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.bn = nn.BatchNorm2d(cout)
        self.conv = nn.Sequential(nn.ReflectionPad2d(1),
                                  nn.Conv2d(cin, cout, 4, 2, 0, bias=False))

    def forward(self, x):
        a = F.leaky_relu(x, 0.2)
        return self.bn(self.conv(a)), a


class _Up(nn.Module):
    """LeakyReLU -> upsample -> BN."""

    def __init__(self, cin, cout, no_conv_t):
        super().__init__()
        self.bn = nn.BatchNorm2d(cout)
        self.up = _upsample(cin, cout, no_conv_t)

    def forward(self, x):
        return self.bn(self.up(F.leaky_relu(x, 0.2)))


class SkipConnectionLayer(nn.Module):
    """down -> submodule -> up, then concat(up, link) and dropout."""

    def __init__(self, down, submodule, up, drop_rate):
        super().__init__()
        self.up_block = up
        self.submodule = submodule
        self.down_block = down
        self.dropout = nn.Dropout2d(drop_rate) if drop_rate else None

    def forward(self, x):
        y, link = self.down_block(x)
        if self.submodule is not None:
            y = self.submodule(y)
        y = torch.cat([self.up_block(y), link], dim=1)
        return self.dropout(y) if self.dropout is not None else y


class MNet(nn.Module):
    def __init__(self, in_channels, out_channels, ngf=64, drop_rate=0.0,
                 no_conv_t=True, use_selu=False, activation="tanh",
                 depth=4):
        super().__init__()
        down = [(2 ** min(i + 1, 3)) * ngf for i in range(depth)]
        up = [(2 ** min(i, 3)) * ngf for i in range(depth)]
        cins = [ngf] + down[:-1]
        self.output = nn.Sequential(_upsample(2 * up[0], out_channels,
                                              no_conv_t),
                                    _activation(activation))
        block = None
        for i in reversed(range(depth)):
            cin = down[-1] if i == depth - 1 else 2 * up[i + 1]
            block = SkipConnectionLayer(
                _Down(cins[i], down[i]), block, _Up(cin, up[i], no_conv_t),
                drop_rate if i > 0 else 0.0)
        self.model = block
        self.input = nn.Sequential(
            nn.ReflectionPad2d(1),
            nn.Conv2d(in_channels, ngf, 4, 2, 0, bias=False))

    def forward(self, x):
        return self.output(self.model(self.input(x)))


class PatchGAN(nn.Module):
    def __init__(self, in_channels, out_channels=1, ndf=64, n_layers=3,
                 use_selu=False, use_sigmoid=False):
        super().__init__()
        body, prev = [], ndf
        for n in range(1, n_layers):
            feats = prev * 2 if n < 4 else prev
            body += [nn.ReflectionPad2d(1),
                     nn.Conv2d(prev, feats, 4, 2, 0, bias=False),
                     _norm(feats, use_selu)]
            prev = feats
        tail = prev * 2 if n_layers < 4 else prev
        body += [nn.ReflectionPad2d(1),
                 nn.Conv2d(prev, tail, 3, 1, 0, bias=False),
                 _norm(tail, use_selu)]
        self.final = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(tail, 1, 3, 1, 0, bias=False),
            *([nn.Sigmoid()] if use_sigmoid else []))
        self.body = nn.Sequential(*body)
        self.stem = nn.Sequential(nn.Conv2d(in_channels, ndf, 4, 2, 1),
                                  nn.LeakyReLU(0.2))

    def forward(self, x):
        return self.final(self.body(self.stem(x)))


def get_generator(name, **kwargs):
    if name.lower() != "mnet":
        raise ValueError(f"the stand-in reference builds mnet only, not "
                         f"{name!r}")
    return MNet(**kwargs)


def get_discriminator(name, **kwargs):
    if name.lower() != "patchgan":
        raise ValueError(f"the stand-in reference builds patchgan only, "
                         f"not {name!r}")
    return PatchGAN(**kwargs)
'''


def write_reference(root) -> Path:
    """Write the stand-in reference under ``root`` (``root/src/``) and
    return ``root``, ready for ``--reference-path``."""
    src = Path(root) / "src"
    src.mkdir(parents=True, exist_ok=True)
    (src / "__init__.py").write_text("")
    (src / "networks.py").write_text(NETWORKS)
    importlib.invalidate_caches()
    return Path(root)
