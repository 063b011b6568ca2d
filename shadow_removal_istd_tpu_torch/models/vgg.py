"""VGG-19-BN feature extractor for the perceptual (visual) loss.

Port of ``shadow_removal_istd_tpu/models/vgg.py``: torchvision
``vgg19_bn().features[:40]``, conv blocks 1-4 through pool4, with frozen
BatchNorm (running statistics, as ``.eval()``). It always computes in
f32, as flax promotes a bf16 input against f32 weights.

Weights: :func:`load_vgg_npz` reads the ``.npz`` that
``shadow_removal_istd_tpu/tools/convert_vgg.py`` writes
(``conv{i}_kernel`` HWIO, ``conv{i}_bias``, ``bn{i}_scale/bias/mean/
var``); :func:`init_vgg_` gives seeded random weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from shadow_removal_istd_tpu_torch.models.layers import conv2d_rows, max_pool
from shadow_removal_istd_tpu_torch.parallel import spatial

# torchvision vgg19 cfg "E" through pool4: features[:40]
VGG19_CFG_THROUGH_POOL4 = (
    64, 64, "M",
    128, 128, "M",
    256, 256, 256, 256, "M",
    512, 512, 512, 512, "M",
)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class _ConvBN(nn.Module):
    """3x3 conv (zero pad, bias) -> frozen BN -> ReLU."""

    def __init__(self, cin: int, cout: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.bn_weight = nn.Parameter(torch.ones(cout))
        self.bn_bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("running_mean", torch.zeros(cout))
        self.register_buffer("running_var", torch.ones(cout))

    @spatial.native
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_rows(x, self.weight, self.bias, 1, 1)
        slab = spatial.is_sharded(y)
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(self.running_var + self.eps) * self.bn_weight
        y = ((y - self.running_mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
             + self.bn_bias.view(1, -1, 1, 1))
        return spatial.mark_rows(F.relu(y), slab)


class _MaxPool(nn.Module):
    """2x2 max pool, stride 2 (``layers.max_pool``: a row slab whose
    rows do not split into pairs is gathered)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(x, 2)


class VGG19Features(nn.Module):
    """Frozen VGG-19-BN features through pool4 (NCHW, f32)."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for spec in VGG19_CFG_THROUGH_POOL4:
            if spec == "M":
                layers.append(_MaxPool())
            else:
                layers.append(_ConvBN(cin, spec))
                cin = spec
        self.layers = nn.Sequential(*layers)
        self.requires_grad_(False)

    def convbns(self) -> list[_ConvBN]:
        return [m for m in self.layers if isinstance(m, _ConvBN)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x.float())


def imagenet_normalize(img_01: torch.Tensor) -> torch.Tensor:
    """Normalize a [0,1] NCHW image with ImageNet statistics, in the
    image's dtype."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img_01.dtype,
                        device=img_01.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=img_01.dtype,
                       device=img_01.device).view(1, 3, 1, 1)
    return (img_01 - mean) / std


def load_vgg_npz(path: str, module: VGG19Features | None = None
                 ) -> VGG19Features:
    """Fill ``module`` (a new one when None) from a converted ``.npz``;
    raises on a missing key or a shape mismatch."""
    module = module if module is not None else VGG19Features()
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    with torch.no_grad():
        for i, m in enumerate(module.convbns()):
            src = {
                m.weight: data[f"conv{i}_kernel"].transpose(3, 2, 0, 1),
                m.bias: data[f"conv{i}_bias"],
                m.bn_weight: data[f"bn{i}_scale"],
                m.bn_bias: data[f"bn{i}_bias"],
                m.running_mean: data[f"bn{i}_mean"],
                m.running_var: data[f"bn{i}_var"],
            }
            for dst, arr in src.items():
                if tuple(arr.shape) != tuple(dst.shape):
                    raise ValueError(f"vgg layer {i}: shape {arr.shape} "
                                     f"does not match {tuple(dst.shape)}")
                dst.copy_(torch.from_numpy(
                    np.ascontiguousarray(arr, np.float32)))
    return module


@torch.no_grad()
def init_vgg_(module: VGG19Features, generator: torch.Generator
              ) -> VGG19Features:
    """Seeded random weights: Kaiming-normal convs (ReLU gain, so
    features stay O(1) through 12 convs), zero biases, identity BN."""
    for m in module.convbns():
        fan_in = m.weight.shape[1] * 9
        m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
        m.bias.zero_()
        m.bn_weight.fill_(1.0)
        m.bn_bias.zero_()
        m.running_mean.zero_()
        m.running_var.fill_(1.0)
    return module
