"""Model registry with the JAX package's string keys (case-insensitive);
``stcgan`` is the pix2pix U-Net G and the NLayer D, as there."""

from __future__ import annotations

from typing import Any

from torch import nn

from shadow_removal_istd_tpu_torch.models.began import BEGAN
from shadow_removal_istd_tpu_torch.models.denseunet import DenseUNet
from shadow_removal_istd_tpu_torch.models.dummy import DummyNet
from shadow_removal_istd_tpu_torch.models.mnet import MNet
from shadow_removal_istd_tpu_torch.models.patchgan import PatchGAN
from shadow_removal_istd_tpu_torch.models.pix2pix import (
    NLayerDiscriminator,
    Pix2PixUNet,
)
from shadow_removal_istd_tpu_torch.models.unet import UNet

GENERATORS = {
    "unet": UNet,
    "mnet": MNet,
    "denseunet": DenseUNet,
    "stcgan": Pix2PixUNet,
}

DISCRIMINATORS = {
    "patchgan": PatchGAN,
    "began": BEGAN,
    "stcgan": NLayerDiscriminator,
    "dummy": DummyNet,
}


def get_generator(key: str, **kwargs: Any) -> nn.Module:
    """Instantiate a generator by registry key."""
    return GENERATORS[key.lower()](**kwargs)


def get_discriminator(key: str, **kwargs: Any) -> nn.Module:
    """Instantiate a discriminator by registry key; the dummy D has one
    output channel unless told otherwise."""
    cls = DISCRIMINATORS[key.lower()]
    if cls is DummyNet:
        kwargs.setdefault("out_channels", 1)
    return cls(**kwargs)
