"""Model registry with the JAX package's string keys; ``mnet`` and
``patchgan`` are ported so far."""

from __future__ import annotations

from typing import Any

from torch import nn

from shadow_removal_istd_tpu_torch.models.mnet import MNet
from shadow_removal_istd_tpu_torch.models.patchgan import PatchGAN

GENERATORS = {"mnet": MNet}
DISCRIMINATORS = {"patchgan": PatchGAN}


def get_generator(key: str, **kwargs: Any) -> nn.Module:
    """Instantiate a generator by registry key (case-insensitive)."""
    cls = GENERATORS.get(key.lower())
    if cls is None:
        raise NotImplementedError(f"generator {key!r} is not ported yet")
    return cls(**kwargs)


def get_discriminator(key: str, **kwargs: Any) -> nn.Module:
    """Instantiate a discriminator by registry key (case-insensitive);
    ``began``, ``stcgan`` and ``dummy`` are not ported yet."""
    cls = DISCRIMINATORS.get(key.lower())
    if cls is None:
        raise NotImplementedError(
            f"discriminator {key!r} is not ported yet")
    return cls(**kwargs)
