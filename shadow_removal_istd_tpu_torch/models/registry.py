"""Model registry with the JAX package's string keys; only ``mnet`` is
ported so far."""

from __future__ import annotations

from typing import Any

from torch import nn

from shadow_removal_istd_tpu_torch.models.mnet import MNet

GENERATORS = {"mnet": MNet}


def get_generator(key: str, **kwargs: Any) -> nn.Module:
    """Instantiate a generator by registry key (case-insensitive)."""
    cls = GENERATORS.get(key.lower())
    if cls is None:
        raise NotImplementedError(f"generator {key!r} is not ported yet")
    return cls(**kwargs)
