"""Generators of the port (eval mode)."""

from shadow_removal_istd_tpu_torch.models.mnet import MNet  # noqa: F401
from shadow_removal_istd_tpu_torch.models.registry import (  # noqa: F401
    get_generator,
)
