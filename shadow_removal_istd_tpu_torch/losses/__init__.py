"""Losses of the port: L1 data loss, adversarial losses and the VGG
visual loss."""

from shadow_removal_istd_tpu_torch.losses.adversarial import (  # noqa: F401
    AdversarialLoss,
    make_adversarial_loss,
)
from shadow_removal_istd_tpu_torch.losses.data import l1_loss  # noqa: F401
from shadow_removal_istd_tpu_torch.losses.visual import (  # noqa: F401
    visual_loss,
)
