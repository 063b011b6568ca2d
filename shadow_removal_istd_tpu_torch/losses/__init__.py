"""Losses of the port: L1 data loss, adversarial losses, the VGG visual
loss, BEGAN's k-balance and SoftAdapt weighting."""

from shadow_removal_istd_tpu_torch.losses.adversarial import (  # noqa: F401
    AdversarialLoss,
    make_adversarial_loss,
)
from shadow_removal_istd_tpu_torch.losses.began_balance import (  # noqa: F401
    began_d_loss,
    began_k_update,
)
from shadow_removal_istd_tpu_torch.losses.data import l1_loss  # noqa: F401
from shadow_removal_istd_tpu_torch.losses.softadapt import (  # noqa: F401
    SoftAdaptState,
    softadapt_combine,
    softadapt_init,
    softadapt_update,
)
from shadow_removal_istd_tpu_torch.losses.visual import (  # noqa: F401
    visual_loss,
)
