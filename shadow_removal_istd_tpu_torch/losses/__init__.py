"""Losses of the port: L1 and L2 data losses, adversarial losses, the
VGG visual loss (and its legacy sp-space form), BEGAN's k-balance and
SoftAdapt weighting."""

from shadow_removal_istd_tpu_torch.losses.adversarial import (  # noqa: F401
    AdversarialLoss,
    make_adversarial_loss,
)
from shadow_removal_istd_tpu_torch.losses.began_balance import (  # noqa: F401
    began_d_loss,
    began_k_update,
)
from shadow_removal_istd_tpu_torch.losses.data import (  # noqa: F401
    l1_loss,
    l2_loss,
)
from shadow_removal_istd_tpu_torch.losses.softadapt import (  # noqa: F401
    SoftAdaptState,
    softadapt_combine,
    softadapt_init,
    softadapt_update,
)
from shadow_removal_istd_tpu_torch.losses.visual import (  # noqa: F401
    sp_visual_loss,
    visual_loss,
)
