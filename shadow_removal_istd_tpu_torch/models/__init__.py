"""Models of the port: MNet generators, PatchGAN discriminators and the
VGG-19-BN feature extractor of the visual loss."""

from shadow_removal_istd_tpu_torch.models.mnet import MNet  # noqa: F401
from shadow_removal_istd_tpu_torch.models.patchgan import (  # noqa: F401
    PatchGAN,
)
from shadow_removal_istd_tpu_torch.models.registry import (  # noqa: F401
    get_discriminator,
    get_generator,
)
