"""Models of the port: the JAX package's generator and discriminator
zoo by registry key, and the VGG-19-BN feature extractor of the visual
loss."""

from shadow_removal_istd_tpu_torch.models.began import BEGAN  # noqa: F401
from shadow_removal_istd_tpu_torch.models.denseunet import (  # noqa: F401
    DenseUNet,
)
from shadow_removal_istd_tpu_torch.models.dummy import DummyNet  # noqa: F401
from shadow_removal_istd_tpu_torch.models.mnet import MNet  # noqa: F401
from shadow_removal_istd_tpu_torch.models.patchgan import (  # noqa: F401
    PatchGAN,
)
from shadow_removal_istd_tpu_torch.models.pix2pix import (  # noqa: F401
    NLayerDiscriminator,
    Pix2PixUNet,
)
from shadow_removal_istd_tpu_torch.models.registry import (  # noqa: F401
    get_discriminator,
    get_generator,
)
from shadow_removal_istd_tpu_torch.models.unet import UNet  # noqa: F401
