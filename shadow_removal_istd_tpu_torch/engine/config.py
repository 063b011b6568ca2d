"""Training configuration; port of
``shadow_removal_istd_tpu/engine/config.py`` with the same fields and
defaults. ``remat`` rematerializes the train step's three regions
(``engine/steps.py``): activation memory for recomputed forwards."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TrainConfig:
    # models
    net_g: str = "mnet"
    net_d: str = "patchgan"
    ngf: int = 64
    ndf: int = 64
    droprate: float = 0.05
    nn_upconv: bool = False     # --NN-upconv
    use_selu: bool = False      # --SELU
    activation: str = "tanh"

    # optimization
    lr_g: float = 5e-4
    lr_d: float = 1e-4
    decay: float = 0.003        # per-epoch exponential decay, gamma=1-decay
    beta1: float = 0.5
    beta2: float = 0.999
    adam_eps: float = 1e-8

    # loss weights
    lambda1: float = 5.0        # data2 (shadow-free L1)
    lambda2: float = 0.5        # adversarial G1/D1
    lambda3: float = 0.5        # adversarial G2/D2
    lambda4: float = 5.0        # visual matte
    lambda5: float = 50.0       # visual shadow-free

    # adversarial flavour
    d_loss_fn: str = "standard"   # {standard, leastsquare}
    d_type: str = "normal"        # {normal, rel, rel_avg}
    loss_mode: str = "reference"  # reference-exact vs corrected semantics
    softadapt: bool = False

    # data/augmentation
    image_size: int = 256
    batch_size: int = 16
    aug_scale: float = 0.05
    aug_angle: float = 15.0
    aug_method: str = "gather"    # or "shear" (the hshear kernel path)

    # legacy-tree options
    lr_schedule: str = "exponential"   # or "plateau" (ReduceLROnPlateau)
    aug_resize: tuple | None = None
    valid_resize: tuple | None = None
    infer_resize: tuple | None = None
    dcgan_init: bool = False
    dcgan_bn_compat: bool = False
    train_datas: tuple = ("img", "target", "matte")

    # runtime
    remat: bool = False
    steps_per_epoch: int = 1      # for the per-epoch lr decay schedule
    use_visual_loss: bool = True  # needs VGG weights
    compute_dtype: str = "float32"  # or "bfloat16": bf16 activations and
    # convs, f32 params/BatchNorm statistics/losses/optimizer

    def __post_init__(self):
        if self.net_d == "dummy":
            # the reference zeroes the adversarial terms for the dummy D
            object.__setattr__(self, "lambda2", 0.0)
            object.__setattr__(self, "lambda3", 0.0)
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be float32 or bfloat16, "
                             f"got {self.compute_dtype!r}")

    @property
    def began(self) -> bool:
        return self.net_d == "began"
