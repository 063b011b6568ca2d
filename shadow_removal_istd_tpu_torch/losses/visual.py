"""VGG-19-BN perceptual ("visual") loss; port of
``shadow_removal_istd_tpu/losses/visual.py``.

Predictions and targets map from [-1, 1] to [0, 1], a 1-channel matte is
broadcast to 3 channels, ImageNet normalisation runs in the input's
dtype, then the frozen VGG (in f32) runs through pool4; the loss is the
MSE of the features, with the target branch under ``no_grad``. While
tracing is on, each VGG backward of a prediction is a device span,
``step.visual_backward`` (``utils/profiling.py::backward_span``). The
training tensors' channel order goes in as it is (the reference feeds
BGR into the RGB-normalised VGG; the quirk is kept).
:func:`sp_visual_loss` is the legacy sp-space form.
"""

from __future__ import annotations

import torch

from shadow_removal_istd_tpu_torch.data.h5 import ISTD_MEAN, ISTD_STD
from shadow_removal_istd_tpu_torch.models.layers import replaying
from shadow_removal_istd_tpu_torch.models.vgg import (
    VGG19Features,
    imagenet_normalize,
)
from shadow_removal_istd_tpu_torch.utils.profiling import backward_span


def _features(vgg: VGG19Features, img_pm1: torch.Tensor) -> torch.Tensor:
    img = img_pm1 * 0.5 + 0.5
    if img.shape[1] == 1:
        img = img.expand(-1, 3, -1, -1)
    x = imagenet_normalize(img)
    f = vgg(x)
    if not replaying():
        # the VGG's backward: from the features' gradient to its input's
        backward_span("step.visual_backward", f, x)
    return f


def target_features(vgg: VGG19Features,
                    target_pm1: torch.Tensor) -> torch.Tensor:
    """The target branch's VGG features, under ``no_grad``."""
    with torch.no_grad():
        return _features(vgg, target_pm1)


def visual_loss_to(vgg: VGG19Features, pred_pm1: torch.Tensor,
                   f_target: torch.Tensor) -> torch.Tensor:
    """Feature-space MSE against precomputed :func:`target_features`."""
    return (_features(vgg, pred_pm1) - f_target).square().mean()


def visual_loss(vgg: VGG19Features, pred_pm1: torch.Tensor,
                target_pm1: torch.Tensor) -> torch.Tensor:
    """Feature-space MSE; gradient flows through the pred branch only."""
    f_pred = _features(vgg, pred_pm1)
    f_target = target_features(vgg, target_pm1)
    return (f_pred - f_target).square().mean()


def sp_visual_loss(vgg: VGG19Features, x_norm: torch.Tensor,
                   sp_pred: torch.Tensor,
                   img_target01: torch.Tensor) -> torch.Tensor:
    """Legacy sp-space perceptual loss (reference STCGAN/loss.py:42-56),
    on (N, 3, H, W) tensors: the mean/std-normalised input is
    denormalised with the ISTD statistics (B, G, R; ``data/h5.py``),
    multiplied by ``sp_pred`` and clamped to [0, 1], and the VGG
    features of that reconstruction are matched against those of the
    [0, 1] target. As in the reference, no ImageNet normalisation runs
    before the VGG, and the target branch is under ``no_grad``. Dormant
    in the reference's training; kept for API completeness."""
    shape = (1, -1, 1, 1)
    std = torch.as_tensor(ISTD_STD, dtype=x_norm.dtype,
                          device=x_norm.device).view(shape)
    mean = torch.as_tensor(ISTD_MEAN, dtype=x_norm.dtype,
                           device=x_norm.device).view(shape)
    img_pred = (sp_pred * (x_norm * std + mean)).clamp(0.0, 1.0)
    f_pred = vgg(img_pred)
    with torch.no_grad():
        f_target = vgg(img_target01)
    return (f_pred - f_target).square().mean()
