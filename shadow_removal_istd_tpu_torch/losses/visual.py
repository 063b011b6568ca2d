"""VGG-19-BN perceptual ("visual") loss; port of
``shadow_removal_istd_tpu/losses/visual.py``.

Predictions and targets map from [-1, 1] to [0, 1], a 1-channel matte is
broadcast to 3 channels, ImageNet normalisation runs in the input's
dtype, then the frozen VGG (in f32) runs through pool4; the loss is the
MSE of the features, with the target branch under ``no_grad``. The
training tensors' channel order goes in as it is (the reference feeds
BGR into the RGB-normalised VGG; the quirk is kept).
"""

from __future__ import annotations

import torch

from shadow_removal_istd_tpu_torch.models.vgg import (
    VGG19Features,
    imagenet_normalize,
)


def _features(vgg: VGG19Features, img_pm1: torch.Tensor) -> torch.Tensor:
    img = img_pm1 * 0.5 + 0.5
    if img.shape[1] == 1:
        img = img.expand(-1, 3, -1, -1)
    return vgg(imagenet_normalize(img))


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
