"""BEGAN k-balance: proportional control of the D fake-term weight.

Port of ``shadow_removal_istd_tpu/losses/began_balance.py`` (reference
src/cgan.py:211-213, 290-297, 352-360): k starts at 0, the D loss is
``L(real) - k * L(fake)`` over L1 reconstructions, and k moves by
``lambda_k * (gamma * L_real - L_fake)``, clipped to [0, 1]. k is a 0-d
tensor on the device: the update needs no host sync.
"""

from __future__ import annotations

import torch

GAMMA = 0.7
LAMBDA_K = 0.001


def began_d_loss(k: torch.Tensor, loss_real: torch.Tensor,
                 loss_fake: torch.Tensor) -> torch.Tensor:
    """D objective: reconstruction of real minus k * reconstruction of
    fake."""
    return loss_real - k * loss_fake


def began_k_update(k: torch.Tensor, loss_real: torch.Tensor,
                   loss_fake: torch.Tensor, gamma: float = GAMMA,
                   lambda_k: float = LAMBDA_K) -> torch.Tensor:
    """k <- clip(k + lambda_k * (gamma * L_real - L_fake), 0, 1)."""
    balance = gamma * loss_real - loss_fake
    return torch.clamp(k + lambda_k * balance, 0.0, 1.0)
