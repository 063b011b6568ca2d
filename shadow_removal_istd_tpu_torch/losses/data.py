"""Data (pixel) losses; port of ``shadow_removal_istd_tpu/losses/data.py``
(mean L1, mean squared error), accumulated in at least f32."""

from __future__ import annotations

import torch


def _acc(x: torch.Tensor) -> torch.Tensor:
    """Accumulation dtype: f32 under bf16 compute, f64 stays f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (accumulated in >= f32)."""
    return (_acc(pred) - _acc(target)).abs().mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error (accumulated in >= f32)."""
    return (_acc(pred) - _acc(target)).square().mean()
