"""SoftAdapt dynamic loss weighting, as a state and an update.

Port of ``shadow_removal_istd_tpu/losses/softadapt.py`` (reference
src/loss.py:115-191): the weights follow a softmax over the losses'
normalized changes, EMA-smoothed with alpha 0.9. The state's tensors
live on the device; updates need no host sync.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class SoftAdaptState(NamedTuple):
    weights: torch.Tensor    # (n,) current mixture weights (sum 1)
    prev_loss: torch.Tensor  # (n,) previous losses


def softadapt_init(n: int, init_weights: Sequence[float] | None = None,
                   device: str | torch.device = "cpu") -> SoftAdaptState:
    """f32 weights ``init_weights`` normalized to sum 1 (uniform when
    None) and previous losses of one."""
    if init_weights is None:
        w = torch.ones(n) / n
    else:
        w = torch.tensor(init_weights, dtype=torch.float32)
        w = w / w.sum()
    return SoftAdaptState(weights=w.to(device),
                          prev_loss=torch.ones(n, device=device))


@torch.no_grad()
def softadapt_update(state: SoftAdaptState, losses: torch.Tensor,
                     beta: float = 0.1, epsilon: float = 1e-8,
                     weighted: bool = True, normalized: bool = True,
                     alpha: float = 0.9) -> SoftAdaptState:
    """One weight update from the current (detached) loss vector."""
    losses = losses.detach()
    grad = losses - state.prev_loss
    if normalized:  # relative ratios instead of absolute values
        grad = grad / state.prev_loss.clamp(min=epsilon)
    grad = grad - grad.max()
    new_w = torch.softmax(beta * grad, dim=0)
    if weighted:  # account for losses of different ranges
        new_w = new_w * (state.prev_loss.sum() - state.prev_loss)
        new_w = new_w / new_w.sum()
    weights = alpha * state.weights + (1 - alpha) * new_w
    return SoftAdaptState(weights=weights, prev_loss=losses)


def softadapt_combine(state: SoftAdaptState,
                      losses: torch.Tensor) -> torch.Tensor:
    """Weighted total loss; the weights carry no gradient."""
    return torch.sum(losses * state.weights.detach())
