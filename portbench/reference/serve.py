"""The served answer, from the model: for a 480x640 BGR uint8 request,
``x = u8 / 255 * 2 - 1``; the matte ``m = G1(x)`` and the shadow-free
image ``y = G2(x ++ m)`` (MNet, eval BatchNorm, nearest upsample); each
answer ``uint8(clip(t * 0.5 + 0.5, 0, 1) * 255)``, truncated, as the
reference's ``astype(uint8)``."""

from __future__ import annotations

import torch

from portbench.reference import nets


def _to_u8(t):
    return (torch.clamp(t * 0.5 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)


@torch.no_grad()
def stacked(w1: dict, w2: dict, imgs_u8: torch.Tensor, block: int = 8):
    """(N, H, W, 3) uint8 on the card -> (matte (N, H, W) uint8,
    shadow-free (N, H, W, 3) uint8), in blocks of ``block`` images."""
    mattes, frees = [], []
    for i in range(0, imgs_u8.shape[0], block):
        x = imgs_u8[i:i + block].permute(0, 3, 1, 2).float() * (2.0 / 255.0) - 1.0
        m = nets.mnet(w1, x, train=False, nearest=True)
        y = nets.mnet(w2, torch.cat([x, m], 1), train=False, nearest=True)
        mattes.append(_to_u8(m)[:, 0])
        frees.append(_to_u8(y).permute(0, 2, 3, 1))
    return torch.cat(mattes), torch.cat(frees)
