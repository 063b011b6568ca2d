"""Metric functions on tensors (batched, any device); port of
``shadow_removal_istd_tpu/metrics/metrics.py``.

Formulas of reference src/eval.py:

- RMSE (eval.py:127-129): the sum over masked pixels of the per-pixel
  Euclidean distance in LAB (the ISTD protocol: no square root of a
  mean);
- MAE (eval.py:123-124): the sum of absolute LAB differences over masked
  pixels, all channels summed;
- aggregation (eval.py:104-111): dataset sums over dataset pixel counts,
  for the shadow mask, its complement and all pixels;
- PSNR (eval.py:132-134): skimage's, data_range 1 for [0, 1] floats;
- SSIM (eval.py:137-138): skimage ``structural_similarity`` with
  multichannel defaults: 7x7 uniform window, K1 .01, K2 .03, sample
  covariance, data_range 2.
"""

from __future__ import annotations

import numpy as np
import torch


def lab_rmse(lab1: torch.Tensor, lab2: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Summed per-pixel LAB Euclidean distance over masked pixels.
    lab1/lab2: (..., H, W, 3); mask: (..., H, W)."""
    dist = torch.sqrt(((lab1 - lab2) ** 2).sum(dim=-1))
    return (dist * mask).sum()


def lab_mae(lab1: torch.Tensor, lab2: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Summed absolute LAB difference over masked pixels (all channels)."""
    return ((lab1 - lab2).abs().sum(dim=-1) * mask).sum()


def region_metrics(lab1: torch.Tensor, lab2: torch.Tensor,
                   mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """Sums and pixel counts of one image or batch, shadow and non-shadow
    apart, for :func:`aggregate_regions`."""
    mask = mask.to(lab1.dtype)
    inv = 1.0 - mask
    return {
        "rmse_sum": lab_rmse(lab1, lab2, mask),
        "mae_sum": lab_mae(lab1, lab2, mask),
        "pixels": mask.sum(),
        "rmse_non_sum": lab_rmse(lab1, lab2, inv),
        "mae_non_sum": lab_mae(lab1, lab2, inv),
        "pixels_non": inv.sum(),
    }


def aggregate_regions(parts: list[dict]) -> dict[str, float]:
    """Σerr/Σpixels over the dataset (reference eval.py:104-111), summed
    on the host in float64. A region of zero pixels (the non-shadow part
    of a maskless run) gives NaN, as the reference's numpy division does."""
    tot = {k: float(np.sum([float(p[k]) for p in parts])) for k in parts[0]}

    def div(a, b):
        return a / b if b else float("nan")

    return {
        "rmse": div(tot["rmse_sum"], tot["pixels"]),
        "mae": div(tot["mae_sum"], tot["pixels"]),
        "rmse_non": div(tot["rmse_non_sum"], tot["pixels_non"]),
        "mae_non": div(tot["mae_non_sum"], tot["pixels_non"]),
        "rmse_all": div(tot["rmse_sum"] + tot["rmse_non_sum"],
                        tot["pixels"] + tot["pixels_non"]),
        "mae_all": div(tot["mae_sum"] + tot["mae_non_sum"],
                       tot["pixels"] + tot["pixels_non"]),
    }


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio (dB)."""
    mse = ((img1 - img2) ** 2).mean()
    return 10.0 * torch.log10(data_range ** 2 / mse)


def _uniform_filter_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """Valid-mode uniform box filter over an (H, W) tensor, by separable
    cumulative sums, as the JAX package computes it."""
    def box1d(a, dim):
        c = torch.cumsum(a, dim=dim)
        c = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)), c], dim=dim)
        n = a.shape[dim]
        hi = c.narrow(dim, win, n + 1 - win)
        lo = c.narrow(dim, 0, n + 1 - win)
        return (hi - lo) / win
    return box1d(box1d(x, 0), 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 2.0,
         win_size: int = 7, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Structural similarity of (H, W, C) float images, the mean over
    channels: skimage's uniform-window path (7x7, sample-covariance
    normalization, boundary crop)."""
    np_win = win_size ** 2
    cov_norm = np_win / (np_win - 1.0)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    def channel_ssim(a, b):
        ua = _uniform_filter_valid(a, win_size)
        ub = _uniform_filter_valid(b, win_size)
        uaa = _uniform_filter_valid(a * a, win_size)
        ubb = _uniform_filter_valid(b * b, win_size)
        uab = _uniform_filter_valid(a * b, win_size)
        va = cov_norm * (uaa - ua * ua)
        vb = cov_norm * (ubb - ub * ub)
        vab = cov_norm * (uab - ua * ub)
        num = (2 * ua * ub + c1) * (2 * vab + c2)
        den = (ua ** 2 + ub ** 2 + c1) * (va + vb + c2)
        return (num / den).mean()

    return torch.stack([channel_ssim(img1[..., c], img2[..., c])
                        for c in range(img1.shape[-1])]).mean()
