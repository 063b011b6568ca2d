"""Evaluation metrics: LAB RMSE/MAE over shadow / non-shadow / all
regions, PSNR, SSIM (the ISTD protocol, reference src/eval.py)."""

from shadow_removal_istd_tpu_torch.metrics.metrics import (  # noqa: F401
    lab_mae,
    lab_rmse,
    psnr,
    region_metrics,
    ssim,
)
