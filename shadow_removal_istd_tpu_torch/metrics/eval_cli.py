"""Standalone eval CLI, the ISTD metric protocol; port of
``shadow_removal_istd_tpu/metrics/eval_cli.py``.

Same interface and math as reference src/eval.py: compare two image
directories (predictions vs ground truth), optionally with a shadow-mask
directory, reporting LAB RMSE/MAE over shadow / non-shadow / all regions
(Σerr/Σpixels over the dataset), or also PSNR/SSIM when maskless::

    python -m shadow_removal_istd_tpu_torch.metrics.eval_cli DIR1 DIR2 \\
        [-m MASKDIR] [--image-size 256] [--logfile ./eval.log] \\
        [--device cuda|cpu]

- images load as RGB floats in [0, 1] and resize with the half-pixel,
  edge-clamped bilinear (anti_aliasing=False, like eval.py:74-77), on
  ``--device``;
- masks get the gaussian anti-aliasing skimage's resize applies by
  default (on the host, scipy) before the 0.5 threshold (eval.py:80-81);
- LAB is skimage's math (``ops/color.py``).

The JAX package's quirks are kept: the per-image path scores PSNR/SSIM
on the images before the ``--image-size`` resize, and the batched path
anti-aliases each mask to its image's shape and then again to the size.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from shadow_removal_istd_tpu_torch import resolve_device
from shadow_removal_istd_tpu_torch.metrics.metrics import (
    aggregate_regions,
    psnr,
    region_metrics,
    ssim,
)
from shadow_removal_istd_tpu_torch.ops.color import rgb_to_lab
from shadow_removal_istd_tpu_torch.ops.resize import resize_linear
from shadow_removal_istd_tpu_torch.utils.image_io import (
    imread_color,
    imread_gray,
)

logger = logging.getLogger(__name__)


def _load_rgb01(path: str) -> np.ndarray:
    bgr = imread_color(path)
    return bgr[..., ::-1].astype(np.float32) / 255.0


def _load_mask01(path: str) -> np.ndarray:
    return imread_gray(path).astype(np.float32) / 255.0


def _resize(img: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an (H, W, C) or (H, W) tensor; the input itself
    when it already has ``shape``."""
    if tuple(img.shape[:2]) == tuple(shape):
        return img
    if img.dim() == 3:
        return resize_linear(img, shape)
    return resize_linear(img[..., None], shape)[..., 0]


def _antialias_mask(mask: np.ndarray, out_shape: tuple[int, int],
                    device: torch.device) -> torch.Tensor:
    """Shrink a float (H, W) mask with the gaussian pre-filter skimage's
    resize applies by default (on the host), then resize it bilinearly
    on ``device``."""
    factors = (mask.shape[0] / out_shape[0], mask.shape[1] / out_shape[1])
    if max(factors) > 1.0:
        from scipy import ndimage
        sigma = [max(0.0, (f - 1.0) / 2.0) for f in factors]
        mask = ndimage.gaussian_filter(mask, sigma, mode="nearest")
    return _resize(torch.from_numpy(np.ascontiguousarray(mask)).to(device),
                   out_shape)


def all_metrics(dir1: str, dir2: str, size: int | None = None,
                maskdir: str | None = None, batch_size: int = 16,
                device: str | torch.device = "cuda") -> dict[str, float]:
    """Dataset metrics per the reference protocol (src/eval.py:41-115).

    When every image of the split has one resolution (ISTD's do) and a
    mask directory is given, the LAB metric runs batched on ``device``,
    one call per ``batch_size`` images."""
    device = resolve_device(device)
    files = sorted(os.listdir(dir1))
    if maskdir is not None and batch_size > 1:
        batched = _try_all_metrics_batched(dir1, dir2, maskdir, files,
                                           size, batch_size, device)
        if batched is not None:
            return batched

    def load(path):
        return torch.from_numpy(_load_rgb01(path)).to(device)

    parts = []
    psnrs, ssims = [], []
    for f in files:
        img1 = load(os.path.join(dir1, f))
        hw = tuple(img1.shape[:2])
        img2 = _resize(load(os.path.join(dir2, f)), hw)
        if maskdir is not None:
            # the reference resizes the mask with skimage's DEFAULT
            # anti-aliasing (eval.py:68-70: gaussian pre-filter)
            mask = _antialias_mask(
                _load_mask01(os.path.join(maskdir, f)), hw, device)
        else:
            mask = torch.ones(hw, device=device)
        if size is not None:
            target = (size, size)
            img1_r, img2_r = _resize(img1, target), _resize(img2, target)
            mask_r = _antialias_mask(mask.cpu().numpy(), target,
                                     device) > 0.5
        else:
            img1_r, img2_r, mask_r = img1, img2, mask > 0.5
        parts.append({k: float(v) for k, v in region_metrics(
            rgb_to_lab(img1_r), rgb_to_lab(img2_r), mask_r).items()})
        if maskdir is None:
            psnrs.append(float(psnr(img1, img2)))
            ssims.append(float(ssim(img1, img2)))

    results = aggregate_regions(parts)
    if maskdir is None:
        results["psnr"] = float(np.mean(psnrs))
        results["ssim"] = float(np.mean(ssims))
    return results


def _image_shape(path: str) -> tuple[int, int]:
    """(H, W) without a full decode where possible: the PNG IHDR (width
    and height big-endian at bytes 16-24); a full decode otherwise."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] == b"\x89PNG\r\n\x1a\n" and len(head) >= 24:
        w = int.from_bytes(head[16:20], "big")
        h = int.from_bytes(head[20:24], "big")
        return (h, w)
    return imread_color(path).shape[:2]


def _try_all_metrics_batched(dir1, dir2, maskdir, files, size, batch_size,
                             device):
    """The batched path; None when the resolutions are mixed (found by a
    header probe before any decode, so the per-image path repeats no
    work)."""
    shapes = {_image_shape(os.path.join(dir1, f)) for f in files}
    if len(shapes) != 1:
        return None
    hw = next(iter(shapes))
    parts = []
    for start in range(0, len(files), batch_size):
        imgs1, imgs2, masks = [], [], []
        for f in files[start:start + batch_size]:
            i1 = torch.from_numpy(
                _load_rgb01(os.path.join(dir1, f))).to(device)
            i2 = _resize(torch.from_numpy(
                _load_rgb01(os.path.join(dir2, f))).to(device), hw)
            mask = _antialias_mask(
                _load_mask01(os.path.join(maskdir, f)), hw, device)
            if size is not None:
                i1 = _resize(i1, (size, size))
                i2 = _resize(i2, (size, size))
                mask = _antialias_mask(mask.cpu().numpy(), (size, size),
                                       device)
            imgs1.append(i1)
            imgs2.append(i2)
            masks.append(mask > 0.5)
        out = region_metrics(rgb_to_lab(torch.stack(imgs1)),
                             rgb_to_lab(torch.stack(imgs2)),
                             torch.stack(masks))
        parts.append({k: float(v) for k, v in out.items()})
    return aggregate_regions(parts)


def main(argv=None) -> dict[str, float]:
    parser = argparse.ArgumentParser(description="Evaluate errors")
    parser.add_argument("dir1", type=str)
    parser.add_argument("dir2", type=str)
    parser.add_argument("-m", "--maskdir", default=None,
                        help="mask directory (default: %(default)s)")
    parser.add_argument("--image-size", default=256, type=int,
                        help="target image size (default: %(default)d)")
    parser.add_argument("--logfile", default="./eval.log")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from shadow_removal_istd_tpu_torch.utils.logging_utils import (
        setup_logging,
    )
    setup_logging(args.logfile)
    # the args snapshot goes beside the logfile, not into the cwd
    snap_dir = os.path.dirname(os.path.abspath(args.logfile))
    os.makedirs(snap_dir, exist_ok=True)
    with open(os.path.join(snap_dir, "eval_args.json"), "w") as fp:
        json.dump(vars(args), fp, indent=4, sort_keys=True)

    errors = all_metrics(args.dir1, args.dir2, size=args.image_size,
                         maskdir=args.maskdir, device=args.device)
    for k, v in errors.items():
        logger.info("%s: %s", k, v)
        print(f"{k}: {v}")
    return errors


if __name__ == "__main__":
    main()
