"""Color adjustment: per-channel linear regression color correction; port
of ``shadow_removal_istd_tpu/tools/color_adjustment.py`` (host numpy).

The reference's MATLAB tooling (color_adjustment_code/
color_adjustment.m:9-27, ISTD_fix.m:10-19): per image, regress each
channel of the shadow image's non-shadow pixels on the shadow-free
image's, then apply that per-channel affine map to the whole
shadow-free image, which gives the ``*_C_fixed`` ground truth::

    python -m shadow_removal_istd_tpu_torch.tools.color_adjustment \\
        --path <ISTD root> --subset train [--out-dirname NAME]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from shadow_removal_istd_tpu_torch.utils.image_io import (
    imread_color,
    imread_gray,
    imwrite,
)


def color_adjustment(shadow_free: np.ndarray, shadow: np.ndarray,
                     shadow_mask: np.ndarray):
    """(corrected uint8 image, params[6]) as the MATLAB code gives them.

    params = [b0_ch0, b1_ch0, b0_ch1, b1_ch1, b0_ch2, b1_ch2], where
    target ~= b0 + b1 * source per channel, fitted by least squares on
    the non-shadow pixels (``shadow_mask == 0``)."""
    nonshadow = shadow_mask == 0
    src = shadow_free.astype(np.float64)[nonshadow] / 255.0   # (P, 3)
    tgt = shadow.astype(np.float64)[nonshadow] / 255.0
    params = []
    corrected = shadow_free.astype(np.float64) / 255.0
    for c in range(3):
        a = np.stack([np.ones_like(src[:, c]), src[:, c]], axis=1)
        coef, *_ = np.linalg.lstsq(a, tgt[:, c], rcond=None)
        params.extend(coef.tolist())
        corrected[..., c] = corrected[..., c] * coef[1] + coef[0]
    # MATLAB's uint8() rounds to nearest, not towards zero
    out = np.clip(np.rint(corrected * 255.0), 0, 255).astype(np.uint8)
    return out, np.array(params)


def fix_split(root: str, subset: str = "train",
              out_dirname: str | None = None) -> int:
    """A whole split, as ISTD_fix.m: writes ``<subset>_C_fixed_official``
    (or ``out_dirname``) from ``_A``, ``_B`` and ``_C``; returns the file
    count."""
    a_dir = os.path.join(root, subset, f"{subset}_A")
    b_dir = os.path.join(root, subset, f"{subset}_B")
    c_dir = os.path.join(root, subset, f"{subset}_C")
    out_dir = os.path.join(root, subset,
                           out_dirname or f"{subset}_C_fixed_official")
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(os.listdir(a_dir))
    for fname in files:
        shadow = imread_color(os.path.join(a_dir, fname))
        mask = imread_gray(os.path.join(b_dir, fname))
        shadow_free = imread_color(os.path.join(c_dir, fname))
        corrected, _ = color_adjustment(shadow_free, shadow, mask)
        imwrite(os.path.join(out_dir, fname), corrected)
    return len(files)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="ISTD color adjustment (per-channel linear regression)")
    parser.add_argument("--path", required=True)
    parser.add_argument("--subset", default="train",
                        choices=["train", "test"])
    parser.add_argument("--out-dirname", default=None)
    args = parser.parse_args(argv)
    n = fix_split(args.path, args.subset, args.out_dirname)
    print(f"color-adjusted {n} images")


if __name__ == "__main__":
    main()
