"""Shadow-parameter (sp) preprocessing; port of
``shadow_removal_istd_tpu/tools/preprocess.py`` (host numpy, no card).

Two sp methods, selectable by ``--method``:

- ``ratio`` (the reference's default): sp = shadowless / shadowed per
  pixel, zero shadowed pixels counted as 1 (src/utils.py:45-47);
  :func:`apply_sp` clip-multiplies to restore (src/utils.py:50-57).
  ``data/h5.py``'s ``build_h5`` stores this sp.
- ``polyfit``: the reference's dormant richer sp (src/preprocess.py:18-24,
  src/utils.py:17-44): per pixel and channel, ``shadowless ~
  poly(shadowed)`` of degree ``--deg`` over a ``--ksize`` window, weighted
  by a hat function of the shadow-free gray level times a pyramid
  distance weight, solved for all pixels at once from the window
  moments' normal equations (:func:`compute_sp_polyfit`). Output (H, W,
  3, deg+1), coefficients low -> high degree; :func:`apply_sp_poly`
  evaluates the polynomial to restore.

The CLI maps over ``<subset>_A`` against ``<subset>_C_fixed_official``
(else ``<subset>_C_fixed``) and writes ``.npy`` files and, optionally,
the restored images::

    python -m shadow_removal_istd_tpu_torch.tools.preprocess \\
        --path <ISTD root> --subset train [--method polyfit] \\
        [--save-sp yes] [--save-img no]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from shadow_removal_istd_tpu_torch.utils.image_io import imread_color, imwrite


def compute_sp(shadowed: np.ndarray, shadowless: np.ndarray) -> np.ndarray:
    """Per-pixel shadow parameters (float32): shadowless / shadowed, with
    zero shadowed pixels counted as 1."""
    shadowed = shadowed.copy()
    shadowed[shadowed == 0] = 1
    return shadowless.astype(np.float32) / shadowed.astype(np.float32)


def apply_sp(shadowed: np.ndarray, sp: np.ndarray) -> np.ndarray:
    """Restore a shadow-free estimate: clip(sp * shadowed), to uint8 for a
    uint8 image, else to [0, 1] float32."""
    if shadowed.dtype == np.uint8:
        return np.clip(sp * shadowed, 0, 255).astype(np.uint8)
    return np.clip(sp * shadowed, 0, 1).astype(np.float32)


# Hat weight over gray level (src/utils.py:17-18): up over [0, 63], flat
# 64 over [64, 191], down over [192, 255]; gray 0 and 255 weigh 0, as in
# the reference's own table.
_HAT_LUT = np.concatenate((np.arange(64), np.full(128, 64),
                           np.arange(64)[::-1])).astype(np.float64)


def _bgr_to_gray_u8(bgr: np.ndarray) -> np.ndarray:
    """BGR -> GRAY uint8 as the reference's ``cv.cvtColor``
    (src/utils.py:25): cv2 itself when it imports, else the fixed-point
    descale, which matches cv2 but for one level on ~0.2 % of pixels
    (cv2 5.x rounds in float)."""
    try:
        import cv2
        return cv2.cvtColor(np.ascontiguousarray(bgr), cv2.COLOR_BGR2GRAY)
    except Exception:
        b = bgr[..., 0].astype(np.int64)
        g = bgr[..., 1].astype(np.int64)
        r = bgr[..., 2].astype(np.int64)
        return ((1868 * b + 9617 * g + 4899 * r + (1 << 13)) >> 14).astype(
            np.uint8)


def _pyramid_weight(ksize: int) -> np.ndarray:
    """Distance weight per window offset (src/utils.py:31-33):
    ksize - |di| - |dj| from the window's centre."""
    b = (ksize - 1) // 2
    i = np.abs(np.arange(ksize) - b)
    return (ksize - i[:, None] - i[None, :]).astype(np.float64)


def compute_sp_polyfit(shadowed: np.ndarray, shadowless: np.ndarray,
                       ksize: int = 5, deg: int = 1) -> np.ndarray:
    """Weighted per-pixel polynomial sp, all pixels at once.

    Per pixel p and channel c, the coefficients minimise ``sum_j w_j^2
    (poly(x_j) - y_j)^2`` over the ksize x ksize edge-padded window
    around p (x = shadowed, y = shadowless, ``w = hat(gray(shadowless))
    * pyramid(offset)``), which is what the reference's per-pixel
    ``numpy.polynomial.polynomial.polyfit(x, y, deg, w=w)`` computes.
    The normal equations ``G a = h`` (``G[ab] = sum w^2 x^(a+b)``,
    ``h[a] = sum w^2 x^a y``) are built from window moments and solved
    batched: a direct solve where ``G`` is well conditioned, the
    pseudo-inverse's min-norm solution on degenerate windows (all-zero
    hat weight, a constant patch).

    Returns float32 (H, W, 3, deg+1), coefficients low -> high degree."""
    assert shadowed.dtype == shadowless.dtype
    border = (ksize - 1) // 2        # ksize should be odd
    pad2 = ((border, border), (border, border))
    px = np.pad(shadowed, pad2 + ((0, 0),), mode="edge")
    py = np.pad(shadowless, pad2 + ((0, 0),), mode="edge")
    if shadowed.dtype == np.uint8:
        gray = _bgr_to_gray_u8(py)
    else:   # float input: scaled to the table's 0..255 domain
        gray = _bgr_to_gray_u8(
            (np.clip(py, 0.0, 1.0) * 255.0).astype(np.uint8))
    w1 = _HAT_LUT[gray]

    # (H, W, 3, k, k) value windows, (H, W, 1, k, k) weights
    xw = sliding_window_view(px.astype(np.float64), (ksize, ksize),
                             axis=(0, 1))
    yw = sliding_window_view(py.astype(np.float64), (ksize, ksize),
                             axis=(0, 1))
    w = (sliding_window_view(w1, (ksize, ksize))
         * _pyramid_weight(ksize))[:, :, None, :, :]
    wsq = w * w

    # moments S_p = sum w^2 x^p (p <= 2 deg), T_p = sum w^2 x^p y
    n_coef = deg + 1
    xpow = np.ones_like(xw)
    S, T = [], []
    for p in range(2 * deg + 1):
        if p:
            xpow = xpow * xw
        S.append(np.sum(wsq * xpow, axis=(-2, -1)))
        if p <= deg:
            T.append(np.sum(wsq * xpow * yw, axis=(-2, -1)))
    G = np.stack([np.stack([S[a + b] for b in range(n_coef)], -1)
                  for a in range(n_coef)], -2)
    h = np.stack(T, -1)
    Gf = G.reshape(-1, n_coef, n_coef)
    hf = h.reshape(-1, n_coef)
    det = np.linalg.det(Gf)
    hadamard = np.prod(np.sqrt((Gf * Gf).sum(-1)), axis=-1)
    ok = np.abs(det) > 1e-9 * np.maximum(hadamard, 1e-30)
    coef = np.zeros_like(hf)
    if ok.any():
        coef[ok] = np.linalg.solve(Gf[ok], hf[ok][..., None])[..., 0]
    if (~ok).any():
        coef[~ok] = np.einsum("...ij,...j->...i",
                              np.linalg.pinv(Gf[~ok]), hf[~ok])
    return coef.reshape(G.shape[:-2] + (n_coef,)).astype(np.float32)


def apply_sp_poly(shadowed: np.ndarray, sp: np.ndarray) -> np.ndarray:
    """Restore a shadow-free estimate by evaluating the polynomial sp
    (low -> high coefficients) at each shadowed value (Horner)."""
    x = shadowed.astype(np.float64)
    out = np.zeros(shadowed.shape, np.float64)
    for k in range(sp.shape[-1] - 1, -1, -1):
        out = out * x + sp[..., k].astype(np.float64)
    if shadowed.dtype == np.uint8:
        return np.clip(out, 0, 255).astype(np.uint8)
    return np.clip(out, 0, 1).astype(np.float32)


def process_split(root: str, subset: str, save_sp: bool = True,
                  save_img: bool = False,
                  target_dirname: str | None = None,
                  method: str = "ratio", ksize: int = 5,
                  deg: int = 1) -> int:
    """Compute sp for every aligned pair of a split; returns the file
    count. ``ratio`` writes ``sp/`` and ``sp_restored_img/`` (sp of shape
    (H, W, 3)); ``polyfit`` writes ``sp_poly/`` and
    ``sp_poly_restored_img/`` ((H, W, 3, deg+1)), so the two methods
    never overwrite each other."""
    image_dir = os.path.join(root, subset, f"{subset}_A")
    if target_dirname is None:
        target_dirname = f"{subset}_C_fixed_official"
        if not os.path.isdir(os.path.join(root, subset, target_dirname)):
            target_dirname = f"{subset}_C_fixed"
    target_dir = os.path.join(root, subset, target_dirname)
    sp_dir = os.path.join(root, subset,
                          "sp" if method == "ratio" else "sp_poly")
    restored_dir = os.path.join(
        root, subset, ("sp_restored_img" if method == "ratio"
                       else "sp_poly_restored_img"))
    if save_sp:
        os.makedirs(sp_dir, exist_ok=True)
    if save_img:
        os.makedirs(restored_dir, exist_ok=True)

    filenames = sorted(os.listdir(image_dir))
    for fname in filenames:
        img = imread_color(os.path.join(image_dir, fname))
        target = imread_color(os.path.join(target_dir, fname))
        if method == "ratio":
            sp = compute_sp(img, target)
            restored = apply_sp(img, sp) if save_img else None
        else:
            sp = compute_sp_polyfit(img, target, ksize=ksize, deg=deg)
            restored = apply_sp_poly(img, sp) if save_img else None
        stem = os.path.splitext(fname)[0]
        if save_sp:
            np.save(os.path.join(sp_dir, stem), sp)
        if save_img:
            imwrite(os.path.join(restored_dir, fname), restored)
    return len(filenames)


def main(argv=None) -> None:
    from shadow_removal_istd_tpu_torch.cli.main import str2bool

    parser = argparse.ArgumentParser(
        description="Preprocess shadow removal dataset")
    parser.add_argument("--path", default="../ISTD_DATASET")
    parser.add_argument("--subset", default="train",
                        choices=["train", "test"])
    # the reference's type=bool parses any non-empty string, "false"
    # included, as True; a real bool parser, as in the JAX package
    parser.add_argument("--save-sp", type=str2bool, nargs="?",
                        const=True, default=True)
    parser.add_argument("--save-img", type=str2bool, nargs="?",
                        const=True, default=False)
    parser.add_argument("--method", default="ratio",
                        choices=["ratio", "polyfit"],
                        help="ratio sp (the reference's default) or the "
                             "weighted polynomial fit (its dormant "
                             "variant, src/utils.py:17-44)")
    parser.add_argument("--ksize", type=int, default=5,
                        help="polyfit neighbourhood size (odd)")
    parser.add_argument("--deg", type=int, default=1,
                        help="polyfit polynomial degree")
    args = parser.parse_args(argv)
    n = process_split(args.path, args.subset, args.save_sp, args.save_img,
                      method=args.method, ksize=args.ksize, deg=args.deg)
    print(f"completed preprocessing of {n} files", file=sys.stderr)


if __name__ == "__main__":
    main()
