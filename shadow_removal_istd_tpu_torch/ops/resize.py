"""Resize as two matrix products; port of
``shadow_removal_istd_tpu/ops/resize.py``.

A separable resize ``out = R_h @ img @ R_w^T`` of (..., H, W, C) images,
where ``R_h`` (out_h, in_h) and ``R_w`` (out_w, in_w) hold exact
interpolation weights:

- ``linear``: OpenCV ``INTER_LINEAR``'s half-pixel mapping
  ``src = (dst + 0.5) * in/out - 0.5`` with edge clamping (reference
  src/transform.py:176-178; src/eval.py:64-66 uses skimage's
  order=1 mode="edge", the same convention);
- ``area``: OpenCV ``INTER_AREA`` box-overlap averaging, exact for
  integer and fractional shrink factors (src/transform.py:173-174).

Both products run in full float32 whatever the process-wide matmul
settings say (TF32 would miss the evaluation protocol's 1e-5).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def resize_matrix_linear(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) bilinear weight matrix, half-pixel convention."""
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * (in_size / out_size) - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    hi = np.clip(lo + 1, 0, in_size - 1)
    lo = np.clip(lo, 0, in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), 1.0 - frac)
    np.add.at(mat, (rows, hi), frac)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def resize_matrix_area(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) box-filter weight matrix (INTER_AREA shrink):
    output pixel ``i`` averages the source interval ``[i*r, (i+1)*r)``,
    end pixels weighted by their overlap, ``r = in/out``. Enlarging falls
    back to the linear matrix, as the reference picks area only when
    shrinking."""
    if out_size >= in_size:
        return resize_matrix_linear(in_size, out_size)
    r = in_size / out_size
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        a, b = i * r, (i + 1) * r
        lo, hi = int(np.floor(a)), int(np.ceil(b))
        for j in range(lo, min(hi, in_size)):
            overlap = min(b, j + 1) - max(a, j)
            if overlap > 0:
                mat[i, j] = overlap / r
    return mat.astype(np.float32)


@contextlib.contextmanager
def full_f32_matmul():
    """Full float32 matmuls inside, the caller's setting restored after
    (``torch.backends.cuda.matmul.allow_tf32`` follows the precision)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _apply_separable(img: torch.Tensor, rh: np.ndarray,
                     rw: np.ndarray) -> torch.Tensor:
    """Rows then columns of (..., H, W, C) images. The rows are one
    matmul per image over (H, W*C); the columns go through ``einsum``,
    which folds every other axis into one GEMM (a broadcast ``rw @ x``
    runs N*rows GEMMs of C columns each, 3-5x slower on the card)."""
    *lead, h, w, c = img.shape
    rh_t = torch.from_numpy(rh).to(img.device, img.dtype)
    rw_t = torch.from_numpy(rw).to(img.device, img.dtype)
    with full_f32_matmul():
        out = rh_t @ img.reshape(*lead, h, w * c)        # contract H
        out = out.reshape(*lead, rh.shape[0], w, c)
        return torch.einsum("pw,...owc->...opc", rw_t, out)  # contract W


def resize_linear(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to ``size`` = (rows, cols)."""
    h, w = img.shape[-3], img.shape[-2]
    return _apply_separable(img, resize_matrix_linear(h, size[0]),
                            resize_matrix_linear(w, size[1]))


def resize_area(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Area (box) resize of (..., H, W, C) to ``size`` = (rows, cols)."""
    h, w = img.shape[-3], img.shape[-2]
    return _apply_separable(img, resize_matrix_area(h, size[0]),
                            resize_matrix_area(w, size[1]))


def resize(img: torch.Tensor, size: tuple[int, int],
           method: str = "auto") -> torch.Tensor:
    """Resize (..., H, W, C) float image(s) to ``size`` = (rows, cols).
    ``method="auto"`` is the reference's Resize transform: area when
    strictly shrinking in both dimensions, linear otherwise
    (src/transform.py:169-178)."""
    h, w = img.shape[-3], img.shape[-2]
    if method == "auto":
        method = "area" if (size[0] < h and size[1] < w) else "linear"
    if method == "linear":
        return resize_linear(img, size)
    if method == "area":
        return resize_area(img, size)
    raise ValueError(f"unknown resize method: {method}")
