"""Inverse-affine bilinear warps; port of
``shadow_removal_istd_tpu/ops/warp.py``.

The reference augments with ``cv.warpAffine`` driven by
``cv.getRotationMatrix2D(center, angle, scale)`` (src/transform.py:71-74,
94-96): rotation by ``angle`` degrees CCW and isotropic scaling about the
image center ``((cols-1)/2, (rows-1)/2)``, constant-zero border. For every
output pixel the *inverse* transform gives source coordinates, and four
neighbours are gathered and blended bilinearly, out-of-bounds taps
counting zero. The output grid may be offset and mirrored, which is how
the augmentation folds its random crop and horizontal flip into the same
gather.

Batched: every function takes a leading sample axis with one matrix,
offset and flip per sample (the JAX package maps a one-image function
over the batch).
"""

from __future__ import annotations

import torch


def rotation_scale_matrix(angle_deg: torch.Tensor, scale: torch.Tensor,
                          center: tuple[float, float]) -> torch.Tensor:
    """(..., 2, 3) forward affines equal to ``cv.getRotationMatrix2D``:
    source (x, y) -> destination, about ``center`` = (cx, cy) in (col,
    row) coordinates: [[a, b, (1-a)cx - b*cy], [-b, a, b*cx + (1-a)cy]]
    with a = scale*cos(angle), b = scale*sin(angle)."""
    theta = torch.deg2rad(angle_deg)
    a = scale * torch.cos(theta)
    b = scale * torch.sin(theta)
    cx, cy = center
    row0 = torch.stack([a, b, (1.0 - a) * cx - b * cy], dim=-1)
    row1 = torch.stack([-b, a, b * cx + (1.0 - a) * cy], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert (..., 2, 3) affine matrices."""
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    row0 = torch.stack([ia, ib, -(ia * tx + ib * ty)], dim=-1)
    row1 = torch.stack([ic, id_, -(ic * tx + id_ * ty)], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def affine_warp(img: torch.Tensor, inv_matrix: torch.Tensor,
                out_shape: tuple[int, int] | None = None,
                offset: tuple[torch.Tensor, torch.Tensor] | None = None,
                flip: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinear warp of (N, H, W, C) images with a zero border; float32
    (N, rows, cols, C) out.

    ``inv_matrix`` (N, 2, 3) maps destination (x, y) -> source (x, y),
    the inverse that ``cv.warpAffine`` applies. ``out_shape`` = (rows,
    cols) defaults to the input's. ``offset`` = (row0, col0), each (N,),
    places the output grid in the pre-warp destination plane (the fused
    crop). ``flip`` (N,) bool mirrors the destination columns of the
    width-W plane before sampling (the fused horizontal flip).

    Each output pixel reads two column pairs (rows y0 and y0+1, columns
    ``clip(x0, 0, W-2)`` and the next) straight from the source's dtype
    (uint8 stays uint8) and interpolates in float32. A tap counts only if
    its true position is in range and the gathered element holds that
    position, which keeps the right and bottom edges exact.
    """
    n, h, w, c = img.shape
    oh, ow = out_shape if out_shape is not None else (h, w)
    dev = img.device
    rows = torch.arange(oh, dtype=torch.float32, device=dev).expand(n, oh)
    cols = torch.arange(ow, dtype=torch.float32, device=dev).expand(n, ow)
    if offset is not None:
        rows = rows + offset[0].to(torch.float32)[:, None]
        cols = cols + offset[1].to(torch.float32)[:, None]
    if flip is not None:
        cols = torch.where(flip[:, None], (w - 1.0) - cols, cols)
    xg = cols[:, None, :]                    # (N, 1, ow): dest x (col)
    yg = rows[:, :, None]                    # (N, oh, 1): dest y (row)
    m = inv_matrix.to(torch.float32)[:, :, :, None, None]  # (N, 2, 3, 1, 1)
    xs = m[:, 0, 0] * xg + m[:, 0, 1] * yg + m[:, 0, 2]    # (N, oh, ow)
    ys = m[:, 1, 0] * xg + m[:, 1, 1] * yg + m[:, 1, 2]

    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = xs - x0
    fy = ys - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    # the gathered pair starts at clip(x0, 0, W-2) so it always fits; the
    # weights below are computed against the pair's actual columns
    start_x = x0i.clamp(0, w - 2)
    flat = img.reshape(n * h * w, c)
    base = torch.arange(n, device=dev)[:, None, None] * h

    def row_pair(yi):
        """The (start_x, start_x + 1) columns of row ``yi``, float32."""
        i0 = ((base + yi.clamp(0, h - 1)) * w + start_x).reshape(-1)
        return (flat[i0].to(torch.float32).reshape(n, oh, ow, c),
                flat[i0 + 1].to(torch.float32).reshape(n, oh, ow, c))

    top0, top1 = row_pair(y0i)
    bot0, bot1 = row_pair(y0i + 1)

    def valid(pos, size):
        return ((pos >= 0) & (pos < size)).to(torch.float32)

    vx0, vx1 = valid(x0i, w), valid(x0i + 1, w)
    vy0, vy1 = valid(y0i, h), valid(y0i + 1, h)

    def elem_weight(pos):
        # (1-fx) if the element holds column x0, fx if it holds x0+1
        is_x0 = (pos == x0i).to(torch.float32)
        is_x1 = (pos == x0i + 1).to(torch.float32)
        return ((1.0 - fx) * is_x0 * vx0 + fx * is_x1 * vx1)[..., None]

    w0, w1 = elem_weight(start_x), elem_weight(start_x + 1)
    top = top0 * w0 + top1 * w1
    bot = bot0 * w0 + bot1 * w1
    fy = fy[..., None]
    return (top * (1.0 - fy) * vy0[..., None]
            + bot * fy * vy1[..., None])
