"""Color-space conversions (sRGB -> CIELAB, D65); port of
``shadow_removal_istd_tpu/ops/color.py``.

The evaluation protocol measures errors in LAB space with skimage's
``color.rgb2lab`` math (reference src/eval.py:86-99): sRGB linearization
(threshold 0.04045), the sRGB -> XYZ D65 matrix and the CIE f(t) cube
root with the 0.008856 threshold, in float32 on tensors of any device.

Training images flow in BGR channel order (cv2 convention, reference
src/dataset.py:100); eval reads RGB. ``bgr_to_rgb`` converts between the
two.
"""

from __future__ import annotations

import numpy as np
import torch

# sRGB (linear) -> XYZ, D65 white point: skimage's float64 inverse of its
# rgb_from_xyz matrix, to float32 precision (the JAX package's constants)
_XYZ_FROM_RGB = np.array(
    [[0.412456432268236, 0.357576076280027, 0.180437480294450],
     [0.212672846318362, 0.715152167154881, 0.072174999573213],
     [0.019333904103299, 0.119192028243221, 0.950304073677404]],
    dtype=np.float32)

# D65 reference white (skimage "D65", 2-degree observer)
_WHITE_D65 = np.array([0.95047, 1.0, 1.08883], dtype=np.float32)

_EPS = 0.008856  # (6/29)^3


def bgr_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """Swap the channel order of a (..., 3) image."""
    return img.flip(-1)


def srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    """Inverse sRGB companding on values in [0, 1]."""
    return torch.where(srgb > 0.04045, ((srgb + 0.055) / 1.055) ** 2.4,
                       srgb / 12.92)


def rgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) sRGB in [0, 1] -> XYZ, as explicit float32 multiply-adds
    in the JAX package's order (no matmul, whose precision a global flag
    could change)."""
    linear = srgb_to_linear(rgb)
    r, g, b = linear[..., 0], linear[..., 1], linear[..., 2]
    m = [[float(v) for v in row] for row in _XYZ_FROM_RGB]
    x = m[0][0] * r + m[0][1] * g + m[0][2] * b
    y = m[1][0] * r + m[1][1] * g + m[1][2] * b
    z = m[2][0] * r + m[2][1] * g + m[2][2] * b
    return torch.stack([x, y, z], dim=-1)


def xyz_to_lab(xyz: torch.Tensor) -> torch.Tensor:
    """(..., 3) XYZ -> CIELAB (L in [0, 100]). torch has no ``cbrt``: the
    cube root is ``t ** (1/3)`` of ``t`` clamped to the threshold, so the
    branch not taken cannot make a NaN of a negative ``t``."""
    t = xyz / torch.from_numpy(_WHITE_D65).to(xyz.device)
    kappa_term = 7.787 * t + 16.0 / 116.0
    f = torch.where(t > _EPS, t.clamp_min(_EPS) ** (1.0 / 3.0), kappa_term)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    lum = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([lum, a, b], dim=-1)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) sRGB in [0, 1] -> CIELAB, skimage's ``rgb2lab`` math."""
    return xyz_to_lab(rgb_to_xyz(rgb))
