"""Synchronized random augmentation of the training stream group.

Port of ``shadow_removal_istd_tpu/ops/augment.py``: the reference's
RandomScale(+-5%) -> RandomRotate(+-15 deg) -> RandomHorizontalFlip(0.5)
-> RandomCrop(256) -> [-1, 1] chain, with ONE draw per sample shared by
every stream of the (shadow, matte, shadow-free) group: the streams are
concatenated on channels and augmented together, by one of two paths:

- ``method="gather"``: scale and rotation compose into one affine, the
  flip mirrors the destination plane and the crop offsets its grid, so
  the whole chain is one exact bilinear gather (``ops/warp.affine_warp``,
  cv2's geometry);
- ``method="shear"``: a center scale by two matmuls, then a rotation by
  three ``hshear`` launches (``ops/shear.fused_augment_shear``). It needs
  H, W and the crop to be multiples of 8; other shapes take the gather
  path, as in the JAX package.

An optional pre-augmentation resize (``AugmentConfig.resize``, the legacy
tree's 300x400) resamples the group exactly first (``ops/resize.resize``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch

from shadow_removal_istd_tpu_torch.ops.resize import resize
from shadow_removal_istd_tpu_torch.ops.shear import fused_augment_shear
from shadow_removal_istd_tpu_torch.ops.warp import (
    affine_warp,
    invert_affine,
    rotation_scale_matrix,
)


@dataclass(frozen=True)
class AugmentConfig:
    """scale: max relative scale jitter (U[1-s, 1+s]); angle: max
    rotation in degrees (U[-a, a]); flip_prob: probability of a
    horizontal flip; crop_size: output crop; resize: optional
    pre-augmentation resize to (rows, cols); method: "gather" (the exact
    bilinear gather) or "shear" (the ``hshear`` path)."""

    scale: float = 0.05
    angle: float = 15.0
    flip_prob: float = 0.5
    crop_size: int = 256
    resize: tuple | None = None
    method: str = "gather"

    def __post_init__(self):
        if self.method not in ("shear", "gather"):
            raise ValueError(f"unknown augmentation method {self.method!r}")


def uses_shear(cfg: AugmentConfig, h: int, w: int) -> bool:
    """Whether (H, W) images (after the pre-augmentation resize) take the
    ``hshear`` path: ``method="shear"`` and H, W and the crop multiples
    of 8; otherwise the gather path runs."""
    return (cfg.method == "shear" and h % 8 == 0 and w % 8 == 0
            and cfg.crop_size % 8 == 0)


def augment_gather(stacked: torch.Tensor, params: dict,
                   crop: int) -> torch.Tensor:
    """Fused warp + flip + crop of (N, H, W, C) images (uint8 or float)
    by one bilinear gather each; float32 (N, C, crop, crop) in [-1, 1]."""
    _, h, w, _ = stacked.shape
    center = ((w - 1) / 2.0, (h - 1) / 2.0)
    inv = invert_affine(rotation_scale_matrix(
        params["angle"].float(), params["scale"].float(), center))
    warped = affine_warp(stacked, inv, out_shape=(crop, crop),
                         offset=(params["row_off"], params["col_off"]),
                         flip=params["flip"])
    # uint8 [0, 255] -> [-1, 1] (reference src/utils.py:60-62)
    warped = warped * (2.0 / 255.0) - 1.0
    return warped.permute(0, 3, 1, 2).contiguous()


def _off_range(dim: int, crop: int) -> tuple[int, int]:
    """[lo, hi) of a crop offset: inside the image randint(0, dim - crop);
    dim == crop gives 0; a crop LARGER than the image places the image at
    a random position inside the zero-padded crop, offsets in
    [-(crop - dim), 0)."""
    if dim > crop:
        return 0, dim - crop
    if dim == crop:
        return 0, 1
    return -(crop - dim), 0


def sample_augment_params(generator: torch.Generator, batch: int,
                          image_shape: tuple[int, int],
                          cfg: AugmentConfig,
                          device: str | torch.device = "cpu") -> dict:
    """Per-sample parameters, one draw per sample per transform, shared
    by every stream: scale, angle (f32), flip (bool, ``u <= p``), row_off
    and col_off (int64), all (batch,) on ``device``, drawn from
    ``generator`` (which lives on that device)."""
    h, w = image_shape

    def uniform(lo, hi):
        u = torch.rand(batch, generator=generator, device=device)
        return lo + u * (hi - lo)

    scale = uniform(1.0 - cfg.scale, 1.0 + cfg.scale)
    angle = uniform(-cfg.angle, cfg.angle)
    # the reference flips when rand() <= flip_prob
    flip = torch.rand(batch, generator=generator,
                      device=device) <= cfg.flip_prob
    r_lo, r_hi = _off_range(h, cfg.crop_size)
    c_lo, c_hi = _off_range(w, cfg.crop_size)
    if r_lo < 0 or c_lo < 0:
        logging.getLogger(__name__).warning(
            "crop_size %d exceeds the %dx%d image: crops are zero-padded "
            "with the image randomly placed", cfg.crop_size, h, w)
    row_off = torch.randint(r_lo, r_hi, (batch,), generator=generator,
                            device=device)
    col_off = torch.randint(c_lo, c_hi, (batch,), generator=generator,
                            device=device)
    return {"scale": scale, "angle": angle, "flip": flip,
            "row_off": row_off, "col_off": col_off}


def augment_batch(generator: torch.Generator | None,
                  streams: tuple[torch.Tensor, ...], cfg: AugmentConfig,
                  params: dict | None = None,
                  mesh=None) -> tuple[torch.Tensor, ...]:
    """Augment a group of (N, H, W, C) uint8 streams with synchronized
    draws (from ``generator``, unless ``params`` are given; their offsets
    are drawn for the resized shape). Returns float32 (N, C, crop, crop)
    crops in [-1, 1], in the same order.

    With ``mesh`` (a ``parallel.mesh.Mesh``) the streams are this rank's
    slice of the global batch (its data coordinate's): the parameters are
    drawn (or given) for the global batch, and the rank's slice of them
    is applied, so the crops equal one device's over the global batch."""
    batch = streams[0].shape[0]
    world = mesh.n_data if mesh is not None else 1
    splits = [s.shape[-1] for s in streams]
    stacked = torch.cat(list(streams), dim=-1)
    if cfg.resize is not None:
        stacked = resize(stacked.float(), cfg.resize, method="auto")
    h, w = stacked.shape[1:3]
    if params is None:
        params = sample_augment_params(generator, batch * world, (h, w),
                                       cfg, device=stacked.device)
    if world > 1:
        rows = mesh.rows(batch * world)
        params = {k: v[rows] for k, v in params.items()}
    if uses_shear(cfg, h, w):
        warped = fused_augment_shear(stacked, params, cfg.crop_size,
                                     max_angle_deg=cfg.angle)
    else:
        warped = augment_gather(stacked, params, cfg.crop_size)
    return tuple(torch.split(warped, splits, dim=1))


def normalize_batch(streams: tuple[torch.Tensor, ...]
                    ) -> tuple[torch.Tensor, ...]:
    """uint8 (N, H, W, C) -> float32 (N, C, H, W) in [-1, 1], no
    augmentation (the validation path)."""
    return tuple(s.permute(0, 3, 1, 2).float() * (2.0 / 255.0) - 1.0
                 for s in streams)


def denormalize(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1], in the input's dtype (reference
    src/cgan.py:441-442)."""
    return img * 0.5 + 0.5


def float_to_uint8(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> uint8: clip, scale by 255 and truncate, as numpy's
    ``astype(uint8)`` (reference src/utils.py:65-67)."""
    return (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
