"""Synthetic ISTD-like triplets for tests, smoke runs and benchmarks;
port of ``shadow_removal_istd_tpu/data/synthetic.py::synthetic_triplets``
(same numpy draws, so the same seed gives the same arrays).

Structured, not noise: a smooth base image, a soft elliptical shadow
matte, and the shadowed image derived from them, so the supervised
losses have real signal to fit.
"""

from __future__ import annotations

import numpy as np


def synthetic_triplets(n: int = 8, h: int = 480, w: int = 640,
                       seed: int = 0) -> dict[str, np.ndarray]:
    """Dict of uint8 arrays {img (N,H,W,3), mask (N,H,W,1), matte
    (N,H,W,1), target (N,H,W,3)} resembling ISTD samples."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs, masks, mattes, targets = [], [], [], []
    for i in range(n):
        base = (0.4 + 0.4 * np.sin(xx / (20 + 10 * (i % 3)) + i)
                * np.cos(yy / (25 + 5 * (i % 4))))
        img = np.stack([base * c for c in
                        rng.uniform(0.6, 1.0, 3).astype(np.float32)], -1)
        img += rng.normal(0, 0.02, img.shape).astype(np.float32)
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        ry, rx = rng.uniform(0.1, 0.3) * h, rng.uniform(0.1, 0.3) * w
        d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        matte = np.clip(1.0 - d, 0.0, 1.0).astype(np.float32)
        shadowed = img * (1.0 - 0.6 * matte[..., None])
        imgs.append(np.clip(shadowed, 0, 1))
        masks.append((matte > 0.05).astype(np.float32))
        mattes.append(matte)
        targets.append(np.clip(img, 0, 1))

    def to_u8(a):
        return (np.stack(a) * 255).astype(np.uint8)

    return {"img": to_u8(imgs), "mask": to_u8(masks)[..., None],
            "matte": to_u8(mattes)[..., None], "target": to_u8(targets)}
