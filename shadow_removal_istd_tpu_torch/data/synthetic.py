"""Synthetic ISTD-like triplets for tests, smoke runs and benchmarks;
port of ``shadow_removal_istd_tpu/data/synthetic.py`` (same numpy draws,
so the same seed gives the same arrays).

Structured, not noise: a smooth base image, a soft elliptical shadow
matte, and the shadowed image derived from them, so the supervised
losses have real signal to fit.
"""

from __future__ import annotations

import os

import numpy as np

from shadow_removal_istd_tpu_torch.utils.image_io import imwrite


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


def write_istd_layout(root: str, n_train: int = 4, n_test: int = 2,
                      h: int = 96, w: int = 128, seed: int = 0) -> None:
    """Materialize a synthetic ISTD directory tree (``{subset}/
    {subset}_{A,B,matte,C_fixed}/NNN-{subset}.png``), the same pixels as
    the JAX package's. Rows cycle through the five PNG filter types, so
    a reader's every unfilter path is exercised."""
    filters = np.arange(h) % 5
    for subset, n in (("train", n_train), ("test", n_test)):
        data = synthetic_triplets(n, h, w, seed=seed + (subset == "test"))
        dirs = {"img": f"{subset}_A", "mask": f"{subset}_B",
                "matte": f"{subset}_matte", "target": f"{subset}_C_fixed"}
        for stream, d in dirs.items():
            path = os.path.join(root, subset, d)
            os.makedirs(path, exist_ok=True)
            for i in range(n):
                arr = data[stream][i]
                if arr.shape[-1] == 1:
                    arr = arr[..., 0]
                imwrite(os.path.join(path, f"{i:03d}-{subset}.png"), arr,
                        filters)
