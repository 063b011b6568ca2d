"""The serving engine's answers as its dispatch computed them before
page-locked staging: a fresh ``np.full`` batch of 128, each replica's
slice uploaded from pageable memory and run through ``_stacked``, the
outputs downloaded with ``.cpu()``, joined by ``np.concatenate`` on the
host, and cropped.

Imports ``torch`` and ``numpy`` only, so the CPU tests and the card
tests (run there without the tests' conftest) both load it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def padded_batch(engine, n: int) -> int:
    """The device batch the engine pads a group of ``n`` to."""
    if engine.fixed_batch is not None:
        return engine.fixed_batch
    nd = len(engine.devices)
    bp = min(1 << max(0, (n - 1).bit_length()), max(engine.max_batch, n))
    return math.ceil(bp / nd) * nd


def full_batch(engine, imgs: list[np.ndarray]) -> np.ndarray:
    """The padded batch: 128 everywhere, each image in its corner."""
    bh, bw = engine.bucket_of(*imgs[0].shape[:2])
    batch = np.full((padded_batch(engine, len(imgs)), bh, bw, 3), 128,
                    np.uint8)
    for i, im in enumerate(imgs):
        batch[i, :im.shape[0], :im.shape[1]] = im
    return batch


def pageable(engine, imgs: list[np.ndarray]
             ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per image ``(matte, shadow_free)``, computed the pageable way."""
    batch = full_batch(engine, imgs)
    b = len(batch) // len(engine.devices)
    outs = [engine._stacked(torch.from_numpy(batch[j * b:(j + 1) * b]).to(d),
                            j)
            for j, d in enumerate(engine.devices)]
    m_np = np.concatenate([m.cpu().numpy() for m, _ in outs])
    y_np = np.concatenate([y.cpu().numpy() for _, y in outs])
    return [(m_np[i, :im.shape[0], :im.shape[1], 0],
             y_np[i, :im.shape[0], :im.shape[1]])
            for i, im in enumerate(imgs)]
