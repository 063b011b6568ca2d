"""Device-resident dataset cache; port of
``shadow_removal_istd_tpu/data/device_cache.py``.

ISTD is small (~2.7 GB uint8 for all training streams), so every stream
stays on the card as one stacked uint8 tensor; each step gathers its
shuffled batch there and feeds the augmentation kernel, with no host
work and no host-to-device copy in the training loop.
"""

from __future__ import annotations

import numpy as np
import torch


class DeviceDatasetCache:
    """Stacked (N, H, W, C) uint8 streams on ``device``, in sorted stream
    order (``img``, ``matte``, ``target`` = x, m, y)."""

    def __init__(self, streams: dict[str, np.ndarray],
                 device: str | torch.device):
        self.names = tuple(sorted(streams))
        self.arrays = tuple(
            torch.from_numpy(np.ascontiguousarray(streams[k])).to(device)
            for k in self.names)
        self.n = int(self.arrays[0].shape[0])
        for name, a in zip(self.names, self.arrays):
            if a.shape[0] != self.n:
                raise ValueError(f"stream {name} has {a.shape[0]} samples, "
                                 f"expected {self.n}")

    def gather(self, indices: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Batch-gather every stream by index, on the device."""
        return tuple(a.index_select(0, indices) for a in self.arrays)

    def epoch_indices(self, generator: torch.Generator, batch_size: int,
                      drop_last: bool = True) -> torch.Tensor:
        """Shuffled (steps, batch) int64 index matrix for one epoch, drawn
        from ``generator`` on the cache's device. ``drop_last=False``
        keeps every sample by wrapping the permutation around to fill the
        ragged final batch."""
        dev = self.arrays[0].device
        perm = torch.randperm(self.n, generator=generator, device=dev)
        if drop_last:
            steps = self.n // batch_size
            return perm[:steps * batch_size].reshape(steps, batch_size)
        steps = -(-self.n // batch_size)
        pad = steps * batch_size - self.n
        full = torch.cat([perm, perm[:pad]]) if pad else perm
        return full.reshape(steps, batch_size)
