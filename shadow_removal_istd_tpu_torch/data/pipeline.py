"""Host-side batch pipeline; port of
``shadow_removal_istd_tpu/data/pipeline.py``.

The host's only per-step job is slicing preloaded uint8 arrays into
batches (decode happens once up front). Shuffling is numpy-seeded per
epoch for reproducibility. The trainer runs validation and inference
through it, in order, keeping the ragged last batch, and its
host-pipeline training epochs in the seeded order, dropping it.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class BatchPipeline:
    """Batches over stacked uint8 stream arrays.

    streams: dict name -> (N, H, W, C) uint8; iteration yields tuples in
    sorted-name order (the engine's (img, matte, target) convention).
    """

    def __init__(self, streams: dict[str, np.ndarray], batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 38107943):
        self.streams = dict(sorted(streams.items()))
        self.n = next(iter(self.streams.values())).shape[0]
        for name, arr in self.streams.items():
            if arr.shape[0] != self.n:
                raise ValueError(f"stream {name} misaligned: {arr.shape[0]} "
                                 f"samples, expected {self.n}")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)

    def order(self, epoch: int | None = None) -> np.ndarray:
        """The sample order of one epoch (see :meth:`epoch`)."""
        idx = np.arange(self.n)
        if self.shuffle:
            rng = (self._rng if epoch is None
                   else np.random.default_rng((self.seed, epoch)))
            rng.shuffle(idx)
        return idx

    def epoch(self, epoch: int | None = None) \
            -> Iterator[tuple[np.ndarray, ...]]:
        """Pass ``epoch`` for RESUME-DETERMINISTIC shuffling: the
        permutation becomes a pure function of (seed, epoch), so a run
        resumed from a checkpoint at epoch N sees the same batch order
        the uninterrupted run saw. Without it the stateful stream is
        used (reproducible only from epoch 0)."""
        idx = self.order(epoch)
        stop = (self.n - self.batch_size + 1) if self.drop_last else self.n
        for start in range(0, max(stop, 0), self.batch_size):
            sel = idx[start:start + self.batch_size]
            yield tuple(arr[sel] for arr in self.streams.values())
