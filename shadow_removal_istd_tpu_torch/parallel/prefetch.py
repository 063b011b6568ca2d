"""Host -> device prefetching; port of
``shadow_removal_istd_tpu/parallel/prefetch.py``.

Double-buffered transfers: while the card computes step N, batch N+1 is
already on its way (uint8, so 4x less PCIe traffic than float32; the
augmentation normalizes on the card). Only the first batch is staged
before the first yield, so the card starts after one batch's host work;
the queue is topped up to ``size`` batches after each yield, while the
card runs the step the consumer has just enqueued.

On a CUDA device each batch's arrays are copied into pinned host
buffers (a ring of ``size + 1`` slots, each reused once the copy out of
it has finished), then copied to the card ``non_blocking`` on a side
stream, which records an event. The consumer's stream waits on that
event before the batch is used, and every tensor is marked with
``record_stream`` so that its memory is not handed out again before the
consumer's work on it is done. On the CPU a batch is a plain
``torch.from_numpy`` view.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device: str | torch.device = "cuda") -> Iterator:
    """Yield each tuple of numpy arrays from ``iterator`` as a tuple of
    tensors on ``device``, in order; ``size`` batches are in flight
    ahead of the one in use."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield tuple(torch.from_numpy(np.ascontiguousarray(a))
                        for a in batch)
        return
    side = torch.cuda.Stream(device)
    slots: list = [None] * (size + 1)    # (pinned tensors, copy-done event)
    queue: collections.deque = collections.deque()
    count = 0

    def put(batch):
        nonlocal count
        k = count % len(slots)
        count += 1
        old = [None] * len(batch)
        if slots[k] is not None:
            slots[k][1].synchronize()
            old = slots[k][0] + old
        pinned = [p if p is not None and tuple(p.shape) == a.shape
                  and p.dtype == _dtype(a)
                  else torch.empty(a.shape, dtype=_dtype(a), pin_memory=True)
                  for p, a in zip(old, batch)]
        for p, a in zip(pinned, batch):
            np.copyto(p.numpy(), a)
        with torch.cuda.stream(side):
            on_card = tuple(p.to(device, non_blocking=True) for p in pinned)
            done = torch.cuda.Event()
            done.record(side)
        slots[k] = (pinned, done)
        queue.append((on_card, done))

    it = iter(iterator)
    first = next(it, None)
    if first is not None:
        put(first)
    while queue:
        on_card, done = queue.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in on_card:
            t.record_stream(consumer)
        yield on_card
        # the consumer has enqueued its step on this batch: stage the
        # next ones while the card runs it
        while len(queue) < size:
            nxt = next(it, None)
            if nxt is None:
                break
            put(nxt)


def _dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.empty(0, a.dtype)).dtype
