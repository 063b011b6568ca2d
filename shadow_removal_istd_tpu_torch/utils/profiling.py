"""Profiler traces and step timing; port of
``shadow_removal_istd_tpu/utils/profiling.py`` on ``torch.profiler``.

:func:`trace` records one region (the trainer wraps its second epoch)
into a Chrome trace file, viewable in Perfetto or ``chrome://tracing``;
:class:`StepTimer` publishes images/s to the metric stream.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch


def trace_path(logdir: str) -> str:
    """The file :func:`trace` writes:
    ``<logdir>/<host>.<pid>.pt.trace.json``."""
    return os.path.join(logdir,
                        f"{socket.gethostname()}.{os.getpid()}.pt.trace.json")


@contextlib.contextmanager
def trace(logdir: str | None, device: str | torch.device = "cpu"):
    """Record the region into :func:`trace_path` ``(logdir)`` (a no-op
    when ``logdir`` is None): host activity, plus the card's kernels and
    copies when ``device`` is a CUDA device. Yields the profiler (None
    when off); its ``key_averages()`` are read after the region."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.stop()
        prof.export_chrome_trace(trace_path(logdir))


class StepTimer:
    """Wall-clock throughput over a window of steps."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._images = 0

    def update(self, n_images: int) -> None:
        self._images += n_images

    def rate(self) -> float:
        """images/sec since the last reset."""
        dt = time.perf_counter() - self._t0
        return self._images / dt if dt > 0 else 0.0

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._images = 0
