"""Two-stage pipeline parallelism for stacked G1 -> G2 inference; port of
``shadow_removal_istd_tpu/parallel/pipeline.py``.

The stacked generators are a two-stage pipeline by construction: G1
detects the shadow matte, G2 removes the shadow given it. Here the
stages split the given devices into two equal groups: G1's weights live
only on the first group, G2's only on the second, and each batch flows
A -> B with the image and matte handed over between the stages. Each
stage enqueues its work on a CUDA stream of its own per device, so
while stage B finishes batch i, stage A already works on batch i+1
(:meth:`StackedPipeline.stream` keeps ``depth`` batches in flight).
Within a stage a batch that splits evenly over the group's devices is
sharded over them; a ragged one runs whole on the group's first
device, the result a replicated stage gives.

A device list that names one card twice puts both stages on that card,
on two streams. On the CPU the stages run one after the other.
"""

from __future__ import annotations

import contextlib
import copy
import logging
from collections import deque
from typing import Any, Callable, Iterable, Iterator, Sequence

import torch
from torch import nn

logger = logging.getLogger(__name__)


def _device_of(net: nn.Module) -> torch.device:
    return next(net.parameters()).device


def place(net: nn.Module, device: torch.device) -> nn.Module:
    """``net`` in eval mode on ``device``: itself when it is there, else
    a copy moved there (whose frozen decoder kernels, where the network
    has them, are built anew on that device)."""
    if _device_of(net) == device:
        return net.eval()
    moved = copy.deepcopy(net).to(device)
    moved.train()           # drops kernels frozen for the old device
    moved.eval()
    if hasattr(moved, "freeze"):
        moved.freeze()
    return moved


def _stream(device: torch.device):
    return torch.cuda.Stream(device=device) if device.type == "cuda" else None


def _on(*streams) -> contextlib.ExitStack:
    """Make each (CUDA) stream current on its device."""
    stack = contextlib.ExitStack()
    for s in streams:
        if s is not None:
            stack.enter_context(torch.cuda.stream(s))
    return stack


def _wait(stream, tensor: torch.Tensor) -> None:
    """``stream`` waits for the work queued so far on ``tensor``'s
    current stream, and ``tensor``'s memory is kept for ``stream``."""
    if stream is None or not tensor.is_cuda:
        return
    stream.wait_stream(torch.cuda.current_stream(tensor.device))
    if tensor.device == stream.device:
        tensor.record_stream(stream)


def _event(stream):
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def _hand_over(tensors, device: torch.device, ev_a, h, s_b):
    """Stage A's outputs (ready at ``ev_a``) for stage B on ``device``.
    On one card stage B's stream waits for stage A's; across cards the
    copies run on a hand-over stream ``h`` of stage A's card, so that
    stage A's own stream never waits for stage B's queue (a copy between
    cards synchronizes both devices' current streams)."""
    if ev_a is None:                               # CPU stages
        return tuple(t.to(device) for t in tensors)
    if h is None:
        s_b.wait_event(ev_a)
        for t in tensors:
            t.record_stream(s_b)
        return tuple(tensors)
    h.wait_event(ev_a)
    with _on(h, s_b):
        out = tuple(t.to(device, non_blocking=True) for t in tensors)
    for t in tensors:
        t.record_stream(h)
    return out


def _hand_to_caller(t: torch.Tensor, ev) -> None:
    """The caller's current stream on ``t``'s device waits for ``ev``
    (the stage that made ``t``); ``t``'s memory is kept for it."""
    if ev is None:
        return
    caller = torch.cuda.current_stream(t.device)
    caller.wait_event(ev)
    t.record_stream(caller)


class StackedPipeline:
    """G1 on one device group, G2 on the other, batches flowing through.
    ``__call__(x) -> (m_pred, y_pred)`` matches ``engine.steps
    .infer_step(g1, g2, x)`` (``x`` an (N, 3, H, W) image in [-1, 1] on
    any device; the matte comes back on stage A's first device, the
    shadow-free image on stage B's); :meth:`stream` pipelines an
    iterator of batches with up to ``depth`` in flight."""

    def __init__(self, g1: nn.Module, g2: nn.Module,
                 devices: Sequence[Any] | None = None, depth: int = 2):
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        if len(devices) < 2:
            raise ValueError("the pipeline needs >= 2 devices, got "
                             f"{devices}")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"the pipeline's devices mix types: {devices}")
        half = len(devices) // 2
        if len(devices) % 2:
            logger.warning("the pipeline splits devices into two equal "
                           "stage groups; odd device %s stays idle",
                           devices[-1])
        self.devices_a, self.devices_b = devices[:half], devices[half:2 * half]
        # each stage's weights exist only on its own device group (one
        # copy per distinct device)
        self.g1 = self._replicas(g1, self.devices_a)
        self.g2 = self._replicas(g2, self.devices_b)
        self.streams_a = [_stream(d) for d in self.devices_a]
        self.streams_b = [_stream(d) for d in self.devices_b]
        self.streams_h = [_stream(a) if a != b else None
                          for a, b in zip(self.devices_a, self.devices_b)]
        self.depth = depth

    @staticmethod
    def _replicas(net: nn.Module, devices) -> list[nn.Module]:
        placed: dict[torch.device, nn.Module] = {}
        for d in devices:
            if d not in placed:
                placed[d] = place(net, d)
        return [placed[d] for d in devices]

    def _slices(self, n: int) -> list[slice]:
        """The batch's shard per device of a stage: equal slices when
        they divide it, else the whole batch on the first device."""
        k = len(self.devices_a)
        if n % k == 0 and n >= k:
            b = n // k
            return [slice(j * b, (j + 1) * b) for j in range(k)]
        return [slice(0, n)]

    @torch.no_grad()
    def _run(self, x: torch.Tensor):
        """Enqueue both stages of one batch; returns ``(m, y, done)``,
        ``done`` the events on the caller's streams after which ``m`` and
        ``y`` are complete (empty on the CPU)."""
        ms, ys, evs_a, evs_b = [], [], [], []
        for j, sl in enumerate(self._slices(x.shape[0])):
            s_a, s_b = self.streams_a[j], self.streams_b[j]
            _wait(s_a, x)
            with _on(s_a):
                x_a = x[sl].to(self.devices_a[j], non_blocking=True)
                m = self.g1[j](x_a)
            ev_a = _event(s_a)
            x_b, m_b = _hand_over((x_a, m), self.devices_b[j], ev_a,
                                  self.streams_h[j], s_b)
            with _on(s_b):
                y = self.g2[j](torch.cat([x_b.to(m_b.dtype), m_b], dim=1))
            ms.append(m)
            ys.append(y)
            evs_a.append(ev_a)
            evs_b.append(_event(s_b))
        m, y = self._gather(ms, evs_a), self._gather(ys, evs_b)
        done = [_event(torch.cuda.current_stream(t.device))
                for t in (m, y) if t.is_cuda]
        return m, y, done

    @staticmethod
    def _gather(parts: list[torch.Tensor], events: list) -> torch.Tensor:
        """The parts on the first part's device, on the caller's stream."""
        for t, ev in zip(parts, events):
            _hand_to_caller(t, ev)
        if len(parts) == 1:
            return parts[0]
        return torch.cat([t.to(parts[0].device) for t in parts])

    def __call__(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        m, y, _ = self._run(x)
        return m, y

    def stream(self, batches: Iterable[torch.Tensor]
               ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """Pipeline an iterator of image batches, keeping up to ``depth``
        in flight: batch i+1's stages are enqueued before batch i is
        waited for, so stage A works on batch i+1 while stage B finishes
        batch i. Each yielded pair is complete on the card."""
        for m, y, done in overlap(self._run, batches, self.depth):
            for ev in done:
                ev.synchronize()
            yield m, y


def overlap(fn: Callable, batches: Iterable[Any],
            depth: int = 2) -> Iterator[Any]:
    """Dispatch ahead: yield ``fn(batch)`` results with up to
    ``depth`` batches in flight, so the consumer's blocking read-back of
    result i overlaps the (asynchronously enqueued) device work of batch
    i+1. The one implementation behind :meth:`StackedPipeline.stream`
    and the trainer's ``infer`` read-back."""
    q: deque = deque()
    for x in batches:
        q.append(fn(x))
        if len(q) >= depth:
            yield q.popleft()
    while q:
        yield q.popleft()
