"""Profiler traces, program spans and step timing; port of
``shadow_removal_istd_tpu/utils/profiling.py`` on ``torch.profiler``.

:func:`trace` records one region (the trainer wraps its second epoch)
into a Chrome trace file, viewable in Perfetto or ``chrome://tracing``;
:class:`StepTimer` publishes images/s to the metric stream.

:func:`span` marks a stretch of the program's own work (the batcher's
take and dispatch, the engine's copies and forward, the train step's
phases). Spans record while tracing is on: after :func:`enable`, and
for as long as a ``torch.profiler`` session runs in the process, so a
profiled region carries them without a flag. Each records its name, its
thread, ``time.time_ns()`` at start and end (the clock of the
profiler's events), its parent (the innermost span open on its thread)
and its attributes; inside a profiler session it also opens a
``record_function`` range of its name, so that the trace's host
timeline shows it. ``span(..., device=True)`` also records a CUDA event
at each end, resolved to ``device_ms`` by :func:`drain`. Finished spans
are kept in memory, at most ``MAX_SPANS`` of them; further ones are
counted by :func:`dropped`. While tracing is off a span site reads two
flags and enters a shared null context.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import socket
import threading
import time
import types

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1 << 16

# torch's own flag for a running profiler session (set by every
# torch.profiler / autograd profiler start and stop)
_session = (_autograd_profiler
            if hasattr(_autograd_profiler, "_is_profiler_enabled")
            else types.SimpleNamespace(_is_profiler_enabled=False))
_on = False
_kept: list = []            # (record, (start event, end event) | None)
_kept_lock = threading.Lock()
_dropped = 0
_ids = itertools.count(1)
_stacks: dict[int, list] = {}   # thread id -> its open spans' records


class _Null:
    """What a span site enters while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL = _Null()


def enable() -> None:
    """Record spans from now on (until :func:`disable`)."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording spans (they still record inside a profiler
    session); spans already open finish."""
    global _on
    _on = False


def recording() -> bool:
    """Whether spans record now (after :func:`enable`, or inside a
    profiler session)."""
    return _on or _session._is_profiler_enabled


def dropped() -> int:
    """Spans finished while ``MAX_SPANS`` were kept, since import."""
    return _dropped


def span(name: str, device: bool = False, **attrs):
    """A context manager over one stretch of the program's work, named
    ``name`` (``layer.step``), with ``attrs`` (plain values). While
    tracing is off, a shared null context."""
    if not (_on or _session._is_profiler_enabled):
        return _NULL
    return _Span(name, device, attrs)


def annotate(**attrs) -> None:
    """Add ``attrs`` to the innermost span open on this thread."""
    if not (_on or _session._is_profiler_enabled):
        return
    stack = _stacks.get(threading.get_ident())
    if stack:
        stack[-1]["attrs"].update(attrs)


def backward_span(name: str, first: torch.Tensor,
                  last: torch.Tensor) -> None:
    """A device span over the part of a backward pass from the gradient
    of ``first`` (an output) to that of ``last`` (an input it was
    computed from): a tensor hook on each opens and closes it, on the
    thread that runs the backward, its parent the innermost span open
    then on this thread. Registered only while tracing is on and both
    tensors take gradients; the hooks change no gradient."""
    if not (_on or _session._is_profiler_enabled):
        return
    if not (first.requires_grad and last.requires_grad):
        return
    owner = threading.get_ident()
    sp = _Span(name, True, {}, owner=owner)

    def opened(grad):
        sp.__enter__()

    def closed(grad):
        if sp.rec["start_ns"] is not None:
            sp.__exit__(None, None, None)

    first.register_hook(opened)
    last.register_hook(closed)


class _Span:
    __slots__ = ("rec", "device", "owner", "rf", "events")

    def __init__(self, name, device, attrs, owner=None):
        self.rec = {"name": name, "id": next(_ids), "parent": None,
                    "thread": None, "start_ns": None, "end_ns": None,
                    "attrs": attrs, "device_ms": None}
        self.device, self.owner = device, owner
        self.rf = self.events = None

    def __enter__(self):
        rec, me = self.rec, threading.get_ident()
        parents = _stacks.get(self.owner if self.owner is not None else me)
        if parents:
            rec["parent"] = parents[-1]["id"]
        rec["thread"] = me
        _stacks.setdefault(me, []).append(rec)
        if _session._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(rec["name"])
            self.rf.__enter__()
        if (self.device and torch.cuda.is_available()
                and torch.cuda.is_initialized()):
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        rec["start_ns"] = time.time_ns()
        return rec

    def __exit__(self, *exc):
        global _dropped
        rec = self.rec
        rec["end_ns"] = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        stack = _stacks[rec["thread"]]
        if stack[-1] is rec:
            stack.pop()
        else:   # brackets of a backward may close out of order
            del stack[next(i for i, r in enumerate(stack) if r is rec)]
        with _kept_lock:
            if len(_kept) < MAX_SPANS:
                _kept.append((rec, self.events))
            else:
                _dropped += 1
        return False


def drain() -> list[dict]:
    """The spans finished since the last drain, in the order they
    finished, and forget them. Each is a dict: ``name``, ``id``,
    ``parent`` (an id or None), ``thread`` (``threading.get_ident``),
    ``start_ns``, ``end_ns`` (``time.time_ns``), ``attrs``, and
    ``device_ms`` (the card's time between the span's CUDA events, or
    None); resolving it waits for the span's end event."""
    global _kept
    with _kept_lock:
        kept, _kept = _kept, []
    for rec, events in kept:
        if events is not None:
            events[1].synchronize()
            rec["device_ms"] = events[0].elapsed_time(events[1])
    return [rec for rec, _ in kept]


def trace_path(logdir: str) -> str:
    """The file :func:`trace` writes:
    ``<logdir>/<host>.<pid>.pt.trace.json``."""
    return os.path.join(logdir,
                        f"{socket.gethostname()}.{os.getpid()}.pt.trace.json")


@contextlib.contextmanager
def trace(logdir: str | None, device: str | torch.device = "cpu"):
    """Record the region into :func:`trace_path` ``(logdir)`` (a no-op
    when ``logdir`` is None): host activity with the program's spans,
    plus the card's kernels and copies when ``device`` is a CUDA device.
    Yields the profiler (None when off); its ``key_averages()`` are read
    after the region."""
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
    prof.start()        # the spans record while it runs
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.stop()
        if not _on:
            drain()     # the trace holds them as ranges
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
