"""The traced window: torch.profiler's raw events, reduced to what the
per-layer readers and the result line need.

Events are read from the profiler's kineto results (name, device type,
start and duration in ns on the host's wall clock, which ``time.time_ns``
shares). Device activity is every kernel, copy and set on the card, not
the card's mirrors of host annotations (such as ``Optimizer.step``),
which span the idle time between their kernels; the device is busy
where their union lies, and idle elsewhere in the window. An idle gap is labelled by what the host was doing: the
innermost host event (the shortest of those that overlap it most).
"""

from __future__ import annotations

from dataclasses import dataclass, field


# what runs on the card: kernels, copies and sets
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Event:
    name: str
    device: bool        # True: ran on the card
    start: int          # ns
    end: int            # ns


@dataclass
class Window:
    t0: int
    t1: int
    events: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def device_events(self):
        return [e for e in self.events if e.device and e.end > self.t0 and e.start < self.t1]

    def host_events(self):
        return [e for e in self.events if not e.device]

    def busy_intervals(self):
        spans = sorted((max(e.start, self.t0), min(e.end, self.t1))
                       for e in self.device_events())
        merged = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.seconds)

    def gaps(self):
        """(start, end) of every idle stretch in the window."""
        out, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < self.t1:
            out.append((t, self.t1))
        return out

    def kernel_seconds(self, match) -> float:
        """Device seconds of the events whose name satisfies ``match``."""
        return sum(min(e.end, self.t1) - max(e.start, self.t0)
                   for e in self.device_events() if match(e.name)) / 1e9

    def top_ops(self, n=10):
        by = {}
        for e in self.device_events():
            d = min(e.end, self.t1) - max(e.start, self.t0)
            by[_short(e.name)] = by.get(_short(e.name), 0) + d
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n=10):
        host = sorted(self.host_events(), key=lambda e: e.start)
        out = []
        for a, b in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]:
            best, key = "host: no traced operation", None
            for e in host:
                if e.start >= b:
                    break
                ov = min(e.end, b) - max(e.start, a)
                if ov <= 0:
                    continue
                k = (ov, -(e.end - e.start))
                if key is None or k > key:
                    best, key = "host: " + _short(e.name), k
            out.append([best, (b - a) / 1e9])
        return out


def _short(name: str) -> str:
    name = " ".join(name.split())
    return name if len(name) <= 160 else name[:157] + "..."


def start(device_type: str = "cuda"):
    """A started profiler recording host operations and (on the card) the
    device's activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:    # host operations of every thread, where this torch can
        extra = {"experimental_config": torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)}
    except (AttributeError, TypeError):
        extra = {}
    prof = profile(activities=acts, record_shapes=False, with_stack=False, **extra)
    prof.start()
    return prof


def stop(prof, t0: int, t1: int) -> Window:
    """Stop ``prof`` and keep its events as a :class:`Window` [t0, t1]
    (ns, ``time.time_ns``)."""
    import torch

    prof.stop()
    cuda = torch.autograd.DeviceType.CUDA
    raw = prof.profiler.kineto_results.events()
    host_names = {e.name() for e in raw if e.device_type() != cuda}
    events = []
    for e in raw:
        on_card = e.device_type() == cuda
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        if on_card and ((kind is not None and kind not in DEVICE_WORK)
                        or e.name() in host_names):
            continue    # the card's mirror of a host annotation holds idle time too
        s = e.start_ns()
        events.append(Event(e.name(), on_card, s, s + e.duration_ns()))
    return Window(t0, t1, events)
