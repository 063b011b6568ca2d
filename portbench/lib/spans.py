"""The program's own spans of the traced window (``utils/profiling.py``
in the program), for the readers of ``program_span`` metrics.

The program records spans for as long as a profiler session runs, so
the traced window's spans wait in its recorder when the readers run:
the first reader drains them into ``obs["spans"]``, the others read
them there. A program without the recorder gives None, and its readers
read nothing.

Serving: each idle instant of the window (``Window.gaps()``) goes to
the innermost span of the batcher's thread that covers it (the thread
of the ``batcher.dispatch`` spans); an instant under none of them goes
nowhere. Training: the card's time of each span, from its CUDA events.
"""

from __future__ import annotations

import bisect


def spans(obs):
    """The window's spans (dicts as the program's ``drain()`` gives
    them), or None."""
    if "window" not in obs:
        return None
    if "spans" not in obs:
        try:
            from shadow_removal_istd_tpu_torch.utils import profiling
        except ImportError:
            obs["spans"] = None
        else:
            drain = getattr(profiling, "drain", None)
            obs["spans"] = drain() if drain is not None else None
    return obs["spans"] or None


def idle_by_name(window, spans_):
    """(ns of the window's idle time under each span name, each idle
    instant counted for the innermost span of the batcher's thread over
    it; the number of ``batcher.dispatch`` spans that start in the
    window), or None without a dispatch span."""
    disp = [s for s in spans_ if s["name"] == "batcher.dispatch"]
    if not disp:
        return None
    thread = disp[0]["thread"]
    mine = [s for s in spans_ if s["thread"] == thread and s["end_ns"] > s["start_ns"]
            and s["end_ns"] > window.t0 and s["start_ns"] < window.t1]
    idle_before = _idle_clock(window)
    # a sweep over the spans' ends: the innermost open span (the last
    # opened) owns the stretch up to the next end
    marks = sorted([(s["start_ns"], 1, -s["end_ns"], i) for i, s in enumerate(mine)]
                   + [(s["end_ns"], 0, 0, i) for i, s in enumerate(mine)])
    out, open_, t = {}, [], window.t0
    for when, is_start, _, i in marks:
        when = min(max(when, window.t0), window.t1)
        if open_ and when > t:
            name = mine[open_[-1]]["name"]
            out[name] = out.get(name, 0) + idle_before(when) - idle_before(t)
        t = max(t, when)
        if is_start:
            open_.append(i)
        elif i in open_:
            open_.remove(i)
    n = sum(1 for s in disp if window.t0 <= s["start_ns"] < window.t1)
    return out, n


def _idle_clock(window):
    """t -> the window's idle ns before t."""
    gaps = window.gaps()
    starts = [a for a, _ in gaps]
    before = [0]
    for a, b in gaps:
        before.append(before[-1] + (b - a))

    def idle_before(t):
        k = bisect.bisect_right(starts, t)
        if k == 0:
            return 0
        a, b = gaps[k - 1]
        return before[k - 1] + min(t, b) - a

    return idle_before


def idle_ms_a_dispatch(obs, names):
    """Idle ms a dispatch under the spans named ``names``, or None."""
    sp = spans(obs)
    if sp is None:
        return None
    got = idle_by_name(obs["window"], sp)
    if got is None or got[1] == 0:
        return None
    by_name, n = got
    return sum(by_name.get(name, 0) for name in names) / n / 1e6


def device_ms(obs, names):
    """The card's ms of the spans named ``names``, or None where no such
    span has a device time."""
    sp = spans(obs)
    if sp is None:
        return None
    times = [s["device_ms"] for s in sp if s["name"] in names and s["device_ms"] is not None]
    return sum(times) if times else None
