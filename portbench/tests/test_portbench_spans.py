"""The readers of the program's spans (``lib/spans.py`` and the
``program_span`` metrics) on made-up windows and spans."""

import importlib.util

import pytest

from portbench.lib import spans as lib
from portbench.lib.trace import Event, Window
from portbench.tests.tiny import ROOT

MS = 1_000_000
BATCHER, OTHER = 11, 22
IDLE_READERS = ("idle_copy_in_ms.tput", "idle_launch_ms.tput", "idle_copy_out_ms.tput",
                "idle_batcher_ms.tput")
TRAIN_READERS = ("visual_pct.train", "augment_pct.train")


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sp(name, a, b, thread=BATCHER, device_ms=None):
    return {"name": name, "id": None, "parent": None, "thread": thread,
            "start_ns": int(a * MS), "end_ns": int(b * MS), "attrs": {},
            "device_ms": device_ms}


def serving():
    """A 20 ms window, the card busy over [2, 4], [9, 12], [15, 16] ms:
    idle 14 ms. Two dispatches on the batcher thread; [19, 20] lies under
    no span; another thread's span over the whole window is not the
    batcher's."""
    busy = [Event("kernel", True, a * MS, b * MS) for a, b in ((2, 4), (9, 12), (15, 16))]
    window = Window(0, 20 * MS, busy)
    spans = [sp("batcher.take", 0, 1),
             sp("batcher.dispatch", 1, 10),
             sp("engine.assemble", 1.5, 3), sp("engine.upload", 3, 5),
             sp("engine.forward", 5, 6), sp("engine.download", 6, 8.5),
             sp("engine.unpack", 8.5, 9.5), sp("batcher.resolve", 9.5, 9.8),
             sp("batcher.take", 10, 13),
             sp("batcher.dispatch", 13, 19), sp("engine.forward", 14, 15.5),
             sp("engine.forward", 0, 20, thread=OTHER)]
    return {"window": window, "spans": spans}


def test_innermost_span_takes_each_idle_instant():
    obs = serving()
    by_name, n = lib.idle_by_name(obs["window"], obs["spans"])
    assert n == 2
    want = {"batcher.take": 2, "batcher.dispatch": 4.5, "engine.assemble": 0.5,
            "engine.upload": 1, "engine.forward": 2, "engine.download": 2.5,
            "engine.unpack": 0.5, "batcher.resolve": 0}
    assert {k: v / MS for k, v in by_name.items() if v} == {k: v for k, v in want.items() if v}


def test_dispatch_self_time_and_the_per_dispatch_division():
    obs = serving()
    got = {name: reader(name)(obs) for name in IDLE_READERS}
    assert got["idle_copy_in_ms.tput"] == pytest.approx(1.5 / 2)
    assert got["idle_launch_ms.tput"] == pytest.approx(2 / 2)
    assert got["idle_copy_out_ms.tput"] == pytest.approx(3 / 2)
    # takes 1 + 1, resolve 0, the dispatches' own time 0.5 and 1 + 3
    assert got["idle_batcher_ms.tput"] == pytest.approx(6.5 / 2)


def test_a_gap_under_no_span_counts_nowhere():
    obs = serving()
    idle_ms = obs["window"].idle_pct() / 100 * 20
    assert idle_ms == pytest.approx(14.0)
    attributed = sum(reader(name)(obs) for name in IDLE_READERS) * 2
    assert attributed == pytest.approx(idle_ms - 1.0)


def test_training_shares():
    spans = [sp("train.step", 0, 10, device_ms=10.0), sp("train.step", 10, 20, device_ms=10.0),
             sp("step.visual", 1, 2, device_ms=3.0), sp("step.visual", 11, 12, device_ms=3.0),
             *[sp("step.visual_backward", 2, 3, device_ms=2.0) for _ in range(4)],
             sp("epoch.gather", 0, 1, device_ms=0.5), sp("epoch.gather", 10, 11, device_ms=0.5),
             sp("epoch.augment", 0, 1, device_ms=1.5), sp("epoch.augment", 10, 11, device_ms=1.5),
             sp("step.g_phase", 1, 3, device_ms=None)]
    obs = {"window": Window(0, 20 * MS, []), "spans": spans}
    assert reader("visual_pct.train")(obs) == pytest.approx(100 * 14 / 20)
    assert reader("augment_pct.train")(obs) == pytest.approx(100 * 4 / 24)
    # spans with no device time (the CPU) read nothing
    cpu = {"window": obs["window"], "spans": [dict(s, device_ms=None) for s in spans]}
    assert all(reader(name)(cpu) is None for name in TRAIN_READERS)


@pytest.mark.parametrize("name", IDLE_READERS + TRAIN_READERS)
def test_nothing_to_read_reads_nothing(name):
    assert reader(name)({}) is None
    window = Window(0, MS, [])
    assert reader(name)({"window": window, "spans": None}) is None
    assert reader(name)({"window": window, "spans": []}) is None


def test_the_programs_spans_are_drained_once_into_obs(monkeypatch):
    from shadow_removal_istd_tpu_torch.utils import profiling

    profiling.drain()
    profiling.enable()
    try:
        with profiling.span("batcher.dispatch", dispatch=0):
            pass
    finally:
        profiling.disable()
    obs = {"window": Window(0, MS, [])}
    got = lib.spans(obs)
    assert [s["name"] for s in got] == ["batcher.dispatch"] and obs["spans"] is got
    assert lib.spans(obs) is got and profiling.drain() == []
    # a program without the recorder (the parent commit's) gives nothing
    monkeypatch.delattr(profiling, "drain")
    assert lib.spans({"window": Window(0, MS, [])}) is None
