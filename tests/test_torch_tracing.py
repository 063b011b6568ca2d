"""The port's program spans (``utils/profiling.py``): the batcher's,
the engine's, the train step's and the epoch's, on the CPU.

Held: with tracing off a served request and a train step record no
span, open no ``record_function`` range and register no tensor hook,
and a span site costs a call, two flag reads and a null context (its
time a site is reported); with tracing on, one dispatch through a
``MicroBatcher`` yields its take, its dispatch (id, images, padded
batch, how it was staged) and, under that dispatch, the engine's five
steps and the futures' resolution, in order; inside a CPU profiler
session the spans record by themselves and their ``time.time_ns``
stamps lie within 1 ms of the profiler's ranges of the same name, and
the CLI's Chrome trace (``trace``) carries them; an epoch step yields the
gather, the augmentation and the step's phases in order, and each
``step.visual_backward`` bracket holds exactly the VGG's 12 convolution
backward nodes; served answers, and the 14 metrics and every parameter
over 2 train steps (plain and rematerialized), are bit-identical with
tracing on and off.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.epoch import RngStreams, make_epoch
from shadow_removal_istd_tpu_torch.engine.state import init_state
from shadow_removal_istd_tpu_torch.engine.steps import train_step
from shadow_removal_istd_tpu_torch.models.vgg import (
    VGG19_CFG_THROUGH_POOL4,
    VGG19Features,
)
from shadow_removal_istd_tpu_torch.ops.augment import AugmentConfig
from shadow_removal_istd_tpu_torch.serving import InferenceEngine, MicroBatcher
from shadow_removal_istd_tpu_torch.utils import profiling

ENGINE_KW = dict(ngf=4, dtype="float32", max_batch=4, device="cpu")
TRAIN_KW = dict(ngf=4, ndf=4, droprate=0.0, batch_size=2, image_size=64,
                aug_method="shear")
ENGINE_STEPS = ("engine.assemble", "engine.upload", "engine.forward",
                "engine.download", "engine.unpack")
PHASES = ("step.g_forward", "step.d_phase", "step.g_phase",
          "step.g_backward", "step.adam_g")
OURS = ("batcher.", "engine.", "train.", "step.", "epoch.")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine(**ENGINE_KW)


def _img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _state(**kw):
    torch.manual_seed(5)
    vgg = VGG19Features()
    for p in vgg.parameters():
        nn.init.normal_(p, 0.0, 0.05)
    return init_state(TrainConfig(**TRAIN_KW, **kw),
                      torch.Generator().manual_seed(0), device="cpu", vgg=vgg)


def _batches(n):
    g = torch.Generator().manual_seed(1)
    return [tuple(torch.rand((2, c, 64, 64), generator=g) * 2 - 1
                  for c in (3, 1, 3)) for _ in range(n)]


def _serve(engine, imgs, window_ms=500.0):
    batcher = MicroBatcher(engine, window_ms=window_ms)
    try:
        futs = [batcher.submit(im) for im in imgs]
        return [f.result(timeout=120) for f in futs]
    finally:
        batcher.close()


def _by(spans, name):
    return [s for s in spans if s["name"] == name]


def test_off_records_nothing_and_opens_no_range_or_hook(engine, monkeypatch):
    ranges, hooks = [], []
    real_range = torch.autograd.profiler.record_function
    real_hook = torch.Tensor.register_hook

    def counted_range(name, *a, **k):
        if name.startswith(OURS):
            ranges.append(name)
        return real_range(name, *a, **k)

    def counted_hook(self, fn):
        hooks.append(fn)
        return real_hook(self, fn)

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counted_range)
    monkeypatch.setattr(torch.Tensor, "register_hook", counted_hook)
    _serve(engine, [_img(40, 56, 0)])
    state = _state()
    train_step(state, _batches(1)[0])
    assert profiling.drain() == []
    assert ranges == [] and hooks == []


def test_off_span_site_cost(record_property):
    """A site while tracing is off against a bare ``with`` of a null
    context, in the same process: the difference is the call (with
    CPython's empty keyword dict) and the two flag reads."""
    n = 100_000
    null = contextlib.nullcontext()
    span = profiling.span

    def sites():
        t = time.perf_counter_ns()
        for _ in range(n):
            with span("engine.upload"):
                pass
        return (time.perf_counter_ns() - t) / n

    def bare():
        t = time.perf_counter_ns()
        for _ in range(n):
            with null:
                pass
        return (time.perf_counter_ns() - t) / n

    site, base = [], []
    for _ in range(5):
        site.append(sites())
        base.append(bare())
    site_ns, base_ns = min(site), min(base)
    record_property("span_site_ns", site_ns)
    record_property("null_with_ns", base_ns)
    print(f"span site off: {site_ns:.1f} ns; with nullcontext: {base_ns:.1f} ns")
    assert profiling.drain() == []
    assert site_ns < 2.5 * base_ns


def test_threads_record_and_drain_without_losing_a_span():
    """More recording threads than cores and a concurrent drainer, with a
    short switch interval: every span is drained once, nested under its
    own thread's parent."""
    n_threads, n_spans = 2 * (os.cpu_count() or 4), 300
    drained, stop = [], threading.Event()

    def record():
        for k in range(n_spans):
            with profiling.span("outer", k=k):
                with profiling.span("inner"):
                    pass

    def drainer():
        while not stop.is_set():
            drained.extend(profiling.drain())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    profiling.enable()
    try:
        threads = [threading.Thread(target=record) for _ in range(n_threads)]
        sink = threading.Thread(target=drainer)
        sink.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stop.set()
        sink.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        profiling.disable()
    assert not any(t.is_alive() for t in threads) and not sink.is_alive()
    drained.extend(profiling.drain())
    assert len(drained) == 2 * n_threads * n_spans
    assert len({s["id"] for s in drained}) == len(drained)
    outer = {s["id"]: s for s in drained if s["name"] == "outer"}
    for s in drained:
        if s["name"] == "inner":
            parent = outer[s["parent"]]
            assert parent["thread"] == s["thread"]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
    assert profiling.dropped() == 0


def test_one_dispatch_nests_the_engine_under_the_batcher(engine):
    profiling.enable()
    out = _serve(engine, [_img(40, 56, 0), _img(33, 60, 1)])
    profiling.disable()
    spans = profiling.drain()
    assert len(out) == 2
    (disp,) = _by(spans, "batcher.dispatch")
    assert disp["attrs"] == {"dispatch": 0, "images": 2, "padded": 2,
                             "staging": "none"}
    assert disp["parent"] is None
    steps = [_by(spans, name) for name in (*ENGINE_STEPS, "batcher.resolve")]
    assert [len(s) for s in steps] == [1] * 6
    steps = [s[0] for s in steps]
    for s in steps:
        assert s["parent"] == disp["id"] and s["thread"] == disp["thread"]
        assert disp["start_ns"] <= s["start_ns"] <= s["end_ns"] <= disp["end_ns"]
        assert s["device_ms"] is None
    for a, b in zip(steps, steps[1:]):
        assert a["end_ns"] <= b["start_ns"]
    takes = [s for s in _by(spans, "batcher.take")
             if s["end_ns"] <= disp["start_ns"]]
    assert takes and all(s["thread"] == disp["thread"] and s["parent"] is None
                         for s in takes)


def test_spans_follow_a_profiler_session_on_its_clock(engine):
    img = _img(40, 56, 0)
    engine.infer_group([img])
    assert profiling.drain() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.infer_group([img])
    spans = {s["name"]: s for s in profiling.drain()}
    assert set(spans) == set(ENGINE_STEPS)
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ENGINE_STEPS}
    assert set(ranges) == set(ENGINE_STEPS)
    for name, e in ranges.items():
        s = spans[name]
        assert abs(e.start_ns() - s["start_ns"]) < 1_000_000, name
        assert abs(e.start_ns() + e.duration_ns() - s["end_ns"]) < 1_000_000, name
    engine.infer_group([img])
    assert profiling.drain() == []


def test_the_clis_chrome_trace_carries_the_spans(engine, tmp_path):
    with profiling.trace(str(tmp_path)):
        engine.infer_group([_img(40, 56, 0)])
    with open(profiling.trace_path(str(tmp_path))) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(ENGINE_STEPS) <= names
    assert profiling.drain() == []


def test_epoch_step_phases_and_the_vgg_backward_bracket():
    state = _state()
    gen = torch.Generator().manual_seed(2)
    arrays = tuple(torch.randint(0, 256, (4, 72, 80, c), generator=gen,
                                 dtype=torch.uint8) for c in (3, 1, 3))
    epoch_fn = make_epoch(AugmentConfig(crop_size=64, method="shear"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        epoch_fn(state, arrays, torch.tensor([[0, 2]]), RngStreams(3, 0))
    spans = profiling.drain()
    order = sorted((s for s in spans if s["parent"] is None),
                   key=lambda s: s["start_ns"])
    assert [s["name"] for s in order] == ["epoch.gather", "epoch.augment",
                                          "train.step"]
    (step,) = _by(spans, "train.step")
    phases = sorted((s for s in spans if s["parent"] == step["id"]),
                    key=lambda s: s["start_ns"])
    assert [s["name"] for s in phases] == list(PHASES)
    by_phase = {s["name"]: s for s in phases}
    (vis,) = _by(spans, "step.visual")
    assert vis["parent"] == by_phase["step.g_phase"]["id"]
    brackets = _by(spans, "step.visual_backward")
    assert len(brackets) == 2
    g_back = by_phase["step.g_backward"]
    for b in brackets:
        assert b["parent"] == g_back["id"]
        assert g_back["start_ns"] <= b["start_ns"] < b["end_ns"] <= g_back["end_ns"]
    convs = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name() == "autograd::engine::evaluate_function: "
                            "ConvolutionBackward0"]
    n_vgg = sum(isinstance(v, int) for v in VGG19_CFG_THROUGH_POOL4)
    assert n_vgg == 12
    inside = [[c for c in convs if b["start_ns"] <= c[0] and c[1] <= b["end_ns"]]
              for b in brackets]
    assert [len(i) for i in inside] == [n_vgg, n_vgg]
    # no other network's convolution backward overlaps a bracket
    touching = [c for c in convs for b in brackets
                if c[0] < b["end_ns"] and c[1] > b["start_ns"]]
    assert len(touching) == 2 * n_vgg


def test_each_dispatch_says_how_it_was_staged(engine):
    """Every dispatch of a served stream carries ``staging`` (``"none"``
    on the CPU, with no page-locked count) and the engine's five steps
    under it, in order."""
    profiling.enable()
    out = _serve(engine, [_img(40, 56, s) for s in range(6)], window_ms=0.0)
    profiling.disable()
    spans = profiling.drain()
    assert len(out) == 6
    dispatches = _by(spans, "batcher.dispatch")
    assert sum(d["attrs"]["images"] for d in dispatches) == 6
    for d in dispatches:
        assert d["attrs"]["staging"] == "none"
        assert "pinned_allocs" not in d["attrs"]
        inner = sorted((s for s in spans if s["parent"] == d["id"]
                        and s["name"].startswith("engine.")),
                       key=lambda s: s["start_ns"])
        assert [s["name"] for s in inner] == list(ENGINE_STEPS)


def test_tracing_changes_no_answer(engine):
    imgs = [_img(40, 56, s) for s in range(3)]
    plain = engine.infer_group(imgs)
    profiling.enable()
    traced = engine.infer_group(imgs)
    profiling.disable()
    assert profiling.drain()
    for (m0, y0), (m1, y1) in zip(plain, traced):
        assert np.array_equal(m0, m1) and np.array_equal(y0, y1)


@pytest.mark.parametrize("remat", [False, True])
def test_tracing_changes_no_training_state(remat):
    """Two steps with tracing off and on: the 14 metrics and every
    parameter and statistic bit for bit; under remat the replays open no
    second visual span or bracket."""
    batches = _batches(2)
    runs = []
    for on in (False, True):
        state = _state(remat=remat)
        if on:
            profiling.enable()
        metrics = [train_step(state, b) for b in batches]
        profiling.disable()
        params = [p.detach().clone() for n in state.models.all()
                  for p in [*n.parameters(), *n.buffers()]]
        runs.append((metrics, params))
    spans = profiling.drain()
    assert [len(_by(spans, n)) for n in ("train.step", "step.visual",
                                         "step.visual_backward")] == [2, 2, 4]
    (m_off, p_off), (m_on, p_on) = runs
    for a, b in zip(m_off, m_on):
        assert a.keys() == b.keys() and len(a) == 14
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(p_off, p_on))
