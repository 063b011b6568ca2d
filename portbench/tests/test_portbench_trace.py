"""The trace reduction and the per-layer readers on made-up events."""

import importlib.util

import pytest

from portbench.lib import costs
from portbench.lib.trace import Event, Window
from portbench.tests.tiny import ROOT

MS = 1_000_000


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def window():
    # a 10 ms window: kernels over [1, 3] and [2, 4] ms (overlapping),
    # a copy over [6, 7], one reaching past the end; host work around
    ev = [Event("void decoder_upsample_tc_kernel<128>(...)", True, 1 * MS, 3 * MS),
          Event("narrow_tc_kernel", True, 2 * MS, 4 * MS),
          Event("Memcpy DtoH (Device -> Pageable)", True, 6 * MS, 7 * MS),
          Event("hshear_kernel", True, 9 * MS, 12 * MS),
          Event("aten::copy_", False, 4 * MS, 6 * MS),
          Event("cudaStreamSynchronize", False, 4 * MS + MS // 2, 5 * MS + MS // 2),
          Event("portbench.outer", False, 0, 10 * MS)]
    return Window(0, 10 * MS, ev)


def test_busy_idle_and_gaps():
    w = window()
    assert w.busy_intervals() == [[1 * MS, 4 * MS], [6 * MS, 7 * MS], [9 * MS, 10 * MS]]
    assert w.busy_s() == pytest.approx(5e-3)
    assert w.idle_pct() == pytest.approx(50.0)
    assert w.gaps() == [(0, 1 * MS), (4 * MS, 6 * MS), (7 * MS, 9 * MS)]
    gaps = w.top_gaps()
    # the 2 ms gap at [4, 6]: aten::copy_ covers all of it and is the
    # shortest such host event
    assert gaps[0] == ["host: aten::copy_", pytest.approx(2e-3)]
    assert [g[1] for g in gaps] == pytest.approx([2e-3, 2e-3, 1e-3])
    ops = dict((k, v) for k, v in w.top_ops())
    assert ops["hshear_kernel"] == pytest.approx(1e-3)      # clipped at the end
    assert w.kernel_seconds(lambda n: "decoder_upsample" in n) == pytest.approx(2e-3)


def test_serving_readers():
    w = window()
    calls = [(0, 4 * MS, 8, 8), (5 * MS, 9 * MS, 3, 4)]
    obs = {"window": w, "calls": calls, "images": 11, "batches": 2,
           "flops_per_image": 1e9, "k1_least_s": lambda bp: bp * 1e-4}
    assert reader("batch_mean.tput")(obs) == pytest.approx(5.5)
    assert reader("dispatch_ms.tput")(obs) == pytest.approx(4.0)
    assert reader("mfu.tput")(obs) == pytest.approx(100 * 11e9 / (0.01 * costs.PEAK_BF16))
    # K1 launches took 2 + 2 ms; their least time 12 * 1e-4 s
    assert reader("k1_roofline.tput")(obs) == pytest.approx(100 * 1.2e-3 / 4e-3)
    assert reader("idle_pct.tput")(obs) == pytest.approx(50.0)


def test_training_readers():
    obs = {"window": window(), "images": 32, "flops_per_image": 1e9,
           "peak_flops": costs.PEAK_F32, "hshear_bytes": 3.35e12 * 0.5e-3,
           "vis_ms": 3.0, "step_ms": 5.0}
    assert reader("mfu.train")(obs) == pytest.approx(100 * 32e9 / (0.01 * 67e12))
    assert reader("vis_loss_pct.train")(obs) == pytest.approx(60.0)
    # 0.5 ms of bytes over the 1 ms hshear ran inside the window
    assert reader("hshear_roofline.train")(obs) == pytest.approx(50.0)
    assert reader("idle_pct.train")(obs) == pytest.approx(50.0)


@pytest.mark.parametrize("name", ["batch_mean.tput", "dispatch_ms.tput", "mfu.tput",
                                  "k1_roofline.tput", "mfu.train", "vis_loss_pct.train",
                                  "hshear_roofline.train", "idle_pct.tput", "idle_pct.train"])
def test_nothing_to_read_reads_nothing(name):
    assert reader(name)({}) is None
    # a window without the metric's kernels: a roofline share stays
    # silent rather than reading 0
    if "roofline" in name:
        empty = Window(0, MS, [Event("other", True, 0, MS)])
        obs = {"window": empty, "calls": [(0, MS, 1, 1)], "k1_least_s": lambda b: 1e-4,
               "hshear_bytes": 1e6}
        assert reader(name)(obs) is None


def test_stop_keeps_the_cards_work_and_not_its_mirrors_of_host_annotations():
    import torch

    from portbench.lib import trace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    class E:
        def __init__(self, name, dev, start, dur):
            self._n, self._d, self._s, self._l = name, dev, start, dur

        def name(self):
            return self._n

        def device_type(self):
            return self._d

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._l

    class Prof:
        def stop(self):
            pass

    prof = Prof()
    prof.profiler = type("P", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: [
        E("Optimizer.step#Adam.step", cpu, 0, 9 * MS),
        E("Optimizer.step#Adam.step", cuda, 0, 9 * MS),     # the card's mirror
        E("void adam_kernel", cuda, 1 * MS, 1 * MS),
        E("Memcpy HtoD (Pageable -> Device)", cuda, 5 * MS, 1 * MS)]})()
    w = trace.stop(prof, 0, 10 * MS)
    assert [e.name for e in w.device_events()] == ["void adam_kernel",
                                                   "Memcpy HtoD (Pageable -> Device)"]
    assert w.idle_pct() == pytest.approx(80.0)
