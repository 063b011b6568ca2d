"""Every cell end to end at a tiny size on the CPU through the plain
paths, its last line parsed against the contract; the run's refusal
without a card; and the faults each cell can have, planted under the
timed path, each turning ``correct`` false."""

import io
import json
import shutil
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from portbench import control
from portbench.drivers import serve
from portbench.run import cell_metrics, emit, run_cell
from portbench.tests import tiny

CELLS = [w["name"] for w in tiny.bench()["workloads"]]


def _line(cell, trace, **kw):
    line = run_cell(tiny.ctx(cell, trace=trace, **kw))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        emit(line)
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
    return last


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_end_to_end(cell, trace):
    line = _line(cell, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    e2e, per = cell_metrics(tiny.bench(), cell)
    want = {m["name"]: m["unit"] for m in (per if trace else e2e)}
    for name, m in line["metrics"].items():
        assert m["unit"] == want[name] and isinstance(m["value"], float)
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
        # the CPU has no device time: the device readers stay silent
        assert "mfu.train" in line["metrics"] or not cell.endswith("train")
    else:
        assert set(line["metrics"]) == set(want)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit", "bound"}


def test_without_a_card_no_result(tmp_path):
    root = tiny.ROOT
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (root, tmp_path):
        proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                               "--seed", "3000000017", "--seconds", "1", "--trace", "0"],
                              cwd=cwd, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_open_schedule_same_work_every_seed():
    a = serve.open_schedule(200.0, 5.0, 0, np.random.default_rng(1))
    b = serve.open_schedule(200.0, 5.0, 0, np.random.default_rng(2))
    assert len(a) == len(b) == 1000
    assert a[-1] == pytest.approx(5.0) and b[-1] == pytest.approx(5.0)
    assert np.all(np.diff(a) > 0)
    assert np.allclose(np.sort(np.diff(a, prepend=0)), np.sort(np.diff(b, prepend=0)))
    assert not np.allclose(a, b)


# the open-loop generator, which no cell drives today (PERF.md §7)
OPEN = {"loop": "open", "rate_per_s": 40.0, "gap_seed": 0}


def test_open_loop_counts_lateness_from_the_due_time(monkeypatch):
    """A submit that stalls 0.3 s makes the generator late and every
    request behind it later; both are counted from the due times."""
    from shadow_removal_istd_tpu_torch.serving.server import MicroBatcher

    plain = MicroBatcher.submit
    calls = []

    def submit(self, img):
        calls.append(1)
        if len(calls) == 16 + 10:     # the set-up sends 16, the window 40
            time.sleep(0.3)
        return plain(self, img)

    monkeypatch.setattr(MicroBatcher, "submit", submit)
    res = serve.run(tiny.ctx("mnet.serve.sat", seconds=1.0, traffic=OPEN))
    late = res["extra"]["generator_late_ms"]
    assert late["max"] >= 250.0 and late["p50"] >= 0.0
    # the requests due during the stall are late by it, counted from their due times
    assert res["e2e"]["serve_p95_ms"] >= 100.0 and len(res["latencies_s"]) == 40


# -- faults, planted under the timed path ----------------------------------

def _answer_altered(monkeypatch):
    from shadow_removal_istd_tpu_torch.serving.engine import InferenceEngine

    plain = InferenceEngine._stacked

    def altered(self, x_u8, replica=0):
        m, y = plain(self, x_u8, replica)
        return m, y ^ 64

    monkeypatch.setattr(InferenceEngine, "_stacked", altered)


def _train_fault(kind):
    def plant(monkeypatch):
        from shadow_removal_istd_tpu_torch.engine import epoch

        if kind in ("half_batch", "unchanged"):
            step, _ = control._train_planted(kind, epoch)
        else:       # the step's answer altered where it is produced
            plain = epoch.train_step

            def step(state, batch, gens=(None, None), **kw):
                return {k: v * 1.1 for k, v in plain(state, batch, gens, **kw).items()}

        monkeypatch.setattr(epoch, "train_step", step)
    return plant


FAULTS = [(c, "answer", _answer_altered) for c in CELLS if "serve" in c]
FAULTS += [(c, k, _train_fault(k)) for c in CELLS if c.endswith("train")
           for k in ("unchanged", "half_batch", "answer")]


@pytest.mark.parametrize("cell,kind,plant", FAULTS, ids=[f"{c}-{k}" for c, k, _ in FAULTS])
def test_fault_is_not_correct(cell, kind, plant, monkeypatch):
    plant(monkeypatch)
    line = run_cell(tiny.ctx(cell))
    assert line["correct"] is False, line["checks"]


def test_without_a_fault_the_same_cells_are_correct():
    torch.manual_seed(0)
    for cell in CELLS:
        assert run_cell(tiny.ctx(cell, seed=2 ** 31 + 5))["correct"] is True
