"""Every file that BENCHMARK.json names is found by name, and the file
keeps to the contract's shapes."""

import json
import re

from portbench.run import cell_metrics
from portbench.tests.tiny import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    assert len(json.dumps(b)) < 64 * 1024


def test_every_named_file_is_found():
    b = bench()
    for c in b["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and c["file"].startswith("portbench/")
        assert c["reduced"] == []
    for w in b["workloads"]:
        traffic = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench" / "drivers" / f"{traffic['driver']}.py").is_file()
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    b = bench()
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for w in b["workloads"]:
        e2e, per = cell_metrics(b, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per
        for m in per:
            assert m["moves"] in names
