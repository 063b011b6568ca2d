"""Tiny CPU sizes of every cell, for the CPU tests: the plain paths at
widths and shapes a test run holds."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SERVE = {"config": {"model": {"ngf": 4}},
         "traffic": {"height": 64, "width": 96, "pool": 4, "clients": 4,
                     "keep_share": 1.0, "sample": 4,
                     "trace_lead_s": 0.2, "trace_s": 0.5}}
# the checked steps at these sizes normalise a few values per channel in
# the innermost BatchNorms, where f32 rounding alone moves either side
# further than at the cell's sizes: the CPU runs hold their own limits
TINY_TRAIN_LIMITS = {"aug_max_abs": 1e-4, "loss1_gap": 5e-3, "loss23_gap": 5e-2, "grad1_gap": 5e-2,
                     "change3_gap": 0.5}
TRAIN = {"config": {"model": {"ngf": 4, "ndf": 4}, "limits": {"train": TINY_TRAIN_LIMITS},
                    "train": {"n_train": 8, "data_hw": [64, 96], "image_size": 64,
                              "batch_size": 2}},
         "traffic": {"chunk_steps": 1, "trace_lead_s": 0.2, "trace_s": 0.5}}


# pix2pix's 8 levels halve a 256-pixel crop down to one pixel
PIX2PIX = {"config": {"model": {"ngf": 4, "ndf": 4}, "limits": {"train": TINY_TRAIN_LIMITS},
                      "train": {"n_train": 8, "data_hw": [256, 264], "image_size": 256,
                                "batch_size": 2}},
           "traffic": TRAIN["traffic"]}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def overrides(cell):
    w = bench_cell(cell)
    if not w["traffic"].startswith("epoch"):
        return SERVE
    return PIX2PIX if w["config"].startswith("pix2pix") else TRAIN


def bench_cell(name):
    return next(w for w in bench()["workloads"] if w["name"] == name)


def ctx(name, seed=1, seconds=1.0, trace=False, traffic=None):
    from portbench.run import Ctx, _merge

    over = overrides(name)
    if traffic:
        over = _merge(over, {"traffic": traffic})
    return Ctx(ROOT, bench(), bench_cell(name), seed, seconds, trace, "cpu", overrides=over)
