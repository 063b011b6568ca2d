"""On the card: the control (the nearest precision below the
configuration's, in the program's place) must fail the cell's limits
where the program keeps within them, on three seeds.

    python -m pytest -m cuda portbench/tests/test_portbench_control_cuda.py

Serving runs a one-second window at 480x640 with 8 sampled answers;
training the checked steps at the cell's sizes (they need no window).
The control is the program's int8 engine for bf16 serving and the
reference with TF32 on for f32 training (``portbench/control.py``)."""

import pytest

from portbench import control
from portbench.run import Ctx
from portbench.tests import tiny

SEEDS = (101, 202, 303)
SERVE = {"traffic": {"pool": 16, "sample": 8, "keep_share": 0.05}}


def _over_limits(ctx, readings):
    lim = ctx.config["limits"]["serve" if "mean_abs_gray" in readings else "train"]
    return [k for k, v in readings.items() if lim.get(k) is not None and v > lim[k]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mnet.serve.sat", "mnet.train", "pix2pix.train"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_where_the_program_holds(cuda, cell, seed):
    over = SERVE if "serve" in cell else {}

    def ctx():
        return Ctx(tiny.ROOT, tiny.bench(), tiny.bench_cell(cell), seed, 1.0, False, "cuda",
                   overrides=over)

    kind = control._serve if "serve" in cell else control._train
    program = kind(ctx(), "program")
    ctl = kind(ctx(), "control")
    assert not _over_limits(ctx(), program), program
    assert _over_limits(ctx(), ctl), ctl
