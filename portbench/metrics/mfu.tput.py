"""The stacked forward's share of the card's bf16 peak: FLOPs of the
images answered in the traced window (the bucket's per-image count,
``lib/costs.py``) over the window's length at 989 TFLOP/s. Layer:
stacked forward."""

from portbench.lib.costs import PEAK_BF16


def read(obs):
    if "calls" not in obs:
        return None
    images = sum(c[2] for c in obs["calls"])
    return 100.0 * images * obs["flops_per_image"] / (obs["window"].seconds * PEAK_BF16)
