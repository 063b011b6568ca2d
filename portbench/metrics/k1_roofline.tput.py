"""K1's share of its roofline in the traced window: the least time of
every K1 launch of the window's dispatches (10 a stacked forward at the
padded batch; ``lib/costs.py``), over the K1 kernels' device time.
Layer: decoder op K1."""

import re

_K1 = re.compile(r"decoder_upsample|narrow_tc_kernel|narrow_f32_kernel")


def read(obs):
    if "calls" not in obs:
        return None
    spent = obs["window"].kernel_seconds(lambda n: bool(_K1.search(n)))
    if spent <= 0:
        return None
    least = sum(obs["k1_least_s"](c[3]) for c in obs["calls"])
    return 100.0 * least / spent
