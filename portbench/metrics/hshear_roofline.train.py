"""``hshear``'s share of its roofline in the traced window: the bytes its
3 passes a step must move (the columns each row's taps reach, the
output, the taps; ``lib/costs.py``, for the parameters the steps drew)
at 3.35 TB/s, over the ``hshear`` kernels' device time. Layer:
augmentation."""

from portbench.lib.costs import PEAK_BYTES


def read(obs):
    if "hshear_bytes" not in obs:
        return None
    spent = obs["window"].kernel_seconds(lambda n: "hshear" in n)
    if spent <= 0:
        return None
    return 100.0 * obs["hshear_bytes"] / PEAK_BYTES / spent
