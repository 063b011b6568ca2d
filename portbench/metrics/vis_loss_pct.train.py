"""The visual loss's share of the step: device time between the
``g_adv`` and ``g_visual`` marks of ``train_step`` over the steps' device
time (CUDA events at the marks). Layer: train step."""


def read(obs):
    if not obs.get("step_ms"):
        return None
    return 100.0 * obs["vis_ms"] / obs["step_ms"]
