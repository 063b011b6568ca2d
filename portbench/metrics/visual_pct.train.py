"""The visual loss's share of the train step on the card: the device ms
of the ``step.visual`` spans (the VGG forwards of predictions and
targets, and the losses) and the ``step.visual_backward`` spans (each
VGG backward, bracketed by tensor hooks) over the ``train.step`` spans'
(CUDA events at each span's ends; ``lib/spans.py``). Layer: train
step."""

from portbench.lib.spans import device_ms


def read(obs):
    step = device_ms(obs, ("train.step",))
    vis = device_ms(obs, ("step.visual", "step.visual_backward"))
    if not step or vis is None:
        return None
    return 100.0 * vis / step
