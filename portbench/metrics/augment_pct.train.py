"""The epoch's gather and augmentation as a share of its steps on the
card: device ms of the ``epoch.gather`` (the ``index_select`` of each
step's rows) and ``epoch.augment`` (``augment_batch``) spans, over their
own plus the ``train.step`` spans' (CUDA events at each span's ends;
``lib/spans.py``). Layer: augmentation."""

from portbench.lib.spans import device_ms


def read(obs):
    step = device_ms(obs, ("train.step",))
    aug = device_ms(obs, ("epoch.gather", "epoch.augment"))
    if step is None or aug is None or aug + step <= 0:
        return None
    return 100.0 * aug / (aug + step)
