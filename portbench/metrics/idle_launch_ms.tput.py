"""Device idle ms a dispatch while the batcher thread is inside
``engine.forward``, the host launch of the stacked forward (the card
waits for the host's launches): each idle instant of the traced window
goes to the innermost batcher-thread span over it (``lib/spans.py``).
Layer: stacked forward."""

from portbench.lib.spans import idle_ms_a_dispatch


def read(obs):
    return idle_ms_a_dispatch(obs, ("engine.forward",))
