"""Device idle ms a dispatch while the batcher thread is inside the
engine's ``engine.assemble`` (the batch built in numpy) or
``engine.upload`` (the pageable copy to the card) spans: each idle
instant of the traced window goes to the innermost batcher-thread span
over it (``lib/spans.py``), summed over the window's dispatches
(``batcher.dispatch`` spans). Layer: engine."""

from portbench.lib.spans import idle_ms_a_dispatch


def read(obs):
    return idle_ms_a_dispatch(obs, ("engine.assemble", "engine.upload"))
