"""Device idle ms a dispatch while the batcher thread is inside
``engine.download`` (the copies to the host, which wait for the
forward) or ``engine.unpack`` (the concatenation and the crops): each
idle instant of the traced window goes to the innermost batcher-thread
span over it (``lib/spans.py``). Layer: engine."""

from portbench.lib.spans import idle_ms_a_dispatch


def read(obs):
    return idle_ms_a_dispatch(obs, ("engine.download", "engine.unpack"))
