"""Device idle ms a dispatch while the batcher thread is in the
batcher's own work: ``batcher.take`` (the blocking get and the batch
window), ``batcher.resolve`` (the futures' results) and
``batcher.dispatch`` outside its engine spans: each idle instant of the
traced window goes to the innermost batcher-thread span over it
(``lib/spans.py``). Layer: batcher."""

from portbench.lib.spans import idle_ms_a_dispatch


def read(obs):
    return idle_ms_a_dispatch(obs, ("batcher.take", "batcher.resolve", "batcher.dispatch"))
