"""The benchmark of ``shadow_removal_istd_tpu_torch`` on NVIDIA H100 cards.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data: a cell names a configuration
(``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``, whose ``driver`` key names the
general generator in ``portbench/drivers/``); each per-layer metric is a
reader of its own (``portbench/metrics/<metric>.py``). The yardstick
(peaks, FLOP and byte counts, trace reduction) lives in ``portbench/lib/``
and the plain reference that decides ``correct`` in
``portbench/reference/``, which imports nothing of the program.

This package imports nothing at import time: ``run.py`` stamps the
process start before torch loads.
"""
