"""The share of the traced window in which no kernel, copy or set ran on
the card (the profiler's timeline). Layer: device."""

from portbench.lib.readers import idle_pct as read  # noqa: F401
