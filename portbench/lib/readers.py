"""Readers that several per-layer metrics share."""


def dispatch_ms(obs):
    calls = obs.get("calls")
    if not calls:
        return None
    return sum(b - a for a, b, _, _ in calls) / len(calls) / 1e6


def idle_pct(obs):
    win = obs.get("window")
    return None if win is None else win.idle_pct()
