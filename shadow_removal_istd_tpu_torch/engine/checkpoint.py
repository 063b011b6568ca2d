"""Checkpointing: full train state and per-network weight files, in the
JAX package's flax msgpack format, so either package reads what the
other writes. Port of ``shadow_removal_istd_tpu/engine/checkpoint.py``.

1. Per-network weight files ``{G1,G2,D1,D2}_{ClassName}_{best|latest}
   .msgpack`` holding ``{"params", "batch_stats"}``, loadable one by one
   (``--load-weights-*``, and the serving engine).
2. The full training state (step, parameters, BatchNorm statistics, both
   Adam states, BEGAN's k1/k2, the SoftAdapt state) as one file
   ``{"epoch", "state", "host"}``, where ``host`` carries the best
   validation loss and the plateau controllers' state.

The tree mapping is ``tools/convert.py``'s; the encoding
``utils/msgpack_codec.py``'s. The orbax backend is not ported.
"""

from __future__ import annotations

import os

from shadow_removal_istd_tpu_torch.engine.state import TrainState
from shadow_removal_istd_tpu_torch.tools.convert import (
    flax_tree_to_torch,
    load_train_state,
    torch_to_flax_tree,
    train_state_to_flax,
)
from shadow_removal_istd_tpu_torch.utils.msgpack_codec import (
    from_bytes,
    to_bytes,
)

NETS = ("G1", "G2", "D1", "D2")


def _net(state: TrainState, net: str):
    if net.upper() not in NETS:
        raise ValueError(f"net must be one of {NETS}, got {net!r}")
    return getattr(state.models, net.lower())


def net_filename(state: TrainState, net: str, suffix: str) -> str:
    return f"{net}_{type(_net(state, net)).__name__}_{suffix}.msgpack"


def _write(path: str, data: bytes) -> None:
    """Write through a temporary file and rename, so a reader never sees
    a torn file."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _read(path: str):
    with open(path, "rb") as f:
        return from_bytes(f.read())


def save_model_weights(state: TrainState, weights_dir: str,
                       suffix: str = "latest") -> list[str]:
    """Write the four per-network weight files (params + batch stats)."""
    os.makedirs(weights_dir, exist_ok=True)
    written = []
    for net in NETS:
        path = os.path.join(weights_dir, net_filename(state, net, suffix))
        _write(path, to_bytes(torch_to_flax_tree(_net(state, net))))
        written.append(path)
    return written


def load_model_weights(state: TrainState, net: str, path: str) -> None:
    """Load one network's weight file into the state
    (``--load-weights-*``); raises on a tree that does not match."""
    flax_tree_to_torch(_read(path), _net(state, net))


def save_checkpoint(state: TrainState, path: str, epoch: int = 0,
                    host: dict | None = None) -> None:
    """Full training state to one file, ``epoch`` recorded; ``host``
    carries host-side state outside the networks (the best validation
    loss, the plateau controllers)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"epoch": epoch, "state": train_state_to_flax(state)}
    if host:
        payload["host"] = host
    _write(path, to_bytes(payload))


def load_checkpoint(state: TrainState, path: str) -> tuple[int, dict]:
    """Restore a full training state in place; returns (epoch, host).
    Fields the file lacks keep their current values, and a file without
    a ``host`` section returns an empty dict, as in the JAX package."""
    raw = _read(path)
    load_train_state(raw.get("state", {}), state)
    return int(raw.get("epoch", 0)), dict(raw.get("host") or {})
