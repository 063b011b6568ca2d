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
``utils/msgpack_codec.py``'s.

3. The orbax backend (``--checkpoint-backend orbax``): a directory of
   ``step_N`` orbax checkpoints (``engine/orbax_format.py``), each with a
   ``meta_step_N.json`` beside it holding ``{"epoch", "host"}``, read and
   written by the JAX package's ``save_checkpoint_orbax`` /
   ``load_checkpoint_orbax`` as well. :class:`AsyncCheckpointer` commits
   in a background thread: ``save`` returns once the state is copied to
   the host, so the next optimizer step, which updates the parameters in
   place, cannot reach bytes still being written.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from shadow_removal_istd_tpu_torch.engine import orbax_format
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

logger = logging.getLogger(__name__)


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


# ------------------------------------------------------------------ orbax


class AsyncCheckpointer:
    """Commits orbax checkpoint directories in a background thread, one at
    a time. :meth:`save` waits for the commit before it (orbax's rule, and
    it bounds the host copies in flight to one), then starts this one;
    :meth:`wait_until_finished` joins it and re-raises its error.
    ``commit_ms`` lists each finished commit's wall time."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.commit_ms: list[float] = []

    def _commit(self, path: str, tree: dict) -> None:
        t0 = time.perf_counter()
        try:
            orbax_format.write_step(path, tree)
        except BaseException as exc:    # re-raised by wait_until_finished
            self._error = exc
            return
        self.commit_ms.append((time.perf_counter() - t0) * 1e3)
        logger.info("orbax checkpoint %s committed in %.1f ms", path,
                    self.commit_ms[-1])

    def save(self, path: str, tree: dict) -> None:
        """Write ``tree`` (host numpy leaves, never written to again) as
        the orbax directory ``path`` in the background."""
        self.wait_until_finished()
        self._thread = threading.Thread(
            target=self._commit, args=(path, tree),
            name="orbax-commit", daemon=False)
        self._thread.start()

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def make_orbax_checkpointer() -> AsyncCheckpointer:
    """One checkpointer to own for a training run's lifetime."""
    return AsyncCheckpointer()


def save_checkpoint_orbax(state: TrainState, directory: str, step: int,
                          host: dict | None = None,
                          checkpointer: AsyncCheckpointer | None = None,
                          wait: bool = False) -> None:
    """The full training state as ``directory/step_N``, the JAX package's
    layout: ``meta_step_N.json`` (``{"epoch", "host"}``) goes beside the
    step directory, never inside it, and its presence does not mean the
    step is committed (readers go through :func:`latest_orbax_step`).

    Returns once every tensor is copied to the host; the directory commits
    in the background unless ``wait``. A throwaway checkpointer (none
    given) always drains."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    ckptr = checkpointer or make_orbax_checkpointer()
    ckptr.wait_until_finished()
    tree = train_state_to_flax(state)   # host copies, taken before returning
    ckptr.save(os.path.join(directory, f"step_{step}"), tree)
    _write(os.path.join(directory, f"meta_step_{step}.json"),
           json.dumps({"epoch": step, "host": host or {}}).encode())
    if wait or checkpointer is None:
        ckptr.wait_until_finished()


def latest_orbax_step(directory: str) -> int:
    """Largest committed ``step_N`` in an orbax checkpoint directory (a
    staged ``step_N.orbax-checkpoint-tmp-*`` is not one)."""
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.isdir(
                os.path.join(directory, name)):
            try:
                steps.append(int(name[len("step_"):]))
            except ValueError:
                continue
    if not steps:
        raise FileNotFoundError(
            f"no finalized orbax checkpoints under {directory}")
    return max(steps)


def load_checkpoint_orbax(state: TrainState, directory: str,
                          step: int | None = None) -> tuple[int, dict]:
    """Restore a full training state in place from an orbax checkpoint
    directory; returns (epoch, host). ``directory`` is the backend's root
    (its latest step, or ``step``) or one ``step_N`` directory."""
    directory = os.path.abspath(directory)
    base = os.path.basename(directory)
    if base.startswith("step_"):
        step = int(base[len("step_"):])
        directory = os.path.dirname(directory)
    elif step is None:
        step = latest_orbax_step(directory)
    load_train_state(orbax_format.read_step(
        os.path.join(directory, f"step_{step}")), state)
    meta_path = os.path.join(directory, f"meta_step_{step}.json")
    epoch, host = step, {}
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        epoch = int(meta.get("epoch", step))
        host = dict(meta.get("host") or {})
    return epoch, host
