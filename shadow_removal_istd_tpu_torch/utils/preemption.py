"""Graceful preemption of long training runs; port of
``shadow_removal_istd_tpu/utils/preemption.py``.

Preemptible machines deliver SIGTERM shortly before eviction. The
training loop then checkpoints the full state at the next epoch boundary
and exits cleanly, so ``--load-checkpoint`` resumes exactly where the
preempted run stopped.

The handler only sets a flag: all checkpoint IO happens on the main
thread at a safe point (between epochs), never inside the signal
context.
"""

from __future__ import annotations

import logging
import signal

logger = logging.getLogger(__name__)


class PreemptionGuard:
    """Installs signal handlers that request a graceful stop.

    Usage::

        with PreemptionGuard() as guard:
            for epoch in ...:
                train_one_epoch()
                if guard.requested:
                    save_checkpoint(epoch)
                    break
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._old: dict = {}
        self.requested = False

    def _handler(self, signum, frame):
        self.requested = True
        logger.warning(
            "received signal %s: will checkpoint and stop at the next "
            "epoch boundary", signal.Signals(signum).name)

    def __enter__(self):
        for s in self._signals:
            try:
                self._old[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):
                # not the main thread / unsupported platform: a no-op
                # guard rather than a refusal to train
                logger.debug("could not install handler for %s", s)
        return self

    def __exit__(self, *exc):
        for s, old in self._old.items():
            signal.signal(s, old)
        self._old.clear()
        return False
