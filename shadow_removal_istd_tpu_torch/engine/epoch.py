"""One training epoch over the device-resident dataset: gather ->
augment (the configuration's method: the exact bilinear gather or the
``hshear`` kernel) -> train step, per step, with no host work and no
host sync inside the epoch.

Port of ``shadow_removal_istd_tpu/engine/epoch.py``. JAX compiles the
epoch into one ``lax.scan``; PyTorch runs it eagerly, step by step, and
only enqueues work on the card: metric sums stay on the device until the
caller reads them. (Capturing the epoch as a CUDA graph is a later
step.) The trainer's host-pipeline epoch runs the same step loop,
:func:`train_steps`, over batches uploaded from the host, so that a host
epoch over a batch order equals the fused epoch over that index matrix,
step for step.

Randomness is a pure function of ``(seed, epoch, step)``, as JAX's
``fold_in`` makes it: :class:`RngStreams` derives each generator's seed
from ``numpy.random.SeedSequence([seed, epoch, step, stream])``, one
stream each for the epoch's shuffle, a step's augmentation draws and
G1's and G2's dropout masks. The two frameworks draw different numbers
from these seeds; the tests inject the same index matrix and
augmentation parameters into both.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from shadow_removal_istd_tpu_torch.engine.state import TrainState
from shadow_removal_istd_tpu_torch.engine.steps import train_step
from shadow_removal_istd_tpu_torch.ops.augment import (
    AugmentConfig,
    augment_batch,
)
from shadow_removal_istd_tpu_torch.utils.profiling import span

STREAMS = {"init": 0, "shuffle": 1, "augment": 2, "dropout_g1": 3,
           "dropout_g2": 4}


def derive_seed(seed: int, epoch: int, step: int, stream: str) -> int:
    """A 63-bit seed that depends only on its four arguments."""
    ss = np.random.SeedSequence([seed, epoch, step, STREAMS[stream]])
    return int(ss.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)


class RngStreams:
    """The generators of one epoch: ``generator(stream, step)`` is a
    fresh ``torch.Generator`` on ``device`` seeded by
    :func:`derive_seed`."""

    def __init__(self, seed: int, epoch: int,
                 device: str | torch.device = "cpu"):
        self.seed, self.epoch, self.device = seed, epoch, torch.device(device)

    def generator(self, stream: str, step: int = 0) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(derive_seed(self.seed, self.epoch, step, stream))
        return gen


def train_steps(state: TrainState, raws: Iterable, aug_cfg: AugmentConfig,
                gen: RngStreams,
                param_source: Callable[[int], dict] | None = None):
    """The step loop of both epochs. For each raw batch ``raws`` yields
    (a tuple of (B, H, W, C) uint8 tensors on the card, sorted stream
    order), step ``s`` augments it with the ``("augment", s)`` draw (or
    ``param_source(s)``'s parameters) and runs ``train_step`` with the
    step's dropout generators. Over ``state.mesh`` a raw batch is this
    rank's slice of the global batch, and the draws (or the given
    parameters) are the global batch's. While tracing is on
    (``utils/profiling.py``) each augmentation is a device span,
    ``epoch.augment``. Returns ``(sums, n, first)``:
    the 14 metrics summed over the ``n`` steps (device tensors, not read
    back) and step 0's augmented batch."""
    sums: dict[str, torch.Tensor] = {}
    first = None
    n = 0
    for step, raw in enumerate(raws):
        shard = {} if state.mesh is None else {"mesh": state.mesh}
        with span("epoch.augment", device=True):
            if param_source is not None:
                batch = augment_batch(None, raw, aug_cfg,
                                      params=param_source(step), **shard)
            else:
                batch = augment_batch(gen.generator("augment", step), raw,
                                      aug_cfg, **shard)
        if first is None:
            first = batch
        metrics = train_step(state, batch,
                             (gen.generator("dropout_g1", step),
                              gen.generator("dropout_g2", step)))
        for k, v in metrics.items():
            sums[k] = sums[k] + v if k in sums else v
        n += 1
    return sums, n, first


def make_epoch(aug_cfg: AugmentConfig,
               param_source: Callable[[int], dict] | None = None):
    """Build ``epoch_fn(state, arrays, idx, gen) -> (state, sums)``.

    ``arrays``: the (N, H, W, C) uint8 streams on the card in sorted
    stream order; ``idx``: the (steps, batch) index matrix (over a mesh,
    this rank's columns of the global one); ``gen``: the
    epoch's :class:`RngStreams`. Step ``s`` gathers ``idx[s]`` on the
    card (a device span, ``epoch.gather``, while tracing is on) and runs
    :func:`train_steps`' step. ``param_source(step)``,
    when given, supplies each step's augmentation parameters in place of
    the draw (the tests inject JAX's). ``sums`` are the 14 metrics
    summed over the epoch, as device tensors."""

    def epoch_fn(state: TrainState, arrays, idx: torch.Tensor,
                 gen: RngStreams):
        def raws():
            for step in range(idx.shape[0]):
                with span("epoch.gather", device=True):
                    raw = tuple(a.index_select(0, idx[step]) for a in arrays)
                yield raw

        sums, _, _ = train_steps(state, raws(), aug_cfg, gen, param_source)
        return state, sums

    return epoch_fn
