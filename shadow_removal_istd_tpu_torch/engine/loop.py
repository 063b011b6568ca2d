"""Trainer: fused training epochs, validation and best-model tracking.

Port of the core of ``shadow_removal_istd_tpu/engine/loop.py::Trainer``
(the ``--device-cache`` fused path): the uint8 training streams live on
the card (``data/device_cache.py``), every epoch runs ``engine/epoch.py``
(gather -> ``hshear`` augmentation -> adversarial step), and every
``valid_every`` epochs :meth:`Trainer.run_valid_epoch` runs
``eval_step`` over full-resolution validation batches, keeping the best
``total`` (0.8*G + 0.2*D).

Not ported yet: checkpoints and per-network weight files, TensorBoard
scalars and images, the CLI, ISTD directory and HDF5 loading, the
plateau schedule, preemption and the in-training evaluation protocol.

Precision: PyTorch runs f32 cuDNN convolutions in TF32 by default. The
trainer turns TF32 off for cuDNN and cuBLAS (process-wide flags), so an
f32 step computes in full f32, as the tests hold it; under
``compute_dtype="bfloat16"`` the bf16 convolutions are unaffected and
the f32 parts (VGG, augmentation matmuls) stay exact.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch
from torch import nn

from shadow_removal_istd_tpu_torch import resolve_device
from shadow_removal_istd_tpu_torch.data.device_cache import (
    DeviceDatasetCache,
)
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.epoch import (
    RngStreams,
    derive_seed,
    make_epoch,
)
from shadow_removal_istd_tpu_torch.engine.state import TrainState, init_state
from shadow_removal_istd_tpu_torch.engine.steps import METRIC_KEYS, eval_step
from shadow_removal_istd_tpu_torch.models.vgg import (
    VGG19Features,
    load_vgg_npz,
)
from shadow_removal_istd_tpu_torch.ops.augment import (
    AugmentConfig,
    check_supported,
    normalize_batch,
)

logger = logging.getLogger(__name__)


def _select(streams: dict[str, np.ndarray], cfg: TrainConfig) -> dict:
    """The configuration's streams; sorted they must be (x, m, y)."""
    picked = {k: streams[k] for k in cfg.train_datas}
    if len(picked) != 3:
        raise ValueError(f"training needs 3 streams (x, m, y), got "
                         f"{sorted(picked)}")
    return picked


class Trainer:
    def __init__(self, cfg: TrainConfig, train_streams: dict,
                 valid_streams: dict | None = None, *, seed: int,
                 device: str | torch.device = "cuda",
                 vgg_weights: str | nn.Module | None = None,
                 allow_missing_vgg: bool = False):
        """``train_streams``/``valid_streams``: dicts of (N, H, W, C)
        uint8 numpy arrays (``cfg.train_datas`` picks three of them).
        ``vgg_weights``: a converted ``.npz`` path or a VGG module (e.g.
        seeded random weights); nonzero visual lambdas need one unless
        ``allow_missing_vgg``, which then trains without those terms."""
        self.device = resolve_device(device)
        self.seed = seed
        self.cache = DeviceDatasetCache(_select(train_streams, cfg),
                                        self.device)
        steps = self.cache.n // cfg.batch_size
        if steps == 0:
            raise ValueError(f"{self.cache.n} training samples make no "
                             f"batch of {cfg.batch_size}")
        self.cfg = dataclasses.replace(cfg, steps_per_epoch=steps)
        _, h, w, _ = self.cache.arrays[0].shape
        self.aug_cfg = AugmentConfig(
            scale=cfg.aug_scale, angle=cfg.aug_angle, flip_prob=0.5,
            crop_size=cfg.image_size, resize=cfg.aug_resize,
            method=cfg.aug_method)
        check_supported(self.aug_cfg, h, w)
        self.valid = (DeviceDatasetCache(_select(valid_streams, cfg),
                                         self.device)
                      if valid_streams else None)

        vgg = None
        if isinstance(vgg_weights, nn.Module):
            vgg = vgg_weights
        elif vgg_weights:
            if not os.path.isfile(vgg_weights):
                raise FileNotFoundError(
                    f"vgg_weights {vgg_weights!r} does not exist")
            vgg = load_vgg_npz(vgg_weights)
        elif cfg.use_visual_loss and (cfg.lambda4 or cfg.lambda5):
            msg = (f"visual loss weights lambda4={cfg.lambda4}/lambda5="
                   f"{cfg.lambda5} are nonzero but no VGG weights were "
                   "given: convert them once with tools/convert_vgg.py and "
                   "pass vgg_weights, or set lambda4 = lambda5 = 0, or pass "
                   "allow_missing_vgg=True to train WITHOUT the perceptual "
                   "terms")
            if not allow_missing_vgg:
                raise ValueError(msg)
            logger.warning("%s (continuing without them)", msg)
        if vgg is not None and not isinstance(vgg, VGG19Features):
            raise TypeError(f"vgg_weights module must be VGG19Features, "
                            f"got {type(vgg).__name__}")

        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        init_gen = torch.Generator().manual_seed(
            derive_seed(seed, 0, 0, "init"))
        self.state: TrainState = init_state(self.cfg, init_gen, self.device,
                                            vgg=vgg)
        self.epoch_fn = make_epoch(self.aug_cfg)
        self.best_loss = float("inf")
        self.history: list[dict[str, float]] = []

    # ----------------------------------------------------------- train
    def train(self, epochs: int, valid_every: int = 10) -> None:
        """Epochs ``0 .. epochs-1``; validates after every epoch that is
        a multiple of ``valid_every`` and keeps the best ``total``. Reads
        the epoch's metric sums back once per epoch (``history``)."""
        for epoch in range(epochs):
            sums, n = self.run_train_epoch(epoch)
            self.history.append({k: float(v) / n for k, v in sums.items()})
            if self.valid is not None and epoch % valid_every == 0:
                total = self.run_valid_epoch(epoch)
                if total < self.best_loss:
                    self.best_loss = total
                    logger.info("improvement after epoch %d, error=%.4f",
                                epoch, total)

    def run_train_epoch(self, epoch: int
                        ) -> tuple[dict[str, torch.Tensor], int]:
        """One fused epoch; returns the metric sums (device tensors, not
        read back) and the step count."""
        gen = RngStreams(self.seed, epoch, self.device)
        idx = self.cache.epoch_indices(gen.generator("shuffle"),
                                       self.cfg.batch_size)
        self.state, sums = self.epoch_fn(self.state, self.cache.arrays, idx,
                                         gen)
        return sums, idx.shape[0]

    def run_valid_epoch(self, epoch: int) -> float:
        """``eval_step`` over the validation streams at full resolution,
        in order, keeping the ragged last batch; returns the mean of the
        batches' ``total`` and stores every metric's mean in
        ``last_valid``. The eval generators use the current weights (no
        frozen decoder kernels: ``MNet.train`` drops them)."""
        b = self.cfg.batch_size
        sums: dict[str, torch.Tensor] = {}
        n = 0
        for start in range(0, self.valid.n, b):
            sel = torch.arange(start, min(start + b, self.valid.n),
                               device=self.device)
            batch = normalize_batch(self.valid.gather(sel))
            for k, v in eval_step(self.state, batch).items():
                sums[k] = sums[k] + v if k in sums else v
            n += 1
        self.last_valid = {k: float(v) / n for k, v in sums.items()}
        logger.info("valid epoch %d: %s", epoch, ", ".join(
            f"{k} {self.last_valid[k]:.4f}" for k in (*METRIC_KEYS[:6],
                                                      "total")))
        return self.last_valid["total"]
