"""Trainer: fused training epochs, validation, best-model tracking,
per-network weight files, checkpoints and inference to PNG files.

Port of ``shadow_removal_istd_tpu/engine/loop.py`` (its ``--device-cache``
path). Data comes from ISTD directories (``run.data_dirs``) or injected
streams. The uint8 training streams live on the card
(``data/device_cache.py``) and every epoch runs ``engine/epoch.py``
(gather -> ``hshear`` augmentation -> adversarial step); validation and
inference walk the test split in order through the host
``BatchPipeline``, keeping the ragged last batch (resized to
``valid_resize`` when set). Every ``valid_every`` epochs
:meth:`Trainer.run_valid_epoch` runs ``eval_step``, keeping the best
``total`` (0.8*G + 0.2*D) and writing the ``best`` weight files on
improvement; the ``latest`` ones are written on every ``log_every`` epoch
and the full checkpoint every ``save_every``. Files are the JAX package's
flax msgpack files (``engine/checkpoint.py``).

With ``run.eval_metrics`` each validation also scores ``eval_step``'s
predictions by the ISTD protocol (LAB RMSE/MAE over shadow, non-shadow
and all pixels, reference src/eval.py) against the binary ``test_B``
masks, snapped to the PNG grids the offline ``metrics/eval_cli.py``
reads, and passes ``Eval/*`` (``EvalProxy/*`` when the masks are
missing and the matte stands in) to ``Trainer.eval_writer``.

Not ported yet (``RunConfig`` raises where one is asked for): the HDF5
dataset, the orbax backend, the host-pipeline training epoch
(``device_cache=False``), profiler traces, pipeline-parallel inference.
TensorBoard scalars and images (``vis_every``) and the preemption save
are not ported either: epoch metrics go to the log, ``Eval/*`` to the
log and the writer hook.

The legacy tree's options: ``dcgan_init`` re-initializes the four
networks DCGAN-style at start, drawn from the ``init`` stream after the
default init; under ``lr_schedule="plateau"`` two ReduceLROnPlateau
controllers step once per epoch on the SUMMED epoch ``G`` and ``D``
(read back with the epoch's other sums) and scale the constant base
rates; their state rides in the checkpoint's ``host`` section as
``plateau_g``/``plateau_d``, as in the JAX package.

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
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from shadow_removal_istd_tpu_torch import resolve_device
from shadow_removal_istd_tpu_torch.data.device_cache import (
    DeviceDatasetCache,
)
from shadow_removal_istd_tpu_torch.data.istd import ISTDDataset
from shadow_removal_istd_tpu_torch.data.pipeline import BatchPipeline
from shadow_removal_istd_tpu_torch.engine import checkpoint as ckpt
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.epoch import (
    RngStreams,
    derive_seed,
    make_epoch,
)
from shadow_removal_istd_tpu_torch.engine.schedules import ReduceLROnPlateau
from shadow_removal_istd_tpu_torch.engine.state import TrainState, init_state
from shadow_removal_istd_tpu_torch.engine.steps import (
    METRIC_KEYS,
    eval_step,
    infer_step,
)
from shadow_removal_istd_tpu_torch.metrics.metrics import (
    aggregate_regions,
    region_metrics,
)
from shadow_removal_istd_tpu_torch.models.layers import apply_dcgan_init_
from shadow_removal_istd_tpu_torch.models.vgg import load_vgg_npz
from shadow_removal_istd_tpu_torch.ops.augment import (
    AugmentConfig,
    denormalize,
    float_to_uint8,
    normalize_batch,
)
from shadow_removal_istd_tpu_torch.ops.color import bgr_to_rgb, rgb_to_lab
from shadow_removal_istd_tpu_torch.ops.resize import resize, resize_linear
from shadow_removal_istd_tpu_torch.utils.image_io import imwrite

logger = logging.getLogger(__name__)


@dataclass
class RunConfig:
    """Run-level knobs (paths, intervals): the non-model CLI surface,
    with the JAX package's fields and defaults, except ``device_cache``,
    which is True: the port trains on the device cache only."""

    data_dirs: tuple[str, ...] = ()
    data_h5: str | None = None
    logs_dir: str = "./logs"
    weights_dir: str = "./weights"
    infered_dir: str = "./infered"
    checkpoint_path: str = "./checkpoint.msgpack"
    checkpoint_backend: str = "msgpack"
    log_every: int = 3
    valid_every: int = 10
    vis_every: int = 50
    save_every: int = 50
    seed: int = 38107943
    vgg_weights: str | None = None
    allow_missing_vgg: bool = False  # warn instead of failing when the
    # visual-loss lambdas are nonzero but no VGG weights are available
    tasks: tuple[str, ...] = ("train",)
    device_cache: bool = True
    profile_dir: str | None = None
    preempt_save: bool = True
    eval_metrics: bool = False
    pipeline_infer: bool = False

    def __post_init__(self):
        unported = {
            "data_h5": self.data_h5 is not None,
            "checkpoint_backend='orbax'": self.checkpoint_backend == "orbax",
            "device_cache=False (the host-pipeline epoch)":
                not self.device_cache,
            "profile_dir": self.profile_dir is not None,
            "pipeline_infer": self.pipeline_infer,
        }
        for name, is_set in unported.items():
            if is_set:
                raise NotImplementedError(f"{name} is not ported yet")
        if self.checkpoint_backend != "msgpack":
            raise ValueError(f"unknown checkpoint backend "
                             f"{self.checkpoint_backend!r}")


EVAL_KEYS = ("rmse", "rmse_non", "rmse_all", "mae", "mae_non", "mae_all")


class KeepLast:
    """The trainer's default writer hook (the ``add_scalar(tag, value,
    epoch)`` surface of a TensorBoard writer): keeps each tag's last
    value in ``values``."""

    def __init__(self, values: dict[str, float]):
        self.values = values

    def add_scalar(self, tag: str, value: float, epoch: int) -> None:
        self.values[tag] = float(value)

    def flush(self) -> None:
        pass


def _select(streams: dict[str, np.ndarray], cfg: TrainConfig) -> dict:
    """The configuration's streams; sorted they must be (x, m, y)."""
    picked = {k: streams[k] for k in cfg.train_datas}
    if len(picked) != 3:
        raise ValueError(f"training needs 3 streams (x, m, y), got "
                         f"{sorted(picked)}")
    return picked


class Trainer:
    def __init__(self, cfg: TrainConfig, run: RunConfig,
                 train_streams: dict | None = None,
                 valid_streams: dict | None = None,
                 valid_names: list[str] | None = None, *,
                 device: str | torch.device = "cuda"):
        """``train_streams``/``valid_streams``: dicts of (N, H, W, C)
        uint8 numpy arrays (``cfg.train_datas`` picks three of them),
        injected directly; otherwise ISTD directories from
        ``run.data_dirs`` are loaded (reference src/cgan.py:98-121).
        Injected validation streams take precedence over the
        directories' test split."""
        self.device = resolve_device(device)
        self.run = run
        streams_injected = (train_streams is not None
                            or valid_streams is not None)
        if train_streams is None and run.data_dirs:
            train_streams, loaded_valid, loaded_names = self._load_dirs(cfg)
            if valid_streams is None:
                valid_streams, valid_names = loaded_valid, loaded_names
        self.valid_names = valid_names or []

        self.cache = None
        steps = 1
        if train_streams:
            self.cache = DeviceDatasetCache(_select(train_streams, cfg),
                                            self.device)
            steps = self.cache.n // cfg.batch_size
            if steps == 0:
                raise ValueError(f"{self.cache.n} training samples make no "
                                 f"batch of {cfg.batch_size}")
        # the lr schedule decays once per epoch, like the reference's
        self.cfg = dataclasses.replace(cfg, steps_per_epoch=steps)
        self.aug_cfg = AugmentConfig(
            scale=cfg.aug_scale, angle=cfg.aug_angle, flip_prob=0.5,
            crop_size=cfg.image_size, resize=cfg.aug_resize,
            method=cfg.aug_method)
        self.valid_pipe = (
            BatchPipeline(_select(valid_streams, cfg), cfg.batch_size,
                          shuffle=False, drop_last=False, seed=run.seed)
            if valid_streams else None)

        vgg = None
        if run.vgg_weights:
            if not os.path.isfile(run.vgg_weights):
                raise FileNotFoundError(
                    f"--vgg-weights {run.vgg_weights!r} does not exist")
            vgg = load_vgg_npz(run.vgg_weights)
        elif (cfg.use_visual_loss and (cfg.lambda4 or cfg.lambda5)
              and "train" in run.tasks):
            msg = (f"visual loss weights lambda4={cfg.lambda4}/lambda5="
                   f"{cfg.lambda5} are nonzero but no VGG weights were "
                   "given: convert them once with tools/convert_vgg.py and "
                   "pass --vgg-weights, or set --lambda4 0 --lambda5 0, or "
                   "pass --allow-missing-vgg to train WITHOUT the "
                   "perceptual terms")
            if not run.allow_missing_vgg:
                raise ValueError(msg)
            logger.warning("%s (continuing without them)", msg)

        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        init_gen = torch.Generator().manual_seed(
            derive_seed(run.seed, 0, 0, "init"))
        self.state: TrainState = init_state(self.cfg, init_gen, self.device,
                                            vgg=vgg)
        if self.cfg.dcgan_init:
            # the legacy tree applies DCGAN init when no weights are
            # loaded (reference STCGAN/stcgan.py:408-433)
            bn_mean = 0.0 if self.cfg.dcgan_bn_compat else 1.0
            for net in self.state.models.all():
                apply_dcgan_init_(net, init_gen, bn_mean)
        self.plateau_g = self.plateau_d = None
        if self.cfg.lr_schedule == "plateau":
            self.plateau_g = ReduceLROnPlateau(self.cfg.lr_g)
            self.plateau_d = ReduceLROnPlateau(self.cfg.lr_d)
        self.epoch_fn = make_epoch(self.aug_cfg)
        self.start_epoch = 0
        self.best_loss = float("inf")
        self.history: list[dict[str, float]] = []
        self.last_valid: dict[str, float] = {}
        self.last_eval: dict[str, float] = {}
        self.eval_writer = KeepLast(self.last_eval)
        # the binary shadow masks of the validation split for the eval
        # protocol (reference src/eval.py:67-70 reads the mask directory,
        # not the matte), loaded apart when the streams lack them
        self._valid_masks = None
        if (run.eval_metrics and "mask" not in cfg.train_datas
                and streams_injected):
            # masks from run.data_dirs would be ordered against another
            # validation set than the injected one
            logger.warning(
                "--eval-metrics with injected validation streams: no "
                "aligned mask stream; Eval scalars use the matte proxy "
                "(tagged EvalProxy/*)")
        elif run.eval_metrics and "mask" not in cfg.train_datas:
            try:
                self._valid_masks = np.concatenate([
                    ISTDDataset(d, "test", datas=("mask",)).load_all()["mask"]
                    for d in run.data_dirs])
            except FileNotFoundError:
                logger.warning(
                    "--eval-metrics: no binary mask directory (test_B) "
                    "found under %s; Eval scalars fall back to the matte "
                    "proxy (tagged EvalProxy/*)", run.data_dirs)

    # ------------------------------------------------------------ data
    def _load_dirs(self, cfg: TrainConfig):
        train_parts, valid_parts, names = [], [], []
        for d in self.run.data_dirs:
            name = os.path.basename(os.path.normpath(d))
            tr = ISTDDataset(d, "train", datas=cfg.train_datas, name=name)
            va = ISTDDataset(d, "test", datas=cfg.train_datas, name=name)
            t0 = time.perf_counter()
            train_parts.append(tr.load_all())
            valid_parts.append(va.load_all())
            logger.info("loaded %s: %d train + %d test samples in %.1f s",
                        d, len(tr), len(va), time.perf_counter() - t0)
            names.extend(va.filename(i) for i in range(len(va)))
        keys = train_parts[0].keys()
        train = {k: np.concatenate([p[k] for p in train_parts]) for k in keys}
        valid = {k: np.concatenate([p[k] for p in valid_parts]) for k in keys}
        return train, valid, names

    def valid_batches(self):
        """The validation split in order, normalized NCHW on the card,
        resized first (NHWC, ``resize(method="auto")``) when
        ``valid_resize`` is set."""
        size = self.cfg.valid_resize
        for raw in self.valid_pipe.epoch():
            streams = tuple(torch.from_numpy(a).to(self.device) for a in raw)
            if size is not None:
                streams = tuple(resize(s.float(), size) for s in streams)
            yield normalize_batch(streams)

    def _save_weights(self, suffix: str) -> None:
        ckpt.save_model_weights(self.state, self.run.weights_dir, suffix)

    # ----------------------------------------------------------- train
    def train(self, epochs: int) -> None:
        """Epochs ``start_epoch .. epochs-1``. Reads the epoch's metric
        sums back once per epoch (``history``)."""
        if self.cache is None:
            raise ValueError("no training data")
        run = self.run
        t_start = time.time()
        logger.info("start training: %d epochs, %d steps/epoch", epochs,
                    self.cfg.steps_per_epoch)
        for epoch in range(self.start_epoch, epochs):
            sums, n = self.run_train_epoch(epoch)
            sums = {k: float(v) for k, v in sums.items()}
            self.history.append({k: v / n for k, v in sums.items()})
            if self.plateau_g is not None:
                # the legacy scheduler steps on the SUMMED epoch losses
                # (reference STCGAN/stcgan.py:315-317)
                self.plateau_g.step(sums["G"])
                self.plateau_d.step(sums["D"])
                self._apply_plateau()
            if epoch % run.log_every == 0:
                logger.info("train epoch %d: %s", epoch, ", ".join(
                    f"{k} {self.history[-1][k]:.4f}"
                    for k in METRIC_KEYS[:10]))
                self._save_weights("latest")
            if epoch % run.valid_every == 0 and self.valid_pipe:
                total = self.run_valid_epoch(epoch)
                if total < self.best_loss:
                    self.best_loss = total
                    self._save_weights("best")
                    logger.info("improvement after epoch %d, error=%.4f",
                                epoch, total)
            if epoch % run.save_every == 0:
                # the epoch is complete: resume continues with the next
                self.save(epoch + 1)
        logger.info("training time %.1fs; best validation loss %.3f",
                    time.time() - t_start, self.best_loss)

    def run_train_epoch(self, epoch: int
                        ) -> tuple[dict[str, torch.Tensor], int]:
        """One fused epoch; returns the metric sums (device tensors, not
        read back) and the step count."""
        gen = RngStreams(self.run.seed, epoch, self.device)
        idx = self.cache.epoch_indices(gen.generator("shuffle"),
                                       self.cfg.batch_size)
        self.state, sums = self.epoch_fn(self.state, self.cache.arrays, idx,
                                         gen)
        return sums, idx.shape[0]

    def run_valid_epoch(self, epoch: int) -> float:
        """``eval_step`` over the validation split in order, keeping the
        ragged last batch; returns the mean of the batches' ``total`` and
        stores every metric's mean in ``last_valid``. The eval generators
        use the current weights (no frozen decoder kernels:
        ``MNet.train`` drops them). With ``run.eval_metrics``, the
        protocol's sums of each batch's ``y_pred`` are aggregated and
        passed to ``eval_writer`` as ``Eval/*`` or ``EvalProxy/*``."""
        sums: dict[str, torch.Tensor] = {}
        lab_parts = []
        n = ofs = 0
        for batch in self.valid_batches():
            metrics, (_, y_pred) = eval_step(self.state, batch,
                                             return_preds=True)
            n_b = batch[0].shape[0]
            if self.run.eval_metrics:
                mask = self._protocol_mask(batch[1], ofs, n_b)
                lab_parts.append(self._lab_parts(y_pred, batch[2], mask))
            ofs += n_b
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
            n += 1
        self.last_valid = {k: float(v) / n for k, v in sums.items()}
        logger.info("valid epoch %d: %s", epoch, ", ".join(
            f"{k} {self.last_valid[k]:.4f}" for k in (*METRIC_KEYS[:6],
                                                      "total")))
        if lab_parts:
            agg = aggregate_regions(lab_parts)
            # the binary mask stream gives the paper's protocol (Eval/*);
            # the matte threshold is only a proxy for it
            tag = "Eval" if self._has_protocol_masks() else "EvalProxy"
            for k in EVAL_KEYS:
                self.eval_writer.add_scalar(f"{tag}/{k}", agg[k], epoch)
            self.eval_writer.flush()
            logger.info(
                "eval protocol%s @ epoch %d: RMSE shadow %.2f / "
                "non-shadow %.2f / all %.2f",
                "" if tag == "Eval" else " (matte proxy)", epoch,
                agg["rmse"], agg["rmse_non"], agg["rmse_all"])
        return self.last_valid["total"]

    def _has_protocol_masks(self) -> bool:
        """True when the shadow mask behind ``Eval/*`` is the protocol's
        binary ``_B`` stream, not the matte-threshold proxy."""
        return (self._valid_masks is not None
                or "mask" in self.cfg.train_datas)

    def _protocol_mask(self, m: torch.Tensor, ofs: int,
                       n: int) -> torch.Tensor:
        """Boolean (N, H, W) shadow mask of one validation batch: the
        loaded binary masks binarized as the protocol's ``img_as_bool``
        (uint8 >= 128; after ``valid_resize``, the resized [0, 1] mask >
        0.5); else the ``m`` stream (NCHW in [-1, 1]) > 0, which is the
        mask itself when the datas hold it and the matte proxy
        otherwise."""
        if self._valid_masks is None:
            return m[:, 0] > 0.0
        u8 = torch.from_numpy(self._valid_masks[ofs:ofs + n, ..., 0]).to(
            self.device)
        if self.cfg.valid_resize is not None:
            f = resize(u8.float()[..., None] / 255.0, self.cfg.valid_resize)
            return f[..., 0] > 0.5
        return u8 >= 128

    @staticmethod
    def _lab_parts(y_pred: torch.Tensor, y: torch.Tensor,
                   mask: torch.Tensor) -> dict[str, torch.Tensor]:
        """The protocol's sums of one batch, on the card. ``y_pred`` and
        ``y`` are BGR NCHW in [-1, 1]; the protocol scores RGB 8-bit PNGs
        (reference src/eval.py:63-70), so both sides are snapped to their
        PNG grids first: the prediction through the writer's own ops
        (``float_to_uint8`` truncates), the target by rounding (half to
        even) back to its uint8 source. At native resolution ``Eval/*``
        then equals ``metrics/eval_cli.py`` on the PNGs ``infer`` writes;
        with ``valid_resize`` or ``infer_resize`` it tracks them only."""
        q_pred = float_to_uint8(denormalize(y_pred)).float() / 255.0
        q_tgt = torch.round(denormalize(y.float()).clamp(0.0, 1.0)
                            * 255.0) / 255.0

        def to_lab(t):
            return rgb_to_lab(bgr_to_rgb(t.permute(0, 2, 3, 1)))

        return region_metrics(to_lab(q_pred), to_lab(q_tgt), mask)

    # ------------------------------------------------------- inference
    @torch.no_grad()
    def infer(self) -> int:
        """G1 -> G2 over the validation split in the compute dtype,
        written to ``{infered}/shadowless/{name}.png`` (BGR) and
        ``{infered}/matte/{name}.png`` (reference src/cgan.py:420-464),
        resized bilinearly to ``infer_resize`` first when it is set (the
        legacy tree's outputs, reference STCGAN/stcgan.py:366-373).
        PNG encoding runs on a small thread pool (zlib releases the GIL)
        while the next batch computes. Returns the image count."""
        if self.valid_pipe is None:
            raise ValueError("no validation data")
        g1, g2 = self.state.models.g1, self.state.models.g2
        g1.eval()
        g2.eval()
        for sub in ("shadowless", "matte"):
            os.makedirs(os.path.join(self.run.infered_dir, sub),
                        exist_ok=True)
        idx = 0
        futures = []
        with ThreadPoolExecutor(max_workers=4) as pool:
            for x, _, _ in self.valid_batches():
                m, y = infer_step(g1, g2, x)
                m = denormalize(m).permute(0, 2, 3, 1)
                y = denormalize(y).permute(0, 2, 3, 1)
                if self.cfg.infer_resize is not None:
                    m = resize_linear(m, self.cfg.infer_resize)
                    y = resize_linear(y, self.cfg.infer_resize)
                m_np = float_to_uint8(m)[..., 0].cpu().numpy()
                y_np = float_to_uint8(y).cpu().numpy()
                for i in range(m_np.shape[0]):
                    name = (self.valid_names[idx]
                            if idx < len(self.valid_names)
                            else f"{idx:05d}")
                    for sub, arr in (("shadowless", y_np[i]),
                                     ("matte", m_np[i])):
                        path = os.path.join(self.run.infered_dir, sub,
                                            f"{name}.png")
                        os.makedirs(os.path.dirname(path), exist_ok=True)
                        futures.append(pool.submit(imwrite, path, arr))
                    idx += 1
                # bound the pending writes to ~2 batches of outputs
                while len(futures) > 4 * max(self.cfg.batch_size, 1):
                    futures.pop(0).result()
            for f in futures:
                f.result()  # surface any write error
        return idx

    # ------------------------------------------------------ checkpoint
    def _apply_plateau(self) -> None:
        """The controllers' scales onto the state's learning rates."""
        self.state.lr_scale_g = self.plateau_g.scale
        self.state.lr_scale_d = self.plateau_d.scale

    def save(self, epoch: int) -> None:
        host = {"best_loss": self.best_loss}
        if self.plateau_g is not None:
            host["plateau_g"] = self.plateau_g.state_dict()
            host["plateau_d"] = self.plateau_d.state_dict()
        ckpt.save_checkpoint(self.state, self.run.checkpoint_path, epoch,
                             host=host)

    def load(self, path: str | None = None) -> None:
        path = path or self.run.checkpoint_path
        epoch, host = ckpt.load_checkpoint(self.state, path)
        self.start_epoch = epoch
        if "best_loss" in host:
            self.best_loss = float(host["best_loss"])
        if self.plateau_g is not None and "plateau_g" in host:
            self.plateau_g.load_state_dict(host["plateau_g"])
            self.plateau_d.load_state_dict(host["plateau_d"])
            self._apply_plateau()
        logger.info("checkpoint loaded (epoch %d)", epoch)

    def load_weights(self, g1=None, g2=None, d1=None, d2=None) -> None:
        """Per-network weight loading (reference src/cgan.py:525-542)."""
        for net, path in (("G1", g1), ("G2", g2), ("D1", d1), ("D2", d2)):
            if path:
                ckpt.load_model_weights(self.state, net, path)
                logger.info("loaded %s weights: %s", net, path)
