"""Trainer: training epochs, validation, best-model tracking,
per-network weight files, checkpoints, TensorBoard event files and
inference to PNG files.

Port of ``shadow_removal_istd_tpu/engine/loop.py``. Data comes from the
HDF5 dataset (``run.data_h5``, ``data/h5.py``; it takes precedence),
ISTD directories (``run.data_dirs``) or injected streams. An epoch takes one
of two paths, both the step loop of ``engine/epoch.py`` (augmentation,
with the ``hshear`` kernel on the shear path -> adversarial step):

- ``run.device_cache`` (the CLI's default): the uint8 training streams
  live on the card (``data/device_cache.py``); each step gathers its
  batch there, the order drawn on the card (``engine/epoch.py``);
- otherwise (``RunConfig``'s default, as in the JAX package) the host
  ``BatchPipeline`` gathers each batch in its seeded order and
  ``parallel/prefetch.py`` uploads it, the next batch in flight while
  the current step computes.

Metric sums stay on the card until the epoch's one read-back.
Validation and inference walk the test split in order through the host
``BatchPipeline``, keeping the ragged last batch (resized to
``valid_resize`` when set). Every ``valid_every`` epochs
:meth:`Trainer.run_valid_epoch` runs ``eval_step``, keeping the best
``total`` (0.8*G + 0.2*D) and writing the ``best`` weight files on
improvement; the ``latest`` ones are written on every ``log_every`` epoch
and the full checkpoint every ``save_every``. Files are the JAX package's
flax msgpack files (``engine/checkpoint.py``).

TensorBoard (``utils/tb_writer.py``, event files under
``logs_dir/{train,valid}``), with the JAX trainer's tags: ``Loss/*``,
``Loss/total``, ``D{1,2}_output/{real,fake,diff}`` and
``perf/images_per_sec`` every ``log_every`` epochs; the ``input``,
``matte`` and ``output`` grids of a batch every ``vis_every`` epochs
(and of the first validation batch on every validation), through the
stacked eval forward.

``run.preempt_save``: SIGTERM checkpoints at the next epoch boundary
(``utils/preemption.py``) and ``train`` returns True. ``run.profile_dir``:
the second epoch of ``train`` is traced there (``utils/profiling.py``).

With ``run.eval_metrics`` each validation also scores ``eval_step``'s
predictions by the ISTD protocol (LAB RMSE/MAE over shadow, non-shadow
and all pixels, reference src/eval.py) against the binary ``test_B``
masks, snapped to the PNG grids the offline ``metrics/eval_cli.py``
reads, and passes ``Eval/*`` (``EvalProxy/*`` when the masks are
missing and the matte stands in) to the ``valid`` event file and to
``Trainer.eval_writer``.

Data parallelism (``mesh=``, a ``parallel.mesh.Mesh`` of several
ranks, one process each): every rank holds the whole dataset, draws the
same global batch order and augmentation parameters from the shared
seed and trains on its contiguous slice (``engine/steps.py`` makes the
step the global batch's: BatchNorm statistics, gradients, metrics). A
validation batch that splits evenly over the ranks is sharded and its
metrics averaged; a ragged one runs whole on every rank, as the JAX
trainer runs it on one device, except in a multi-process run
(``mesh.processes > 1``), which drops it, as JAX does. Rank 0 alone
writes the weight files, the checkpoint, the event files and the
``infer`` PNGs; every rank loads. ``infer`` raises in a multi-process
run, as in JAX. ``run.pipeline_infer`` runs ``infer`` on the two-stage
``parallel.pipeline.StackedPipeline`` over the selected devices (the
mesh's, else every card), and warns and takes the fused path with fewer
than two.

``run.checkpoint_backend``: ``"msgpack"`` writes ``run.checkpoint_path``
as one file; ``"orbax"`` makes it a directory of ``step_N`` orbax
checkpoints (``engine/orbax_format.py``) that the JAX package reads and
writes too, committed in the background: ``save`` returns once rank 0 has
copied the state to the host, and the commits in flight are drained at
the end of ``train`` (the SIGTERM save included, so the process never
exits before its checkpoint is committed) and before any ``load``. Every
rank takes part in the gather of a model-sharded state; rank 0 alone
copies and writes, and no rank waits on a barrier another one skips.

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

import contextlib
import dataclasses
import functools
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
from shadow_removal_istd_tpu_torch.data.h5 import ISTDH5Dataset
from shadow_removal_istd_tpu_torch.data.istd import ISTDDataset
from shadow_removal_istd_tpu_torch.data.pipeline import BatchPipeline
from shadow_removal_istd_tpu_torch.engine import checkpoint as ckpt
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.epoch import (
    RngStreams,
    derive_seed,
    make_epoch,
    train_steps,
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
    augment_batch,
    denormalize,
    float_to_uint8,
    normalize_batch,
)
from shadow_removal_istd_tpu_torch.ops.color import bgr_to_rgb, rgb_to_lab
from shadow_removal_istd_tpu_torch.ops.resize import resize, resize_linear
from shadow_removal_istd_tpu_torch.parallel.mesh import (
    SPATIAL_AXIS,
    Mesh,
    all_gather,
    is_primary,
    shard_batch,
    shard_images,
    shard_state,
    sum_across,
    unshard_state,
)
from shadow_removal_istd_tpu_torch.parallel.pipeline import (
    StackedPipeline,
    overlap,
)
from shadow_removal_istd_tpu_torch.parallel.prefetch import (
    prefetch_to_device,
)
from shadow_removal_istd_tpu_torch.utils.image_io import imwrite
from shadow_removal_istd_tpu_torch.utils.preemption import PreemptionGuard
from shadow_removal_istd_tpu_torch.utils.profiling import StepTimer, trace
from shadow_removal_istd_tpu_torch.utils.tb_writer import (
    NullWriter,
    SummaryWriter,
)

logger = logging.getLogger(__name__)


@dataclass
class RunConfig:
    """Run-level knobs (paths, intervals): the non-model CLI surface,
    with the JAX package's fields and defaults."""

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
    device_cache: bool = False   # True: the fused epoch over the card's copy
    profile_dir: str | None = None  # torch.profiler trace of the 2nd epoch
    preempt_save: bool = True
    eval_metrics: bool = False
    pipeline_infer: bool = False

    def __post_init__(self):
        if self.checkpoint_backend not in ("msgpack", "orbax"):
            raise ValueError(f"unknown checkpoint backend "
                             f"{self.checkpoint_backend!r}")


EVAL_KEYS = ("rmse", "rmse_non", "rmse_all", "mae", "mae_non", "mae_all")
# the fused epoch's visualization batch draws its augmentation from this
# step index, which no real step uses (the JAX trainer's fold_in(1 << 20))
VIS_STEP = 1 << 20


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
                 device: str | torch.device = "cuda",
                 mesh: Mesh | None = None):
        """``train_streams``/``valid_streams``: dicts of (N, H, W, C)
        uint8 numpy arrays (``cfg.train_datas`` picks three of them),
        injected directly; otherwise the HDF5 file ``run.data_h5`` or
        else the ISTD directories of ``run.data_dirs`` are loaded
        (reference src/cgan.py:98-121). Injected validation streams take
        precedence over the loaded test split. ``mesh``: this rank's
        ``parallel.mesh.Mesh`` (its device replaces ``device``); a mesh
        of several ranks trains data-parallel on global batches of
        ``cfg.batch_size``."""
        self.mesh = mesh
        self._dp = mesh if mesh is not None and mesh.world > 1 else None
        # host-side side effects belong to rank 0 (the JAX trainer's
        # process 0); every rank computes the same global step
        self._primary = mesh is None or is_primary(mesh)
        # a spatial or model axis makes every forward collective: each
        # rank takes part, rank 0 alone writes
        self._collective = self._dp is not None and (
            self._dp.n_spatial > 1 or self._dp.n_model > 1)
        self._warned_spatial = False
        if self._dp is not None and cfg.batch_size % self._dp.n_data:
            raise ValueError(f"batch size {cfg.batch_size} does not split "
                             f"over {self._dp.n_data} data ranks")
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self.run = run
        streams_injected = (train_streams is not None
                            or valid_streams is not None)
        if train_streams is None and (run.data_h5 or run.data_dirs):
            loader = self._load_h5 if run.data_h5 else self._load_dirs
            train_streams, loaded_valid, loaded_names = loader(cfg)
            if valid_streams is None:
                valid_streams, valid_names = loaded_valid, loaded_names
        self.valid_names = valid_names or []

        self.cache = self.train_pipe = None
        steps = 1
        if train_streams:
            picked = _select(train_streams, cfg)
            self.train_pipe = BatchPipeline(picked, cfg.batch_size,
                                            shuffle=True, drop_last=True,
                                            seed=run.seed)
            steps = len(self.train_pipe)
            if steps == 0:
                raise ValueError(f"{self.train_pipe.n} training samples "
                                 f"make no batch of {cfg.batch_size}")
            if run.device_cache:
                self.cache = DeviceDatasetCache(picked, self.device)
        # the lr schedule decays once per epoch, like the reference's
        self.cfg = dataclasses.replace(cfg, steps_per_epoch=steps)
        self.aug_cfg = AugmentConfig(
            scale=cfg.aug_scale, angle=cfg.aug_angle, flip_prob=0.5,
            crop_size=cfg.image_size, resize=cfg.aug_resize,
            method=cfg.aug_method)
        self.valid_pipe = None
        if valid_streams:
            # a multi-process run drops the ragged final validation
            # batch, as the JAX trainer does; one process keeps it
            drop_ragged = mesh is not None and mesh.processes > 1
            picked = _select(valid_streams, cfg)
            n_valid = next(iter(picked.values())).shape[0]
            if drop_ragged and n_valid % cfg.batch_size:
                logger.warning(
                    "multi-host validation drops the ragged final "
                    "batch (%d of %d samples)",
                    n_valid % cfg.batch_size, n_valid)
            self.valid_pipe = BatchPipeline(
                picked, cfg.batch_size, shuffle=False,
                drop_last=drop_ragged, seed=run.seed)

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
        if self._dp is not None:
            self.state.mesh = self._dp
            shard_state(self._dp, self.state)
        self.plateau_g = self.plateau_d = None
        if self.cfg.lr_schedule == "plateau":
            self.plateau_g = ReduceLROnPlateau(self.cfg.lr_g)
            self.plateau_d = ReduceLROnPlateau(self.cfg.lr_d)
        self.epoch_fn = make_epoch(self.aug_cfg)
        self.start_epoch = 0
        self.best_loss = float("inf")
        self.preempted = False
        self._orbax: ckpt.AsyncCheckpointer | None = None
        self.history: list[dict[str, float]] = []
        self.last_valid: dict[str, float] = {}
        self.last_eval: dict[str, float] = {}
        self.eval_writer = KeepLast(self.last_eval)
        self._writers: dict[str, SummaryWriter] = {}
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
        elif (run.eval_metrics and "mask" not in cfg.train_datas
              and run.data_h5):
            ds = ISTDH5Dataset(run.data_h5, "test")
            try:
                self._valid_masks = ds.load_streams(("mask",))["mask"]
            except KeyError:
                logger.warning(
                    "--eval-metrics: HDF5 file carries no mask stream; "
                    "Eval scalars fall back to the matte proxy (tagged "
                    "EvalProxy/*)")
            finally:
                ds.close()
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
    def _load_h5(self, cfg: TrainConfig):
        """The train and test streams of ``run.data_h5``, one read per
        stream, and the test split's file names."""
        t0 = time.perf_counter()
        out = []
        for subset in ("train", "test"):
            ds = ISTDH5Dataset(self.run.data_h5, subset)
            try:
                out.append(ds.load_streams(tuple(cfg.train_datas)))
                names = ds.filenames()
            finally:
                ds.close()
        logger.info("loaded %s: %d train + %d test samples in %.1f s",
                    self.run.data_h5, len(next(iter(out[0].values()))),
                    len(names), time.perf_counter() - t0)
        return out[0], out[1], names

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

    def _upload(self, raw) -> tuple[torch.Tensor, ...]:
        """uint8 NHWC host arrays -> normalized NCHW on the card, resized
        first (NHWC, ``resize(method="auto")``) when ``valid_resize`` is
        set."""
        streams = tuple(torch.from_numpy(a).to(self.device) for a in raw)
        if self.cfg.valid_resize is not None:
            streams = tuple(resize(s.float(), self.cfg.valid_resize)
                            for s in streams)
        return normalize_batch(streams)

    def valid_batches(self):
        """The validation split in order, whole batches, normalized NCHW
        on the card (see :meth:`_upload`)."""
        for raw in self.valid_pipe.epoch():
            yield self._upload(raw)

    @contextlib.contextmanager
    def _whole_state(self):
        """The state gathered to full over a model axis (every rank takes
        part) while files are written or read, split again after; the
        files are the single-device flax layout."""
        tp = self._dp is not None and self._dp.n_model > 1
        if tp:
            unshard_state(self._dp, self.state)
        try:
            yield
        finally:
            if tp:
                shard_state(self._dp, self.state)

    def _save_weights(self, suffix: str) -> None:
        with self._whole_state():
            if self._primary:
                ckpt.save_model_weights(self.state, self.run.weights_dir,
                                        suffix)

    def _writer(self, which: str) -> SummaryWriter | NullWriter:
        """The event file writer of ``logs_dir/<which>``, opened on first
        use (a :class:`NullWriter` on the ranks other than 0)."""
        if which not in self._writers:
            self._writers[which] = (
                SummaryWriter(os.path.join(self.run.logs_dir, which))
                if self._primary else NullWriter())
        return self._writers[which]

    def close(self) -> None:
        """Write out and close the event files (a later log opens new
        ones)."""
        for w in self._writers.values():
            w.close()
        self._writers.clear()

    # ----------------------------------------------------------- train
    def train(self, epochs: int) -> bool:
        """Epochs ``start_epoch .. epochs-1``. Reads each epoch's metric
        sums back once (``history``). Returns True when a SIGTERM stopped
        the run after checkpointing its last complete epoch."""
        if self.train_pipe is None:
            raise ValueError("no training data")
        run = self.run
        timer = StepTimer()
        t_start = time.time()
        guard = PreemptionGuard() if run.preempt_save else None
        with guard or contextlib.nullcontext():
            # the guard is live before this line prints: a SIGTERM any
            # time after "start training" gets a clean checkpoint
            logger.info("start training: %d epochs, %d steps/epoch",
                        epochs, self.cfg.steps_per_epoch)
            for epoch in range(self.start_epoch, epochs):
                # profile the second epoch (the first pays for builds)
                profile_now = epoch == self.start_epoch + 1
                with trace(run.profile_dir if profile_now else None,
                           self.device):
                    self.run_train_epoch(
                        epoch, log_scalars=epoch % run.log_every == 0,
                        visualize=epoch % run.vis_every == 0)
                timer.update(self.cfg.steps_per_epoch * self.cfg.batch_size)
                if epoch % run.log_every == 0:
                    self._writer("train").add_scalar(
                        "perf/images_per_sec", timer.rate(), epoch)
                    timer.reset()
                if epoch % run.valid_every == 0 and self.valid_pipe:
                    total = self.run_valid_epoch(epoch)
                    if total < self.best_loss:
                        self.best_loss = total
                        self._save_weights("best")
                        logger.info("improvement after epoch %d, "
                                    "error=%.4f", epoch, total)
                if guard is not None and self._preempt_requested(guard):
                    # epoch + 1: this epoch is complete, a resume must
                    # continue with the next one
                    self.save(epoch + 1)
                    self._save_weights("latest")
                    if self._primary:
                        logger.warning(
                            "preemption checkpoint written after epoch %d "
                            "(%s); resume with --load-checkpoint", epoch,
                            run.checkpoint_path)
                    else:
                        # the check is local, as in the JAX package:
                        # rank 0 writes only on a SIGTERM of its own
                        logger.warning(
                            "preempted: stopping after epoch %d; rank 0 "
                            "writes the checkpoint", epoch)
                    self.preempted = True
                    break
                if epoch % run.save_every == 0:
                    self.save(epoch + 1)
        self._drain_async_saves()
        for w in self._writers.values():
            w.flush()
        logger.info("training time %.1fs; best validation loss %.3f",
                    time.time() - t_start, self.best_loss)
        return self.preempted

    def _preempt_requested(self, guard: PreemptionGuard) -> bool:
        """The guard's flag; over a model axis any rank's, since the
        checkpoint is written from the gathered state, with every rank
        taking part (else each rank checks its own, as in JAX)."""
        if self._dp is None or self._dp.n_model == 1:
            return guard.requested
        flag = torch.tensor([float(guard.requested)])
        torch.distributed.all_reduce(flag)     # the default (gloo) group
        return bool(flag.item())

    def run_train_epoch(self, epoch: int, log_scalars: bool = False,
                        visualize: bool = False) -> dict[str, float]:
        """One epoch on the device cache (``run.device_cache``) or the
        host pipeline; reads the metric sums back once, appends their
        means to ``history`` (and returns them), steps the plateau
        controllers, and with ``log_scalars`` logs the epoch, writes its
        ``Loss/*`` and ``D*_output/*`` scalars and the ``latest`` weight
        files; with ``visualize`` writes the image grids of one augmented
        batch."""
        gen = RngStreams(self.run.seed, epoch, self.device)
        if self.cache is not None:
            # every rank draws the global order; each trains on its
            # columns of it
            idx = shard_batch(self._dp, self.cache.epoch_indices(
                gen.generator("shuffle"), self.cfg.batch_size), dim=1)
            self.state, sums_dev = self.epoch_fn(self.state,
                                                 self.cache.arrays, idx, gen)
            n, vis = idx.shape[0], None
            if visualize and (self._primary or self._collective):
                vis = augment_batch(gen.generator("augment", VIS_STEP),
                                    self.cache.gather(idx[0]), self.aug_cfg,
                                    mesh=self._dp)
        else:
            raws = prefetch_to_device(
                (shard_batch(self._dp, raw)
                 for raw in self.train_pipe.epoch(epoch)), 2, self.device)
            sums_dev, n, vis = train_steps(self.state, raws, self.aug_cfg,
                                           gen)
        sums = _read_back(sums_dev)
        self.history.append({k: v / n for k, v in sums.items()})
        if self.plateau_g is not None:
            # the legacy scheduler steps on the SUMMED epoch losses
            # (reference STCGAN/stcgan.py:315-317)
            self.plateau_g.step(sums["G"])
            self.plateau_d.step(sums["D"])
            self._apply_plateau()
        if log_scalars:
            logger.info("train epoch %d: %s", epoch, ", ".join(
                f"{k} {self.history[-1][k]:.4f}" for k in METRIC_KEYS[:10]))
            self._log_scalars("train", epoch, sums, n)
            self._save_weights("latest")
        if visualize and vis is not None and (self._primary
                                              or self._collective):
            self._log_images("train", epoch, vis)
        return self.history[-1]

    def run_valid_epoch(self, epoch: int) -> float:
        """``eval_step`` over the validation split in order, keeping the
        ragged last batch; returns the mean of the batches' ``total``,
        stores every metric's mean in ``last_valid`` and writes the
        ``valid`` scalars and the first batch's image grids. The eval
        generators use the current weights (no frozen decoder kernels:
        ``MNet.train`` drops them). With ``run.eval_metrics``, the
        protocol's sums of each batch's ``y_pred`` are aggregated and
        written as ``Eval/*`` or ``EvalProxy/*``. Over a mesh a batch
        that splits evenly is sharded (its metrics and protocol sums
        reduced over the ranks); a ragged one runs whole on every rank."""
        sums: dict[str, torch.Tensor] = {}
        lab_parts = []
        n = ofs = 0
        vis = None
        for raw in self.valid_pipe.epoch():
            n_b = raw[0].shape[0]
            mesh = (self._dp if self._dp is not None
                    and n_b % self._dp.n_data == 0 else None)
            start = 0
            if mesh is not None:
                start = mesh.rows(n_b).start
                raw = shard_batch(mesh, raw)
            full = self._upload(raw)
            batch, rows = self._place_rows(full, mesh)
            metrics, (_, y_pred) = eval_step(self.state, batch,
                                             return_preds=True, mesh=mesh)
            if self.run.eval_metrics:
                mask = self._protocol_mask(full[1], ofs + start,
                                           full[0].shape[0])
                if rows is not None:
                    mask = mask[:, rows]
                parts = self._lab_parts(y_pred, batch[2], mask)
                if mesh is not None:
                    keys = list(parts)
                    parts = dict(zip(keys, sum_across(torch.stack(
                        [parts[k] for k in keys]), mesh, "forward")))
                lab_parts.append(parts)
            ofs += n_b
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
            n += 1
            if vis is None:
                vis = full
        sums = _read_back(sums)
        self.last_valid = {k: v / n for k, v in sums.items()}
        logger.info("valid epoch %d: %s", epoch, ", ".join(
            f"{k} {self.last_valid[k]:.4f}" for k in (*METRIC_KEYS[:6],
                                                      "total")))
        self._log_scalars("valid", epoch, sums, n)
        if lab_parts:
            agg = aggregate_regions(lab_parts)
            # the binary mask stream gives the paper's protocol (Eval/*);
            # the matte threshold is only a proxy for it
            tag = "Eval" if self._has_protocol_masks() else "EvalProxy"
            for w in (self._writer("valid"), self.eval_writer):
                for k in EVAL_KEYS:
                    w.add_scalar(f"{tag}/{k}", agg[k], epoch)
                w.flush()
            logger.info(
                "eval protocol%s @ epoch %d: RMSE shadow %.2f / "
                "non-shadow %.2f / all %.2f",
                "" if tag == "Eval" else " (matte proxy)", epoch,
                agg["rmse"], agg["rmse_non"], agg["rmse_all"])
        if self._primary or self._collective:
            self._log_images("valid", epoch, vis)
        return self.last_valid["total"]

    def _place_rows(self, batch, mesh: Mesh | None):
        """A forward batch (NCHW tensors, this rank's data rows) split
        into row slabs over the spatial axis, with this rank's row slice;
        when the image height does not split over the spatial ranks,
        warn once and keep the rows whole (data-only), as the JAX
        trainer's ``_place`` does. ``(batch, None)`` without a spatial
        axis or a data-split batch."""
        if mesh is None or mesh.n_spatial == 1:
            return batch, None
        h = batch[0].shape[2]
        if h % mesh.n_spatial:
            if not self._warned_spatial:
                self._warned_spatial = True
                logger.warning(
                    "--spatial-shard %d does not divide image height %d; "
                    "falling back to data-only sharding (no spatial "
                    "latency scaling)", mesh.n_spatial, h)
            return batch, None
        b = h // mesh.n_spatial
        r = mesh.coord(SPATIAL_AXIS)
        return (shard_images(mesh, tuple(batch), data=False),
                slice(r * b, (r + 1) * b))

    def _forward(self, x: torch.Tensor):
        """``infer_step`` of this rank's batch ``x``. On a spatial or
        model axis every rank of ``x``'s line takes part: each computes
        its row slab (or its channels) and the rows are gathered back;
        ranks of other data coordinates compute their own ``x``."""
        g1, g2 = self.state.models.g1, self.state.models.g2
        g1.eval()
        g2.eval()
        if not self._collective:
            return infer_step(g1, g2, x)
        (xb,), rows = self._place_rows((x,), self._dp)
        outs = infer_step(g1, g2, xb, self._dp)
        if rows is None:
            return outs
        return tuple(torch.cat(all_gather(t.contiguous(), self._dp,
                                          SPATIAL_AXIS), dim=2)
                     for t in outs)

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

    # ------------------------------------------------------- reporting
    def _log_scalars(self, which: str, epoch: int, sums: dict[str, float],
                     n: int) -> None:
        """``Loss/<k>`` (the mean of the 10 losses), ``Loss/total`` =
        (0.8 G + 0.2 D) / n and ``D{1,2}_output/{real,fake,diff}`` from
        the epoch's sums over ``n`` steps (or validation batches)."""
        w = self._writer(which)
        for k in METRIC_KEYS[:10]:
            w.add_scalar(f"Loss/{k}", sums[k] / n, epoch)
        w.add_scalar("Loss/total", (0.8 * sums["G"] + 0.2 * sums["D"]) / n,
                     epoch)
        for d in ("D1", "D2"):
            real, fake = sums[f"{d}_real"] / n, sums[f"{d}_fake"] / n
            w.add_scalar(f"{d}_output/real", real, epoch)
            w.add_scalar(f"{d}_output/fake", fake, epoch)
            w.add_scalar(f"{d}_output/diff", real - fake, epoch)
        w.flush()

    @torch.no_grad()
    def _log_images(self, which: str, epoch: int, batch,
                    n_images: int = 8) -> None:
        """The ``input``, ``matte`` and ``output`` grids (4 a row) of the
        first ``n_images`` of ``batch`` (NCHW, [-1, 1]): the input, and
        G1's and G2's outputs of the stacked eval forward, BGR -> RGB for
        display (reference src/cgan.py:373-396). The writer encodes them
        on its thread; the next scalar log's flush (or the end of
        ``train``) waits for them."""
        x = batch[0][:n_images]
        m_pred, y_pred = self._forward(x)
        w = self._writer(which)
        for tag, img, bgr in (("input", x, True), ("matte", m_pred, False),
                              ("output", y_pred, True)):
            a = img.float().permute(0, 2, 3, 1).cpu().numpy()
            if bgr:
                a = a[..., ::-1]
            a = np.clip(a * 0.5 + 0.5, 0, 1)
            w.add_image(tag, make_grid(a, nrow=4), epoch, dataformats="HWC")

    # ------------------------------------------------------- inference
    @torch.no_grad()
    def infer(self) -> int:
        """G1 -> G2 over the validation split in the compute dtype,
        written to ``{infered}/shadowless/{name}.png`` (BGR) and
        ``{infered}/matte/{name}.png`` (reference src/cgan.py:420-464),
        resized bilinearly to ``infer_resize`` first when it is set (the
        legacy tree's outputs, reference STCGAN/stcgan.py:366-373).
        PNG encoding runs on a small thread pool (zlib releases the GIL)
        while the next batch computes, and the read-back of each batch
        waits until the next one is enqueued (``parallel.pipeline
        .overlap``). Under ``run.pipeline_infer`` G1 and G2 run as the
        two stages of a :class:`StackedPipeline` over the selected
        devices (the mesh's, else every card of the host); with fewer
        than two it warns and runs fused. Rank 0 alone writes (the
        other ranks return 0); a multi-process run raises, as the JAX
        trainer does. On a spatial or model axis every rank takes part in
        each batch's forward (``_forward``); the pipeline then gathers
        the weights to full on rank 0 and ignores both axes, with JAX's
        warnings. Returns the image count."""
        if self.valid_pipe is None:
            raise ValueError("no validation data")
        if self.mesh is not None and self.mesh.processes > 1:
            # PNG output needs full batches on one host
            raise NotImplementedError(
                "--tasks infer is single-process; rerun inference on "
                "one host with --load-weights-g1/-g2 or "
                "--load-checkpoint")
        if self.run.pipeline_infer and self._collective:
            if self._dp.n_spatial > 1:
                logger.warning(
                    "--pipeline-infer ignores --spatial-shard: each batch "
                    "runs whole on the pipeline's stages")
            if self._dp.n_model > 1:
                logger.warning(
                    "--pipeline-infer discards --model-shard: each "
                    "stage's FULL weights are replicated onto its device "
                    "— if the model was sharded because it exceeds one "
                    "card's memory, this will OOM; use the fused "
                    "(non-pipeline) infer path instead")
            with self._whole_state():
                return self._infer(pipeline=True) if self._primary else 0
        if not (self._primary or self._collective):
            return 0
        return self._infer(pipeline=self.run.pipeline_infer)

    def _infer(self, pipeline: bool) -> int:
        g1, g2 = self.state.models.g1, self.state.models.g2
        g1.eval()
        g2.eval()
        run_infer = self._forward
        if pipeline:
            devs = (list(self.mesh.devices) if self.mesh is not None
                    else self._host_devices())
            if len(devs) >= 2:
                run_infer = StackedPipeline(g1, g2, devs)
            else:
                logger.warning("--pipeline-infer needs >= 2 selected "
                               "devices; using the fused path")
                run_infer = functools.partial(infer_step, g1, g2)

        def compute(x):
            m, y = run_infer(x)
            m = denormalize(m).permute(0, 2, 3, 1)
            y = denormalize(y).permute(0, 2, 3, 1)
            if self.cfg.infer_resize is not None:
                m = resize_linear(m, self.cfg.infer_resize)
                y = resize_linear(y, self.cfg.infer_resize)
            return float_to_uint8(m)[..., 0], float_to_uint8(y)

        if not self._primary:      # a spatial or model rank: compute only
            for x, _, _ in self.valid_batches():
                compute(x)
            return 0
        for sub in ("shadowless", "matte"):
            os.makedirs(os.path.join(self.run.infered_dir, sub),
                        exist_ok=True)
        idx = 0
        futures = []
        with ThreadPoolExecutor(max_workers=4) as pool:
            for m_u8, y_u8 in overlap(compute, (x for x, _, _ in
                                                self.valid_batches())):
                m_np, y_np = m_u8.cpu().numpy(), y_u8.cpu().numpy()
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

    def _host_devices(self) -> list[torch.device]:
        """Every card of the host (a trainer without a mesh selected
        none), or its one CPU."""
        if self.device.type != "cuda":
            return [self.device]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]

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
        with self._whole_state():
            if not self._primary:
                return
            if self.run.checkpoint_backend == "orbax":
                if self._orbax is None:
                    self._orbax = ckpt.make_orbax_checkpointer()
                # returns once the state is on the host; the directory
                # commits while the next epochs run
                ckpt.save_checkpoint_orbax(self.state,
                                           self.run.checkpoint_path, epoch,
                                           host=host,
                                           checkpointer=self._orbax)
            else:
                ckpt.save_checkpoint(self.state, self.run.checkpoint_path,
                                     epoch, host=host)

    def _drain_async_saves(self) -> None:
        """Wait for the orbax commits in flight (re-raising a failed one)."""
        if self._orbax is not None:
            self._orbax.wait_until_finished()

    def load(self, path: str | None = None) -> None:
        """Restore the state from a checkpoint file (msgpack) or an orbax
        directory (the backend's root, or one ``step_N`` in it)."""
        self._drain_async_saves()
        path = path or self.run.checkpoint_path
        with self._whole_state():
            if os.path.isdir(path):
                epoch, host = ckpt.load_checkpoint_orbax(self.state, path)
            else:
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
        if not any((g1, g2, d1, d2)):
            return
        with self._whole_state():
            for net, path in (("G1", g1), ("G2", g2), ("D1", d1),
                              ("D2", d2)):
                if path:
                    ckpt.load_model_weights(self.state, net, path)
                    logger.info("loaded %s weights: %s", net, path)


def _read_back(sums: dict[str, torch.Tensor]) -> dict[str, float]:
    """Device metric sums as floats, in one transfer."""
    keys = list(sums)
    return dict(zip(keys, torch.stack([sums[k] for k in keys]).tolist()))


def make_grid(images: np.ndarray, nrow: int = 4) -> np.ndarray:
    """Tile (N, H, W, C) into a (rows*H, nrow*W, 3) grid, row-major, the
    last row's empty tiles zero and gray repeated to 3 channels; the JAX
    trainer's ``_make_grid`` as one reshape."""
    n, h, w, c = images.shape
    rows = -(-n // nrow)
    tiles = np.zeros((rows * nrow, h, w, 3), images.dtype)
    tiles[:n] = images                     # broadcasts a gray channel
    return tiles.reshape(rows, nrow, h, w, 3).transpose(0, 2, 1, 3, 4) \
        .reshape(rows * h, nrow * w, 3)
