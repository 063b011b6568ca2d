"""Training / inference CLI of the port; port of
``shadow_removal_istd_tpu/cli/main.py``.

The same flags, names, defaults and choices as the JAX package's CLI (and
the reference's, src/main.py:132-329), the args.json snapshot and reload,
run-dir naming that encodes lr / D-type / D-loss, and seeding::

    python -m shadow_removal_istd_tpu_torch.cli.main --tasks train infer \\
        --data-dir <ISTD root> [--devices cpu]

Differences:
- ``--devices`` is ``cuda`` (the default) or ``cpu``; a device count, a
  list or another platform raises. Without a card ``cuda`` raises: the
  CPU runs only when asked for.
- Flags whose feature is not ported raise ``NotImplementedError`` naming
  the flag when set away from their default. Every ``--net-G``/``--net-D``
  choice, ``--softadapt``, ``--SELU``, ``--remat`` (the rematerialized
  train step) and ``--data-h5`` (the HDF5 dataset, read by the port's
  own HDF5 codec; it takes precedence over ``--data-dir``) run.

TensorBoard event files land in ``<logs>/{train,valid}``, a
``--profile-dir`` trace of the second epoch in that directory
(``<host>.<pid>.pt.trace.json``). With ``--preempt-save`` (the default)
a SIGTERM during training checkpoints at the next epoch boundary and the
remaining tasks are skipped; ``--device-cache no`` trains on the host
pipeline (batches uploaded while the previous step computes).

Weight and checkpoint files are the JAX package's flax msgpack files, so
a run of either package resumes or serves from the other's.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import random
import re
import signal
import threading
import time

import numpy as np
import torch

from shadow_removal_istd_tpu_torch import resolve_device

logger = logging.getLogger(__name__)

PRESERVED_ARGS = [
    "load_args",
    "load_checkpoint",
    "load_weights_g1",
    "load_weights_g2",
    "load_weights_d1",
    "load_weights_d2",
    "weights", "logs",
    # per-invocation infrastructure, never part of a run's identity
    "coordinator", "num_processes", "process_id",
]

# flag -> (args attribute, is it set away from its default?)
_UNPORTED_FLAGS = {
    "--spatial-shard": ("spatial_shard", lambda v: v > 1),
    "--model-shard": ("model_shard", lambda v: v > 1),
    "--coordinator": ("coordinator", lambda v: v is not None),
    "--num-processes": ("num_processes", lambda v: v is not None),
    "--process-id": ("process_id", lambda v: v is not None),
    "--pipeline-infer": ("pipeline_infer", bool),
    "--export-stablehlo": ("export_stablehlo", lambda v: v is not None),
    "--checkpoint-backend orbax": ("checkpoint_backend",
                                   lambda v: v == "orbax"),
}


def str2bool(v: str) -> bool:
    return v.lower() in ("yes", "true", "t", "y", "1")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Training ST-CGAN model for shadow removal "
                    "(PyTorch/CUDA)")
    parser.add_argument("--tasks", required=True, nargs="+",
                        choices=["train", "infer", "serve"], type=str,
                        help="the task to run; 'serve' starts the online "
                             "HTTP daemon on the loaded/trained weights")
    parser.add_argument("--devices", default=["cuda"],
                        type=lambda s: re.split(", *| +", s),
                        help="cuda (default) or cpu")
    parser.add_argument("--batch-size", default=16, type=int)
    parser.add_argument("--epochs", default=100000, type=int)
    parser.add_argument("--data-dir", default=[],
                        type=lambda s: re.split(", *| +", s),
                        help="root folder(s) with images")
    parser.add_argument("--data-h5", default=None,
                        help="HDF5 dataset file (build with "
                             "shadow_removal_istd_tpu_torch.data.h5."
                             "build_h5); takes precedence over --data-dir")
    parser.add_argument("--workers", default=4, type=int,
                        help="kept for CLI parity; PNGs decode on the "
                             "native loader's or a thread pool")
    parser.add_argument("--image-size", default=256, type=int)
    parser.add_argument("--aug-scale", default=0.05, type=float)
    parser.add_argument("--aug-angle", default=15, type=int)
    parser.add_argument("--net-G", default="mnet",
                        choices=["unet", "mnet", "denseunet", "stcgan"])
    parser.add_argument("--net-D", default="patchgan",
                        choices=["patchgan", "began", "stcgan", "dummy"])
    parser.add_argument("--ngf", default=64, type=int)
    parser.add_argument("--ndf", default=64, type=int)
    parser.add_argument("--droprate", default=0.05, type=float)
    parser.add_argument("--lr-D", default=0.0001, type=float)
    parser.add_argument("--lr-G", default=0.0005, type=float)
    parser.add_argument("--decay", default=0.003, type=float)
    parser.add_argument("--beta1", default=0.5, type=float)
    parser.add_argument("--beta2", default=0.999, type=float)
    parser.add_argument("--lambda1", default=5, type=float)
    parser.add_argument("--lambda2", default=0.5, type=float)
    parser.add_argument("--lambda3", default=0.5, type=float)
    parser.add_argument("--lambda4", default=5, type=float)
    parser.add_argument("--lambda5", default=50, type=float)
    parser.add_argument("--manual_seed", default=38107943, type=int)
    parser.add_argument("--load-weights-g1", default=None)
    parser.add_argument("--load-weights-g2", default=None)
    parser.add_argument("--load-weights-d1", default=None)
    parser.add_argument("--load-weights-d2", default=None)
    parser.add_argument("--load-args", default=None)
    parser.add_argument("--load-checkpoint", default=None)
    parser.add_argument("--D-loss-fn", default="standard",
                        choices=["standard", "leastsquare"])
    parser.add_argument("--D-type", default="normal",
                        choices=["normal", "rel", "rel_avg"])
    parser.add_argument("--softadapt", type=str2bool, default=False,
                        const=True, nargs="?")
    parser.add_argument("--SELU", type=str2bool, default=False,
                        const=True, nargs="?")
    parser.add_argument("--NN-upconv", type=str2bool, default=False,
                        const=True, nargs="?")
    parser.add_argument("--activation", default="tanh",
                        choices=["none", "sigmoid", "tanh", "htanh"])
    parser.add_argument("--log-every", default=3, type=int)
    parser.add_argument("--valid-every", default=10, type=int)
    parser.add_argument("--vis-every", default=50, type=int)
    parser.add_argument("--save-every", default=50, type=int)
    parser.add_argument("--weights", default="./weights")
    parser.add_argument("--infered", default="./infered")
    parser.add_argument("--logs", default="./logs")
    parser.add_argument("--vgg-weights", default=None,
                        help="converted VGG19-BN .npz for the visual loss")
    parser.add_argument("--allow-missing-vgg", action="store_true",
                        help="train WITHOUT the perceptual terms (warning "
                             "instead of an error) when lambda4/lambda5 "
                             "are nonzero but no --vgg-weights is given")
    parser.add_argument("--loss-mode", default="reference",
                        choices=["reference", "corrected"],
                        help="reference-exact vs corrected adversarial "
                             "loss flag semantics")
    parser.add_argument("--compute-dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="bfloat16 = mixed-precision training "
                             "(f32 params/BN/losses)")
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize the train step: its backward "
                             "replays the forwards, for far less "
                             "activation memory (full-resolution "
                             "batches)")
    parser.add_argument("--device-cache", type=str2bool, default=True,
                        const=True, nargs="?",
                        help="keep the dataset on the card and gather "
                             "each batch there; no: the host pipeline "
                             "uploads each batch")
    parser.add_argument("--aug-method", default="shear",
                        choices=["gather", "shear"],
                        help="augmentation path: exact bilinear gather "
                             "(cv2 geometry) or the 3-shear hshear kernel")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of the "
                             "second training epoch into this directory")
    parser.add_argument("--spatial-shard", type=int, default=1,
                        help="spatial partitioning (not ported yet)")
    parser.add_argument("--model-shard", type=int, default=1,
                        help="tensor parallelism (not ported yet)")
    parser.add_argument("--checkpoint-backend", default="msgpack",
                        choices=["msgpack", "orbax"],
                        help="full-state checkpoint format: msgpack = one "
                             "file (orbax is not ported yet)")
    parser.add_argument("--coordinator", default=None,
                        help="multi-host training (not ported yet)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="multi-host training (not ported yet)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="multi-host training (not ported yet)")
    parser.add_argument("--serve-host", default="127.0.0.1",
                        help="--tasks serve: bind address")
    parser.add_argument("--serve-port", default=8650, type=int,
                        help="--tasks serve: port (0 = ephemeral)")
    parser.add_argument("--serve-window-ms", default=5.0, type=float,
                        help="--tasks serve: micro-batching window")
    parser.add_argument("--serve-max-batch", default=8, type=int,
                        help="--tasks serve: max coalesced batch")
    parser.add_argument("--serve-max-queue", default=None, type=int,
                        help="--tasks serve: admission-control queue "
                             "bound (default 8*max-batch)")
    parser.add_argument("--serve-timeout-s", default=600.0, type=float,
                        help="--tasks serve: per-request deadline")
    parser.add_argument("--pipeline-infer", action="store_true",
                        help="pipeline-parallel inference (not ported "
                             "yet)")
    parser.add_argument("--eval-metrics", action="store_true",
                        help="score each validation by the ISTD protocol "
                             "(LAB RMSE/MAE, Eval/* in the log)")
    parser.add_argument("--preempt-save", type=str2bool, default=True,
                        help="on SIGTERM, write the full checkpoint at "
                             "the next epoch boundary and exit cleanly")
    parser.add_argument("--export-stablehlo", default=None,
                        help="serving artifact export (not ported yet)")
    parser.add_argument("--export-shape", type=int, nargs=2,
                        default=[480, 640], metavar=("H", "W"),
                        help="image H W for --export-stablehlo")
    return parser


def makedirs(args) -> None:
    """Run-dir naming encoding hyperparameters (src/main.py:100-118)."""
    arg_str = f"_lr{args.lr_G:.5f}_"
    if args.D_type == "rel":
        arg_str += "Rp"
    elif args.D_type == "rel_avg":
        arg_str += "Ra"
    arg_str += "SGAN" if args.D_loss_fn == "standard" else "LSGAN"
    args.weights += arg_str
    args.logs += arg_str
    os.makedirs(args.logs, exist_ok=True)
    if "train" in args.tasks:
        os.makedirs(args.weights, exist_ok=True)
    if "infer" in args.tasks:
        os.makedirs(args.infered, exist_ok=True)


def snapshotargs(args, filename: str = "args.json") -> None:
    args_file = os.path.join(args.logs, filename)
    with open(args_file, "w") as fp:
        json.dump(vars(args), fp, indent=4, sort_keys=True)


def load_args(args) -> None:
    """--load-args: restore a previous run's flags, preserving the
    load/output paths of the current invocation."""
    with open(args.load_args, "r") as f:
        arg_dict = json.load(f)
    for k in PRESERVED_ARGS:
        arg_dict.pop(k, None)
    args.__dict__.update(arg_dict)


def set_manual_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def prepare_run_dirs(args) -> None:
    """Reference order (src/main.py:24-40): makedirs and the args.json
    snapshot come FIRST, from the current invocation's flags; only then
    does --load-args overlay the stored run's flags."""
    makedirs(args)
    snapshotargs(args)
    if args.load_args is not None:
        load_args(args)


def refuse_unported(args) -> None:
    """Raise ``NotImplementedError`` naming the first flag whose feature
    the port lacks, when set away from its default."""
    for flag, (attr, is_set) in _UNPORTED_FLAGS.items():
        if is_set(getattr(args, attr)):
            raise NotImplementedError(f"{flag} is not ported yet")


def select_device(devices: list[str]) -> torch.device:
    """``--devices``: one entry, ``cuda`` or ``cpu``."""
    if len(devices) != 1 or devices[0].isdigit():
        raise NotImplementedError(
            f"--devices {' '.join(devices)}: several devices (data "
            "parallelism) are not ported yet; pass cuda or cpu")
    return resolve_device(devices[0])


def main(args) -> None:
    time_str = time.strftime("%Y%m%d-%H%M%S")
    prepare_run_dirs(args)
    refuse_unported(args)
    device = select_device(args.devices)
    if args.manual_seed != -1:
        set_manual_seed(args.manual_seed)
    from shadow_removal_istd_tpu_torch.utils.logging_utils import (
        setup_logging,
    )
    setup_logging(os.path.join(args.logs, f"main-{time_str}.log"))
    logger.info("Arguments: %s", args)

    if (("infer" in args.tasks or "serve" in args.tasks)
            and "train" not in args.tasks):
        if args.load_checkpoint is None and not (args.load_weights_g1
                                                 and args.load_weights_g2):
            raise ValueError("inference needs --load-weights-g1/g2 or "
                             "--load-checkpoint")

    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
    from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer

    cfg = TrainConfig(
        net_g=args.net_G, net_d=args.net_D, ngf=args.ngf, ndf=args.ndf,
        droprate=args.droprate, nn_upconv=args.NN_upconv,
        use_selu=args.SELU, activation=args.activation,
        lr_g=args.lr_G, lr_d=args.lr_D, decay=args.decay,
        beta1=args.beta1, beta2=args.beta2,
        lambda1=args.lambda1, lambda2=args.lambda2, lambda3=args.lambda3,
        lambda4=args.lambda4, lambda5=args.lambda5,
        d_loss_fn=args.D_loss_fn, d_type=args.D_type,
        loss_mode=args.loss_mode, softadapt=args.softadapt,
        image_size=args.image_size, batch_size=args.batch_size,
        aug_scale=args.aug_scale, aug_angle=args.aug_angle,
        use_visual_loss=True,  # the Trainer enforces the VGG rule
        compute_dtype=args.compute_dtype,
        aug_method=args.aug_method,
        remat=args.remat,
    )
    run = RunConfig(
        data_dirs=tuple(args.data_dir), data_h5=args.data_h5,
        logs_dir=args.logs, weights_dir=args.weights,
        infered_dir=args.infered,
        checkpoint_path=os.path.join(args.weights, "checkpoint.msgpack"),
        checkpoint_backend=args.checkpoint_backend,
        log_every=args.log_every, valid_every=args.valid_every,
        vis_every=args.vis_every, save_every=args.save_every,
        seed=args.manual_seed if args.manual_seed != -1 else 0,
        vgg_weights=args.vgg_weights,
        allow_missing_vgg=args.allow_missing_vgg, tasks=tuple(args.tasks),
        device_cache=args.device_cache,
        profile_dir=args.profile_dir,
        preempt_save=args.preempt_save,
        eval_metrics=args.eval_metrics,
        pipeline_infer=args.pipeline_infer,
    )
    trainer = Trainer(cfg, run, device=device)
    trainer.load_weights(g1=args.load_weights_g1, g2=args.load_weights_g2,
                         d1=args.load_weights_d1, d2=args.load_weights_d2)
    if args.load_checkpoint is not None:
        if not os.path.exists(args.load_checkpoint):
            print(f"{args.load_checkpoint} does not exist")
        else:
            trainer.load(args.load_checkpoint)

    if "train" in args.tasks:
        trainer.train(args.epochs)
        trainer.close()
    if trainer.preempted:
        # eviction is near: the checkpoint is the deliverable, and a
        # SIGKILL during inference would leave truncated outputs
        logger.warning("preempted: skipping remaining tasks")
        return
    if "infer" in args.tasks:
        trainer.infer()
    if "serve" in args.tasks:
        _serve(trainer, cfg, args)


def _serve(trainer, cfg, args) -> None:
    """``--tasks serve``: hand the trained or loaded generators to the
    online daemon (no file round-trip). Blocks until SIGTERM/SIGINT,
    which replace the trainer's preemption handler: while serving, the
    graceful action is shutting the server down."""
    from shadow_removal_istd_tpu_torch.serving import (
        InferenceEngine,
        ShadowRemovalServer,
    )
    from shadow_removal_istd_tpu_torch.tools.convert import (
        torch_to_flax_tree,
    )

    engine = InferenceEngine(
        cfg.net_g, ngf=cfg.ngf, droprate=cfg.droprate,
        nn_upconv=cfg.nn_upconv, use_selu=cfg.use_selu,
        activation=cfg.activation,
        dtype=("bfloat16" if cfg.compute_dtype == "bfloat16"
               else "float32"),
        max_batch=args.serve_max_batch, device=trainer.device)
    models = trainer.state.models
    engine.set_variables(torch_to_flax_tree(models.g1),
                         torch_to_flax_tree(models.g2))
    server = ShadowRemovalServer(engine, host=args.serve_host,
                                 port=args.serve_port,
                                 window_ms=args.serve_window_ms,
                                 max_queue=args.serve_max_queue,
                                 request_timeout_s=args.serve_timeout_s)

    def _on_signal(signum, frame):
        logger.info("signal %d: stopping server", signum)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    logger.info("serving on http://%s:%d (POST /v1/unshadow)",
                *server.address)
    server.serve_forever()


if __name__ == "__main__":
    main(build_parser().parse_args())
