"""Training / inference CLI of the port; port of
``shadow_removal_istd_tpu/cli/main.py``.

The same flags, names, defaults and choices as the JAX package's CLI (and
the reference's, src/main.py:132-329), the args.json snapshot and reload,
run-dir naming that encodes lr / D-type / D-loss, and seeding::

    python -m shadow_removal_istd_tpu_torch.cli.main --tasks train infer \\
        --data-dir <ISTD root> [--devices cpu]

Devices and ranks:
- ``--devices`` is ``cuda`` (the default, one card), ``cpu`` or a count
  N of cards. Without a card ``cuda`` and N raise: the CPU runs only
  when asked for. N is capped to the cards present and to the largest
  divisor of the batch size (with the other processes' ranks counted),
  as the JAX CLI caps its data mesh.
- Training on N > 1 cards starts N ranks, one process per card
  (``torch.multiprocessing``, spawn), each training data-parallel on its
  slice of every global batch (``parallel/mesh.py``); rank 0 alone
  writes files. The collectives run over NCCL when every rank has a card
  of its own, else over gloo (ranks sharing a card, CPU ranks).
- ``--coordinator host:port --num-processes P --process-id i`` joins P
  such processes (one per host), each with its own ``--devices`` ranks:
  P x N ranks in all, rank ``i * N + local``; ``--devices cpu`` (or
  ``cuda``) makes the process itself one rank. The three flags go
  together, with the JAX CLI's messages. ``--tasks serve`` refuses them;
  ``infer`` raises in such a run, as in JAX.
- ``--spatial-shard S`` and ``--model-shard M`` make the ranks a
  (data, spatial, model) mesh (``parallel/mesh.py``), sized by the JAX
  CLI's ``_select_mesh`` capping (:func:`mesh_shape`): forward work
  splits image rows over S ranks (``parallel/spatial.py``), weights,
  BatchNorm statistics and Adam moments split their channels over M
  (``parallel/tensor.py``); both together form JAX's composed mesh.
  With one process, N cards give ``data * S * M`` ranks; with several,
  every rank of the run must fit the mesh.
- ``--pipeline-infer`` runs ``infer`` as the two-stage pipeline over the
  selected cards (``parallel/pipeline.py``); with fewer than two it
  warns and runs fused.
- Flags whose feature is not ported raise ``NotImplementedError`` naming
  the flag when set away from their default (``--checkpoint-backend
  orbax``). Every ``--net-G``/``--net-D``
  choice, ``--softadapt``, ``--SELU``, ``--remat`` (the rematerialized
  train step) and ``--data-h5`` (the HDF5 dataset, read by the port's
  own HDF5 codec; it takes precedence over ``--data-dir``) run.

TensorBoard event files land in ``<logs>/{train,valid}``, a
``--profile-dir`` trace of the second epoch in that directory
(``<host>.<pid>.pt.trace.json``). With ``--preempt-save`` (the default)
a SIGTERM during training checkpoints at the next epoch boundary and the
remaining tasks are skipped; ``--device-cache no`` trains on the host
pipeline (batches uploaded while the previous step computes).
``--export-stablehlo PATH`` (the JAX flag's name) writes, after the
tasks, the G pair as a ``torch.export`` serving artifact at
``--export-shape H W`` (``tools/export.py``), not a StableHLO file.

Weight and checkpoint files are the JAX package's flax msgpack files, so
a run of either package resumes or serves from the other's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import random
import re
import signal
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from shadow_removal_istd_tpu_torch import resolve_device
from shadow_removal_istd_tpu_torch.parallel.mesh import (
    Mesh,
    barrier,
    distributed_init,
    make_mesh,
    unshard_state,
)

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
                        help="cuda (default, one card), cpu, or a count "
                             "N of cards: training on N > 1 starts one "
                             "data-parallel rank per card")
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
                        help="shard image H rows over this many ranks "
                             "(spatial partitioning with halo exchanges; "
                             "forward-only work: validation/inference)")
    parser.add_argument("--model-shard", type=int, default=1,
                        help="shard conv feature channels over this many "
                             "ranks (tensor parallelism: weights, BN "
                             "stats and Adam moments split; composes "
                             "with --spatial-shard)")
    parser.add_argument("--checkpoint-backend", default="msgpack",
                        choices=["msgpack", "orbax"],
                        help="full-state checkpoint format: msgpack = one "
                             "file (orbax is not ported yet)")
    parser.add_argument("--coordinator", default=None,
                        help="multi-host training: rank 0's rendezvous "
                             "address host:port (process 0's host); with "
                             "--num-processes and --process-id")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="multi-host training: total process count "
                             "(one per host)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="multi-host training: this process's index "
                             "(0..num-processes-1)")
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
                        help="pipeline parallelism for inference: G1 on "
                             "one device group, G2 on the other, matte "
                             "handed over between stages (halves "
                             "per-device weight memory; throughput set "
                             "by the slower stage)")
    parser.add_argument("--eval-metrics", action="store_true",
                        help="score each validation by the ISTD protocol "
                             "(LAB RMSE/MAE, Eval/* in the log)")
    parser.add_argument("--preempt-save", type=str2bool, default=True,
                        help="on SIGTERM, write the full checkpoint at "
                             "the next epoch boundary and exit cleanly")
    parser.add_argument("--export-stablehlo", default=None,
                        help="after the tasks, write the G pair as a "
                             "serving artifact at --export-shape: a "
                             "torch.export package (tools/export.py), not "
                             "StableHLO; serve it with the daemon's "
                             "--artifact")
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


def check_multihost_flags(args) -> None:
    """``--coordinator``/``--num-processes``/``--process-id`` go together
    (the JAX CLI's rule and messages); none given is one process."""
    if args.num_processes is not None:
        if args.coordinator is None or args.process_id is None:
            raise SystemExit("--num-processes needs --coordinator "
                             "host:port and --process-id")
    elif args.coordinator is not None:
        raise SystemExit("--coordinator needs --num-processes and "
                         "--process-id")


def select_devices(devices: list[str], batch_size: int,
                   processes: int = 1) -> list[torch.device]:
    """``--devices``: ``cuda`` or ``cpu`` (one device), or a count N of
    cards, capped to the cards present and to the largest n with
    ``batch_size % (processes * n) == 0`` (every rank an equal slice)."""
    if len(devices) != 1:
        raise NotImplementedError(
            f"--devices {' '.join(devices)}: a list of devices is not "
            "ported; pass cuda, cpu or a count of cards")
    if not devices[0].isdigit():
        return [resolve_device(devices[0])]
    resolve_device("cuda")
    want, avail = int(devices[0]), torch.cuda.device_count()
    n = min(want, avail)
    if n < want:
        logger.warning("--devices %d: the host has %d cards; using %d",
                       want, avail, n)
    while n > 1 and batch_size % (processes * n):
        n -= 1
    if batch_size % (processes * n):
        raise SystemExit(f"--batch-size {batch_size} does not split over "
                         f"{processes} processes")
    if n < min(want, avail):
        logger.warning("--devices %d capped to %d, the largest count "
                       "whose ranks split --batch-size %d equally", want,
                       n, batch_size)
    return [torch.device("cuda", i) for i in range(n)]


def mesh_shape(want: int, avail: int, batch_size: int,
               spatial_shard: int = 1, model_shard: int = 1
               ) -> tuple[int, int, int]:
    """The (data, spatial, model) sizes of a run that asks for ``want``
    of ``avail`` ranks: the JAX CLI's ``_select_mesh`` capping, in its
    order and with its warnings. The spatial and model sizes are capped
    to the ranks, then spatial to what the model size leaves; the data
    size takes the rest, capped to the largest divisor of the batch."""
    want = min(want, avail)
    sp = max(1, spatial_shard)
    if sp > want:
        logger.warning("--spatial-shard %d > %d available devices; "
                       "capping", sp, want)
        sp = want
    mp = max(1, model_shard)
    if mp > want:
        logger.warning("--model-shard %d > %d available devices; "
                       "capping", mp, want)
        mp = want
    if sp * mp > want:
        new_sp = max(1, want // mp)
        logger.warning(
            "--spatial-shard %d x --model-shard %d needs %d devices "
            "but only %d are available; capping spatial to %d",
            sp, mp, sp * mp, want, new_sp)
        sp = new_sp
    n = min(want // (sp * mp), batch_size)
    while n > 1 and batch_size % n != 0:
        n -= 1
    return max(n, 1), sp, mp


def select_mesh(devices: list[str], batch_size: int, processes: int = 1,
                spatial_shard: int = 1, model_shard: int = 1
                ) -> tuple[list[torch.device], tuple[int, int, int]]:
    """``--devices`` with ``--spatial-shard``/``--model-shard``: this
    process's rank devices and the mesh shape (:func:`mesh_shape`). One
    process: a count N of cards is asked of the cards present, a device
    name (``cuda``, ``cpu``) is one device; the run takes the first
    ``data * spatial * model`` of them. Several processes: each brings
    its devices (:func:`select_devices` without the batch rule) and
    the mesh must hold every rank of the run."""
    if len(devices) != 1:
        raise NotImplementedError(
            f"--devices {' '.join(devices)}: a list of devices is not "
            "ported; pass cuda, cpu or a count of cards")
    if devices[0].isdigit():
        resolve_device("cuda")
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        want = int(devices[0])
    else:
        avail = [resolve_device(devices[0])]
        want = 1
    if processes == 1:
        shape = mesh_shape(want, len(avail), batch_size, spatial_shard,
                           model_shard)
        return avail[:math.prod(shape)], shape
    local = avail[:min(want, len(avail))]
    world = processes * len(local)
    shape = mesh_shape(world, world, batch_size, spatial_shard, model_shard)
    if math.prod(shape) != world:
        raise SystemExit(
            f"{world} ranks do not form a mesh: --spatial-shard "
            f"{spatial_shard} x --model-shard {model_shard} with "
            f"--batch-size {batch_size} uses {math.prod(shape)} "
            f"(data, spatial, model = {shape})")
    return local, shape


def join_ranks(local_rank: int, devices: list[torch.device],
               init: str | None, processes: int = 1,
               process_id: int = 0,
               shape: tuple[int, int, int] | None = None) -> Mesh:
    """This rank's mesh: without ``init`` one rank over ``devices`` (the
    selected devices, for pipeline inference); else rank ``process_id *
    len(devices) + local_rank`` of ``processes * len(devices)``, on its
    own device, joined at ``init``, over a mesh of ``shape`` (data,
    spatial, model; data-parallel by default)."""
    if init is None:
        return make_mesh(devices[0], devices=devices)
    local = len(devices)
    distributed_init(init, processes * local, process_id * local + local_rank)
    return make_mesh(devices[local_rank], devices=devices,
                     processes=processes, shape=shape)


def start_ranks(target, args: tuple, devices: list[torch.device],
                multi: bool, coordinator: str | None = None) -> None:
    """Run ``target(local_rank, *args, devices, init)`` for this process's
    ranks: in this process when it is one rank (``init`` None unless
    ``multi``), else one spawned process per device, rendezvousing at
    ``coordinator`` or at a file in a temporary directory. A rank that
    fails fails the launch (the others are stopped). A SIGTERM to this
    process goes on to every rank, as it reaches the one process of the
    JAX package's run: each rank's preemption guard sees it."""
    if not multi or len(devices) == 1:
        target(0, *args, devices, coordinator if multi else None)
        return
    with tempfile.TemporaryDirectory() as tmp:
        init = coordinator or f"file://{tmp}/rendezvous"
        ranks = mp.start_processes(target, args=(*args, devices, init),
                                   nprocs=len(devices), join=False,
                                   start_method="spawn")

        def forward(signum, frame):
            for p in ranks.processes:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(p.pid, signum)

        old = signal.signal(signal.SIGTERM, forward)
        try:
            while not ranks.join():
                pass
        finally:
            signal.signal(signal.SIGTERM, old)


def main(args) -> None:
    check_multihost_flags(args)
    time_str = time.strftime("%Y%m%d-%H%M%S")
    prepare_run_dirs(args)
    refuse_unported(args)
    processes = args.num_processes or 1
    if processes > 1 and "serve" in args.tasks:
        raise SystemExit("--tasks serve is single-process; serve from "
                         "the saved weights on one host (data-parallel "
                         "serving uses --devices N within a host)")
    shape = None
    if args.spatial_shard > 1 or args.model_shard > 1:
        devices, shape = select_mesh(args.devices, args.batch_size,
                                     processes, args.spatial_shard,
                                     args.model_shard)
        # every task's forward is collective over these axes
        multi = processes > 1 or len(devices) > 1
    else:
        devices = select_devices(args.devices, args.batch_size, processes)
        multi = processes > 1 or ("train" in args.tasks
                                  and len(devices) > 1)
    start_ranks(_rank_main, (args, time_str, shape), devices, multi,
                args.coordinator)


def rank_logging(log_dir: str, stem: str, local_rank: int,
                 devices: list[torch.device], init: str | None,
                 process_id: int = 0) -> None:
    """Logging of one rank, set up before it joins the group: rank N of
    a run of several logs to ``<stem>-p<N>.log`` with ``[rank N]`` lines,
    as the JAX CLI names process N's file; one rank to ``<stem>.log``."""
    from shadow_removal_istd_tpu_torch.utils.logging_utils import (
        setup_logging,
    )
    rank = None if init is None else process_id * len(devices) + local_rank
    tail = "" if rank is None else f"-p{rank}"
    setup_logging(os.path.join(log_dir, f"{stem}{tail}.log"), rank=rank)


def leave_ranks(mesh: Mesh) -> None:
    """Wait for every rank, then leave the process group."""
    if mesh.world > 1:
        barrier(mesh)
        dist.destroy_process_group()


def _rank_main(local_rank: int, args, time_str: str, shape,
               devices: list[torch.device], init: str | None) -> None:
    """One rank of ``main``: join the group, run the tasks, leave it."""
    rank_logging(args.logs, f"main-{time_str}", local_rank, devices, init,
                 args.process_id or 0)
    mesh = join_ranks(local_rank, devices, init, args.num_processes or 1,
                      args.process_id or 0, shape)
    try:
        _run_tasks(args, mesh)
    finally:
        leave_ranks(mesh)


def _run_tasks(args, mesh: Mesh) -> None:
    if args.manual_seed != -1:
        set_manual_seed(args.manual_seed)
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
    if args.spatial_shard > 1 and "train" in args.tasks:
        logger.warning(
            "--spatial-shard accelerates forward-only work (validation/"
            "inference); training batches shard on the data axis only "
            "(see parallel.mesh.train_batch_sharding)")
    trainer = Trainer(cfg, run, mesh=mesh)
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
        # the daemon serves the whole weights from rank 0
        unshard_state(mesh, trainer.state)
        if mesh.rank == 0:
            _serve(trainer, cfg, args)
    if args.export_stablehlo:
        from shadow_removal_istd_tpu_torch.tools.export import (
            export_stacked_inference,
        )
        nbytes = export_stacked_inference(
            args.export_stablehlo, trainer.state, trainer.state.models,
            image_shape=tuple(args.export_shape))
        if mesh.rank == 0:
            logger.info("serialized serving artifact: %s (%.1f MB, "
                        "torch.export)", args.export_stablehlo, nbytes / 1e6)


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
