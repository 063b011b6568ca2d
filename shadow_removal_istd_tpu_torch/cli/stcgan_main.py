"""Legacy-tree CLI: the reference's older fixed STCGAN pipeline; port of
``shadow_removal_istd_tpu/cli/stcgan_main.py``::

    python -m shadow_removal_istd_tpu_torch.cli.stcgan_main \\
        --tasks train infer --data-dir <ISTD root> [--devices cpu]

Fixed behaviour (reference STCGAN/stcgan.py), whatever the flags say:

- pix2pix U-Net generators and NLayer (70x70 PatchGAN) discriminators
  (``--net-G``/``--net-D`` are parsed for CLI parity only);
- loss weights data1=1, data2=5, adversarial 0.1/0.1, no visual loss;
- ReduceLROnPlateau on the summed epoch losses (factor 0.8, cooldown
  10, min_lr 1e-7), at the constant base rates;
- training images resized to 300x400 before augmentation and the
  ``--image-size`` crop, validation at 256x256, inference outputs
  resized to 192x256;
- the binary masks (``<subset>_B``) as G1's target instead of mattes;
- DCGAN init at start (``--init-compat``: the reference's N(0, .02) BN
  scales).

Training runs the host-pipeline epoch (``RunConfig``'s default, as in
the JAX package); a SIGTERM checkpoints at the next epoch boundary and
skips inference. ``--devices`` is ``cuda`` (the default), ``cpu`` or a
count N of cards: training on N > 1 starts one data-parallel rank per
card, as ``cli/main.py`` does (the JAX legacy CLI maps it onto its data
mesh).
``--no-batch-norm-G`` and ``--no-batch-norm-D`` are parsed, as in the
reference, and refuse to run when set, since the pipeline trains with
BatchNorm whatever they say.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

from shadow_removal_istd_tpu_torch.cli.main import (
    join_ranks,
    leave_ranks,
    rank_logging,
    select_devices,
    start_ranks,
    str2bool,
)

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Training STCGAN (legacy tree) for shadow removal "
                    "(PyTorch/CUDA)")
    parser.add_argument("--tasks", required=True, nargs="+",
                        choices=["train", "infer"], type=str)
    parser.add_argument("--devices", default=["cuda"], nargs="+", type=str,
                        help="cuda (default), cpu or a count N of cards "
                             "(training on N > 1: one rank per card); of "
                             "several only the first counts")
    parser.add_argument("--batch-size", default=16, type=int)
    parser.add_argument("--epochs", default=100000, type=int)
    parser.add_argument("--lr-D", default=0.00002, type=float)
    parser.add_argument("--lr-G", default=0.00005, type=float)
    parser.add_argument("--decay", default=0.00005, type=float)
    parser.add_argument("--workers", default=4, type=int)
    parser.add_argument("--weights", default="../weights", type=str)
    parser.add_argument("--infered", default="../infered", type=str)
    parser.add_argument("--logs", default="../logs", type=str)
    parser.add_argument("--data-dir", default="../ISTD_DATASET", type=str)
    parser.add_argument("--image-size", default=256, type=int)
    parser.add_argument("--aug-scale", default=0.05, type=float)
    parser.add_argument("--aug-angle", default=15, type=int)
    parser.add_argument("--net-G", default="mnet",
                        choices=["unet", "mnet", "denseunet"], type=str)
    parser.add_argument("--net-D", default="patchgan",
                        choices=["patchgan"], type=str)
    parser.add_argument("--load-weights-g1", default=None)
    parser.add_argument("--load-weights-g2", default=None)
    parser.add_argument("--load-weights-d1", default=None)
    parser.add_argument("--load-weights-d2", default=None)
    parser.add_argument("--D-loss-fn", default="standard",
                        choices=["standard", "leastsquare"], type=str)
    parser.add_argument("--D-loss-type", default="normal",
                        choices=["normal", "rel", "rel_avg"], type=str)
    parser.add_argument("--softadapt", type=str2bool, default=False,
                        const=True, nargs="?")
    parser.add_argument("--manual_seed", default=38107943, type=int)
    parser.add_argument("--SELU", default=False, type=str2bool)
    parser.add_argument("--beta1", default=0.5, type=float)
    parser.add_argument("--beta2", default=0.999, type=float)
    parser.add_argument("--NN-upconv", type=str2bool, default=False,
                        const=True, nargs="?")
    # parsed for CLI parity; a truthy value refuses to run (see main)
    parser.add_argument("--no-batch-norm-G", type=str2bool, default=False,
                        const=True, nargs="?")
    parser.add_argument("--no-batch-norm-D", type=str2bool, default=False,
                        const=True, nargs="?")
    parser.add_argument("--log-every", default=3, type=int)
    parser.add_argument("--valid-every", default=10, type=int)
    parser.add_argument("--init-compat", type=str2bool, default=False,
                        const=True, nargs="?",
                        help="reproduce the reference's BN-scale N(0,.02) "
                             "init exactly")
    return parser


def main(args) -> None:
    if args.no_batch_norm_G or args.no_batch_norm_D:
        raise SystemExit(
            "--no-batch-norm-G/-D are parsed for CLI parity but not "
            "implemented (the reference also parses and ignores them, "
            "STCGAN/main.py:236-239); refusing to train with BatchNorm "
            "silently enabled — drop the flag")
    devices = select_devices(list(args.devices), args.batch_size)
    time_str = time.strftime("%Y%m%d-%H%M%S")
    os.makedirs(args.logs, exist_ok=True)
    if "train" in args.tasks:
        os.makedirs(args.weights, exist_ok=True)
    if "infer" in args.tasks:
        os.makedirs(args.infered, exist_ok=True)
    with open(os.path.join(args.logs, "args.json"), "w") as fp:
        json.dump(vars(args), fp, indent=4, sort_keys=True)
    start_ranks(_rank_main, (args, time_str), devices,
                "train" in args.tasks and len(devices) > 1)


def _rank_main(local_rank: int, args, time_str: str, devices,
               init: str | None) -> None:
    """One rank: join the group, train and infer, leave it."""
    rank_logging(args.logs, f"stcgan-{time_str}", local_rank, devices, init)
    mesh = join_ranks(local_rank, devices, init)
    try:
        _run_tasks(args, mesh)
    finally:
        leave_ranks(mesh)


def _run_tasks(args, mesh) -> None:
    logger.info("Arguments: %s", args)

    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
    from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer

    cfg = TrainConfig(
        # the old engine hard-wires pix2pix G + NLayer D (stcgan.py:34-40)
        net_g="stcgan", net_d="stcgan", ngf=64, ndf=64,
        droprate=0.0, nn_upconv=args.NN_upconv, use_selu=args.SELU,
        activation="tanh",
        lr_g=args.lr_G, lr_d=args.lr_D, decay=args.decay,
        beta1=args.beta1, beta2=args.beta2,
        # fixed weights (stcgan.py:117-119); no visual loss
        lambda1=5.0, lambda2=0.1, lambda3=0.1, lambda4=0.0, lambda5=0.0,
        d_loss_fn=args.D_loss_fn, d_type=args.D_loss_type,
        loss_mode="reference", softadapt=args.softadapt,
        image_size=args.image_size, batch_size=args.batch_size,
        aug_scale=args.aug_scale, aug_angle=args.aug_angle,
        lr_schedule="plateau",
        aug_resize=(300, 400),
        valid_resize=(256, 256),
        infer_resize=(192, 256),   # cv.resize(y, (256, 192)) = 192 rows
        dcgan_init=True,
        dcgan_bn_compat=args.init_compat,
        train_datas=("img", "mask", "target"),
        use_visual_loss=False,
    )
    run = RunConfig(
        data_dirs=(args.data_dir,),
        logs_dir=args.logs, weights_dir=args.weights,
        infered_dir=args.infered,
        checkpoint_path=os.path.join(args.weights, "checkpoint.msgpack"),
        log_every=args.log_every, valid_every=args.valid_every,
        vis_every=max(args.log_every, 1) * 10, save_every=args.log_every,
        seed=args.manual_seed if args.manual_seed != -1 else 0,
        tasks=tuple(args.tasks),
    )
    trainer = Trainer(cfg, run, mesh=mesh)
    trainer.load_weights(g1=args.load_weights_g1, g2=args.load_weights_g2,
                         d1=args.load_weights_d1, d2=args.load_weights_d2)
    if "train" in args.tasks:
        trainer.train(args.epochs)
        trainer.close()
    if trainer.preempted:
        logger.warning("preempted: skipping remaining tasks")
        return
    if "infer" in args.tasks:
        trainer.infer()


if __name__ == "__main__":
    main(build_parser().parse_args())
