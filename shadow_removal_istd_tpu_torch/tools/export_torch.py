"""Export a trained checkpoint as reference-format torch ``.pt`` files.

Port of ``shadow_removal_istd_tpu/tools/export_torch.py``, the inverse
of loading a reference ``.pt`` file (``tools/torch_bridge.py``): the
four networks of a checkpoint become
``{G1,G2,D1,D2}_{ClassName}_{suffix}.pt`` bare ``state_dict`` files,
named and laid out as the reference saves them (its src/cgan.py), which
its ``--load-weights-*`` path loads unchanged.

The reference's model classes define the ``state_dict``, so the
reference must be importable: ``--reference-path`` names its repository
root, the directory holding ``src/``. The checkpoint is the JAX
package's or the port's flax msgpack file, read by the port's own
reader. ``--device`` is where the port's models are built: ``cuda``
(the default, which raises without a card) or ``cpu``.

    python -m shadow_removal_istd_tpu_torch.tools.export_torch \\
        --load-checkpoint w/checkpoint.msgpack --out-dir torch_w \\
        --reference-path /path/to/Shadow-Removal-ISTD [--suffix best] \\
        [--net-G mnet --net-D patchgan --ngf 64 --ndf 64 ...] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import types

import torch

from shadow_removal_istd_tpu_torch import resolve_device
from shadow_removal_istd_tpu_torch.tools.torch_bridge import (
    port_to_reference,
)

TRACE_SIZE = 64     # the hook walk's input side; the nets are convolutional


def _import_reference(reference_path: str):
    """The reference's ``src.networks`` module, imported from
    ``reference_path``. ``src.loss`` imports ``torchvision``, which the
    networks do not need: empty stand-in modules take its place where it
    is not installed."""
    sys.path.insert(0, reference_path)
    for name in ("torchvision", "torchvision.models",
                 "torchvision.transforms"):
        sys.modules.setdefault(name, types.ModuleType(name))
    sys.modules["torchvision"].models = sys.modules["torchvision.models"]
    sys.modules["torchvision"].transforms = (
        sys.modules["torchvision.transforms"])
    from src import networks as rn
    return rn


def reference_nets(rn, cfg) -> dict[str, tuple[torch.nn.Module, int]]:
    """The four reference networks of ``cfg``'s configuration, built by
    the reference's factories as its training builds them, each with its
    input channels."""
    g_kw = dict(ngf=cfg.ngf, drop_rate=0.0, no_conv_t=cfg.nn_upconv,
                use_selu=cfg.use_selu, activation=cfg.activation)
    d_kw = dict(ndf=cfg.ndf, use_selu=cfg.use_selu, use_sigmoid=False)
    return {
        "G1": (rn.get_generator(cfg.net_g, in_channels=3, out_channels=1,
                                **g_kw), 3),
        "G2": (rn.get_generator(cfg.net_g, in_channels=4, out_channels=3,
                                **g_kw), 4),
        "D1": (rn.get_discriminator(cfg.net_d, in_channels=4,
                                    out_channels=1, **d_kw), 4),
        "D2": (rn.get_discriminator(cfg.net_d, in_channels=7,
                                    out_channels=3, **d_kw), 7),
    }


def export_reference_weights(state, cfg, out_dir: str, reference_path: str,
                             suffix: str = "latest") -> list[str]:
    """Write the four reference-format ``.pt`` files of ``state``'s
    networks (``state.models``: the train state's, or any object holding
    ``g1``, ``g2``, ``d1``, ``d2``) to ``out_dir``; returns their
    paths. The reference nets live on the CPU, so the files hold CPU
    tensors."""
    rn = _import_reference(reference_path)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name, (ref, in_ch) in reference_nets(rn, cfg).items():
        port = getattr(state.models, name.lower())
        port_to_reference(port, ref,
                          torch.empty(1, TRACE_SIZE, TRACE_SIZE, in_ch))
        path = os.path.join(out_dir,
                            f"{name}_{type(ref).__name__}_{suffix}.pt")
        torch.save(ref.state_dict(), path)
        written.append(path)
    return written


def main(argv=None) -> list[str]:
    from shadow_removal_istd_tpu_torch.engine.checkpoint import (
        load_checkpoint,
    )
    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
    from shadow_removal_istd_tpu_torch.engine.state import init_state

    parser = argparse.ArgumentParser(
        description="export a trained checkpoint as reference-format "
                    "torch .pt weight files")
    parser.add_argument("--load-checkpoint", required=True)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--reference-path", required=True,
                        help="path to the reference repo root "
                             "(contains src/)")
    parser.add_argument("--suffix", default="latest")
    parser.add_argument("--net-G", default="mnet")
    parser.add_argument("--net-D", default="patchgan")
    parser.add_argument("--ngf", type=int, default=64)
    parser.add_argument("--ndf", type=int, default=64)
    parser.add_argument("--NN-upconv", action="store_true")
    parser.add_argument("--SELU", action="store_true")
    parser.add_argument("--activation", default="tanh")
    parser.add_argument("--device", default="cuda",
                        help="torch device the port's models are built "
                             "on: cuda (default) or cpu")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = TrainConfig(net_g=args.net_G, net_d=args.net_D, ngf=args.ngf,
                      ndf=args.ndf, nn_upconv=args.NN_upconv,
                      use_selu=args.SELU, activation=args.activation,
                      use_visual_loss=False, droprate=0.0)
    state = init_state(cfg, torch.Generator().manual_seed(0), device=dev)
    load_checkpoint(state, args.load_checkpoint)
    written = export_reference_weights(state, cfg, args.out_dir,
                                       args.reference_path, args.suffix)
    for p in written:
        print(f"wrote {p}")
    return written


if __name__ == "__main__":
    main()
