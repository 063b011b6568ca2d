"""Serving export: the stacked G1 -> G2 inference graph as a
``torch.export`` artifact.

Port of ``shadow_removal_istd_tpu/tools/export.py``. The JAX package
writes a serialized StableHLO program (``jax.export``) with the trained
parameters baked in; here the same graph is a ``torch.export`` program,
written by ``torch.export.save`` (one zip file: the graph, its input
signature and the weights). Its interface is the JAX artifact's: an
(N, H, W, 3) NHWC image in [-1, 1] in, ``(matte (N, H, W, 1),
shadow_free (N, H, W, 3))`` NHWC out, the permutes inside the graph.

Every decoder step in the graph is the registered op
``srit::decoder_upsample`` (``ops/decoder.py``), not its plain
decomposition, so an artifact served on the card runs the hand-written
decoder kernels. Loading one therefore needs ``torch`` and
``shadow_removal_istd_tpu_torch.ops.decoder`` (which registers the op)
on the serving host, but none of the port's model classes: the
counterpart of the JAX artifact's "needs jax, not this package's model
code". :func:`load_exported` imports only those two.

Typical flow::

    # after training
    export_stacked_inference("model.pt2", trainer.state,
                             trainer.state.models, image_shape=(480, 640))
    # on the serving host
    run = load_exported("model.pt2")
    matte, shadow_free = run(batch_nhwc_in_minus1_1)

Standalone (a checkpoint, e.g. a JAX-written ``checkpoint.msgpack``, to
an artifact)::

    python -m shadow_removal_istd_tpu_torch.tools.export \\
        --load-checkpoint w/checkpoint.msgpack --out model.pt2 \\
        [--shape 480 640] [--batch N] [--ngf 64] [--net-G mnet] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import copy
import logging
import os

import torch
from torch import nn

from shadow_removal_istd_tpu_torch import resolve_device
# registers srit::decoder_upsample, which every artifact's graph calls
from shadow_removal_istd_tpu_torch.ops import decoder as _decoder  # noqa: F401

logger = logging.getLogger(__name__)


class _Stacked(nn.Module):
    """NHWC x in [-1, 1] -> NHWC (matte, shadow_free), eval mode."""

    def __init__(self, g1: nn.Module, g2: nn.Module):
        from shadow_removal_istd_tpu_torch.engine.steps import infer_step

        super().__init__()
        self.g1, self.g2 = g1, g2
        self._infer = infer_step

    def forward(self, x: torch.Tensor):
        m, y = self._infer(self.g1, self.g2, x.permute(0, 3, 1, 2))
        return m.permute(0, 2, 3, 1), y.permute(0, 2, 3, 1)


def _frozen_copy(g: nn.Module) -> nn.Module:
    """An eval copy of ``g`` with its decoder kernels fixed (MNet), so
    the caller's module is left as it was."""
    g = copy.deepcopy(g).eval().requires_grad_(False)
    if hasattr(g, "freeze"):
        g.freeze()
    return g


def _export(path: str, models, image_shape, batch_size, dtype) -> int:
    g1 = _frozen_copy(models.g1)
    g2 = _frozen_copy(models.g2)
    dev = next(g1.parameters()).device
    h, w = image_shape
    # an example batch of 2 keeps a symbolic batch from specialising to 1
    b = 2 if batch_size is None else int(batch_size)
    x = torch.zeros((b, h, w, 3), dtype=dtype, device=dev)
    dynamic = ({"x": {0: torch.export.Dim("batch", min=1)}}
               if batch_size is None else None)
    ep = torch.export.export(_Stacked(g1, g2), (x,), dynamic_shapes=dynamic)
    # atomic publish: a crash mid-write must not leave a truncated
    # artifact at the serving path
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.export.save(ep, f)
    os.replace(tmp, path)
    return os.path.getsize(path)


def export_stacked_inference(path: str, state, models,
                             image_shape: tuple[int, int] = (480, 640),
                             batch_size: int | None = None,
                             dtype: torch.dtype = torch.float32,
                             platforms: tuple[str, ...] = ("cuda",)) -> int:
    """Write the stacked G1 -> G2 eval graph, weights inside, to
    ``path`` (through ``path + ".tmp"`` and a rename). Returns the bytes
    written (0 on a rank other than 0).

    ``models``: holds the generators as ``.g1``/``.g2`` (the train
    state's ``Models``, or an ``InferenceEngine``); they are copied, so
    they stay as they were. ``state``: the ``TrainState`` they belong to
    or None; over its mesh (``state.mesh``) every rank gathers a
    model-split state to full and rank 0 alone exports, as the
    checkpoint files are written. The graph is traced on the
    generators' device in eval mode; ``dtype`` is the input's. An int
    ``batch_size`` pins the batch; None makes it symbolic (any batch
    from 1). ``platforms`` is the JAX signature's: a ``torch.export``
    program is not lowered per platform (``load_exported`` places it),
    so any other value than the default only warns."""
    if tuple(platforms) != ("cuda",):
        logger.warning("platforms=%s has no meaning for a torch.export "
                       "artifact: it runs where load_exported places it",
                       tuple(platforms))
    mesh = getattr(state, "mesh", None)
    if mesh is None or mesh.world == 1:
        return _export(path, models, image_shape, batch_size, dtype)
    from shadow_removal_istd_tpu_torch.parallel.mesh import (
        barrier,
        shard_state,
        unshard_state,
    )

    split = any(getattr(m, "tp_shards", 1) > 1
                for net in state.models.all() for m in net.modules())
    unshard_state(mesh, state)
    try:
        nbytes = (_export(path, models, image_shape, batch_size, dtype)
                  if mesh.rank == 0 else 0)
    finally:
        if split:
            shard_state(mesh, state)
        barrier(mesh)
    return nbytes


def load_program(path: str, device: str | torch.device = "cuda"
                 ) -> torch.export.ExportedProgram:
    """The artifact's ``ExportedProgram`` on ``device`` (its weights
    moved there by ``move_to_device_pass`` when it was saved on
    another). Raises without a card unless ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ep = torch.export.load(path)
    here = {t.device for t in (*ep.state_dict.values(),
                               *ep.constants.values())
            if isinstance(t, torch.Tensor)}
    if here != {dev} and here:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, dev)
    return ep


def input_signature(ep: torch.export.ExportedProgram
                    ) -> tuple[tuple, torch.dtype]:
    """The artifact's input shape ``(b, h, w, 3)`` (``b`` an int when the
    batch is pinned, else a symbol) and dtype."""
    (name,) = ep.graph_signature.user_inputs
    node = next(n for n in ep.graph.nodes if n.name == name)
    val = node.meta["val"]
    return tuple(val.shape), val.dtype


def load_exported(path: str, device: str | torch.device = "cuda"):
    """Load an artifact -> ``run(x) -> (matte, shadow_free)``, ``x`` an
    (N, H, W, 3) tensor in [-1, 1] of the exported dtype on ``device``.
    Needs ``torch`` and the op library only (see the module's doc)."""
    fn = load_program(path, device).module()

    def run(x: torch.Tensor):
        with torch.inference_mode():
            return fn(x)

    return run


def main(argv=None) -> None:
    """Standalone export CLI: checkpoint -> serving artifact. Only the
    generators are read from the checkpoint (the JAX package's or the
    port's flax msgpack file), through the port's own codec."""
    import argparse

    from shadow_removal_istd_tpu_torch.engine.checkpoint import _read
    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
    from shadow_removal_istd_tpu_torch.engine.state import build_models
    from shadow_removal_istd_tpu_torch.tools.convert import (
        flax_tree_to_torch,
    )

    parser = argparse.ArgumentParser(
        description="serialize a trained checkpoint as a torch.export "
                    "serving artifact (the decoder steps as the op "
                    "srit::decoder_upsample)")
    parser.add_argument("--load-checkpoint", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--shape", type=int, nargs=2, default=[480, 640],
                        metavar=("H", "W"))
    parser.add_argument("--batch", type=int, default=None,
                        help="pin the batch (default: symbolic, any "
                             "batch at serving time)")
    parser.add_argument("--net-G", default="mnet")
    parser.add_argument("--ngf", type=int, default=64)
    parser.add_argument("--NN-upconv", action="store_true")
    parser.add_argument("--activation", default="tanh")
    parser.add_argument("--platforms", nargs="+", default=None,
                        help="accepted for the JAX tool's flags; a "
                             "torch.export artifact is not lowered per "
                             "platform (warns)")
    parser.add_argument("--device", default="cuda",
                        help="torch device the graph is traced on: cuda "
                             "(default) or cpu")
    args = parser.parse_args(argv)
    if args.platforms is not None:
        logger.warning("--platforms %s has no meaning for a torch.export "
                       "artifact; ignored", " ".join(args.platforms))

    dev = resolve_device(args.device)
    cfg = TrainConfig(net_g=args.net_G, ngf=args.ngf,
                      nn_upconv=args.NN_upconv, activation=args.activation,
                      use_visual_loss=False, droprate=0.0)
    models = build_models(cfg)
    state = _read(args.load_checkpoint)["state"]
    for k in ("g1", "g2"):
        flax_tree_to_torch(
            {"params": state["g_params"][k],
             "batch_stats": state.get("batch_stats", {}).get(k, {})},
            getattr(models, k)).to(dev)
    nbytes = export_stacked_inference(
        args.out, None, models, image_shape=tuple(args.shape),
        batch_size=args.batch)
    print(f"wrote {args.out} ({nbytes / 1e6:.1f} MB, torch.export, "
          f"device={dev})")


if __name__ == "__main__":
    main()
