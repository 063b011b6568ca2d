"""Weights between the reference's torch models and the port's.

Port of ``shadow_removal_istd_tpu/tools/torch_bridge.py``. Users of the
reference implementation (nhchiu/Shadow-Removal-ISTD) keep one bare
``state_dict`` ``.pt`` file per network; :func:`load_torch_checkpoint`
loads such a file into a port model, and :func:`port_to_reference`
writes a port model's weights into a reference model, whose
``state_dict`` the reference's ``--load-weights-*`` path reads
unchanged (``tools/export_torch.py``).

The map is structural, as in the JAX package: both models run the same
graph, so their parameterized layers, listed in execution order, pair
one to one.

- Reference side (:func:`torch_layer_order`): forward hooks on its
  ``nn.Conv2d``, ``nn.ConvTranspose2d``, ``nn.BatchNorm2d`` and
  ``nn.Linear`` record each the first time it fires, in one eval
  forward.
- Port side (:func:`port_layer_order`): the layers' flax paths from
  ``tools/convert.py::targets`` in the JAX package's execution order,
  with no forward (an eval MNet runs its decoder from frozen phase
  kernels and calls no conv submodule, so hooks would miss it).

Layouts (port <- reference):

- a conv's weight is OIHW on both sides and is copied as it is;
- a transposed conv's is the trap: the reference's ``(Ci, Co, k, k)``
  kernel convolves, the port keeps flax's unflipped kernel as
  ``(Co, Ci, k, k)``, so port = ``ref.transpose(0, 1).flip(2, 3)``;
- a BatchNorm's ``weight``, ``bias``, ``running_mean`` and
  ``running_var`` are copied; the reference's ``num_batches_tracked``
  stays as it is;
- a Linear weight is copied as it is.

Both directions check the two kind sequences and every shape before
anything is written, and raise on a mismatch.
"""

from __future__ import annotations

import torch
from torch import nn

from shadow_removal_istd_tpu_torch.models import (
    BEGAN,
    DenseUNet,
    NLayerDiscriminator,
    Pix2PixUNet,
    UNet,
)
from shadow_removal_istd_tpu_torch.models import layers as L
from shadow_removal_istd_tpu_torch.tools.convert import TreePath, targets

__all__ = [
    "load_torch_checkpoint",
    "port_layer_order",
    "port_to_reference",
    "reference_to_port",
    "torch_layer_order",
]

_TORCH_KINDS = {nn.Conv2d: "conv", nn.ConvTranspose2d: "conv_t",
                nn.BatchNorm2d: "bn", nn.Linear: "dense"}


def torch_layer_order(torch_model: nn.Module, *nchw_args
                      ) -> tuple[list[nn.Module], list[str]]:
    """The reference model's leaf parameterized modules in execution
    order, and their kinds: one eval forward under ``no_grad`` on the
    NCHW example args, whose training mode is restored after."""
    records: list[nn.Module] = []
    seen: set[int] = set()

    def hook(mod, _inp, _out):
        if id(mod) not in seen:
            seen.add(id(mod))
            records.append(mod)

    handles = [m.register_forward_hook(hook) for m in torch_model.modules()
               if type(m) in _TORCH_KINDS]
    was_training = torch_model.training
    torch_model.eval()
    try:
        with torch.no_grad():
            torch_model(*nchw_args)
    finally:
        torch_model.train(was_training)
        for h in handles:
            h.remove()
    return records, [_TORCH_KINDS[type(m)] for m in records]


def _interleave(*seqs) -> list:
    return [m for group in zip(*seqs, strict=True) for m in group]


def _execution_order(m: nn.Module) -> list[nn.Module]:
    """``m``'s parts in the order its forward runs them, each a module
    whose own layers ``targets`` already lists in execution order.
    MNet, PatchGAN, the dummy D and VGG are one part."""
    if isinstance(m, UNet):
        return [*m.downs, m.bottleneck, *_interleave(m.ups, m.dec),
                m.final]
    if isinstance(m, DenseUNet):
        return [m.in_conv, *_interleave(m.enc, m.tdown), m.bottleneck,
                *_interleave(m.tup, m.dec), m.out_conv]
    if isinstance(m, Pix2PixUNet):
        # down the recursion (each level's conv, then its BN), then up
        # it innermost first (each level's transposed conv, then its BN)
        n = m.num_downs
        return [m.downs[0], *_interleave(m.downs[1:n - 1], m.down_bns),
                m.downs[n - 1],
                *_interleave(reversed(m.ups[1:]), reversed(m.up_bns)),
                m.ups[0]]
    if isinstance(m, NLayerDiscriminator):
        return [m.convs[0], *_interleave(m.convs[1:-1], m.bns), m.convs[-1]]
    if isinstance(m, BEGAN):
        return [m.stem, m.stem_norm, *_interleave(m.enc_convs, m.enc_norms),
                *m.mid, *_interleave(m.dec_convs, m.dec_norms), m.out]
    return [m]


def _kind(layer: TreePath) -> str:
    """A layer's kind from its flax module name."""
    name = layer[-1]
    if name.startswith("ConvTranspose_"):
        return "conv_t"
    if name.startswith("BatchNorm_"):
        return "bn"
    if name.startswith("Dense_"):
        return "dense"
    return "conv"


def port_layer_order(module: nn.Module) -> list[tuple[TreePath, str]]:
    """The port model's parameterized layers as ``(flax path, kind)`` in
    execution order (kinds ``conv``, ``conv_t``, ``bn``, ``dense``): the
    JAX package's ``flax_layer_order`` of the same network."""
    t = targets(module)
    order: list[TreePath] = []
    for part in _execution_order(module):
        own = {id(x) for x in (*part.parameters(), *part.buffers())}
        for path, tensor in t.items():
            if id(tensor) in own and path[1:-1] not in order:
                order.append(path[1:-1])
    if len(order) != len({path[1:-1] for path in t}):
        raise RuntimeError(f"{type(module).__name__}: the execution order "
                           "misses layers")
    return [(layer, _kind(layer)) for layer in order]


def _example_args(ref_model: nn.Module, nhwc_args) -> list[torch.Tensor]:
    """Zero NCHW tensors in the reference model's dtype, shaped as the
    NHWC example args (only their shapes matter)."""
    p = next(ref_model.parameters(), None)
    dtype = p.dtype if p is not None else torch.float32
    return [torch.zeros(tuple(a.shape), dtype=dtype).permute(0, 3, 1, 2)
            for a in nhwc_args]


def _pairs(ref_model: nn.Module, port_model: nn.Module, nhwc_args
           ) -> list[tuple[nn.Module, TreePath, str]]:
    """``(reference module, port layer path, kind)`` in execution order;
    raises where the kind sequences differ."""
    p_order = port_layer_order(port_model)
    mods, kinds = torch_layer_order(ref_model,
                                    *_example_args(ref_model, nhwc_args))
    p_kinds = [k for _, k in p_order]
    if p_kinds != kinds:
        raise ValueError("layer sequences differ:\n"
                         f"  port     : {p_kinds}\n  reference: {kinds}")
    return [(mod, path, kind) for mod, (path, kind) in zip(mods, p_order)]


def _leaves(mod: nn.Module, layer: TreePath, kind: str
            ) -> list[tuple[TreePath, torch.Tensor]]:
    """``(port leaf path, reference tensor)`` for one layer."""
    if kind == "bn":
        return [(("params", *layer, "scale"), mod.weight),
                (("params", *layer, "bias"), mod.bias),
                (("batch_stats", *layer, "mean"), mod.running_mean),
                (("batch_stats", *layer, "var"), mod.running_var)]
    out = [(("params", *layer, "kernel"), mod.weight)]
    if mod.bias is not None:
        out.append((("params", *layer, "bias"), mod.bias))
    return out


def _to_port(value: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "conv_t" and value.ndim == 4:
        return value.transpose(0, 1).flip(2, 3)
    return value


def _to_reference(value: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "conv_t" and value.ndim == 4:
        return value.flip(2, 3).transpose(0, 1)
    return value


def _staged(ref_model: nn.Module, port_model: nn.Module, nhwc_args
            ) -> list[tuple[torch.Tensor, torch.Tensor, str]]:
    """``(port tensor, reference tensor, kind)`` for every leaf, every
    layer's leaves and shapes checked first."""
    t = targets(port_model)
    staged = []
    for mod, layer, kind in _pairs(ref_model, port_model, nhwc_args):
        leaves = _leaves(mod, layer, kind)
        want = {p for p in t if p[1:-1] == layer}
        if {p for p, _ in leaves} != want:
            raise ValueError(
                f"{'/'.join(layer)}: the reference layer has "
                f"{sorted(p[-1] for p, _ in leaves)}, the port's "
                f"{sorted(p[-1] for p in want)}")
        for path, ref in leaves:
            dst = t[path]
            shape = tuple(_to_port(ref, kind).shape)
            if shape != tuple(dst.shape):
                raise ValueError(
                    f"shape mismatch at {'/'.join(path[1:])}: port "
                    f"{tuple(dst.shape)} vs reference-converted {shape}")
            staged.append((dst, ref, kind))
    return staged


def _drop_frozen(module: nn.Module) -> None:
    """Drop frozen eval decoder kernels (``Upsample.freeze``): they were
    built from the weights just replaced. The caller freezes again."""
    for m in module.modules():
        if isinstance(m, L.Upsample):
            m.frozen = None


def reference_to_port(ref_model: nn.Module, port_model: nn.Module,
                      *nhwc_args) -> nn.Module:
    """Copy the reference model's weights into ``port_model`` in place
    (its own device and dtype) and return it. ``nhwc_args`` are example
    inputs in NHWC for the reference's hook walk (their shapes are all
    that matters)."""
    staged = _staged(ref_model, port_model, nhwc_args)
    with torch.no_grad():
        for dst, ref, kind in staged:
            dst.copy_(_to_port(ref.detach(), kind))
    _drop_frozen(port_model)
    return port_model


def port_to_reference(port_model: nn.Module, ref_model: nn.Module,
                      *nhwc_args) -> nn.Module:
    """Copy ``port_model``'s weights into the reference model in place
    (its own device and dtype; ``num_batches_tracked`` untouched) and
    return it: the inverse of :func:`reference_to_port`."""
    staged = _staged(ref_model, port_model, nhwc_args)
    with torch.no_grad():
        for src, ref, kind in staged:
            ref.copy_(_to_reference(src.detach(), kind))
    return ref_model


def load_torch_checkpoint(path: str, ref_model: nn.Module,
                          port_model: nn.Module, *nhwc_args) -> nn.Module:
    """Load a reference-format ``state_dict`` file (bare, or wrapped as
    ``{"state_dict": ...}``) into ``port_model`` through ``ref_model``,
    a reference model built with the matching architecture arguments.
    Frozen eval kernels of ``port_model`` are dropped; freeze it again
    to serve it."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    ref_model.load_state_dict(state)
    return reference_to_port(ref_model, port_model, *nhwc_args)
