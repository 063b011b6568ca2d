"""Carry JAX package weights into the port's modules.

The JAX package keeps a generator's weights as the flax tree
``{"params": ..., "batch_stats": ...}``; here it arrives as nested dicts
of numpy arrays (``np.asarray`` of the JAX arrays, or an ``.npz`` read by
``serving/engine.py``). HWIO kernels become OIHW; BatchNorm
``scale``/``bias``/``mean``/``var`` go to ``weight``/``bias``/
``running_mean``/``running_var``. Flax numbers ``_Up_k`` in creation
order, so ``_Up_0`` is the innermost decoder level (``MNet.ups[0]``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from shadow_removal_istd_tpu_torch.models.mnet import MNet

TreePath = tuple[str, ...]


def flatten_tree(tree: Mapping,
                 prefix: TreePath = ()) -> dict[TreePath, object]:
    """Nested mapping -> ``{path tuple: leaf}``."""
    out: dict[TreePath, object] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def unflatten_tree(flat: Mapping[TreePath, object]) -> dict:
    """``{path tuple: leaf}`` -> nested dicts."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _mnet_targets(m: MNet) -> dict[TreePath, torch.Tensor]:
    """Flax leaf path -> the port tensor it fills."""
    t: dict[TreePath, torch.Tensor] = {}

    def conv(path: TreePath, mod: nn.Module) -> None:
        t[("params", *path, "kernel")] = mod.weight

    def bn(scope: str, mod: nn.Module) -> None:
        t[("params", scope, "BatchNorm_0", "scale")] = mod.weight
        t[("params", scope, "BatchNorm_0", "bias")] = mod.bias
        t[("batch_stats", scope, "BatchNorm_0", "mean")] = mod.running_mean
        t[("batch_stats", scope, "BatchNorm_0", "var")] = mod.running_var

    def up(path: TreePath, mod: nn.Module) -> None:
        conv(path + (("ConvReflect_0", "Conv_0") if mod.no_conv_t
                     else ("ConvTranspose_0",)), mod)

    conv(("ConvReflect_0", "Conv_0"), m.stem)
    for k, d in enumerate(m.downs):
        conv((f"_Down_{k}", "ConvReflect_0", "Conv_0"), d.conv)
        bn(f"_Down_{k}", d.bn)
    for k, u in enumerate(m.ups):
        up((f"_Up_{k}", "Upsample_0"), u.up)
        bn(f"_Up_{k}", u.bn)
    up(("Upsample_0",), m.final)
    return t


def flax_tree_to_torch(tree: Mapping, module: nn.Module) -> nn.Module:
    """Load a JAX ``{"params", "batch_stats"}`` tree into ``module``.

    Raises on a missing or extra leaf and on any shape mismatch, before
    any value is written. Values are upcast to f32 (exact for bf16) and
    copied into the module's own dtype and device."""
    if not isinstance(module, MNet):
        raise NotImplementedError(
            f"weight conversion for {type(module).__name__} is not ported "
            "yet")
    targets = _mnet_targets(module)
    leaves = flatten_tree(tree)
    missing = sorted(targets.keys() - leaves.keys())
    extra = sorted(leaves.keys() - targets.keys())
    if missing or extra:
        raise ValueError(f"tree does not match {type(module).__name__}: "
                         f"missing {missing}, extra {extra}")
    staged = []
    for path, dst in targets.items():
        arr = np.asarray(leaves[path]).astype(np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)                    # HWIO -> OIHW
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} does not "
                             f"match {tuple(dst.shape)}")
        staged.append((dst, torch.from_numpy(np.ascontiguousarray(arr))))
    with torch.no_grad():
        for dst, src in staged:
            dst.copy_(src)
    return module
