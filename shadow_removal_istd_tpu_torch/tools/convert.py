"""Carry weights between the JAX package's flax trees and the port.

The JAX package keeps a network's weights as the flax tree
``{"params": ..., "batch_stats": ...}``; here it arrives as nested dicts
of numpy arrays (``np.asarray`` of the JAX arrays, or an ``.npz`` read by
``serving/engine.py``). HWIO kernels become OIHW; BatchNorm
``scale``/``bias``/``mean``/``var`` go to ``weight``/``bias``/
``running_mean``/``running_var``. Flax numbers ``_Up_k`` in creation
order, so ``_Up_0`` is the innermost decoder level (``MNet.ups[0]``).
MNet, PatchGAN and the VGG-19-BN features are mapped;
:func:`torch_to_flax_tree` is the inverse.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from shadow_removal_istd_tpu_torch.models.mnet import MNet
from shadow_removal_istd_tpu_torch.models.patchgan import PatchGAN
from shadow_removal_istd_tpu_torch.models.vgg import VGG19Features

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


def _patchgan_targets(m: PatchGAN) -> dict[TreePath, torch.Tensor]:
    t: dict[TreePath, torch.Tensor] = {
        ("params", "Conv_0", "Conv_0", "kernel"): m.stem.weight,
        ("params", "Conv_0", "Conv_0", "bias"): m.stem.bias,
    }
    for k, (conv, norm) in enumerate(zip(m.convs, m.norms)):
        t[("params", f"ConvReflect_{k}", "Conv_0", "kernel")] = conv.weight
        scope = (f"ActNorm_{k}", "BatchNorm_0")
        t[("params", *scope, "scale")] = norm.bn.weight
        t[("params", *scope, "bias")] = norm.bn.bias
        t[("batch_stats", *scope, "mean")] = norm.bn.running_mean
        t[("batch_stats", *scope, "var")] = norm.bn.running_var
    t[("params", f"ConvReflect_{len(m.convs)}", "Conv_0", "kernel")] = \
        m.final.weight
    return t


def _vgg_targets(m: VGG19Features) -> dict[TreePath, torch.Tensor]:
    t: dict[TreePath, torch.Tensor] = {}
    for i, cb in enumerate(m.convbns()):
        t[("params", f"Conv_{i}", "kernel")] = cb.weight
        t[("params", f"Conv_{i}", "bias")] = cb.bias
        t[("params", f"BatchNorm_{i}", "scale")] = cb.bn_weight
        t[("params", f"BatchNorm_{i}", "bias")] = cb.bn_bias
        t[("batch_stats", f"BatchNorm_{i}", "mean")] = cb.running_mean
        t[("batch_stats", f"BatchNorm_{i}", "var")] = cb.running_var
    return t


_TARGETS = {MNet: _mnet_targets, PatchGAN: _patchgan_targets,
            VGG19Features: _vgg_targets}


def targets(module: nn.Module) -> dict[TreePath, torch.Tensor]:
    """Flax leaf path -> the module tensor it maps to."""
    fn = _TARGETS.get(type(module))
    if fn is None:
        raise NotImplementedError(
            f"weight conversion for {type(module).__name__} is not ported "
            "yet")
    return fn(module)


def torch_to_flax_tree(module: nn.Module) -> dict:
    """The module's weights as the flax ``{"params", "batch_stats"}``
    tree of f32 numpy leaves (OIHW kernels back to HWIO); the inverse
    of :func:`flax_tree_to_torch`."""
    flat = {}
    for path, src in targets(module).items():
        arr = src.detach().float().cpu().numpy()
        flat[path] = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr
    return unflatten_tree(flat)


def flax_tree_to_torch(tree: Mapping, module: nn.Module) -> nn.Module:
    """Load a JAX ``{"params", "batch_stats"}`` tree into ``module``.

    Raises on a missing or extra leaf and on any shape mismatch, before
    any value is written. Values are upcast to f32 (exact for bf16) and
    copied into the module's own dtype and device."""
    dsts = targets(module)
    leaves = flatten_tree(tree)
    missing = sorted(dsts.keys() - leaves.keys())
    extra = sorted(leaves.keys() - dsts.keys())
    if missing or extra:
        raise ValueError(f"tree does not match {type(module).__name__}: "
                         f"missing {missing}, extra {extra}")
    staged = []
    for path, dst in dsts.items():
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
