"""Carry weights between the JAX package's flax trees and the port.

The JAX package keeps a network's weights as the flax tree
``{"params": ..., "batch_stats": ...}``; here it arrives as nested dicts
of numpy arrays (``np.asarray`` of the JAX arrays, or an ``.npz`` read by
``serving/engine.py``). HWIO kernels become OIHW; BatchNorm
``scale``/``bias``/``mean``/``var`` go to ``weight``/``bias``/
``running_mean``/``running_var``. Flax numbers ``_Up_k`` in creation
order, so ``_Up_0`` is the innermost decoder level (``MNet.ups[0]``).
MNet, PatchGAN and the VGG-19-BN features are mapped;
:func:`torch_to_flax_tree` is the inverse. Trees come out with their
keys sorted, as JAX's tree utilities leave them, so a tree encodes to the
bytes the JAX package writes for the same values.

:func:`train_state_to_flax` / :func:`load_train_state` carry the whole
train state: the JAX ``TrainState`` as flax serializes it,
``{"step", "g_params", "d_params", "batch_stats", "opt_g", "opt_d", "k1",
"k2", "softadapt"}``, with each optimizer as optax's Adam chain
``{"0": {"count", "mu", "nu"}, "1": {"count"}}``. Adam's moments are
``torch.optim.Adam``'s ``exp_avg``/``exp_avg_sq``, found by parameter
identity through the same leaf map as the weights (so kernels go through
the same HWIO <-> OIHW transpose), and ``count`` is every parameter's
Adam ``step`` and ``TrainState.step``.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import TYPE_CHECKING

import numpy as np
import torch
from torch import nn

from shadow_removal_istd_tpu_torch.models.mnet import MNet
from shadow_removal_istd_tpu_torch.models.patchgan import PatchGAN
from shadow_removal_istd_tpu_torch.models.vgg import VGG19Features

if TYPE_CHECKING:
    from shadow_removal_istd_tpu_torch.engine.state import TrainState

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
    """``{path tuple: leaf}`` -> nested dicts, keys sorted."""
    tree: dict = {}
    for path, leaf in sorted(flat.items()):
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


def _to_flax(t: torch.Tensor) -> np.ndarray:
    """An f32 numpy copy (never a view of a live CPU tensor) in flax's
    layout. The OIHW -> HWIO transpose runs where the tensor lives, then
    one copy moves it to the host: numpy's strided copy of such a
    transpose moves ~0.1 GB/s."""
    t = t.detach().float()
    if t.ndim == 4:
        t = t.permute(2, 3, 1, 0)
    return t.contiguous().to("cpu", copy=True).numpy()


def _from_flax(leaf, path: TreePath, like: torch.Tensor) -> torch.Tensor:
    """One flax leaf as a contiguous f32 tensor in the port's layout on
    ``like``'s device (the HWIO -> OIHW transpose runs there); raises on
    a shape mismatch. Values are upcast to f32 (exact for bf16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.float()
    else:
        t = torch.from_numpy(np.array(leaf, np.float32))
    perm = (3, 2, 0, 1) if t.ndim == 4 else tuple(range(t.ndim))
    shape = tuple(t.shape[i] for i in perm)
    if shape != tuple(like.shape):
        raise ValueError(f"{'/'.join(path)}: shape {shape} does not match "
                         f"{tuple(like.shape)}")
    return t.to(like.device).permute(perm).contiguous()


def _match(tree: Mapping, dsts: Mapping[TreePath, torch.Tensor],
           what: str) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``(destination, value)`` for every leaf of ``tree``; raises on a
    missing or extra leaf or a shape mismatch, before anything is
    written."""
    leaves = flatten_tree(tree)
    missing = sorted(dsts.keys() - leaves.keys())
    extra = sorted(leaves.keys() - dsts.keys())
    if missing or extra:
        raise ValueError(f"tree does not match {what}: missing {missing}, "
                         f"extra {extra}")
    return [(dst, _from_flax(leaves[path], path, dst))
            for path, dst in dsts.items()]


def torch_to_flax_tree(module: nn.Module) -> dict:
    """The module's weights as the flax ``{"params", "batch_stats"}``
    tree of f32 numpy leaves (OIHW kernels back to HWIO); the inverse
    of :func:`flax_tree_to_torch`."""
    tree = unflatten_tree({path: _to_flax(src)
                           for path, src in targets(module).items()})
    return {k: tree[k] for k in ("params", "batch_stats")}  # flax's order


def flax_tree_to_torch(tree: Mapping, module: nn.Module) -> nn.Module:
    """Load a JAX ``{"params", "batch_stats"}`` tree into ``module``.

    Raises on a missing or extra leaf and on any shape mismatch, before
    any value is written. Values are upcast to f32 (exact for bf16) and
    copied into the module's own dtype and device."""
    staged = _match(tree, targets(module), type(module).__name__)
    with torch.no_grad():
        for dst, src in staged:
            dst.copy_(src)
    return module


# ----------------------------------------------------------- train state

_G, _D = ("g1", "g2"), ("d1", "d2")
_FIELDS = ("step", "g_params", "d_params", "batch_stats", "opt_g", "opt_d",
           "k1", "k2", "softadapt")
_UNPORTED = ("BEGAN's k1/k2 and SoftAdapt are not ported yet: a checkpoint "
             "with nonzero k1/k2 or a softadapt state cannot be loaded")


def _param_targets(module: nn.Module) -> dict[TreePath, torch.Tensor]:
    """Flax ``params`` path (without the ``params`` root) -> parameter."""
    return {path[1:]: t for path, t in targets(module).items()
            if path[0] == "params"}


def _adam_tree(opt: torch.optim.Optimizer, nets: dict[str, nn.Module],
               count: np.ndarray) -> dict:
    """optax's ``adam`` chain state: the moments of every parameter of
    ``nets`` (zeros before the first step, as optax initialises them)."""
    moments = {}
    for which, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        moments[which] = {
            name: unflatten_tree({
                path: _to_flax(opt.state[p][key] if p in opt.state
                               else torch.zeros_like(p))
                for path, p in _param_targets(net).items()})
            for name, net in nets.items()}
    return {"0": {"count": count.copy(), **moments},
            "1": {"count": count.copy()}}


def train_state_to_flax(state: "TrainState") -> dict:
    """The port's train state as the JAX ``TrainState`` tree that
    ``flax.serialization`` writes (numpy leaves, keys in its order)."""
    nets = {k: getattr(state.models, k) for k in (*_G, *_D)}
    trees = {k: torch_to_flax_tree(m) for k, m in nets.items()}
    step = np.asarray(state.step, np.int32)
    return {
        "step": step,
        "g_params": {k: trees[k]["params"] for k in _G},
        "d_params": {k: trees[k]["params"] for k in _D},
        "batch_stats": {k: trees[k]["batch_stats"] for k in sorted(trees)},
        "opt_g": _adam_tree(state.opt_g, {k: nets[k] for k in _G}, step),
        "opt_d": _adam_tree(state.opt_d, {k: nets[k] for k in _D}, step),
        "k1": np.zeros((), np.float32),
        "k2": np.zeros((), np.float32),
        "softadapt": None,
    }


def _adam_state_dict(opt: torch.optim.Optimizer, staged: dict,
                     count: int) -> dict:
    """``opt.state_dict()`` with each parameter's state replaced by the
    staged moments, keyed by the parameter's index in ``opt`` (found by
    identity). ``step`` is an f32 CPU scalar tensor, what
    ``torch.optim.Adam`` creates without ``capturable``/``fused``;
    the moments are already on the parameter's device. Count 0 leaves
    the state empty, as a fresh optimizer's."""
    index = {id(p): i for i, p in enumerate(
        p for g in opt.param_groups for p in g["params"])}
    sd = opt.state_dict()
    sd["state"] = {} if count == 0 else {
        index[id(p)]: {"step": torch.tensor(float(count),
                                            dtype=torch.float32),
                       "exp_avg": mu, "exp_avg_sq": nu}
        for p, (mu, nu) in staged.items()}
    return sd


def load_train_state(tree: Mapping, state: "TrainState") -> None:
    """Load a JAX ``TrainState`` tree (:func:`train_state_to_flax`'s
    form) into ``state`` in place.

    Fields the tree lacks keep their current values (the JAX package's
    forward-compatibility rule). Everything is checked (leaves, shapes,
    equal counts, zero k1/k2, no SoftAdapt) before anything is
    written."""
    tree = dict(tree)
    missing = [k for k in _FIELDS if k not in tree]
    if missing:
        current = train_state_to_flax(state)
        tree.update({k: current[k] for k in missing})
    if (any(np.any(np.asarray(tree[k]) != 0) for k in ("k1", "k2"))
            or tree["softadapt"] is not None):
        raise NotImplementedError(_UNPORTED)
    counts = {int(np.asarray(c)) for c in (
        tree["step"], *(tree[o][i]["count"] for o in ("opt_g", "opt_d")
                        for i in ("0", "1")))}
    if len(counts) != 1:
        raise ValueError(f"step and optimizer counts differ: {counts}")
    (count,) = counts
    copies, adam = [], []
    for opt_key, group, names, opt in (
            ("opt_g", "g_params", _G, state.opt_g),
            ("opt_d", "d_params", _D, state.opt_d)):
        staged: dict = {}
        for k in names:
            net = getattr(state.models, k)
            copies += _match({"params": tree[group][k],
                              "batch_stats": tree["batch_stats"][k]},
                             targets(net), k)
            dsts = _param_targets(net)
            mus = dict(_match(tree[opt_key]["0"]["mu"][k], dsts, f"{k} mu"))
            nus = dict(_match(tree[opt_key]["0"]["nu"][k], dsts, f"{k} nu"))
            staged.update({p: (mus[p], nus[p]) for p in dsts.values()})
        adam.append((opt, _adam_state_dict(opt, staged, count)))
    with torch.no_grad():
        for dst, src in copies:
            dst.copy_(src)
    for opt, sd in adam:
        opt.load_state_dict(sd)
    state.step = count
