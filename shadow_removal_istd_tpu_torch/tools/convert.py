"""Carry weights between the JAX package's flax trees and the port.

The JAX package keeps a network's weights as the flax tree
``{"params": ..., "batch_stats": ...}``; here it arrives as nested dicts
of numpy arrays (``np.asarray`` of the JAX arrays, or an ``.npz`` read by
``serving/engine.py``). HWIO kernels become OIHW; BatchNorm
``scale``/``bias``/``mean``/``var`` go to ``weight``/``bias``/
``running_mean``/``running_var``. Flax numbers submodules per class in
creation order within each scope, so ``_Up_0`` is the innermost decoder
level (``MNet.ups[0]``), and pix2pix's recursion numbers its convs and
BatchNorms in call order in one scope. Every network of the zoo (MNet,
PatchGAN, UNet, DenseUNet, Pix2PixUNet, NLayerDiscriminator, BEGAN,
DummyNet) and the VGG-19-BN features are mapped; one without BatchNorm
(SELU, the dummy D) has an empty ``batch_stats``.
:func:`torch_to_flax_tree` is the inverse. Trees come out with their
keys sorted, as JAX's tree utilities leave them, so a tree encodes to the
bytes the JAX package writes for the same values.

:func:`train_state_to_flax` / :func:`load_train_state` carry the whole
train state: the JAX ``TrainState`` as flax serializes it,
``{"step", "g_params", "d_params", "batch_stats", "opt_g", "opt_d", "k1",
"k2", "softadapt"}``, with each optimizer as optax's Adam chain
``{"0": {"count", "mu", "nu"}, "1": {"count"}}`` (``"1": {}`` under the
plateau schedule, whose constant rate optax keeps no count for). Adam's
moments are
``torch.optim.Adam``'s ``exp_avg``/``exp_avg_sq``, found by parameter
identity through the same leaf map as the weights (so kernels go through
the same HWIO <-> OIHW transpose), and ``count`` is every parameter's
Adam ``step`` and ``TrainState.step``. BEGAN's ``k1``/``k2`` and the SoftAdapt
state (``{"weights", "prev_loss"}``, or None) cross as they are.

:func:`jax_int8_pack_to_torch` carries an int8 pack of the JAX package's
``models/quant.py`` into the port's ``models/quant.py`` layout.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import TYPE_CHECKING

import numpy as np
import torch
from torch import nn

from shadow_removal_istd_tpu_torch.losses.softadapt import SoftAdaptState
from shadow_removal_istd_tpu_torch.models import (
    BEGAN,
    DenseUNet,
    DummyNet,
    MNet,
    NLayerDiscriminator,
    PatchGAN,
    Pix2PixUNet,
    UNet,
)
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


Targets = dict[TreePath, torch.Tensor]


def _conv(t: Targets, path: TreePath, mod: nn.Module) -> None:
    """A flax (transposed-)conv's ``kernel``, and its ``bias`` if any."""
    t[("params", *path, "kernel")] = mod.weight
    if getattr(mod, "bias", None) is not None:
        t[("params", *path, "bias")] = mod.bias


def _bn(t: Targets, path: TreePath, mod: nn.Module) -> None:
    t[("params", *path, "scale")] = mod.weight
    t[("params", *path, "bias")] = mod.bias
    t[("batch_stats", *path, "mean")] = mod.running_mean
    t[("batch_stats", *path, "var")] = mod.running_var


def _actnorm(t: Targets, path: TreePath, mod: nn.Module) -> None:
    """ActNorm's BatchNorm; SELU leaves no leaves."""
    if mod.bn is not None:
        _bn(t, path + ("BatchNorm_0",), mod.bn)


def _up(t: Targets, path: TreePath, mod: nn.Module) -> None:
    """``layers.Upsample``'s conv at its flax path."""
    _conv(t, path + (("ConvReflect_0", "Conv_0") if mod.no_conv_t
                     else ("ConvTranspose_0",)), mod)


def _mnet_targets(m: MNet) -> Targets:
    """Flax leaf path -> the port tensor it fills."""
    t: Targets = {}
    _conv(t, ("ConvReflect_0", "Conv_0"), m.stem)
    for k, d in enumerate(m.downs):
        _conv(t, (f"_Down_{k}", "ConvReflect_0", "Conv_0"), d.conv)
        _bn(t, (f"_Down_{k}", "BatchNorm_0"), d.bn)
    for k, u in enumerate(m.ups):
        _up(t, (f"_Up_{k}", "Upsample_0"), u.up)
        _bn(t, (f"_Up_{k}", "BatchNorm_0"), u.bn)
    _up(t, ("Upsample_0",), m.final)
    return t


def _patchgan_targets(m: PatchGAN) -> Targets:
    t: Targets = {}
    _conv(t, ("Conv_0", "Conv_0"), m.stem)
    for k, (conv, norm) in enumerate(zip(m.convs, m.norms)):
        _conv(t, (f"ConvReflect_{k}", "Conv_0"), conv)
        _actnorm(t, (f"ActNorm_{k}",), norm)
    _conv(t, (f"ConvReflect_{len(m.convs)}", "Conv_0"), m.final)
    return t


def _unet_targets(m: UNet) -> Targets:
    """``_DoubleConv_j``: the encoder blocks, the bottleneck, then the
    decoder blocks innermost first; ``Upsample_0`` is the innermost."""
    t: Targets = {}
    blocks = [*m.downs, m.bottleneck, *m.dec]
    for j, b in enumerate(blocks):
        for k, (conv, norm) in enumerate(((b.conv0, b.norm0),
                                          (b.conv1, b.norm1))):
            _conv(t, (f"_DoubleConv_{j}", f"ConvReflect_{k}", "Conv_0"), conv)
            _actnorm(t, (f"_DoubleConv_{j}", f"ActNorm_{k}"), norm)
    for k, up in enumerate(m.ups):
        _up(t, (f"Upsample_{k}",), up)
    _conv(t, ("Conv_0",), m.final)
    return t


def _denseunet_targets(m: DenseUNet) -> Targets:
    t: Targets = {}
    _conv(t, ("Conv_0",), m.in_conv)
    _conv(t, ("Conv_1",), m.out_conv)
    for j, b in enumerate([*m.enc, m.bottleneck, *m.dec]):
        for k, (bn, conv) in enumerate(zip(b.bns, b.convs)):
            _bn(t, (f"_DenseBlock_{j}", f"BatchNorm_{k}"), bn)
            _conv(t, (f"_DenseBlock_{j}", f"ConvReflect_{k}", "Conv_0"),
                  conv)
    for k, d in enumerate(m.tdown):
        _bn(t, (f"_TransDown_{k}", "BatchNorm_0"), d.bn)
        _conv(t, (f"_TransDown_{k}", "Conv_0"), d.conv)
    for k, u in enumerate(m.tup):
        _conv(t, (f"_TransUp_{k}", *(("ConvReflect_0", "Conv_0")
                                     if u.no_conv_t
                                     else ("ConvTranspose_0",))), u.conv)
    return t


def _pix2pix_targets(m: Pix2PixUNet) -> Targets:
    """One flax scope numbered in creation order: the down convs
    outermost first (``Conv_k`` is level k), the down BNs (levels 1 ..
    n-2), then up the recursion innermost first: ``ConvTranspose_k`` is
    level n-1-k, each followed by its BN (levels n-1 .. 1)."""
    t: Targets = {}
    n = m.num_downs
    for lv, conv in enumerate(m.downs):
        _conv(t, (f"Conv_{lv}", "Conv_0"), conv)
    bns = [*m.down_bns, *reversed(m.up_bns)]
    for k, bn in enumerate(bns):
        _bn(t, (f"BatchNorm_{k}",), bn)
    for lv, up in enumerate(m.ups):
        _conv(t, (f"ConvTranspose_{n - 1 - lv}",), up)
    return t


def _nlayer_targets(m: NLayerDiscriminator) -> Targets:
    t: Targets = {}
    for k, conv in enumerate(m.convs):
        _conv(t, (f"Conv_{k}", "Conv_0"), conv)
    for k, bn in enumerate(m.bns):
        _bn(t, (f"BatchNorm_{k}",), bn)
    return t


def _began_targets(m: BEGAN) -> Targets:
    t: Targets = {}
    convs = [m.stem, *m.enc_convs, *m.mid, *m.dec_convs, m.out]
    for k, conv in enumerate(convs):
        _conv(t, (f"Conv_{k}", "Conv_0"), conv)
    for k, norm in enumerate([m.stem_norm, *m.enc_norms, *m.dec_norms]):
        _actnorm(t, (f"ActNorm_{k}",), norm)
    return t


def _dummy_targets(m: DummyNet) -> Targets:
    t: Targets = {}
    _conv(t, ("Conv_0",), m.conv)
    return t


def _vgg_targets(m: VGG19Features) -> Targets:
    t: Targets = {}
    for i, cb in enumerate(m.convbns()):
        t[("params", f"Conv_{i}", "kernel")] = cb.weight
        t[("params", f"Conv_{i}", "bias")] = cb.bias
        t[("params", f"BatchNorm_{i}", "scale")] = cb.bn_weight
        t[("params", f"BatchNorm_{i}", "bias")] = cb.bn_bias
        t[("batch_stats", f"BatchNorm_{i}", "mean")] = cb.running_mean
        t[("batch_stats", f"BatchNorm_{i}", "var")] = cb.running_var
    return t


_TARGETS = {MNet: _mnet_targets, PatchGAN: _patchgan_targets,
            UNet: _unet_targets, DenseUNet: _denseunet_targets,
            Pix2PixUNet: _pix2pix_targets,
            NLayerDiscriminator: _nlayer_targets, BEGAN: _began_targets,
            DummyNet: _dummy_targets, VGG19Features: _vgg_targets}


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
    # flax's order; a network without BatchNorm has empty batch_stats
    return {k: tree.get(k, {}) for k in ("params", "batch_stats")}


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


# ------------------------------------------------------------- int8 packs


def _int8_pack_shapes(module: MNet) -> dict[str, tuple[int, ...]]:
    """Every key of the JAX int8 pack of ``module`` with its JAX shape:
    ``{site}_w`` HWIO int8 (decoder sites: the (2, 2, Ci, 4Co) phase
    kernel), ``{site}_s`` (rows,), ``{site}_sx`` (), ``{site}_b`` (Co,)
    for the down and up sites."""
    sites = ([("stem", module.stem.weight, False, False)]
             + [(f"down{i}", d.conv.weight, False, True)
                for i, d in enumerate(module.downs)]
             + [(f"up{i}", u.up.weight, True, True)
                for i, u in enumerate(module.ups)]
             + [("final", module.final.weight, True, False)])
    shapes = {}
    for name, w, phase, has_bias in sites:
        co, ci = w.shape[:2]
        rows, k = (4 * co, 2) if phase else (co, 4)
        shapes[name + "_w"] = (k, k, ci, rows)
        shapes[name + "_s"] = (rows,)
        shapes[name + "_sx"] = ()
        if has_bias:
            shapes[name + "_b"] = (co,)
    return shapes


def jax_int8_pack_to_torch(pack: Mapping, module: MNet) -> dict:
    """The JAX package's int8 pack of an MNet (``models/quant.py::
    quantize_mnet``, numpy leaves) -> the port's pack for ``module``'s
    configuration, on its device: ``{site}_w`` HWIO -> ``(rows, kh, kw,
    Ci)`` int8, the scales and biases as f32 tensors. Raises on a missing
    or extra key, a shape mismatch or non-int8 weights, before anything
    is converted."""
    if not module.final.no_conv_t:
        raise ValueError("int8 packs exist for the nearest-upsample MNet "
                         "only")
    want = _int8_pack_shapes(module)
    missing = sorted(want.keys() - pack.keys())
    extra = sorted(pack.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"int8 pack does not match MNet: missing "
                         f"{missing}, extra {extra}")
    arrays = {k: np.asarray(pack[k]) for k in want}
    for key, shape in want.items():
        if arrays[key].shape != shape:
            raise ValueError(f"int8 pack {key}: shape "
                             f"{arrays[key].shape}, expected {shape}")
        if key.endswith("_w") and arrays[key].dtype != np.int8:
            raise ValueError(f"int8 pack {key}: dtype {arrays[key].dtype}")
    dev = module.stem.weight.device
    return {key: torch.from_numpy(np.ascontiguousarray(
                a.transpose(3, 0, 1, 2) if key.endswith("_w")
                else a.astype(np.float32))).to(dev)
            for key, a in arrays.items()}


# ----------------------------------------------------------- train state

_G, _D = ("g1", "g2"), ("d1", "d2")
_FIELDS = ("step", "g_params", "d_params", "batch_stats", "opt_g", "opt_d",
           "k1", "k2", "softadapt")


def _param_targets(module: nn.Module) -> dict[TreePath, torch.Tensor]:
    """Flax ``params`` path (without the ``params`` root) -> parameter."""
    return {path[1:]: t for path, t in targets(module).items()
            if path[0] == "params"}


def _adam_tree(opt: torch.optim.Optimizer, nets: dict[str, nn.Module],
               count: np.ndarray, scheduled: bool = True) -> dict:
    """optax's ``adam`` chain state: the moments of every parameter of
    ``nets`` (zeros before the first step, as optax initialises them),
    then the learning-rate stage, which counts steps only when the rate
    is ``scheduled`` (optax's empty state for a constant rate)."""
    moments = {}
    for which, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        moments[which] = {
            name: unflatten_tree({
                path: _to_flax(opt.state[p][key] if p in opt.state
                               else torch.zeros_like(p))
                for path, p in _param_targets(net).items()})
            for name, net in nets.items()}
    return {"0": {"count": count.copy(), **moments},
            "1": {"count": count.copy()} if scheduled else {}}


def train_state_to_flax(state: "TrainState") -> dict:
    """The port's train state as the JAX ``TrainState`` tree that
    ``flax.serialization`` writes (numpy leaves, keys in its order)."""
    nets = {k: getattr(state.models, k) for k in (*_G, *_D)}
    trees = {k: torch_to_flax_tree(m) for k, m in nets.items()}
    step = np.asarray(state.step, np.int32)
    scheduled = state.cfg.lr_schedule != "plateau"
    return {
        "step": step,
        "g_params": {k: trees[k]["params"] for k in _G},
        "d_params": {k: trees[k]["params"] for k in _D},
        "batch_stats": {k: trees[k]["batch_stats"] for k in sorted(trees)},
        "opt_g": _adam_tree(state.opt_g, {k: nets[k] for k in _G}, step,
                            scheduled),
        "opt_d": _adam_tree(state.opt_d, {k: nets[k] for k in _D}, step,
                            scheduled),
        "k1": _to_flax(state.k1),
        "k2": _to_flax(state.k2),
        # SoftAdaptState as flax writes a NamedTuple: a map of its fields
        "softadapt": (None if state.softadapt is None else
                      {k: _to_flax(v)
                       for k, v in state.softadapt._asdict().items()}),
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
    equal counts, a SoftAdapt state where the state has one) before
    anything is written."""
    tree = dict(tree)
    missing = [k for k in _FIELDS if k not in tree]
    if missing:
        current = train_state_to_flax(state)
        tree.update({k: current[k] for k in missing})
    ks = [_from_flax(tree[k], (k,), getattr(state, k)) for k in ("k1", "k2")]
    softadapt = None
    if tree["softadapt"] is not None:
        sa = tree["softadapt"]
        if set(sa) != set(SoftAdaptState._fields):
            raise ValueError(f"softadapt: expected the fields "
                             f"{SoftAdaptState._fields}, got {sorted(sa)}")
        like = state.softadapt or SoftAdaptState(
            torch.zeros(3, device=state.k1.device),
            torch.zeros(3, device=state.k1.device))
        softadapt = SoftAdaptState(**{
            f: _from_flax(sa[f], ("softadapt", f), getattr(like, f))
            for f in SoftAdaptState._fields})
    elif state.softadapt is not None:
        raise ValueError("the tree has no SoftAdapt state and the "
                         "configuration uses one")
    counts = {int(np.asarray(c)) for c in (
        tree["step"], *(tree[o][i]["count"] for o in ("opt_g", "opt_d")
                        for i in ("0", "1") if "count" in tree[o][i]))}
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
    state.k1, state.k2 = ks
    if softadapt is not None:
        state.softadapt = softadapt
