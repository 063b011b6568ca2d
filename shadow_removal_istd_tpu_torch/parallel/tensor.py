"""Tensor parallelism: column-parallel layers over the model axis.

Port of the model axis of ``shadow_removal_istd_tpu/parallel/mesh.py``
(``make_mesh_tp``, ``model_sharding``). JAX places each state leaf by
``model_sharding`` and XLA's partitioner writes the channel collectives;
here ``parallel.mesh.shard_state`` leaves each rank's modules holding
their out-channel shard (``tp_shards``/``tp_index`` on the module), so
``make_optimizers`` builds Adam moments of the shards, and every split
layer computes as one column-parallel block, full channels in and full
channels out:

- a convolution (``Conv``, ``ConvReflect``, ``ConvTranspose``,
  ``Upsample`` and its decoder kernel) takes the full input through
  :func:`copy_to_model` (the identity, whose backward sums the input
  gradient over the model ranks: each rank's output channels give only
  their part of it), computes its own output channels and all-gathers
  them (:func:`gather_channels`, whose backward keeps this rank's slice
  of the gradient, which every rank holds whole);
- BatchNorm keeps its channels of the full input (through
  :func:`copy_to_model` too: its input gradient holds only this rank's
  channels), normalizes them (in train mode with ``[sum x, sum x^2]``
  all-reduced over the data axis alone: channels are local) and
  all-gathers them.

A replicated layer (a 1- or 3-channel head) computes the same output
from the same input on every model rank, so its gradient is already
whole there and must not be summed; ``engine/steps.py`` broadcasts it
from the first model rank (:func:`sync_replicated_grads`) so that the
copies stay equal bit for bit whatever the device's summation order.
Activations run on full tensors between blocks, replicated, so
``Dropout2d`` draws one device's mask over every channel. The
collectives run inside :func:`tensor_parallel`; a split layer outside
it raises.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

import torch
import torch.distributed as dist
from torch import nn

from shadow_removal_istd_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    all_gather,
)

_active: Mesh | None = None


@contextlib.contextmanager
def tensor_parallel(mesh: Mesh | None) -> Iterator[None]:
    """Let the split layers run their collectives over ``mesh``'s model
    axis (nothing for a mesh without one). Process-wide, as
    ``data_parallel``: autograd runs replays on its device thread."""
    global _active
    prev = _active
    _active = mesh if mesh is not None and mesh.n_model > 1 else None
    try:
        yield
    finally:
        _active = prev


def is_split(module: nn.Module) -> bool:
    """Whether ``module`` holds an out-channel shard."""
    return getattr(module, "tp_shards", 1) > 1


def _mesh(module: nn.Module) -> Mesh:
    if _active is None or _active.n_model != module.tp_shards:
        raise RuntimeError(
            f"{type(module).__name__} holds 1/{module.tp_shards} of its "
            "channels: run it inside parallel.tensor.tensor_parallel "
            "(or gather its weights first)")
    return _active


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward all-reduces the gradient over the model
    group (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """All-gather along channels over the model group; the backward
    keeps this rank's slice (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.index, ctx.c = mesh.coord(MODEL_AXIS), x.shape[1]
        parts = all_gather(x, mesh, MODEL_AXIS)
        out = torch.cat(parts, dim=1)
        if x.dim() == 4 and x.is_contiguous(
                memory_format=torch.channels_last):
            out = out.contiguous(memory_format=torch.channels_last)
        return out

    @staticmethod
    def backward(ctx, grad):
        i, c = ctx.index, ctx.c
        return grad[:, i * c:(i + 1) * c], None


def copy_to_model(x: torch.Tensor, module: nn.Module) -> torch.Tensor:
    """``x`` for ``module``'s local output channels
    (:class:`_CopyToModel`)."""
    mesh = _mesh(module)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, mesh.groups[MODEL_AXIS])


def gather_channels(y: torch.Tensor, module: nn.Module) -> torch.Tensor:
    """``module``'s local output channels joined over the model ranks."""
    return _GatherChannels.apply(y, _mesh(module))


def local_channels(x: torch.Tensor, module: nn.Module) -> torch.Tensor:
    """This rank's channels of a full ``x`` for ``module``."""
    i, n = _mesh(module).coord(MODEL_AXIS), module.tp_shards
    c = x.shape[1] // n
    return x[:, i * c:(i + 1) * c]


def column_parallel() -> tuple[type, ...]:
    """The layer classes with a column-parallel form."""
    from shadow_removal_istd_tpu_torch.models import layers as L

    return (L.ConvReflect, L.Conv, L.ConvTranspose, L.Upsample, L.BatchNorm)


@torch.no_grad()
def sync_replicated_grads(nets: Sequence[nn.Module],
                          mesh: Mesh | None) -> None:
    """Broadcast the gradients of the layers that no model rank splits
    from the first model rank of this rank's line."""
    if mesh is None or mesh.n_model == 1:
        return
    src = mesh.ranks_of(MODEL_AXIS)[0]
    group = mesh.groups[MODEL_AXIS]
    for net in nets:
        for mod in net.modules():
            if is_split(mod):
                continue
            for p in mod.parameters(recurse=False):
                if p.grad is not None:
                    dist.broadcast(p.grad, src=src, group=group)
