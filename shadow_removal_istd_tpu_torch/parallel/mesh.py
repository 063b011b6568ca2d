"""Data parallelism across ranks: the process group, each rank's slice of
a global batch, and the collectives of the data-parallel train step.

Port of the data axis of ``shadow_removal_istd_tpu/parallel/mesh.py``.
JAX runs one SPMD program over a device mesh and XLA inserts the
gradient psum and the global-batch BatchNorm collectives. Here each rank
is a process with one device (``Mesh.device``), and the step names its
collectives itself:

- train-mode BatchNorm all-reduces its per-channel ``[sum x, sum x^2]``
  (over the global count: the ranks' slices are equal) and the
  relativistic-average D loss its batch sums, both through
  :func:`all_reduce_sum`, an autograd function whose backward
  all-reduces the gradient of those sums (``models/layers.py``,
  ``losses/adversarial.py``);
- each rank backpropagates its local loss divided by the world size,
  and :func:`all_reduce_grads` sums the parameter gradients: together
  exactly the gradient of the global-batch loss, the cross-rank
  BatchNorm terms included;
- metrics and the batch statistics of BEGAN's k and SoftAdapt are
  averaged over the ranks (:func:`mean_across`).

Every rank holds the whole dataset and computes the same global choices
(batch order, augmentation parameters, dropout masks) from the shared
seed, then takes its contiguous slice (:func:`shard_batch`), as the JAX
package's ``put_global`` places only a process's shards.

Backend rule (:func:`make_mesh`): NCCL when every rank has a card of its
own, gloo when ranks share a card or run on the CPU (NCCL refuses two
ranks on one device). The data-parallel path uses only ``all_reduce``,
``broadcast`` and ``barrier``, which gloo carries for CUDA tensors too.
The process group has a timeout, so a hung collective fails the run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import socket
from typing import Iterator, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group.

    ``world``/``rank``: the ranks of the group; ``device``: this rank's
    device; ``devices``: the devices selected on this rank's host (the
    pipeline's stages split them); ``processes``: the launching
    processes (``--num-processes``, the JAX package's process count),
    each starting its host's ranks; ``group``/``backend``: the process
    group of the collectives (None for one rank)."""

    world: int
    rank: int
    device: torch.device
    devices: tuple[torch.device, ...]
    processes: int = 1
    group: object = None
    backend: str | None = None

    def rows(self, n: int) -> slice:
        """This rank's contiguous slice of ``n`` global rows."""
        if n % self.world:
            raise ValueError(f"a global batch of {n} does not split over "
                             f"{self.world} ranks")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)


def distributed_init(init_method: str, world_size: int, rank: int,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the gloo process group of ``world_size`` ranks at
    ``init_method`` (``tcp://host:port``, ``host:port`` or
    ``file:///path``). No-op for one rank. :func:`make_mesh` then picks
    the collectives' backend."""
    if world_size <= 1:
        return
    if "://" not in init_method:
        init_method = f"tcp://{init_method}"
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)


def make_mesh(device: str | torch.device,
              devices: Sequence[str | torch.device] | None = None,
              processes: int = 1,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """This rank's :class:`Mesh` over the initialized process group (one
    rank without one). ``devices`` defaults to ``(device,)``.

    NCCL when every rank is on a card of its own (checked by exchanging
    each rank's host and card), else gloo; the choice is logged."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    devices = tuple(torch.device(d) for d in (devices or (device,)))
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return Mesh(1, 0, device, devices, processes)
    world, rank = dist.get_world_size(), dist.get_rank()
    keys: list = [None] * world
    dist.all_gather_object(keys, (socket.gethostname(), str(device)))
    if device.type == "cuda" and len(set(keys)) == world:
        group, backend = dist.new_group(backend="nccl", timeout=timeout), \
            "nccl"
        why = "every rank on a card of its own"
    else:
        group, backend = dist.group.WORLD, "gloo"
        why = ("ranks share a card" if device.type == "cuda"
               else "CPU ranks")
    logger.info("data parallel: rank %d of %d on %s, backend %s (%s)",
                rank, world, device, backend, why)
    return Mesh(world, rank, device, devices, processes, group, backend)


def is_primary(mesh: Mesh | None = None) -> bool:
    """True on the rank that owns host-side side effects (weight files,
    checkpoints, event files, PNG output); always True for one rank."""
    if mesh is not None:
        return mesh.rank == 0
    return not dist.is_initialized() or dist.get_rank() == 0


def shard_batch(mesh: Mesh | None, batch, dim: int = 0):
    """This rank's contiguous slice of every global array (or tensor) in
    ``batch`` along ``dim``; the batch itself for one rank."""
    if mesh is None or mesh.world == 1:
        return batch
    one = not isinstance(batch, (tuple, list))
    parts = [batch] if one else batch
    out = tuple(a[(slice(None),) * dim + (mesh.rows(a.shape[dim]),)]
                for a in parts)
    return out[0] if one else out


def _state_tensors(state) -> list[torch.Tensor]:
    """Every tensor of a train state in a fixed order: parameters and
    buffers of the four networks, both optimizers' state, k1/k2 and the
    SoftAdapt tensors."""
    out = []
    for net in state.models.all():
        out += list(net.parameters()) + list(net.buffers())
    for opt in (state.opt_g, state.opt_d):
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p, {})
                out += [st[k] for k in sorted(st)
                        if isinstance(st[k], torch.Tensor)]
    out += [state.k1, state.k2]
    if state.softadapt is not None:
        out += list(state.softadapt)
    return out


@torch.no_grad()
def shard_state(mesh: Mesh | None, state):
    """Make every rank's train state rank 0's (a broadcast of each
    tensor); the state is replicated, as the JAX package places it on a
    data mesh. Returns ``state``."""
    if mesh is None or mesh.world == 1:
        return state
    for t in _state_tensors(state):
        # NCCL carries card tensors only; Adam's step counts live on the
        # CPU and go through the default (gloo) group
        group = mesh.group if t.is_cuda or mesh.backend != "nccl" else None
        dist.broadcast(t.data, src=0, group=group)
    return state


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradient over
    the ranks, so that each rank's share of a global statistic receives
    every rank's gradient of it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable sum of ``t`` over the ranks of ``mesh``."""
    return _AllReduceSum.apply(t, mesh.group)


_active: Mesh | None = None


@contextlib.contextmanager
def data_parallel(mesh: Mesh | None) -> Iterator[None]:
    """Run the enclosed train step over the global batch of ``mesh``:
    train-mode BatchNorm, dropout and the relativistic-average mean
    consult :func:`active_mesh`. A mesh of one rank (or None) means the
    local batch is the whole batch. Process-wide, since autograd runs a
    backward's replays on its device thread."""
    global _active
    prev = _active
    _active = mesh if mesh is not None and mesh.world > 1 else None
    try:
        yield
    finally:
        _active = prev


def active_mesh() -> Mesh | None:
    """The mesh of the enclosing :func:`data_parallel`, if any."""
    return _active


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """``t.mean(dim=0)`` over the global batch of the active mesh, with
    its gradient (the ranks' slices are equal)."""
    mesh = _active
    if mesh is None:
        return t.mean(dim=0)
    return all_reduce_sum(t.sum(dim=0), mesh) / (t.shape[0] * mesh.world)


def global_rand(shape: Sequence[int], generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """``torch.rand(shape)`` of this rank's rows of the global batch:
    every rank draws the global ``(shape[0] * world, ...)`` block from
    the shared generator and keeps its slice, so the masks equal one
    device's over the whole batch."""
    mesh = _active
    if mesh is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    full = torch.rand((shape[0] * mesh.world, *shape[1:]),
                      generator=generator, device=device)
    return full[mesh.rows(full.shape[0])]


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.Tensor],
                     mesh: Mesh | None) -> None:
    """Sum the parameters' gradients over the ranks, in one flat buffer
    per dtype (a gradient that is None is None on every rank); nothing
    for one rank."""
    if mesh is None or mesh.world == 1:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=mesh.group)
        for g, s in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(s)


@torch.no_grad()
def sum_across(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The sum of ``t`` over the ranks (no gradient); ``t`` itself for
    one rank."""
    if mesh is None or mesh.world == 1:
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.group)
    return out


def mean_across(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The mean of ``t`` over the ranks (no gradient); ``t`` itself for
    one rank."""
    if mesh is None or mesh.world == 1:
        return t
    return sum_across(t, mesh) / mesh.world


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank of ``mesh`` (nothing for one rank)."""
    if mesh is not None and mesh.world > 1:
        dist.barrier()      # the default (gloo) group
