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

Axes. A mesh is the JAX package's ``(data, spatial, model)`` grid of
ranks, row-major with ``model`` innermost (JAX ``make_mesh_3d``):
global rank ``r`` sits at ``(r // (S*M), (r // M) % S, r % M)``. Each
axis has one process group per line of ranks that share the other two
coordinates, and the forward steps' metrics reduce over the
``data x spatial`` plane. The data axis carries the collectives above;
``parallel/spatial.py`` the spatial axis (row halos, forward only) and
``parallel/tensor.py`` the model axis (channel-sharded weights). Gathers
on CUDA tensors over gloo go through ``all_reduce`` of a zero-filled
buffer holding each rank's slot (exact), since gloo carries only
``all_reduce`` and ``broadcast`` for them; over NCCL, and for CPU
tensors, through ``all_gather`` (:func:`all_gather`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import math
import socket
from typing import Iterator, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, SPATIAL_AXIS, MODEL_AXIS)
# marks a tensor as one spatial rank's slab of image rows
ROW_SLAB_ATTR = "_srit_row_slab"
# the process groups a mesh holds: one per axis, and the data x spatial
# plane over which a forward step's metrics reduce
_GROUP_AXES = {DATA_AXIS: (DATA_AXIS,), SPATIAL_AXIS: (SPATIAL_AXIS,),
               MODEL_AXIS: (MODEL_AXIS,),
               "forward": (DATA_AXIS, SPATIAL_AXIS)}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh.

    ``world``/``rank``: every rank of the run and this one's global
    rank; ``device``: this rank's device; ``devices``: the devices
    selected on this rank's host (the pipeline's stages split them);
    ``processes``: the launching processes (``--num-processes``, the JAX
    package's process count), each starting its host's ranks;
    ``group``/``backend``: the process group over every rank (None for
    one rank); ``shape``: the ``(data, spatial, model)`` sizes, whose
    product is ``world`` (``(world, 1, 1)`` by default);
    ``axis_names``: the axes the JAX mesh of this shape would name;
    ``groups``: each axis's (and the ``"forward"`` plane's) group of
    this rank, None where it holds this rank alone."""

    world: int
    rank: int
    device: torch.device
    devices: tuple[torch.device, ...]
    processes: int = 1
    group: object = None
    backend: str | None = None
    shape: tuple[int, int, int] | None = None
    axis_names: tuple[str, ...] = (DATA_AXIS,)
    groups: dict = dataclasses.field(default_factory=dict, compare=False)

    def __post_init__(self):
        if self.shape is None:
            object.__setattr__(self, "shape", (self.world, 1, 1))
        if math.prod(self.shape) != self.world:
            raise ValueError(f"mesh shape {self.shape} does not hold "
                             f"{self.world} ranks")

    def size(self, *axes: str) -> int:
        """The number of ranks along ``axes`` (1 for none)."""
        return math.prod(self.shape[AXES.index(a)] for a in axes)

    def coord(self, *axes: str) -> int:
        """This rank's row-major index along ``axes``."""
        d, s, m = self.shape
        here = (self.rank // (s * m), (self.rank // m) % s, self.rank % m)
        out = 0
        for a in axes:
            i = AXES.index(a)
            out = out * self.shape[i] + here[i]
        return out

    def ranks_of(self, *axes: str) -> list[int]:
        """The global ranks of this rank's line along ``axes``, in the
        order of :meth:`coord`."""
        free = [AXES.index(a) for a in axes]
        d, s, m = self.shape
        here = [self.rank // (s * m), (self.rank // m) % s, self.rank % m]
        out = []
        for k in range(self.size(*axes)):
            c = list(here)
            for i in reversed(free):
                c[i], k = k % self.shape[i], k // self.shape[i]
            out.append((c[0] * s + c[1]) * m + c[2])
        return out

    @property
    def n_data(self) -> int:
        return self.shape[0]

    @property
    def n_spatial(self) -> int:
        return self.shape[1]

    @property
    def n_model(self) -> int:
        return self.shape[2]

    def rows(self, n: int) -> slice:
        """This rank's contiguous slice of ``n`` global rows: its data
        coordinate's share (the spatial and model ranks of one data
        coordinate hold the same rows)."""
        if n % self.n_data:
            raise ValueError(f"a global batch of {n} does not split over "
                             f"{self.n_data} data ranks")
        b = n // self.n_data
        i = self.coord(DATA_AXIS)
        return slice(i * b, (i + 1) * b)


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
              timeout: datetime.timedelta = DEFAULT_TIMEOUT,
              shape: tuple[int, int, int] | None = None,
              axis_names: tuple[str, ...] | None = None) -> Mesh:
    """This rank's :class:`Mesh` over the initialized process group (one
    rank without one). ``devices`` defaults to ``(device,)``; ``shape``
    (data, spatial, model) to ``(world, 1, 1)``, the data-parallel mesh.

    NCCL when every rank is on a card of its own (checked by exchanging
    each rank's host and card), else gloo; the choice is logged. Every
    rank creates every axis group, in one order."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    devices = tuple(torch.device(d) for d in (devices or (device,)))
    names = axis_names or _axis_names(shape)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return Mesh(1, 0, device, devices, processes, shape=shape,
                    axis_names=names)
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
    mesh = Mesh(world, rank, device, devices, processes, group, backend,
                shape=shape, axis_names=names)
    for key, axes in _GROUP_AXES.items():
        n = mesh.size(*axes)
        if n == 1:
            continue
        if n == world:
            mesh.groups[key] = group
            continue
        lines = sorted({tuple(Mesh(world, r, device, devices,
                                   shape=mesh.shape).ranks_of(*axes))
                        for r in range(world)})
        for line in lines:
            g = dist.new_group(list(line), timeout=timeout,
                               backend=backend)
            if rank in line:
                mesh.groups[key] = g
    logger.info("%s: rank %d of %d on %s, backend %s (%s), mesh %s",
                "data parallel" if mesh.shape[1:] == (1, 1) else "mesh",
                rank, world, device, backend, why,
                dict(zip(AXES, mesh.shape)))
    return mesh


def _axis_names(shape) -> tuple[str, ...]:
    """The axes the JAX constructor of this shape names: ``make_mesh``
    (data), ``make_mesh_2d`` (data, spatial), ``make_mesh_tp`` (data,
    model), ``make_mesh_3d`` (all three)."""
    if shape is None:
        return (DATA_AXIS,)
    _, s, m = shape
    return tuple(a for a, on in ((DATA_AXIS, True), (SPATIAL_AXIS, s > 1),
                                 (MODEL_AXIS, m > 1)) if on)


def make_mesh_2d(n_data: int, n_spatial: int, device, **kw) -> Mesh:
    """A (data x spatial) mesh of ``n_data * n_spatial`` ranks, spatial
    innermost (JAX ``make_mesh_2d``); ``kw`` as :func:`make_mesh`."""
    return make_mesh(device, shape=(n_data, n_spatial, 1),
                     axis_names=(DATA_AXIS, SPATIAL_AXIS), **kw)


def make_mesh_tp(n_data: int, n_model: int, device, **kw) -> Mesh:
    """A (data x model) mesh, model innermost (JAX ``make_mesh_tp``)."""
    return make_mesh(device, shape=(n_data, 1, n_model),
                     axis_names=(DATA_AXIS, MODEL_AXIS), **kw)


def make_mesh_3d(n_data: int, n_spatial: int, n_model: int, device,
                 **kw) -> Mesh:
    """The (data x spatial x model) mesh, model innermost (JAX
    ``make_mesh_3d``): forward work splits batch rows over ``data`` and
    image rows over ``spatial`` with every state leaf gathered to full
    at use over ``model`` (ZeRO-3); the train step is data x model and
    the spatial ranks of one (data, model) coordinate repeat it."""
    return make_mesh(device, shape=(n_data, n_spatial, n_model),
                     axis_names=AXES, **kw)


def image_sharding(mesh: Mesh) -> tuple[str | None, str | None]:
    """The axes a FORWARD batch (validation, inference) splits over, as
    JAX's ``P(batch_axis, h_axis)``: batch rows over ``data`` and image
    rows over ``spatial`` where the mesh names them."""
    return (DATA_AXIS if DATA_AXIS in mesh.axis_names else None,
            SPATIAL_AXIS if SPATIAL_AXIS in mesh.axis_names else None)


def train_batch_sharding(mesh: Mesh) -> tuple[str | None]:
    """The axes a TRAINING batch splits over: ``data`` only. The
    spatial path is forward-only, as in the JAX package, whose
    partitioner miscompiles the spatially sharded backward."""
    return (DATA_AXIS if DATA_AXIS in mesh.axis_names else None,)


def shard_images(mesh: Mesh | None, batch, data: bool = True):
    """This rank's block of every NCHW tensor of a forward batch: its
    data coordinate's batch rows and its spatial coordinate's image rows
    (JAX ``shard_images`` on ``image_sharding``). The image height must
    split evenly. Each block is marked as a row slab
    (``parallel/spatial.py``): shard tensors on the device they are
    computed on. ``data=False``: the batch holds this rank's data rows
    already."""
    if mesh is None or mesh.world == 1:
        return batch
    one = not isinstance(batch, (tuple, list))
    n_sp, r = mesh.n_spatial, mesh.coord(SPATIAL_AXIS)
    parts = [batch] if one else list(batch)
    out = []
    for a in (shard_batch(mesh, parts) if data else parts):
        h = a.shape[2]
        if h % n_sp:
            raise ValueError(f"image height {h} does not split over "
                             f"{n_sp} spatial ranks")
        b = h // n_sp
        a = a[:, :, r * b:(r + 1) * b]
        if n_sp > 1:
            setattr(a, ROW_SLAB_ATTR, True)
        out.append(a)
    return out[0] if one else tuple(out)


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
    tensor), then, on a mesh with a model axis, keep each rank's share
    of every leaf :func:`model_sharding` splits (JAX ``shard_state``):
    the modules then hold their out-channel shards (``parallel/tensor.py``
    computes with them) and Adam's moments follow their parameters.
    Warns when less than half the state's bytes split. Returns
    ``state``."""
    if mesh is None or mesh.world == 1:
        return state
    if any(getattr(m, "tp_shards", 1) > 1 for net in state.models.all()
           for m in net.modules()):
        raise ValueError("the state is split already: shard_state "
                         "places a whole state once")
    for t in _state_tensors(state):
        # NCCL carries card tensors only; Adam's step counts live on the
        # CPU and go through the default (gloo) group
        group = mesh.group if t.is_cuda or mesh.backend != "nccl" else None
        dist.broadcast(t.data, src=0, group=group)
    if mesh.n_model > 1:
        _shard_model(mesh, state)
        _warn_if_tp_ineffective(mesh, state)
    return state


def model_sharding(mesh: Mesh, leaf) -> int | None:
    """The tensor-parallel rule for one state leaf (JAX
    ``model_sharding``): the dim split over the model axis, or None to
    replicate. JAX splits a leaf's trailing dim when the axis size
    divides it; that is the out-feature dim of a flax kernel (HWIO) and
    the only dim of a per-channel vector. The port keeps the out-feature
    dim first (OIHW conv weights, and ``(Co, Ci, k, k)`` for
    ``Upsample`` and ``ConvTranspose``), so the rule reads dim 0. Heads
    (1 or 3 channels), odd sizes and scalars replicate."""
    n = mesh.n_model
    shape = tuple(getattr(leaf, "shape", ()))
    if len(shape) >= 1 and shape[0] % n == 0 and shape[0] >= n:
        return 0
    return None


def _sharded_modules(mesh: Mesh, state):
    """(module, its tensors' names) for every module of the four nets
    whose weight :func:`model_sharding` splits; raises for a net with a
    parameter outside the layers ``parallel/tensor.py`` computes with."""
    from shadow_removal_istd_tpu_torch.parallel.tensor import (
        column_parallel,
    )

    out = []
    for net in state.models.all():
        for mod in net.modules():
            own = list(mod._parameters) + list(mod._buffers)
            if not own:
                continue
            if not isinstance(mod, column_parallel()):
                raise NotImplementedError(
                    f"tensor parallelism over {type(net).__name__}: its "
                    f"{type(mod).__name__} has no column-parallel form")
            if model_sharding(mesh, mod.weight) == 0:
                out.append((mod, [k for k in own
                                  if getattr(mod, k) is not None]))
    return out


def _shard_model(mesh: Mesh, state) -> None:
    n, r = mesh.n_model, mesh.coord(MODEL_AXIS)
    moments = _moments(state)
    for mod, names in _sharded_modules(mesh, state):
        for k in names:
            t = getattr(mod, k)
            if isinstance(t, nn.Parameter):
                for st in moments.get(t, ()):
                    for key, v in st.items():
                        if torch.is_tensor(v) and v.shape == t.shape:
                            st[key] = v.chunk(n)[r].clone()
                t.data = t.data.chunk(n)[r].clone()
                t.grad = None
            else:
                mod._buffers[k] = t.chunk(n)[r].clone()
        mod.tp_shards, mod.tp_index = n, r
        if getattr(mod, "frozen", None) is not None:
            mod.frozen = None       # an eval kernel of the full weight


def _moments(state) -> dict:
    """Parameter -> its Adam state dicts."""
    out: dict = {}
    for opt in (state.opt_g, state.opt_d):
        for p, st in opt.state.items():
            out.setdefault(p, []).append(st)
    return out


def _full(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The model axis's shards of ``t`` joined along dim 0."""
    return torch.cat(all_gather(t.contiguous(), mesh, MODEL_AXIS), 0)


@torch.no_grad()
def unshard_state(mesh: Mesh | None, state):
    """Undo the model axis of :func:`shard_state`: every split leaf
    (parameters, BatchNorm statistics, Adam moments) gathered back to
    full on every rank, so the state is the single-device one (weight
    and checkpoint files are written, and loaded, in this form; then
    :func:`shard_state` splits it again). Returns ``state``."""
    if mesh is None or mesh.n_model == 1:
        return state
    moments = _moments(state)
    for net in state.models.all():
        for mod in net.modules():
            if getattr(mod, "tp_shards", 1) == 1:
                continue
            for k in list(mod._parameters) + list(mod._buffers):
                t = getattr(mod, k)
                if t is None:
                    continue
                if isinstance(t, nn.Parameter):
                    for st in moments.get(t, ()):
                        for key, v in st.items():
                            if torch.is_tensor(v) and v.shape == t.shape:
                                st[key] = _full(v, mesh)
                    t.data = _full(t.data, mesh)
                    t.grad = None
                else:
                    mod._buffers[k] = _full(t, mesh)
            mod.tp_shards = 1
            if getattr(mod, "frozen", None) is not None:
                mod.frozen = None
    return state


@contextlib.contextmanager
def gather_model_leaves(mesh: Mesh | None, nets) -> Iterator[None]:
    """Inside, every module of ``nets`` holds its full weights and
    statistics, gathered over the model axis, and computes as on one
    device; on exit the shards are back (JAX ``gather_model_leaves``:
    ZeRO-3 on the composed mesh, whose forward steps run spatially
    sharded on full weights). Forward only."""
    if mesh is None or mesh.n_model == 1:
        yield
        return
    kept = []
    with torch.no_grad():
        for net in nets:
            for mod in net.modules():
                if getattr(mod, "tp_shards", 1) == 1:
                    continue
                saved = {}
                for k in list(mod._parameters) + list(mod._buffers):
                    t = getattr(mod, k)
                    if t is None:
                        continue
                    saved[k] = t.data if isinstance(t, nn.Parameter) else t
                    if isinstance(t, nn.Parameter):
                        t.data = _full(t.data, mesh)
                    else:
                        mod._buffers[k] = _full(t, mesh)
                kept.append((mod, saved, mod.tp_shards,
                             getattr(mod, "frozen", None)))
                mod.tp_shards, mod.frozen = 1, None
    try:
        yield
    finally:
        for mod, saved, n, frozen in kept:
            for k, t in saved.items():
                if isinstance(getattr(mod, k), nn.Parameter):
                    getattr(mod, k).data = t
                else:
                    mod._buffers[k] = t
            mod.tp_shards, mod.frozen = n, frozen


def _warn_if_tp_ineffective(mesh: Mesh, state) -> None:
    """Tensor parallelism degrades to replication where channel counts
    do not divide the model axis (``--model-shard 3`` with power-of-two
    widths): say so when less than half of the state's bytes (at full
    size: parameters, statistics, Adam moments) split, as JAX does."""
    total = sharded = 0
    moments = _moments(state)
    for net in state.models.all():
        for mod in net.modules():
            n = getattr(mod, "tp_shards", 1)
            for k in list(mod._parameters) + list(mod._buffers):
                t = getattr(mod, k)
                if t is None:
                    continue
                copies = 1 + sum(
                    1 for st in moments.get(t, ()) for v in st.values()
                    if torch.is_tensor(v) and v.shape == t.shape)
                b = t.numel() * t.element_size() * n * copies
                total += b
                sharded += b if n > 1 else 0
    frac = sharded / total if total else 0.0
    if frac < 0.5:
        logger.warning(
            "model axis size %d shards only %.0f%% of state bytes — "
            "channel counts must divide the axis size to shard "
            "(power-of-two --model-shard values fit the ngf-multiple "
            "widths); per-card memory will barely drop",
            mesh.n_model, 100 * frac)


# the form of a gather: None picks by backend and device (see
# all_gather); "native" or "reduce" forces one (tests run both on CPU)
GATHER_FORM: str | None = None


def all_gather(t: torch.Tensor, mesh: Mesh, key: str) -> list[torch.Tensor]:
    """Every rank's ``t`` along the group ``key`` (an axis or
    ``"forward"``), in coordinate order (equal shapes). NCCL, and gloo
    with CPU tensors, run ``all_gather``; gloo with CUDA tensors, which
    it gathers not, sums a zero-filled ``(n, *t.shape)`` buffer holding
    each rank's slot (``all_reduce``: exact, since every other term is
    zero)."""
    axes = _GROUP_AXES.get(key, (key,))
    n = mesh.size(*axes)
    if n == 1:
        return [t]
    group = mesh.groups[key]
    form = GATHER_FORM or ("reduce" if t.is_cuda and mesh.backend != "nccl"
                           else "native")
    t = t.contiguous()
    if form == "native":
        out = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(out, t, group=group)
        return out
    buf = t.new_zeros((n, *t.shape))
    buf[mesh.coord(*axes)] = t
    dist.all_reduce(buf, group=group)
    return list(buf.unbind(0))


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the incoming gradient over
    the group, so that each rank's share of a global statistic receives
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
    """Differentiable sum of ``t`` over the data ranks of ``mesh``."""
    if mesh.n_data == 1:
        return t
    return _AllReduceSum.apply(t, mesh.groups[DATA_AXIS])


_active: Mesh | None = None


@contextlib.contextmanager
def data_parallel(mesh: Mesh | None) -> Iterator[None]:
    """Run the enclosed train step over the global batch of ``mesh``:
    train-mode BatchNorm, dropout and the relativistic-average mean
    consult :func:`active_mesh` and reduce over its data axis. A mesh of
    one rank (or None) means the local batch is the whole batch.
    Process-wide, since autograd runs a backward's replays on its device
    thread."""
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
    its gradient (the data ranks' slices are equal)."""
    mesh = _active
    if mesh is None or mesh.n_data == 1:
        return t.mean(dim=0)
    return all_reduce_sum(t.sum(dim=0), mesh) / (t.shape[0] * mesh.n_data)


def global_rand(shape: Sequence[int], generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """``torch.rand(shape)`` of this rank's rows of the global batch:
    every rank draws the global ``(shape[0] * n_data, ...)`` block from
    the shared generator and keeps its data coordinate's slice, so the
    masks equal one device's over the whole batch."""
    mesh = _active
    if mesh is None or mesh.n_data == 1:
        return torch.rand(tuple(shape), generator=generator, device=device)
    full = torch.rand((shape[0] * mesh.n_data, *shape[1:]),
                      generator=generator, device=device)
    return full[mesh.rows(full.shape[0])]


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.Tensor],
                     mesh: Mesh | None) -> None:
    """Sum the parameters' gradients over the data ranks, in one flat
    buffer per dtype (a gradient that is None is None on every rank);
    nothing for one data rank."""
    if mesh is None or mesh.n_data == 1:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=mesh.groups[DATA_AXIS])
        for g, s in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(s)


@torch.no_grad()
def sum_across(t: torch.Tensor, mesh: Mesh | None,
               key: str = DATA_AXIS) -> torch.Tensor:
    """The sum of ``t`` over the ranks of the group ``key`` (the data
    axis; ``"forward"``: the data x spatial plane) with no gradient;
    ``t`` itself where that group is one rank."""
    if mesh is None or mesh.size(*_GROUP_AXES[key]) == 1:
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.groups[key])
    return out


def mean_across(t: torch.Tensor, mesh: Mesh | None,
                key: str = DATA_AXIS) -> torch.Tensor:
    """The mean of ``t`` over the ranks of the group ``key`` (no
    gradient); ``t`` itself where that group is one rank."""
    if mesh is None:
        return t
    n = mesh.size(*_GROUP_AXES[key])
    return t if n == 1 else sum_across(t, mesh, key) / n


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank of ``mesh`` (nothing for one rank)."""
    if mesh is not None and mesh.world > 1:
        dist.barrier()      # the default (gloo) group
