"""Spatial row sharding: image rows split over the spatial axis, forward
only.

Port of the spatial axis of ``shadow_removal_istd_tpu/parallel/mesh.py``
(``make_mesh_2d``, ``image_sharding``, ``shard_images``). JAX row-shards
a forward batch and XLA's partitioner writes the convolutions' halo
exchanges; here each spatial rank holds an equal slab of every image's
rows (``parallel.mesh.shard_images``) and the windowed layers of
``models/layers.py`` exchange their halos themselves inside
:func:`spatial_parallel`:

- a convolution of kernel ``k``, stride ``s`` and padding ``p`` reads
  ``p`` rows of its upper neighbour and ``k - s - p`` of its lower one
  (:func:`exchange_halo`); at the image's top and bottom the op's own
  padding applies (reflect, zero or edge, :func:`pad_rows`), so every
  output row is the one device's;
- the decoder kernel (K1) runs unchanged on the slab with one exchanged
  row added on each inner side, and the two output rows each added row
  produced are cropped (``models/layers.Upsample``);
- BatchNorm in eval, activations and nearest upsampling are row-local.

A level whose rows do not split into whole strides over the ranks (MNet
halves H six times: 480 rows over 4 ranks leave 15 at the deepest
level) is all-gathered (:func:`gather_rows`, counted in
``gather_rows.count``), computed whole on every spatial rank, and split
again where it meets a row-sharded tensor (:func:`split_rows`: the
decoder's skip concat). Which tensors are slabs is tracked by a
``TorchFunctionMode``: an op with a slab among its inputs returns slabs;
a whole tensor that meets a slab in a concat is split first. A layer
whose forward is wrapped in :func:`native` runs its own ops outside the
mode, at full speed, and marks its output itself (:func:`mark_rows`).

Autograd is refused (:func:`exchange_halo`): the spatial path is forward
only, as JAX's ``train_batch_sharding`` keeps it. Nothing computes
unsharded without being counted: a row-sharded input whose layer cannot
run on slabs is gathered.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterator

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from shadow_removal_istd_tpu_torch.parallel.mesh import (
    ROW_SLAB_ATTR as _ATTR,
    SPATIAL_AXIS,
    Mesh,
    all_gather,
)

_active: Mesh | None = None


def is_sharded(x) -> bool:
    """Whether ``x`` is this rank's slab of rows of a spatial forward."""
    return _active is not None and getattr(x, _ATTR, False)


def _mark(x: torch.Tensor, slab: bool = True) -> torch.Tensor:
    setattr(x, _ATTR, slab)
    return x


def _has_slab(values) -> bool:
    """Whether a slab is among ``values`` or their list/tuple items."""
    for v in values:
        if isinstance(v, (list, tuple)):
            if any(getattr(t, _ATTR, False) for t in v):
                return True
        elif getattr(v, _ATTR, False):
            return True
    return False


class _RowSlabs(TorchFunctionMode):
    """Marks every tensor an op returns as a slab when one of its inputs
    is, and splits a whole tensor that a concat joins with slabs."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.cat, torch.concat):
            args = (_match_rows(args[0]),) + tuple(args[1:])
        out = func(*args, **kwargs)
        if _has_slab(args) or _has_slab(kwargs.values()):
            for t in (out if isinstance(out, (list, tuple)) else (out,)):
                if isinstance(t, torch.Tensor):
                    _mark(t)
        return out


def native(forward: Callable) -> Callable:
    """Run a layer's ``forward`` outside the slab tracking (its ops at
    full speed): the layer marks its output itself (:func:`mark_rows`)."""
    @functools.wraps(forward)
    def run(*args, **kwargs):
        if _active is None:
            return forward(*args, **kwargs)
        with torch._C.DisableTorchFunction():
            return forward(*args, **kwargs)
    return run


def mark_rows(y: torch.Tensor, slab: bool) -> torch.Tensor:
    """``y``, marked as a slab when ``slab``."""
    return _mark(y) if slab and _active is not None else y


def _match_rows(parts):
    """The parts of a concat with the whole 4-D ones split to this
    rank's rows when a slab is among them."""
    parts = list(parts)
    if not any(getattr(t, _ATTR, False) for t in parts):
        return parts
    return [split_rows(t) if t.dim() == 4 and not getattr(t, _ATTR, False)
            else t for t in parts]


@contextlib.contextmanager
def spatial_parallel(mesh: Mesh | None) -> Iterator[None]:
    """Run the enclosed forward on row slabs over ``mesh``'s spatial
    axis (nothing for a mesh without one): the windowed layers exchange
    halos, and slabs are tracked (see the module's doc)."""
    global _active
    if mesh is None or mesh.n_spatial == 1:
        yield
        return
    prev = _active
    _active = mesh
    try:
        with _RowSlabs():
            yield
    finally:
        _active = prev


def global_height(x: torch.Tensor) -> int:
    """The image height ``x``'s rows belong to."""
    return x.shape[2] * (_active.n_spatial if is_sharded(x) else 1)


def _gather(x: torch.Tensor) -> list[torch.Tensor]:
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("spatial sharding is forward only: a row slab "
                           "that requires grad cannot exchange rows")
    with torch._C.DisableTorchFunction():
        return all_gather(x, _active, SPATIAL_AXIS)


def exchange_halo(x: torch.Tensor, above: int,
                  below: int) -> tuple[torch.Tensor, int, int]:
    """``x`` (N, C, h, W) with ``above`` rows of its upper neighbour's
    slab prepended and ``below`` rows of its lower one's appended; the
    image's top (bottom) rank gets none above (below). Returns the
    tensor and the rows added above and below."""
    n, r = _active.n_spatial, _active.coord(SPATIAL_AXIS)
    h = x.shape[2]
    if above == below == 0:
        return x, 0, 0
    if above > h or below > h:
        raise ValueError(f"a halo of {above}/{below} rows exceeds a "
                         f"slab of {h}")
    with torch._C.DisableTorchFunction():
        edges = torch.cat([x[:, :, :below], x[:, :, h - above:]], dim=2)
    slabs = _gather(edges)
    top = slabs[r - 1][:, :, below:] if r > 0 and above else None
    bot = slabs[r + 1][:, :, :below] if r < n - 1 and below else None
    with torch._C.DisableTorchFunction():
        out = torch.cat([t for t in (top, x, bot) if t is not None], dim=2)
    return (_mark(out.contiguous(memory_format=_format(x))),
            0 if top is None else above, 0 if bot is None else below)


def _format(x: torch.Tensor):
    return (torch.channels_last
            if x.is_contiguous(memory_format=torch.channels_last)
            and not x.is_contiguous() else torch.contiguous_format)


def pad_rows(x: torch.Tensor, above: int, below: int,
             mode: str) -> torch.Tensor:
    """A slab with ``above``/``below`` rows around it, as one device's
    padded image has them: the neighbours' rows, and at the image's top
    and bottom the op's padding (``"reflect"``, ``"constant"`` zeros or
    ``"replicate"``)."""
    y, a, b = exchange_halo(x, above, below)
    if (a, b) != (above, below):
        with torch._C.DisableTorchFunction():
            y = F.pad(y, (0, 0, above - a, below - b), mode=mode)
        y = _mark(y)
    return y


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a slab, on every spatial rank (counted in
    ``gather_rows.count``)."""
    gather_rows.count += 1
    with torch._C.DisableTorchFunction():
        out = torch.cat(_gather(x), dim=2).contiguous(
            memory_format=_format(x))
    return _mark(out, False)


gather_rows.count = 0


def split_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's slab of a whole tensor (no communication)."""
    n, r = _active.n_spatial, _active.coord(SPATIAL_AXIS)
    h = x.shape[2]
    if h % n:
        raise ValueError(f"{h} rows do not split over {n} spatial ranks")
    b = h // n
    with torch._C.DisableTorchFunction():
        out = x[:, :, r * b:(r + 1) * b]
    return _mark(out)


def crop_rows(x: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Rows ``start:stop`` of a slab computed with halo rows."""
    with torch._C.DisableTorchFunction():
        out = x[:, :, start:stop]
    return _mark(out)


def conv_rows(x: torch.Tensor, kernel: int, stride: int, pad_top: int,
              pad_bottom: int, mode: str) -> tuple[torch.Tensor, bool]:
    """The input of a row-windowed layer (kernel, stride, top and bottom
    padding): a slab padded by :func:`pad_rows` (``True``: the layer
    then pads W only), or, for a whole tensor, ``x`` as it is
    (``False``). A slab whose rows do not split into whole strides, or
    whose output would not split evenly, or that is too short for its
    halo, is gathered first (:func:`gather_rows`)."""
    if not is_sharded(x):
        return x, False
    h = x.shape[2]
    below = kernel - stride - pad_top
    if (h % stride or pad_top + pad_bottom != kernel - stride
            or max(pad_top, below) > h
            or (mode == "reflect" and h <= max(pad_top, pad_bottom))):
        return gather_rows(x), False
    return pad_rows(x, pad_top, below, mode), True


def fit_rows(x: torch.Tensor, window: int) -> torch.Tensor:
    """The input of a layer that reads rows in whole windows (a pool,
    pix2pix's stride-2 level): a slab whose rows split into them, else
    the gathered tensor."""
    if is_sharded(x) and x.shape[2] % window:
        return gather_rows(x)
    return x
