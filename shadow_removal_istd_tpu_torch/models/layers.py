"""Building blocks of the model zoo in PyTorch.

Port of ``shadow_removal_istd_tpu/models/layers.py``. Modules take NCHW
tensors and keep their weights OIHW; a ConvTranspose weight keeps the
JAX package's (unflipped) kernel, see :func:`convtranspose_phase_kernel`
and :class:`ConvTranspose`. Weights come from :func:`init_weights_`
(seeded ``torch.Generator``), from :func:`apply_dcgan_init_` or from a
JAX tree via ``tools/convert.py``.

Compute dtype. A convolution casts its weight to the dtype of its input,
as flax's ``Conv(dtype=...)`` casts kernels at use: a model casts its
input once to the compute dtype and every layer then computes in it,
while parameters stay in their own dtype (f32 under bf16 compute).
BatchNorm statistics run in f32 and its output returns in the input
dtype. Casting a module (``.to(torch.bfloat16)``) casts every parameter
and buffer, as the JAX serving engine casts every leaf.

Train and eval follow ``module.training``: BatchNorm takes batch
statistics and updates its running ones, Dropout2d draws a mask, and
``Upsample`` runs the differentiable unfused form (plain cuDNN, as the
JAX package's training runs plain XLA) in place of the decoder op.

A forward replayed by activation checkpointing (``engine/steps.py``
under ``remat``) runs inside :func:`replaying_forward`: BatchNorm then
normalizes by the batch statistics as always but leaves its running
statistics where the first forward moved them. BatchNorm is the only
layer that changes state in a train forward; a new stateful layer must
read :func:`replaying` the same way.

Parallel forms (``parallel/``), each inactive outside its context:

- inside ``parallel.spatial.spatial_parallel`` (forward only) a
  row-sharded input exchanges its halo rows before each windowed layer
  (the convolutions, ``Upsample``'s decoder kernel on the slab plus one
  row a side, the pools), or is gathered where its rows do not split;
- a layer whose weight ``parallel.mesh.shard_state`` split over the
  model axis computes its own output channels from the full input and
  all-gathers them (``parallel/tensor.py``); BatchNorm normalizes its own
  channels of the full input.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Iterator

import torch
import torch.nn.functional as F
from torch import nn

from shadow_removal_istd_tpu_torch.ops.decoder import (
    decoder_upsample,
    subpixel_depth_to_space,
)
from shadow_removal_istd_tpu_torch.parallel import spatial
from shadow_removal_istd_tpu_torch.parallel.mesh import (
    active_mesh,
    all_reduce_sum,
    global_rand,
)
from shadow_removal_istd_tpu_torch.parallel.tensor import (
    copy_to_model,
    gather_channels,
    is_split,
    local_channels,
)


class _ReflectPad(torch.autograd.Function):
    """``F.pad(mode="reflect")`` of H and W by ``p`` whose backward folds
    the padded border's gradient back onto the rows and columns it
    mirrors with plain slices and adds. Torch's own backward scatters
    with atomic adds on the card, so two runs of one training step
    differed in their last bits; this one is deterministic (a resumed
    run replays the uninterrupted one byte for byte)."""

    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        ctx.channels_last = (x.is_contiguous(memory_format=torch
                                             .channels_last)
                             and not x.is_contiguous())
        return F.pad(x, (p, p, p, p), mode="reflect")

    @staticmethod
    def backward(ctx, g):
        p = ctx.p
        n, c, hp, wp = g.shape
        fmt = (torch.channels_last if ctx.channels_last
               else torch.contiguous_format)
        gx = torch.empty((n, c, hp - 2 * p, wp - 2 * p), dtype=g.dtype,
                         device=g.device, memory_format=fmt)
        gx.copy_(g[..., p:-p, p:-p])
        h, w = gx.shape[2:]
        if p == 1 and h >= 4 and w >= 4:
            # columns 1 and w-2 take padded columns 0 and w+1, rows 1 and
            # h-2 padded rows 0 and h+1, and the four corners likewise:
            # three strided adds (no element is written twice by one)
            cols, rows = slice(1, w - 1, w - 3), slice(1, h - 1, h - 3)
            gx[..., :, cols].add_(g[..., 1:-1, ::w + 1])
            gx[..., rows, :].add_(g[..., ::h + 1, 1:-1])
            gx[..., rows, cols].add_(g[..., ::h + 1, ::w + 1])
            return gx, None
        mid = slice(p, -p)
        # border strips of width p (and the corners), each added onto
        # the p rows or columns inside the edge it mirrors
        lo, hi = slice(1, p + 1), slice(-p - 1, -1)
        for (rows, cols), (src_r, src_c), dims in (
                ((slice(None), lo), (mid, slice(None, p)), (-1,)),
                ((slice(None), hi), (mid, slice(-p, None)), (-1,)),
                ((lo, slice(None)), (slice(None, p), mid), (-2,)),
                ((hi, slice(None)), (slice(-p, None), mid), (-2,)),
                ((lo, lo), (slice(None, p), slice(None, p)), (-2, -1)),
                ((lo, hi), (slice(None, p), slice(-p, None)), (-2, -1)),
                ((hi, lo), (slice(-p, None), slice(None, p)), (-2, -1)),
                ((hi, hi), (slice(-p, None), slice(-p, None)), (-2, -1))):
            strip = g[..., src_r, src_c]
            gx[..., rows, cols].add_(strip if p == 1 else strip.flip(dims))
        return gx, None


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """``jnp.pad(mode="reflect")`` of H and W by ``p``: a side of one
    pixel repeats it (numpy's rule; torch refuses to reflect it), as a
    DenseUNet bottleneck at a 32-pixel bucket has."""
    h, w = x.shape[2], x.shape[3]
    if h > p and w > p:
        if p and torch.is_grad_enabled() and x.requires_grad:
            return _ReflectPad.apply(x, p)
        return F.pad(x, (p, p, p, p), mode="reflect")
    if p != 1:
        raise ValueError(f"reflect pad {p} of a {h}x{w} input")
    x = F.pad(x, (p, p, 0, 0), mode="reflect" if w > p else "replicate")
    return F.pad(x, (0, 0, p, p), mode="reflect" if h > p else "replicate")


class ConvReflect(nn.Module):
    """Conv2d with reflection padding and no bias (torch
    ``padding_mode='reflect'``); every use in the zoo is bias-free."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.empty(cout, cin, kernel_size, kernel_size))

    @spatial.native
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split, p = is_split(self), self.padding
        if split:
            x = copy_to_model(x, self)
        x, rows = spatial.conv_rows(x, self.weight.shape[2], self.stride,
                                    p, p, "reflect")
        if rows and p > 0:
            x = F.pad(x, (p, p, 0, 0), mode="reflect")
        elif p > 0:
            x = reflect_pad(x, p)
        y = F.conv2d(x, self.weight.to(x.dtype), stride=self.stride)
        return spatial.mark_rows(gather_channels(y, self) if split else y,
                                 rows)


class Conv(nn.Module):
    """Conv2d with zero padding (torch's default padding) and an
    optional bias: PatchGAN's stem, the pix2pix, NLayer and BEGAN convs,
    and with ``kernel_size=1, padding=0`` flax's plain 1x1 ``nn.Conv``."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.empty(cout, cin, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    @spatial.native
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split = is_split(self)
        if split:
            x = copy_to_model(x, self)
        b = self.bias.to(x.dtype) if self.bias is not None else None
        y = conv2d_rows(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding)
        return spatial.mark_rows(gather_channels(y, self) if split else y,
                                 spatial.is_sharded(y))


@spatial.native
def conv2d_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                stride: int, padding: int) -> torch.Tensor:
    """``F.conv2d`` with zero padding; a row slab of a spatial forward
    takes its neighbours' rows in place of the padding (the image's
    own top and bottom rows pad with zeros) and gives a slab."""
    x, rows = spatial.conv_rows(x, w.shape[2], stride, padding, padding,
                                "constant")
    return spatial.mark_rows(
        F.conv2d(x, w, b, stride=stride,
                 padding=(0, padding) if rows else padding), rows)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` with stride ``stride``: the weight is
    flax's kernel (``(Co, Ci, k, k)`` from its HWIO), applied unflipped,
    which is torch's ``conv_transpose2d`` with the kernel flipped.
    ``padding=1`` with ``k=4, stride=2`` is flax's ``'SAME'`` (output
    2x, pix2pix); ``padding=0`` with ``k=stride`` is ``'VALID'``
    (DenseUNet's 2x2)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1, bias: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            torch.empty(cout, cin, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    @spatial.native
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split = is_split(self)
        if split:
            x = copy_to_model(x, self)
        w = self.weight.to(x.dtype).transpose(0, 1).flip(2, 3)
        b = self.bias.to(x.dtype) if self.bias is not None else None
        k, s, p = w.shape[2], self.stride, self.padding
        pad_h = p
        if spatial.is_sharded(x):
            # output rows [s*r0, s*(r0+h)) read input rows r0-above ..
            # r0+h-1+below; zero rows stand outside the image
            above, below = (k - 1 - p) // s, 1 + (p - 1) // s
            if k == s + 2 * p and x.shape[2] >= max(above, below):
                x, pad_h = spatial.pad_rows(x, above, below,
                                            "constant"), p + s * above
            else:
                x = spatial.gather_rows(x)
        y = F.conv_transpose2d(x, w, b, stride=s, padding=(pad_h, p))
        return spatial.mark_rows(gather_channels(y, self) if split else y,
                                 spatial.is_sharded(x))


_REPLAY = threading.local()


@contextlib.contextmanager
def replaying_forward() -> Iterator[None]:
    """Mark the forwards run inside, on this thread, as replays of a
    forward that already ran (activation checkpointing's recompute):
    train-mode BatchNorm leaves its running statistics as they are.
    Thread-local, since autograd recomputes on its device thread."""
    prev = getattr(_REPLAY, "on", False)
    _REPLAY.on = True
    try:
        yield
    finally:
        _REPLAY.on = prev


def replaying() -> bool:
    """True inside :func:`replaying_forward` on this thread."""
    return getattr(_REPLAY, "on", False)


class BatchNorm(nn.Module):
    """BatchNorm with the JAX package's arithmetic (eps 1e-5).

    Train: batch mean and biased variance ``max(E[x^2] - E[x]^2, 0)`` in
    ``promote(x, f32)`` normalise the output; the running statistics
    move by momentum 0.1 toward the mean and the UNBIASED variance
    (``n/(n-1)``), as torch's BatchNorm2d (and the JAX package) do,
    except in a replayed forward (:func:`replaying_forward`). Inside
    ``parallel.mesh.data_parallel`` the statistics are the global
    batch's: every rank's per-channel ``[sum x, sum x^2]`` summed over
    the ranks, with the gradient of those sums summed back in the
    backward, and ``n`` the global count (in the unbiased factor too); a
    replay runs the same collectives.

    Eval: the per-channel factor ``weight * rsqrt(running_var + eps)`` is
    formed in the parameter dtype (bf16 in the bf16 engine, as in JAX,
    where the cast batch stats keep that op in bf16); the affine then
    runs in f32. Either way the result returns in the input dtype."""

    momentum = 0.1

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def _factor(self) -> torch.Tensor:
        return (self.weight * torch.rsqrt(self.running_var + self.eps)
                ).float()

    @spatial.native
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split, slab = is_split(self), spatial.is_sharded(x)
        if split:
            # the input gradient of this rank's channels only: summed
            # over the model ranks as a split convolution's is
            x = local_channels(copy_to_model(x, self), self)
        if self.training:
            if slab:
                raise RuntimeError("spatial sharding is forward only: "
                                   "train-mode BatchNorm on row slabs")
            y = self._train_forward(x)
        else:
            s = self._factor().view(1, -1, 1, 1)
            y = ((x.float() - self.running_mean.float().view(1, -1, 1, 1))
                 * s + self.bias.float().view(1, -1, 1, 1)).to(x.dtype)
        return spatial.mark_rows(gather_channels(y, self) if split else y,
                                 slab)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        c = x.shape[1]
        sums = torch.cat([x32.sum(dim=(0, 2, 3)),
                          x32.square().sum(dim=(0, 2, 3))])
        n = x.numel() / c
        mesh = active_mesh()
        if mesh is not None:
            # the global batch's sums over the data axis, whose backward
            # sums their gradients; every data rank holds an equal slice
            # (Mesh.rows), and a model rank its own channels
            sums = all_reduce_sum(sums, mesh)
            n *= mesh.n_data
        mean, ex2 = sums[:c] / n, sums[c:] / n
        var = torch.clamp(ex2 - mean.square(), min=0.0)
        if not replaying():
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
        s = self.weight * torch.rsqrt(var + self.eps)
        y = ((x32 - mean.view(1, -1, 1, 1)) * s.view(1, -1, 1, 1)
             + self.bias.view(1, -1, 1, 1))
        return y.to(x.dtype)

    def affine(self, tile: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
        """f32 ``(scale, shift)`` with ``y = x*scale + shift``, each
        repeated ``tile`` times: ``tile=4`` gives the phase-tiled affine
        whose channel ``c + k*C`` maps to output channel ``c``."""
        s = self._factor()
        shift = self.bias.float() - self.running_mean.float() * s
        return s.repeat(tile).contiguous(), shift.repeat(tile).contiguous()


class ActNorm(nn.Module):
    """LeakyReLU(0.2) then BatchNorm (the activation comes first, as in
    the JAX package's ``ActNorm``), or with ``use_selu`` SELU alone, which
    leaves no BatchNorm (``bn`` is None)."""

    def __init__(self, c: int, use_selu: bool = False):
        super().__init__()
        self.bn = None if use_selu else BatchNorm(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bn is None:
            return F.selu(x)
        return self.bn(F.leaky_relu(x, 0.2))


class Dropout2d(nn.Module):
    """Channel dropout (torch nn.Dropout2d): in training, zeroes whole
    feature maps, one keep/drop draw per sample and channel, and scales
    the kept ones by ``1/(1-p)``; the identity in eval. The mask comes
    from the ``generator`` passed to ``forward``, which training with
    ``p > 0`` requires; under ``parallel.mesh.data_parallel`` it is this
    rank's rows of the global batch's mask."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("Dropout2d in training needs a generator")
        keep = 1.0 - self.p
        mask = global_rand((x.shape[0], x.shape[1], 1, 1), generator,
                           x.device) < keep
        return torch.where(mask, x / keep, 0.0)


class AlphaDropout(nn.Module):
    """SELU-compatible alpha dropout (torch nn.AlphaDropout): dropped
    values go to ``alpha' = -selu_alpha * selu_scale``, then the affine
    ``a*x + b`` keeps mean and variance; one draw per value from the
    ``generator`` passed to ``forward`` (this rank's rows of the global
    batch's draw under ``parallel.mesh.data_parallel``); the identity in
    eval."""

    alpha_prime = -1.7580993408473766

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("AlphaDropout in training needs a generator")
        keep = 1.0 - self.p
        ap = self.alpha_prime
        mask = global_rand(x.shape, generator, x.device) < keep
        a = (keep + ap ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * ap * (1 - keep)
        return a * torch.where(mask, x, ap) + b


def make_dropout(use_selu: bool, rate: float) -> nn.Module | None:
    """Dropout factory: None at rate 0, AlphaDropout under SELU, else
    Dropout2d."""
    if rate == 0:
        return None
    return AlphaDropout(rate) if use_selu else Dropout2d(rate)


@spatial.native
def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Max pool, stride == window (torch F.max_pool2d(x, 2))."""
    x = spatial.fit_rows(x, window)
    return spatial.mark_rows(F.max_pool2d(x, window), spatial.is_sharded(x))


@spatial.native
def avg_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Average pool, stride == window (torch nn.AvgPool2d(2))."""
    x = spatial.fit_rows(x, window)
    return spatial.mark_rows(F.avg_pool2d(x, window), spatial.is_sharded(x))


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsampling by an integer factor."""
    return x.repeat_interleave(factor, 2).repeat_interleave(factor, 3)


def subpixel_phase_kernel(w: torch.Tensor) -> torch.Tensor:
    """3x3 OIHW kernel -> the (2, 2, Ci, 4Co) phase kernel of the
    subpixel form of nearest-2x + 3x3 reflect conv; same sums, in the
    same order and dtype, as the JAX ``subpixel_phase_kernel``."""
    w = w.permute(2, 3, 1, 0)                                  # HWIO
    # row parity: even rows tap (x[i-1], x[i]) with (w0, w1+w2);
    # odd rows tap (x[i], x[i+1]) with (w0+w1, w2)
    we_r = torch.stack([w[0], w[1] + w[2]], dim=0)            # (2,3,ci,co)
    wo_r = torch.stack([w[0] + w[1], w[2]], dim=0)

    def _col(wr):
        return (torch.stack([wr[:, 0], wr[:, 1] + wr[:, 2]], dim=1),
                torch.stack([wr[:, 0] + wr[:, 1], wr[:, 2]], dim=1))

    wee, weo = _col(we_r)
    woe, woo = _col(wo_r)
    return torch.cat([wee, weo, woe, woo], dim=-1).contiguous()


def convtranspose_phase_kernel(w: torch.Tensor) -> torch.Tensor:
    """4x4 OIHW kernel of ConvTranspose(4, stride 2, 'SAME'), unflipped as
    flax applies it (== torch ConvTranspose2d(4, 2, 1) with the kernel
    flipped) -> (2, 2, Ci, 4Co) phase kernel over the zero-padded input:
    output (2i+pr, 2j+pc) takes input (i+pr+di-1, j+pc+dj-1) with tap
    ``w[2di+pr, 2dj+pc]``."""
    w = w.permute(2, 3, 1, 0)                                  # HWIO
    return torch.cat([w[pr::2, pc::2] for pr in (0, 1) for pc in (0, 1)],
                     dim=-1).contiguous()


class Upsample(nn.Module):
    """2x upsampling: nearest + 3x3 reflect conv (``no_conv_t=True``) or
    ConvTranspose(4, 2, 1); no bias.

    Eval: ``x`` may be a tensor or a tuple of channel parts standing for
    their concat (split-skip); ``leaky`` and ``bn`` fold the preceding
    LeakyReLU and the following eval BatchNorm into the same decoder op
    (``ops/decoder.py``), which every call goes through.

    Train: :meth:`train_forward`, the JAX package's unfused training
    math, differentiable: the subpixel phase conv over the edge-padded
    input then depth-to-space (nearest), or ``conv_transpose2d`` with the
    flipped kernel (ConvTranspose)."""

    def __init__(self, cin: int, cout: int, no_conv_t: bool = True):
        super().__init__()
        self.no_conv_t = no_conv_t
        k = 3 if no_conv_t else 4
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.frozen: tuple | None = None

    def phase_kernel(self, dtype: torch.dtype) -> torch.Tensor:
        """(2, 2, Ci, 4Co) phase kernel built from the weight cast to the
        compute dtype (the JAX order: cast, then combine taps)."""
        w = self.weight.to(dtype)
        return (subpixel_phase_kernel(w) if self.no_conv_t
                else convtranspose_phase_kernel(w))

    @torch.no_grad()
    def freeze(self, dtype: torch.dtype, bn: BatchNorm | None = None) -> None:
        """Build the phase kernel (in the compute ``dtype``) and ``bn``'s
        phase-tiled affine once, for every later eval forward. For
        weights that no longer change: a later change of the weights,
        their dtype or device needs another ``freeze`` (``MNet.train``
        drops it)."""
        scale4, bias4 = bn.affine(tile=4) if bn is not None else (None, None)
        self.frozen = (self.phase_kernel(dtype), scale4, bias4)

    @spatial.native
    def forward(self, x, *, leaky: bool = False,
                bn: BatchNorm | None = None) -> torch.Tensor:
        parts = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        split = is_split(self)
        if self.frozen is not None:
            w4, scale4, bias4 = self.frozen
        else:
            w4 = self.phase_kernel(parts[0].dtype)
            scale4, bias4 = (bn.affine(tile=4) if bn is not None
                             else (None, None))
        if bn is not None and is_split(bn) != split:
            raise ValueError("an Upsample and its BatchNorm split alike")
        crop = None
        if any(spatial.is_sharded(p) for p in parts):
            # K1 on the slab plus one neighbour row a side: output rows
            # 2i, 2i+1 read input rows i-1 .. i+1; the image's own top
            # and bottom keep the kernel's edge or zero pad
            h = parts[0].shape[2] if spatial.is_sharded(parts[0]) else \
                parts[1].shape[2]
            halos = [spatial.exchange_halo(
                p if spatial.is_sharded(p) else spatial.split_rows(p), 1, 1)
                for p in parts]
            parts = tuple(t for t, _, _ in halos)
            crop = (2 * halos[0][1], 2 * halos[0][1] + 2 * h)
        parts = tuple(p.contiguous(memory_format=torch.channels_last)
                      for p in parts)
        y = decoder_upsample(parts, w4, scale4, bias4, leaky=leaky,
                             zero_pad=not self.no_conv_t)
        y = gather_channels(y, self) if split else y
        return y if crop is None else spatial.crop_rows(y, *crop)

    def train_forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial.is_sharded(x):
            raise RuntimeError("spatial sharding is forward only: "
                               "Upsample.train_forward on row slabs")
        split = is_split(self)
        if split:
            x = copy_to_model(x, self)
        w = self.weight.to(x.dtype)
        if not self.no_conv_t:
            y = F.conv_transpose2d(x, w.transpose(0, 1).flip(2, 3),
                                   stride=2, padding=1)
        else:
            n, _, h, wd = x.shape
            k = subpixel_phase_kernel(w).permute(3, 2, 0, 1)  # (4Co,Ci,2,2)
            y = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), k)
            y = subpixel_depth_to_space(y, h, wd, w.shape[0])
        return gather_channels(y, self) if split else y


def get_activation(key: str | None) -> Callable | None:
    """Output activation by key: sigmoid / tanh / htanh / none."""
    if key is None or key == "none":
        return None
    if key == "sigmoid":
        return torch.sigmoid
    if key == "tanh":
        return torch.tanh
    if key == "htanh":
        return lambda x: torch.clamp(x, -1.0, 1.0)
    raise ValueError(f"unknown activation: {key}")


_CONVS = (ConvReflect, Conv, ConvTranspose, Upsample)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Random init matching flax's defaults in distribution: conv and
    transposed-conv kernels LeCun-normal (truncated at 2 sigma, fan-in =
    kh*kw*cin), biases 0, BatchNorm identity (weight 1, bias 0, mean 0,
    var 1)."""
    for m in module.modules():
        if isinstance(m, _CONVS):
            fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


@torch.no_grad()
def apply_dcgan_init_(module: nn.Module, generator: torch.Generator,
                      bn_scale_mean: float = 1.0,
                      stddev: float = 0.02) -> None:
    """DCGAN re-init, the JAX ``apply_dcgan_init``: every conv and
    transposed-conv kernel ~ N(0, stddev), every bias 0, every BatchNorm
    scale ~ N(bn_scale_mean, stddev); running statistics untouched.
    ``bn_scale_mean=0.0`` reproduces the reference's N(0, .02) BN-scale
    init. Values are drawn on the CPU from ``generator`` (a CPU
    generator), in module order, and copied to the weights' device."""
    def normal(t, mean):
        t.copy_(torch.empty(t.shape).normal_(mean, stddev,
                                             generator=generator))

    for m in module.modules():
        if isinstance(m, _CONVS):
            normal(m.weight, 0.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            normal(m.weight, bn_scale_mean)
            m.bias.zero_()
