"""The MNet decoder step as one op, with its CUDA kernels and plain version.

Port of ``shadow_removal_istd_tpu/ops/pallas_decoder.py``
(``fused_decoder_upsample``): LeakyReLU(0.2) -> 2x2 subpixel phase conv
-> eval-BatchNorm affine in f32 -> cast -> depth-to-space. In the port it
carries every decoder layer of MNet, in both upsample forms:

- nearest-2x + 3x3 reflect conv: the phase conv over the EDGE-padded
  input (``models/layers.subpixel_phase_kernel``);
- ConvTranspose(4, 2, 1): the same phase conv over the ZERO-padded input
  (``models/layers.convtranspose_phase_kernel``).

The input may be one tensor or the split-skip parts ``(y, link)``, which
stand for their channel concatenation and share one ``w4``; the concat is
never formed. The final MNet layer runs without LeakyReLU and without the
affine (``leaky=False``, no ``scale4``/``bias4``).

Tensors are NCHW in ``channels_last`` memory. ``w4`` keeps the JAX
package's ``(2, 2, Ci, 4*Co)`` layout. Every call goes through the
registered op ``srit::decoder_upsample`` (``torch.library``), so a
``torch.export`` graph holds the step as one node and serves it through
the kernels (``tools/export.py``); a fake kernel gives the output's
shape while tracing. A CPU tensor goes to :func:`decoder_upsample_plain`,
which is the kernels' spec. A CUDA tensor goes to one of three
hand-written kernels, chosen by shape (:func:`decoder_variant`):

- ``narrow`` (``csrc/decoder_upsample_narrow.cu``): Co <= 4 in either
  dtype, i.e. the Co 1/3 final layer; one pass over a spatial tile that
  reads each input element once for all four phases and taps. In bf16 an
  implicit GEMM over the 3x3 window on the tensor cores (``mma.sync``,
  A by ``ldmatrix`` from the halo, N the 4 phases x Co), its halo chunks
  in a 4-stage ring fed by TMA (element loads for a misaligned or ragged
  part; :func:`narrow_plan` reports the route); in f32 FMAs on the CUDA
  cores, fed the same way (a persistent block an SM, 32-channel halo
  chunks by TMA into a 2-stage ring, the swizzled records read in place,
  coalesced depth-to-space stores);
- ``tensor_core`` (``csrc/decoder_upsample_tc.cu``): bf16 with Co >= 32,
  every channel count a multiple of 8 and 16-byte aligned tensors, i.e.
  every MNet step at ngf 64 but the final one; ``wgmma`` with A from
  registers (each tap's fragment by ``ldmatrix`` from the tile's halo)
  and the weights by TMA, a persistent block an SM fed by a producer
  thread through a ring of 32- or 64-channel stages;
- ``cuda_core`` (``csrc/decoder_upsample.cu``): everything else (f32 and
  ragged channel counts with Co >= 5), an implicit GEMM per phase with
  FMAs on the CUDA cores, register-blocked (8x8 outputs a thread in
  128x128 or 128x64 tiles) and pipelined (the next K chunk's loads in
  flight during the FMAs, two shared-memory buffers).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from shadow_removal_istd_tpu_torch.ops import _build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# variant -> (csrc/<library>.cu, C entry point); all share one signature
_KERNELS = {
    "tensor_core": ("decoder_upsample_tc", "srit_decoder_upsample_tc"),
    "cuda_core": ("decoder_upsample", "srit_decoder_upsample"),
    "narrow": ("decoder_upsample_narrow", "srit_decoder_upsample_narrow"),
}


def subpixel_depth_to_space(y: torch.Tensor, h: int, w: int,
                            co: int) -> torch.Tensor:
    """(N, 4Co, H+1, W+1) phase-conv output -> (N, Co, 2H, 2W).

    Phase ``(pr, pc)`` (channels ``(2pr+pc)*Co ...``) fills output pixel
    ``(2i+pr, 2j+pc)`` from phase-grid position ``(i+pr, j+pc)``."""
    n = y.shape[0]
    yee = y[:, 0 * co:1 * co, :h, :w]
    yeo = y[:, 1 * co:2 * co, :h, 1:]
    yoe = y[:, 2 * co:3 * co, 1:, :w]
    yoo = y[:, 3 * co:4 * co, 1:, 1:]
    rows0 = torch.stack([yee, yeo], dim=-1)            # (n, co, h, w, 2)
    rows1 = torch.stack([yoe, yoo], dim=-1)
    out = torch.stack([rows0, rows1], dim=3)           # (n, co, h, 2, w, 2)
    return out.reshape(n, co, 2 * h, 2 * w).contiguous(
        memory_format=torch.channels_last)


def decoder_upsample_plain(parts: Sequence[torch.Tensor], w4: torch.Tensor,
                           scale4: torch.Tensor | None = None,
                           bias4: torch.Tensor | None = None, *,
                           leaky: bool,
                           zero_pad: bool = False) -> torch.Tensor:
    """The kernel's spec in plain PyTorch: leaky (in the input dtype) ->
    edge or zero pad -> ``F.conv2d`` with the phase kernel, summed over
    parts in f32 -> affine -> cast -> depth-to-space.

    The conv runs in f32 on the input-dtype values, so the only rounding
    to the input dtype is the final cast, as in the kernel. On a GPU a
    caller that compares this with the kernel in f32 turns TF32 off
    (``torch.backends.cudnn.allow_tf32 = False``)."""
    dtype = parts[0].dtype
    n, _, h, w = parts[0].shape
    co = w4.shape[-1] // 4
    acc, off = None, 0
    for x in parts:
        c = x.shape[1]
        a = F.leaky_relu(x, 0.2) if leaky else x
        a = F.pad(a.float(), (1, 1, 1, 1),
                  mode="constant" if zero_pad else "replicate")
        k = w4[:, :, off:off + c].float().permute(3, 2, 0, 1)
        y = F.conv2d(a, k)                              # (n, 4co, h+1, w+1)
        acc = y if acc is None else acc + y
        off += c
    if scale4 is not None:
        acc = acc * scale4.float().view(1, -1, 1, 1) \
            + bias4.float().view(1, -1, 1, 1)
    return subpixel_depth_to_space(acc.to(dtype), h, w, co)


def narrow_weight(w4: torch.Tensor) -> torch.Tensor:
    """The narrow kernel's B in plain PyTorch: ``w4`` (2, 2, Ci, 4Co) as
    one weight over the 3x3 window, (3, 3, Ci, N) with N = 4Co padded to 8
    (Co <= 2) or 16: phase p = (pr, pc) reads tap (pr + di, pc + dj) with
    ``w4[di, dj]``, and is zero at the 5 taps it skips and in the padded
    columns. The kernel builds the same values in shared memory, in mma
    fragment order, one 32-channel chunk at a time."""
    _, _, ci, co4 = w4.shape
    co = co4 // 4
    b = w4.new_zeros((3, 3, ci, 8 if co <= 2 else 16))
    for p in range(4):
        pr, pc = divmod(p, 2)
        b[pr:pr + 2, pc:pc + 2, :, p * co:(p + 1) * co] = \
            w4[:, :, :, p * co:(p + 1) * co]
    return b


def decoder_upsample_all_phase(parts: Sequence[torch.Tensor],
                               w4: torch.Tensor,
                               scale4: torch.Tensor | None = None,
                               bias4: torch.Tensor | None = None, *,
                               leaky: bool,
                               zero_pad: bool = False) -> torch.Tensor:
    """:func:`decoder_upsample_plain` in the narrow kernel's form, for
    tests: each input position's 4 phases x Co from one conv over its 3x3
    window with :func:`narrow_weight`, summed over parts in f32, the
    padded columns dropped, affine, cast, and each position's 2 x 2 x Co
    outputs put at (2i + pr, 2j + pc). The main path never calls it."""
    dtype = parts[0].dtype
    n, _, h, w = parts[0].shape
    co = w4.shape[-1] // 4
    b = narrow_weight(w4)
    acc, off = None, 0
    for x in parts:
        c = x.shape[1]
        a = F.leaky_relu(x, 0.2) if leaky else x
        a = F.pad(a.float(), (1, 1, 1, 1),
                  mode="constant" if zero_pad else "replicate")
        y = F.conv2d(a, b[:, :, off:off + c].float().permute(3, 2, 0, 1))
        acc = y if acc is None else acc + y
        off += c
    acc = acc[:, :4 * co]                               # (n, 4co, h, w)
    if scale4 is not None:
        acc = acc * scale4.float().view(1, -1, 1, 1) \
            + bias4.float().view(1, -1, 1, 1)
    y = acc.to(dtype).view(n, 2, 2, co, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, co, 2 * h, 2 * w).contiguous(
        memory_format=torch.channels_last)


def _check(parts: tuple[torch.Tensor, ...], w4: torch.Tensor,
           scale4: torch.Tensor | None,
           bias4: torch.Tensor | None) -> int:
    """Validate shapes shared by both paths; returns Co."""
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"expected 1 or 2 input parts, got {len(parts)}")
    n, _, h, w = parts[0].shape
    for x in parts:
        if x.dim() != 4 or (x.shape[0], x.shape[2], x.shape[3]) != (n, h, w):
            raise ValueError("input parts must share N, H and W: "
                             f"{[tuple(x.shape) for x in parts]}")
        if x.dtype != parts[0].dtype:
            raise ValueError("input parts must share one dtype")
    ci = sum(x.shape[1] for x in parts)
    if w4.dim() != 4 or w4.shape[:3] != (2, 2, ci) or w4.shape[3] % 4:
        raise ValueError(f"w4 must be (2, 2, {ci}, 4*Co), got "
                         f"{tuple(w4.shape)}")
    co = w4.shape[3] // 4
    if (scale4 is None) != (bias4 is None):
        raise ValueError("scale4 and bias4 come together")
    if scale4 is not None and (scale4.shape != (4 * co,)
                               or bias4.shape != (4 * co,)):
        raise ValueError(f"scale4/bias4 must be ({4 * co},)")
    return co


def decoder_variant(dtype: torch.dtype, ci0: int, ci1: int, co: int,
                    aligned: bool) -> str:
    """The kernel that runs a decoder step on the card: ``"narrow"`` for
    ``1 <= co <= 4``, whatever the dtype, channel counts and alignment;
    ``"tensor_core"`` for bf16 with ``co >= 32``, ``ci0``, ``ci1`` (0 for
    one part) and ``co`` multiples of 8 and every tensor 16-byte
    ``aligned``; ``"cuda_core"`` for everything else."""
    if 1 <= co <= 4:
        return "narrow"
    if (dtype == torch.bfloat16 and co >= 32 and aligned
            and ci0 % 8 == 0 and ci1 % 8 == 0 and co % 8 == 0):
        return "tensor_core"
    return "cuda_core"


def _aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


@functools.cache
def _kernel_fn(variant: str):
    """A variant's C entry point (built on first use), typed once."""
    lib, entry = _KERNELS[variant]
    fn = getattr(_build.load(lib), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return fn


_LOADS = {0: "tma", 2: "scalar"}


@functools.cache
def _plan_fn():
    """The narrow kernel's plan entry (built on first use), typed once."""
    fn = _build.load("decoder_upsample_narrow") \
        .srit_decoder_upsample_narrow_plan
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return fn


def narrow_plan(parts: Sequence[torch.Tensor], co: int) -> dict:
    """The launch the narrow kernel makes for these inputs on the current
    card (its C entry ``srit_decoder_upsample_narrow_plan``): ``route``
    (``"tensor_core"`` in bf16, ``"cuda_core"`` in f32), each part's
    ``loads`` (``"tma"`` or ``"scalar"``, i.e. element by element),
    ``stages``, ``tile`` (rows, columns), ``blocks`` (persistent, at most
    one an SM), ``resident`` (every chunk's weights kept in shared memory
    for the launch), ``n_cols`` (the GEMM's N: 8 or 16 in bf16, 4 Co in
    f32) and ``tiles``."""
    x0 = parts[0]
    if x0.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x0.dtype}")
    n, ci0, h, w = x0.shape
    x1 = parts[1] if len(parts) == 2 else None
    plan = (ctypes.c_longlong * 10)()
    with torch.cuda.device(x0.device):
        rc = _plan_fn()(_KERNEL_DTYPES[x0.dtype], x0.data_ptr(),
                x1.data_ptr() if x1 is not None else None, ci0,
                x1.shape[1] if x1 is not None else 0, n, h, w, co, plan)
    if rc != 0:
        raise RuntimeError(f"narrow plan refused these inputs "
                           f"(cudaError {rc})")
    v = list(plan)
    return {"route": "tensor_core" if v[0] else "cuda_core",
            "loads": tuple(_LOADS[k] for k in v[1:3] if k != -1),
            "stages": v[3], "tile": (v[4], v[5]), "blocks": v[6],
            "resident": bool(v[7]), "n_cols": v[8],
            "tiles": v[9]}


def _launch(parts: tuple[torch.Tensor, ...], w4: torch.Tensor,
            scale4: torch.Tensor | None, bias4: torch.Tensor | None,
            co: int, leaky: bool, zero_pad: bool,
            variant: str | None = None) -> tuple[torch.Tensor, str]:
    """Launch the kernel :func:`decoder_variant` picks, or ``variant``
    (a timing run's side-by-side only); returns (output, variant)."""
    x0 = parts[0]
    dev, dtype = x0.device, x0.dtype
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {dtype}")
    for x in parts:
        if x.device != dev or not x.is_contiguous(
                memory_format=torch.channels_last):
            raise ValueError("kernel inputs must be channels_last tensors "
                             f"on {dev}")
    if w4.device != dev or w4.dtype != dtype or not w4.is_contiguous():
        raise ValueError(f"w4 must be a contiguous {dtype} tensor on {dev}")
    if scale4 is not None:
        for t in (scale4, bias4):
            if (t.device != dev or t.dtype != torch.float32
                    or not t.is_contiguous()):
                raise ValueError("scale4/bias4 must be contiguous float32 "
                                 f"on {dev}")
    n, ci0, h, w = x0.shape
    ci1 = parts[1].shape[1] if len(parts) == 2 else 0
    out = torch.empty((n, co, 2 * h, 2 * w), dtype=dtype, device=dev,
                      memory_format=torch.channels_last)
    if variant is None:
        variant = decoder_variant(dtype, ci0, ci1, co,
                                  _aligned(*parts, w4, out))
    with torch.cuda.device(dev):
        rc = _kernel_fn(variant)(_KERNEL_DTYPES[dtype], x0.data_ptr(),
                parts[1].data_ptr() if ci1 else None, ci0, ci1,
                w4.data_ptr(),
                scale4.data_ptr() if scale4 is not None else None,
                bias4.data_ptr() if bias4 is not None else None,
                out.data_ptr(), n, h, w, co, int(leaky), int(zero_pad),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decoder_upsample {variant} kernel launch "
                           f"failed (cudaError {rc})")
    return out, variant


@torch.library.custom_op(
    "srit::decoder_upsample", mutates_args=(),
    schema="(Tensor[] parts, Tensor w4, Tensor? scale4, Tensor? bias4, "
           "bool leaky, bool zero_pad) -> Tensor")
def decoder_upsample_op(parts, w4, scale4, bias4, leaky, zero_pad):
    """The decoder step as the registered op ``srit::decoder_upsample``:
    what :func:`decoder_upsample` calls, and what a ``torch.export``
    graph of the decoder holds (``tools/export.py``). Forward only: no
    autograd formula is registered (training runs
    ``layers.Upsample.train_forward``)."""
    raise ValueError(f"decoder_upsample runs on cuda or cpu, not "
                     f"{parts[0].device.type}")


@decoder_upsample_op.register_kernel("cpu")
def _cpu(parts, w4, scale4, bias4, leaky, zero_pad):
    parts = tuple(parts)
    _check(parts, w4, scale4, bias4)
    return decoder_upsample_plain(parts, w4, scale4, bias4, leaky=leaky,
                                  zero_pad=zero_pad)


@decoder_upsample_op.register_kernel("cuda")
def _cuda(parts, w4, scale4, bias4, leaky, zero_pad):
    """Launch the kernel :func:`decoder_variant` picks, counted. The
    inputs are made ``channels_last``-contiguous first, so an exported
    graph cannot hand the kernel another layout (``_launch`` refuses
    one)."""
    parts = tuple(p.contiguous(memory_format=torch.channels_last)
                  for p in parts)
    co = _check(parts, w4, scale4, bias4)
    out, variant = _launch(parts, w4.contiguous(), scale4, bias4, co, leaky,
                           zero_pad)
    decoder_upsample.launches += 1
    decoder_upsample.launches_by_variant[variant] += 1
    return out


@decoder_upsample_op.register_fake
def _fake(parts, w4, scale4, bias4, leaky, zero_pad):
    """(N, Co, 2H, 2W) in the input dtype, ``channels_last``; N may be
    symbolic."""
    co = _check(tuple(parts), w4, scale4, bias4)
    n, _, h, w = parts[0].shape
    return parts[0].new_empty((n, co, 2 * h, 2 * w)).contiguous(
        memory_format=torch.channels_last)


def decoder_upsample(parts: Sequence[torch.Tensor], w4: torch.Tensor,
                     scale4: torch.Tensor | None = None,
                     bias4: torch.Tensor | None = None, *, leaky: bool,
                     zero_pad: bool = False) -> torch.Tensor:
    """One MNet decoder step; ``parts`` are 1 or 2 (N, Ci_p, H, W) tensors
    standing for their channel concat. Returns (N, Co, 2H, 2W) in the
    input dtype, ``channels_last``.

    Every call goes through the op ``srit::decoder_upsample``
    (:func:`decoder_upsample_op`): CUDA tensors launch the kernel
    :func:`decoder_variant` picks (counted in
    ``decoder_upsample.launches`` and, by variant, in
    ``decoder_upsample.launches_by_variant``, an exported graph's
    launches included); CPU tensors take :func:`decoder_upsample_plain`;
    any other device raises."""
    kind = parts[0].device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"decoder_upsample runs on cuda or cpu, not {kind}")
    return decoder_upsample_op(list(parts), w4, scale4, bias4, leaky,
                               zero_pad)


decoder_upsample.launches = 0
decoder_upsample.launches_by_variant = dict.fromkeys(_KERNELS, 0)
