"""Int8 convolutions of the quantized MNet forward: CUDA kernels and
their plain versions.

The JAX package's int8 post-training quantization
(``shadow_removal_istd_tpu/models/quant.py``) runs every conv of the MNet
forward as ``lax.conv_general_dilated`` on int8 operands with s32
accumulation, after quantizing and padding its input, and dequantizes
after it. PyTorch has no int8 convolution, so the port splits each conv
site into two hand-written kernels (``csrc/int8_conv.cu``):

- :func:`quantize_pad`: one or two channel parts standing for their
  concat (the decoder's ``(u, link)``; never concatenated) -> optional
  LeakyReLU(0.2) in the compute dtype -> ``clip(rint(x / sx), -127,
  127)`` in f32 -> an int8 NHWC tensor padded by 1 (reflect for the
  encoder's 4x4 stride-2 convs, edge for the decoder's 2x2 phase convs)
  and by zero channels up to a multiple of 16 (:func:`channels_padded`);
- :func:`int8_conv`: the conv of that tensor with int8 weights kept
  ``(rows, kh, kw, Cp)`` (:func:`pad_weight`), s32 sums, and the
  epilogue ``(float)acc * scale[row] (+ bias[co])`` cast to the output
  dtype; the phase form (2x2, Ci -> 4Co) stores in depth-to-space order
  and computes only what depth-to-space keeps; a phase weight expanded
  to the 3x3 window (:func:`all_phase_weight`, the finals' form: Co <= 4)
  takes the four phases in one tile. Without a scale it returns the s32
  sums; where the kernel splits K (:func:`conv_plan`) the launch
  (:func:`launch`) allocates its zeroed workspace;
- :func:`int8_conv_quantized`: ``int8_conv`` whose epilogue writes, in
  place of its output, the padded int8 inputs of the sites that read it
  (1 or 2 destinations, each with its scale, LeakyReLU count, pad and
  channel offset): ``quantize_pad`` fused into the producing conv, so
  the int8 forward keeps no bf16 or f32 activation between its convs.

Activations are NCHW in ``channels_last`` memory, as in the rest of the
port. A CPU tensor takes the plain version, which is the kernels' spec; a
CUDA tensor launches the kernel (counted in ``quantize_pad.launches`` and
``int8_conv.launches``, which counts the fused call too, as
``int8_conv_quantized.launches`` does apart) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from shadow_removal_istd_tpu_torch.ops import _build
from shadow_removal_istd_tpu_torch.ops.decoder import subpixel_depth_to_space

_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
CHANNEL_ALIGN = 16   # one 16-byte chunk of int8 channels


def channels_padded(c: int) -> int:
    """The int8 tensors' channel count for ``c`` channels: the next
    multiple of 16 (the kernels move 16-byte chunks)."""
    return -(-c // CHANNEL_ALIGN) * CHANNEL_ALIGN


def pad_weight(w: torch.Tensor) -> torch.Tensor:
    """An int8 ``(rows, kh, kw, Ci)`` weight with its input channels
    zero-padded to :func:`channels_padded`; contiguous."""
    extra = channels_padded(w.shape[-1]) - w.shape[-1]
    return (F.pad(w, (0, extra)) if extra else w).contiguous()


@functools.cache
def _slope(dtype: torch.dtype) -> float:
    return torch.tensor(0.2, dtype=dtype).item()


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2) as JAX computes it in ``x``'s dtype: ``x * slope``
    rounded to the dtype, the slope 0.2 itself rounded to the dtype first
    (a weakly typed 0.2 times a bf16 array is bf16(0.2) = 0.2001953125
    times it; torch's ``leaky_relu(x, 0.2)`` multiplies by 0.2f)."""
    return F.leaky_relu(x, _slope(x.dtype))


def quantize_pad_plain(parts: Sequence[torch.Tensor], sx: torch.Tensor, *,
                       leaky: bool, reflect: bool) -> torch.Tensor:
    """The kernel's spec: ``parts`` (N, C_p, H, W) in one dtype, their
    concat -> leaky (optional, in that dtype) -> ``clip(round(x / sx),
    -127, 127)`` in f32 (round half to even) -> pad 1 (reflect or edge)
    -> (N, H + 2, W + 2, Cp) int8, channels past the concat zero."""
    xs = [(leaky_relu(x) if leaky else x).float() for x in parts]
    x = torch.cat(xs, 1) if len(xs) > 1 else xs[0]
    q = torch.clamp(torch.round(x / sx), -127, 127)
    q = F.pad(q, (1, 1, 1, 1), mode="reflect" if reflect else "replicate")
    q = q.to(torch.int8).permute(0, 2, 3, 1)
    extra = channels_padded(q.shape[-1]) - q.shape[-1]
    return F.pad(q, (0, extra)).contiguous()


def int8_conv_plain(xq: torch.Tensor, wk: torch.Tensor,
                    scale: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None, *, phase: bool,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's spec: the conv of the padded int8 ``xq`` (N, Hp, Wp,
    Cp) with ``wk`` (rows, kh, kw, Cp), exact: int8 products and their
    sums (|sum| < 2^31) are integers that float64 holds exactly, in any
    order. Encoder form (``phase=False``): 4x4 stride 2 -> (N, rows, Ho,
    Wo). Phase form: 2x2 stride 1 -> (N, 4Co, H+1, W+1) -> depth-to-space
    -> (N, Co, 2H, 2W); with an :func:`all_phase_weight` (3x3) it is 3x3
    stride 1 -> (N, 4Co, H, W), phase p's block at its pixels. Then
    ``acc.float() * scale`` (+ ``bias``) and the cast to ``out_dtype``;
    without ``scale`` the int32 sums. NCHW in ``channels_last`` memory."""
    x = xq.permute(0, 3, 1, 2).double()
    k = wk.permute(0, 3, 1, 2).double()
    acc = F.conv2d(x, k, stride=1 if phase else 2).to(torch.int32)
    co = wk.shape[0] // 4 if phase else wk.shape[0]
    h, w = xq.shape[1] - 2, xq.shape[2] - 2

    def to_space(y):
        if not phase:
            return y
        if wk.shape[1] == 2:
            return subpixel_depth_to_space(y, h, w, co)
        # row (2 pr + pc) Co + c at (i, j) -> pixel (2i + pr, 2j + pc)
        return y.view(-1, 2, 2, co, h, w).permute(0, 3, 4, 1, 5, 2).reshape(
            -1, co, 2 * h, 2 * w)

    if scale is None:
        return to_space(acc).contiguous(memory_format=torch.channels_last)
    y = to_space(acc.float() * scale.view(1, -1, 1, 1))
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    return y.to(out_dtype).contiguous(memory_format=torch.channels_last)


def int8_conv_quantized_plain(xq: torch.Tensor, wk: torch.Tensor,
                              scale: torch.Tensor,
                              bias: torch.Tensor | None = None, *,
                              phase: bool, compute_dtype: torch.dtype,
                              dests: Sequence[tuple]) -> None:
    """The fused kernel's spec, the composition it replaces:
    :func:`int8_conv_plain` cast to ``compute_dtype``, then for each
    destination ``(buf, sx, leaky, reflect, c_off)`` LeakyReLU ``leaky``
    (0, 1 or 2) times in that dtype and :func:`quantize_pad_plain`'s
    quantize and pad, written into ``buf[..., c_off:c_off + Co]`` in
    place; ``buf``'s other channels are left as they are."""
    y = int8_conv_plain(xq, wk, scale, bias, phase=phase,
                        out_dtype=compute_dtype)
    co = y.shape[1]
    for buf, sx, leaky, reflect, c_off in dests:
        a = y
        for _ in range(leaky):
            a = leaky_relu(a)
        q = quantize_pad_plain((a,), sx, leaky=False, reflect=reflect)
        buf[..., c_off:c_off + co] = q[..., :co]


def padded_input(n: int, h: int, w: int, channels: int,
                 device) -> torch.Tensor:
    """An (n, h + 2, w + 2, Cp) int8 destination for :func:`int8_conv_
    quantized` whose parts fill ``channels`` channels: zeros where Cp
    has channels past them (:func:`channels_padded`; no part writes
    them), else uninitialised (the parts write every byte)."""
    cp = channels_padded(channels)
    alloc = torch.zeros if cp != channels else torch.empty
    return alloc((n, h + 2, w + 2, cp), dtype=torch.int8, device=device)


@functools.cache
def _fns():
    """The C entry points (built on first use), typed once: quantize_pad,
    then :func:`conv_entries`."""
    lib = _build.load("int8_conv")
    return (quantize_pad_entry(lib), *conv_entries(lib))


def quantize_pad_entry(lib: ctypes.CDLL):
    """A loaded build of ``csrc/int8_conv.cu``'s ``srit_quantize_pad``,
    typed (what :func:`launch_quantize_pad` takes)."""
    qp = lib.srit_quantize_pad
    qp.restype = ctypes.c_int
    qp.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return qp


def conv_entries(lib: ctypes.CDLL) -> tuple:
    """A loaded build of ``csrc/int8_conv.cu``'s conv entries, typed:
    ``srit_int8_conv``, ``srit_int8_conv_split`` (K split over a
    workspace) and ``srit_int8_conv_plan`` (what :func:`launch` takes)."""
    cv = lib.srit_int8_conv
    cv.restype = ctypes.c_int
    cv.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    split = lib.srit_int8_conv_split
    split.restype = ctypes.c_int
    split.argtypes = (cv.argtypes[:-1]
                      + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
    plan = lib.srit_int8_conv_plan
    plan.restype = ctypes.c_int
    plan.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
    return cv, split, plan


@functools.cache
def _quantized_fn():
    """The fused C entry ``srit_int8_conv_quantized`` (built on first
    use), typed."""
    fn = _build.load("int8_conv").srit_int8_conv_quantized
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p] * 3
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
    return fn


def all_phase_weight(wk: torch.Tensor) -> torch.Tensor:
    """A phase-form weight (4Co, 2, 2, Cp) as the same conv over the 3x3
    window, (4Co, 3, 3, Cp): phase p = (pr, pc)'s taps at (pr + di, pc +
    dj), zero elsewhere. :func:`int8_conv` then takes the four phases in
    one tile (each input gathered once, not four times for 1-3 columns:
    the finals' form); the layer that owns the weight expands it once."""
    rows, _, _, cp = wk.shape
    w4 = wk.reshape(4, rows // 4, 2, 2, cp)
    w9 = wk.new_zeros((4, rows // 4, 3, 3, cp))
    for p in range(4):
        pr, pc = divmod(p, 2)
        w9[p, :, pr:pr + 2, pc:pc + 2] = w4[p]
    return w9.view(rows, 3, 3, cp)


def _geometry(xq: torch.Tensor, wk: torch.Tensor, phase: bool):
    """(n, hp, wp, cp, ho, wo, co) of a checked call: the output grid per
    phase and the output channels."""
    n, hp, wp, cp = xq.shape
    co = wk.shape[0] // 4 if phase else wk.shape[0]
    ho, wo = (hp - 2, wp - 2) if phase else ((hp - 2) // 2, (wp - 2) // 2)
    return n, hp, wp, cp, ho, wo, co


def _form(phase: bool, kt: int) -> int:
    """The kernel's form: 0 encoder (4x4), 1 phase (2x2, a tile per
    phase), 2 all four phases in one tile over the 3x3 window."""
    return 0 if not phase else 1 if kt == 2 else 2


def conv_plan(xq: torch.Tensor, wk: torch.Tensor, *, phase: bool) -> dict:
    """The launch the kernel makes for these operands on their card:
    ``bm`` x ``bn`` output tiles, ``splits`` of K (over taps), ``stages``
    of its ring, ``ws_words`` int32 words of split-K workspace (0 when K
    is not split), ``blocks``, ``taps`` (16, 4, or 9 for the all-phase
    form), ``a_tma`` (1 where the activation tiles arrive by TMA, 0
    where they are gathered by ``cp.async``), ``images`` (the images a
    TMA box spans: 1, or more where one image is smaller than a tile)
    and ``m_tiles`` (output tiles along M). Needs the built library (a
    card)."""
    *_, plan = _fns()
    return _plan(plan, _geometry(xq, wk, phase), _form(phase, wk.shape[1]),
                 xq.device.index)


_PLAN_KEYS = ("bm", "bn", "splits", "stages", "ws_words", "blocks", "taps",
              "a_tma", "images", "m_tiles")
_PLAN_FN = ctypes.CFUNCTYPE(ctypes.c_int, *[ctypes.c_int] * 8,
                            ctypes.POINTER(ctypes.c_longlong))


def _plan(plan, geo: tuple, form: int, index: int) -> dict:
    """:func:`conv_plan` for one shape on card ``index`` from the C entry
    ``plan``, asked once a shape (ctypes functions do not hash: the
    cache is keyed by the entry's address)."""
    return dict(_plan_at(ctypes.cast(plan, ctypes.c_void_p).value, geo,
                         form, index))


@functools.lru_cache(maxsize=256)
def _plan_at(addr: int, geo: tuple, form: int, index: int) -> tuple:
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    with torch.cuda.device(index):
        rc = _PLAN_FN(addr)(*geo, form, out)
    if rc != 0:
        raise ValueError(f"int8_conv takes no such shapes (cudaError {rc})")
    return tuple(zip(_PLAN_KEYS, out))


def launch(entries, xq, wk, scale, bias, phase: bool,
           out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of the kernel through ``entries`` = (``srit_int8_conv``,
    ``srit_int8_conv_split``, ``srit_int8_conv_plan``) of a build of
    ``csrc/int8_conv.cu`` (:func:`_fns`'s, or another build's with the
    same C ABI) on checked, contiguous operands on ``xq``'s card: the
    output, and where the plan splits K a zeroed int32 workspace, are
    allocated here. Counts nothing."""
    conv, split, plan = entries
    dev = xq.device
    geo = _geometry(xq, wk, phase)
    n, hp, wp, cp, ho, wo, co = geo
    oh, ow = (2 * ho, 2 * wo) if phase else (ho, wo)
    out = torch.empty((n, co, oh, ow), dtype=out_dtype, device=dev,
                      memory_format=torch.channels_last)
    form = _form(phase, wk.shape[1])
    words = _plan(plan, geo, form, dev.index)["ws_words"]
    with torch.cuda.device(dev):
        args = (xq.data_ptr(), wk.data_ptr(),
                scale.data_ptr() if scale is not None else None,
                bias.data_ptr() if bias is not None else None,
                out.data_ptr(), _OUT_DTYPES[out_dtype], *geo, form)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if words:
            ws = torch.zeros(words, dtype=torch.int32, device=dev)
            rc = split(*args, ws.data_ptr(), words, stream)
        else:
            rc = conv(*args, stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv kernel launch failed (cudaError {rc})")
    return out


def launch_quantized(fn, xq, wk, scale, bias, phase: bool,
                     compute_dtype: torch.dtype, bufs, sxs, leaky, reflect,
                     c_off) -> None:
    """One launch of the fused kernel through ``fn`` (:func:`_quantized_
    fn`'s entry) on checked, contiguous operands on ``xq``'s card, the
    destinations given as the op takes them; a zeroed int32 workspace is
    allocated where the plan splits K. Counts nothing."""
    dev = xq.device
    geo = _geometry(xq, wk, phase)
    *_, plan = _fns()
    words = _plan(plan, geo, _form(phase, wk.shape[1]), dev.index)[
        "ws_words"]
    nd = len(bufs)
    outs = (ctypes.c_void_p * nd)(*[b.data_ptr() for b in bufs])
    scales = (ctypes.c_void_p * nd)(*[t.data_ptr() for t in sxs])
    meta = (ctypes.c_int * (4 * nd))(*[
        v for b, lk, rf, co in zip(bufs, leaky, reflect, c_off)
        for v in (b.shape[3], co, lk, int(rf))])
    with torch.cuda.device(dev):
        ws = (torch.zeros(words, dtype=torch.int32, device=dev) if words
              else None)
        rc = fn(xq.data_ptr(), wk.data_ptr(), scale.data_ptr(),
                bias.data_ptr() if bias is not None else None,
                _IN_DTYPES[compute_dtype], *geo, _form(phase, wk.shape[1]),
                nd, outs, scales, meta,
                ws.data_ptr() if ws is not None else None, words,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv_quantized kernel launch failed "
                           f"(cudaError {rc})")


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """``x`` (N, C, H, W) as channels-last memory (a view when it is)."""
    return x if x.permute(0, 2, 3, 1).is_contiguous() else x.contiguous(
        memory_format=torch.channels_last)


def _device_kind(t: torch.Tensor, op: str) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{op} runs on cuda or cpu, not {kind}")
    return kind


def quantize_pad(parts: Sequence[torch.Tensor], sx: torch.Tensor, *,
                 leaky: bool, reflect: bool) -> torch.Tensor:
    """Quantize 1 or 2 (N, C_p, H, W) parts, standing for their channel
    concat, with the per-tensor scale ``sx`` (a 0-d f32 tensor on their
    device) into a padded (N, H + 2, W + 2, Cp) int8 tensor (see
    :func:`quantize_pad_plain`). CUDA tensors launch the kernel."""
    parts = tuple(parts)
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"expected 1 or 2 parts, got {len(parts)}")
    x0 = parts[0]
    n, _, h, w = x0.shape
    for x in parts:
        if x.dim() != 4 or (x.shape[0], x.shape[2], x.shape[3]) != (n, h, w):
            raise ValueError("parts must share N, H and W: "
                             f"{[tuple(x.shape) for x in parts]}")
        if x.dtype != x0.dtype or x.device != x0.device:
            raise ValueError("parts must share one dtype and device")
    if x0.dtype not in _IN_DTYPES:
        raise TypeError(f"quantize_pad takes float32 or bfloat16, got "
                        f"{x0.dtype}")
    if sx.numel() != 1 or sx.dtype != torch.float32:
        raise ValueError("sx must be one float32 value")
    if reflect and (h < 2 or w < 2):
        raise ValueError(f"reflect pad 1 of a {h}x{w} input")
    if _device_kind(x0, "quantize_pad") == "cpu":
        return quantize_pad_plain(parts, sx, leaky=leaky, reflect=reflect)
    if sx.device != x0.device:
        raise ValueError(f"sx must be on {x0.device}")
    out = launch_quantize_pad(_fns()[0], parts, sx, leaky=leaky,
                              reflect=reflect)
    quantize_pad.launches += 1
    return out


def launch_quantize_pad(qp, parts: Sequence[torch.Tensor],
                        sx: torch.Tensor, *, leaky: bool,
                        reflect: bool) -> torch.Tensor:
    """One launch of ``srit_quantize_pad`` through ``qp`` (:func:`_fns`'s,
    or another build's with the same C ABI) on checked parts on one
    card; the output is allocated here. Counts nothing."""
    xs = [_nhwc(x) for x in parts]
    n, c0, h, w = xs[0].shape
    c1 = xs[1].shape[1] if len(xs) == 2 else 0
    out = torch.empty((n, h + 2, w + 2, channels_padded(c0 + c1)),
                      dtype=torch.int8, device=xs[0].device)
    with torch.cuda.device(xs[0].device):
        rc = qp(_IN_DTYPES[xs[0].dtype], xs[0].data_ptr(),
                xs[1].data_ptr() if c1 else None, c0, c1,
                sx.contiguous().data_ptr(), out.data_ptr(), n, h, w,
                out.shape[3], int(leaky), int(reflect),
                torch.cuda.current_stream(xs[0].device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize_pad kernel launch failed "
                           f"(cudaError {rc})")
    return out


quantize_pad.launches = 0


def int8_conv(xq: torch.Tensor, wk: torch.Tensor,
              scale: torch.Tensor | None = None,
              bias: torch.Tensor | None = None, *, phase: bool,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The conv of a :func:`quantize_pad` output ``xq`` with the int8
    weight ``wk`` (rows, kh, kw, Cp) (``kh = kw = 4`` for the encoder
    form; with ``phase`` rows = 4Co and kh = kw = 2, or 3 for an
    :func:`all_phase_weight`), dequantized by ``scale`` (rows,) and
    ``bias`` (Co,) into ``out_dtype``, or the int32 sums without
    ``scale``. Returns NCHW in ``channels_last`` memory (see
    :func:`int8_conv_plain`). CUDA tensors launch the kernel."""
    _check_conv(xq, wk, scale, bias, phase)
    if scale is None:
        out_dtype = torch.int32
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32, bfloat16 or int32, "
                        f"got {out_dtype}")
    _device_kind(xq, "int8_conv")
    return int8_conv_op(xq, wk, scale, bias, phase, out_dtype)


int8_conv.launches = 0


def _check_conv(xq, wk, scale, bias, phase: bool) -> int:
    """The conv operands' checks (shapes, dtypes; a bias needs a scale);
    returns the output channels."""
    if xq.dtype != torch.int8 or wk.dtype != torch.int8:
        raise TypeError("xq and wk must be int8")
    ks = (2, 3) if phase else (4,)
    if (xq.dim() != 4 or wk.dim() != 4 or wk.shape[1] not in ks
            or wk.shape[2] != wk.shape[1] or wk.shape[3] != xq.shape[3]
            or xq.shape[3] % CHANNEL_ALIGN):
        raise ValueError(f"xq (N, Hp, Wp, Cp) with Cp a multiple of 16 and "
                         f"wk (rows, k, k, Cp) with k in {ks}; got "
                         f"{tuple(xq.shape)} and {tuple(wk.shape)}")
    rows = wk.shape[0]
    if phase and rows % 4:
        raise ValueError(f"the phase form needs 4*Co weight rows, got {rows}")
    co = rows // 4 if phase else rows
    hp, wp = xq.shape[1:3]
    if not phase and (hp % 2 or wp % 2):
        raise ValueError(f"the 4x4 stride-2 form needs an even padded "
                         f"size, got {hp}x{wp}")
    if scale is None:
        if bias is not None:
            raise ValueError("a bias needs a scale")
    elif scale.shape != (rows,) or (bias is not None
                                    and bias.shape != (co,)):
        raise ValueError(f"scale must be ({rows},) and bias ({co},)")
    return co


def int8_conv_quantized(xq: torch.Tensor, wk: torch.Tensor,
                        scale: torch.Tensor,
                        bias: torch.Tensor | None = None, *, phase: bool,
                        compute_dtype: torch.dtype,
                        dests: Sequence[tuple]) -> None:
    """:func:`int8_conv` (the encoder or the 2x2 phase form, dequantized
    by ``scale``, ``bias`` optional) whose epilogue quantizes into 1 or 2
    padded int8 inputs of the sites that read its output, in place of
    returning it. Each destination is ``(buf, sx, leaky, reflect,
    c_off)``: ``buf`` an int8 (N, Ho + 2, Wo + 2, Cp) tensor (Ho x Wo the
    output grid, Cp a multiple of 16, contiguous), ``sx`` its 0-d f32
    scale, ``leaky`` the LeakyReLUs (0, 1 or 2, in ``compute_dtype``)
    before the quantize, ``reflect`` its pad (else edge), and ``c_off``
    the first of the Co channels written (see
    :func:`int8_conv_quantized_plain`). CUDA tensors launch the kernel,
    counted in ``int8_conv.launches`` and
    ``int8_conv_quantized.launches``."""
    if scale is None:
        raise ValueError("the fused quantize needs a scale")
    co = _check_conv(xq, wk, scale, bias, phase)
    if phase and wk.shape[1] != 2:
        raise ValueError("the fused quantize takes the 2x2 phase form, not "
                         "an all-phase weight")
    if compute_dtype not in _IN_DTYPES:
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")
    dests = tuple(dests)
    if not 1 <= len(dests) <= 2:
        raise ValueError(f"expected 1 or 2 destinations, got {len(dests)}")
    n, hp, wp, _ = xq.shape
    oh, ow = (2 * (hp - 2), 2 * (wp - 2)) if phase else ((hp - 2) // 2,
                                                          (wp - 2) // 2)
    for buf, sx, leaky, reflect, c_off in dests:
        if (buf.dtype != torch.int8 or buf.dim() != 4
                or tuple(buf.shape[:3]) != (n, oh + 2, ow + 2)
                or buf.shape[3] % CHANNEL_ALIGN or not buf.is_contiguous()):
            raise ValueError(f"a destination must be a contiguous int8 "
                             f"({n}, {oh + 2}, {ow + 2}, Cp) with Cp a "
                             f"multiple of 16, got {buf.dtype} "
                             f"{tuple(buf.shape)}")
        if not 0 <= c_off <= buf.shape[3] - co:
            raise ValueError(f"channels {c_off}..{c_off + co} lie outside "
                             f"the destination's {buf.shape[3]}")
        if leaky not in (0, 1, 2):
            raise ValueError(f"leaky counts 0, 1 or 2, got {leaky}")
        if sx.numel() != 1 or sx.dtype != torch.float32:
            raise ValueError("sx must be one float32 value")
        if reflect and (oh < 2 or ow < 2):
            raise ValueError(f"reflect pad 1 of a {oh}x{ow} output")
        if buf.device != xq.device or sx.device != xq.device:
            raise ValueError(f"destinations and scales must be on "
                             f"{xq.device}")
    _device_kind(xq, "int8_conv_quantized")
    bufs, sxs, leaky, reflect, c_off = (list(t) for t in zip(*dests))
    int8_conv_quantized_op(xq, wk, scale, bias, phase, compute_dtype, bufs,
                           [t.reshape(()) for t in sxs], leaky, reflect,
                           c_off)


int8_conv_quantized.launches = 0


@torch.library.custom_op(
    "srit::int8_conv", mutates_args=(),
    schema="(Tensor xq, Tensor wk, Tensor? scale, Tensor? bias, bool phase, "
           "ScalarType out_dtype) -> Tensor")
def int8_conv_op(xq, wk, scale, bias, phase, out_dtype):
    """:func:`int8_conv` after its checks, as the registered op
    ``srit::int8_conv``, so a ``FlopCounterMode`` sees it
    (``utils/flops.py``) and a fake or meta tensor gets its shape."""
    raise ValueError(f"int8_conv runs on cuda or cpu, not "
                     f"{xq.device.type}")


def _out_shape(xq, wk, phase) -> tuple[int, int, int, int]:
    n, hp, wp, _ = xq.shape
    rows = wk.shape[0]
    if phase:
        return n, rows // 4, 2 * (hp - 2), 2 * (wp - 2)
    return n, rows, (hp - 2) // 2, (wp - 2) // 2


@int8_conv_op.register_kernel("cpu")
def _int8_conv_cpu(xq, wk, scale, bias, phase, out_dtype):
    return int8_conv_plain(xq, wk, scale, bias, phase=phase,
                           out_dtype=out_dtype)


@int8_conv_op.register_fake
def _int8_conv_fake(xq, wk, scale, bias, phase, out_dtype):
    return xq.new_empty(_out_shape(xq, wk, phase), dtype=out_dtype).contiguous(
        memory_format=torch.channels_last)


@int8_conv_op.register_kernel("cuda")
def _int8_conv_cuda(xq, wk, scale, bias, phase, out_dtype):
    """Launch the kernel (:func:`launch`), counted in
    ``int8_conv.launches``."""
    dev = xq.device
    for t in (wk, scale, bias):
        if t is not None and t.device != dev:
            raise ValueError(f"int8_conv operands must be on {dev}")
    for t in (scale, bias):
        if t is not None and t.dtype != torch.float32:
            raise TypeError("scale and bias must be float32")
    out = launch(_fns()[1:], xq.contiguous(), wk.contiguous(),
                 scale.contiguous() if scale is not None else None,
                 bias.contiguous() if bias is not None else None, phase,
                 out_dtype)
    int8_conv.launches += 1
    return out


@torch.library.custom_op("srit::int8_conv_quantized", mutates_args=("bufs",))
def int8_conv_quantized_op(xq: torch.Tensor, wk: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor | None,
                           phase: bool, compute_dtype: torch.dtype,
                           bufs: list[torch.Tensor], sxs: list[torch.Tensor],
                           leaky: list[int], reflect: list[bool],
                           c_off: list[int]) -> None:
    """:func:`int8_conv_quantized` after its checks, as the registered op
    ``srit::int8_conv_quantized`` (``bufs`` written in place)."""
    raise ValueError(f"int8_conv_quantized runs on cuda or cpu, not "
                     f"{xq.device.type}")


@int8_conv_quantized_op.register_kernel("cpu")
def _int8_conv_quantized_cpu(xq, wk, scale, bias, phase, compute_dtype,
                             bufs, sxs, leaky, reflect, c_off):
    int8_conv_quantized_plain(xq, wk, scale, bias, phase=phase,
                              compute_dtype=compute_dtype,
                              dests=zip(bufs, sxs, leaky, reflect, c_off))


@int8_conv_quantized_op.register_fake
def _int8_conv_quantized_fake(xq, wk, scale, bias, phase, compute_dtype,
                              bufs, sxs, leaky, reflect, c_off):
    return None


@int8_conv_quantized_op.register_kernel("cuda")
def _int8_conv_quantized_cuda(xq, wk, scale, bias, phase, compute_dtype,
                              bufs, sxs, leaky, reflect, c_off):
    """Launch the fused kernel (:func:`launch_quantized`), counted in
    ``int8_conv.launches`` and ``int8_conv_quantized.launches``."""
    dev = xq.device
    for t in (wk, scale, bias):
        if t is not None and t.device != dev:
            raise ValueError(f"int8_conv_quantized operands must be on "
                             f"{dev}")
    for t in (scale, bias):
        if t is not None and t.dtype != torch.float32:
            raise TypeError("scale and bias must be float32")
    launch_quantized(_quantized_fn(), xq.contiguous(), wk.contiguous(),
                     scale.contiguous(),
                     bias.contiguous() if bias is not None else None, phase,
                     compute_dtype, bufs, [t.contiguous() for t in sxs],
                     leaky, reflect, c_off)
    int8_conv.launches += 1
    int8_conv_quantized.launches += 1
