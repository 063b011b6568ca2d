"""Post-training int8 quantization of the stacked MNet pair for serving.

Port of ``shadow_removal_istd_tpu/models/quant.py``, under its names:

1. :func:`fold_mnet` folds each eval BatchNorm into the conv before it
   (conv -> BN becomes conv' + bias) from the port's :class:`MNet`
   module, into a flat dict of f32 tensors (OIHW kernels). The folded
   f32 forward (:func:`mnet_apply_folded`) is the eval-mode MNet.
2. Calibration: :func:`mnet_apply_folded` with ``observe=True`` also
   returns the max |activation| at every conv input;
   :func:`calibrate_mnet` keeps the running max over batches.
3. :func:`quantize_mnet`: symmetric int8, one weight scale per output
   channel (per phase channel over the 4*Co axis of the decoder's phase
   kernels, after ``subpixel_phase_kernel``), one activation scale per
   tensor.
4. :func:`mnet_apply_folded` with ``qparams``: every conv input is
   quantized and padded by ``ops/int8_conv.quantize_pad`` and convolved
   by ``ops/int8_conv.int8_conv`` (s8 x s8 -> s32 on the tensor cores,
   dequantized in its epilogue); the elementwise chain between them runs
   in ``compute_dtype``. The decoder's ``(u, link)`` pairs stay apart.

The pack's layouts are the port's: ``{site}_w`` int8 ``(rows, kh, kw,
Ci)`` (K contiguous, as the kernel reads it; the stem's Ci is padded to
16 channels by ``int8_conv.pad_weight`` at use), ``{site}_s`` f32
(rows,), ``{site}_sx`` a 0-d f32 tensor, ``{site}_b`` f32 (Co,).
Activations are NCHW (``channels_last`` memory). The folded f32 forward,
calibration and the unquantized sites of a selective forward are plain
PyTorch (cuDNN convs, TF32 off), as the JAX package runs them through
``lax.conv``. Only the MNet nearest-upsample decoder quantizes.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
import torch.nn.functional as F

from shadow_removal_istd_tpu_torch.models.layers import (
    reflect_pad,
    subpixel_phase_kernel,
)
from shadow_removal_istd_tpu_torch.ops.decoder import subpixel_depth_to_space
from shadow_removal_istd_tpu_torch.ops.int8_conv import (
    all_phase_weight,
    int8_conv,
    pad_weight,
    quantize_pad,
)
from shadow_removal_istd_tpu_torch.ops.int8_conv import leaky_relu as _leaky


def _bn_fold(kernel: torch.Tensor, bn, eps: float = 1e-5):
    """conv(no bias) -> eval-BN  ==  conv(kernel * s) + b (OIHW, f32)."""
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + eps)
    b = bn.bias.float() - bn.running_mean.float() * s
    return kernel.float() * s.view(-1, 1, 1, 1), b


@torch.no_grad()
def fold_mnet(model, eps: float = 1e-5) -> dict:
    """Fold BatchNorm into conv weights -> flat folded dict (all f32):
    ``stem`` (ngf, ci, 4, 4); ``down{i}_w``/``_b``; ``up{i}_w``/``_b``
    (i in decoder application order, innermost first, as
    ``MNet.ups``); ``final``. Takes the port's MNet (nearest-upsample
    decoder)."""
    if not model.final.no_conv_t:
        raise ValueError(
            "int8 PTQ supports the MNet nearest-upsample decoder "
            "(no_conv_t/NN-upconv); this param tree has a ConvTranspose "
            "decoder — train with --NN-upconv or serve it in bf16")
    f = {"stem": model.stem.weight.detach().float().clone()}
    for i, down in enumerate(model.downs):
        f[f"down{i}_w"], f[f"down{i}_b"] = _bn_fold(down.conv.weight,
                                                    down.bn, eps)
    for i, up in enumerate(model.ups):
        f[f"up{i}_w"], f[f"up{i}_b"] = _bn_fold(up.up.weight, up.bn, eps)
    f["final"] = model.final.weight.detach().float().clone()
    return f


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` as an IEEE division on every device (CUDA turns a
    division by a host scalar into a product with its reciprocal)."""
    return a / torch.as_tensor(b, dtype=a.dtype, device=a.device)


def _wscale(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric weight scale (first axis)."""
    amax = w.abs().amax(dim=tuple(range(1, w.ndim)))
    return _div(torch.clamp(amax, min=1e-12), 127.0)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8 (half to even)."""
    return torch.clamp(torch.round(_div(x, scale)), -127, 127).to(torch.int8)


def _phase_rows(w: torch.Tensor) -> torch.Tensor:
    """3x3 OIHW decoder kernel -> its (4Co, 2, 2, Ci) phase kernel."""
    return subpixel_phase_kernel(w).permute(3, 0, 1, 2).contiguous()


@torch.no_grad()
def quantize_mnet(folded: dict, act_scales: dict, depth: int = 4) -> dict:
    """Folded f32 params + calibrated activation amaxes -> int8 pack.

    The decoder and final kernels are quantized AFTER the subpixel phase
    transform, so the quantization error is taken on the kernel that
    runs; each of the 4*Co phase channels has its own scale."""
    q: dict[str, Any] = {}

    def pack(name, w):              # w: (rows, kh, kw, ci) f32
        sw = _wscale(w)
        q[name + "_w"] = _quantize(w, sw.view(-1, 1, 1, 1))
        sx = _div(torch.clamp(act_scales[name].float(), min=1e-12), 127.0)
        q[name + "_s"] = (sx * sw).float()       # dequant scale
        q[name + "_sx"] = sx.float()             # input quant

    pack("stem", folded["stem"].permute(0, 2, 3, 1))
    for i in range(depth):
        pack(f"down{i}", folded[f"down{i}_w"].permute(0, 2, 3, 1))
        q[f"down{i}_b"] = folded[f"down{i}_b"]
        pack(f"up{i}", _phase_rows(folded[f"up{i}_w"]))
        q[f"up{i}_b"] = folded[f"up{i}_b"]
    pack("final", _phase_rows(folded["final"]))
    return {k: v.contiguous() for k, v in q.items()}


@contextlib.contextmanager
def _full_f32():
    """cuDNN convolutions without TF32 inside (the folded f32 forward is
    the reference the int8 forward is held to)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


ENCODER_SITES = frozenset(
    ["stem"] + [f"down{i}" for i in range(8)])


def mnet_apply_folded(folded: dict | None, x: torch.Tensor, depth: int = 4,
                      activation: str = "tanh", observe: bool = False,
                      qparams: dict | None = None,
                      quant_sites: frozenset | None = None,
                      compute_dtype: torch.dtype = torch.float32):
    """Eval-mode MNet forward from folded (or quantized) params; ``x`` is
    (N, C, H, W).

    - folded params, ``observe=False``  -> y          (f32 reference)
    - folded params, ``observe=True``   -> (y, amax)  (calibration)
    - ``qparams`` set                   -> y          (int8 convs)
    - ``qparams`` + ``quant_sites``     -> SELECTIVE int8: only the
      named sites run int8 convs; the rest run the folded weights in
      ``compute_dtype`` (pass ``folded`` too); :data:`ENCODER_SITES`
      quantizes the stride-2 encoder only.

    The graph of models/mnet.py in eval: stem conv; depth x (leaky ->
    4x4s2 conv + bias); depth x (leaky -> subpixel up conv + bias ->
    the post-leaky encoder link beside it); the final subpixel up conv;
    the output activation, in f32."""
    amax: dict[str, torch.Tensor] = {}
    if quant_sites is not None and qparams is not None and folded is None:
        raise ValueError("selective int8 needs the folded f32 params for "
                         "the unquantized sites")
    cd = compute_dtype

    def obs(name, *ts):
        if observe:
            amax[name] = torch.stack(
                [t.abs().amax().float() for t in ts]).amax()

    def q(name):
        if qparams is None:
            return None
        if quant_sites is not None and name not in quant_sites:
            return None
        return qparams[name + "_sx"], qparams[name + "_s"]

    def bias(name):
        src = folded if (qparams is None or quant_sites is not None) \
            else qparams
        return src[name + "_b"]

    def conv_s2(a, name, b):
        """4x4 stride-2 reflect conv (+ bias), cast to the compute
        dtype."""
        qs = q(name)
        if qs is not None:
            xq = quantize_pad((a,), qs[0], leaky=False, reflect=True)
            return int8_conv(xq, pad_weight(qparams[name + "_w"]), qs[1], b,
                             phase=False, out_dtype=cd)
        w = folded[name if name == "stem" else name + "_w"]
        y = F.conv2d(reflect_pad(a, 1), w.to(a.dtype), stride=2)
        return y.to(cd) if b is None else (y + b.view(1, -1, 1, 1)).to(cd)

    def phase_conv(parts, name, leaky, b, out_dtype):
        """leaky (optional) over the parts' concat -> subpixel phase conv
        (+ bias) -> ``out_dtype``."""
        qs = q(name)
        if qs is not None:
            xq = quantize_pad(parts, qs[0], leaky=leaky, reflect=False)
            return int8_conv(xq, pad_weight(qparams[name + "_w"]), qs[1], b,
                             phase=True, out_dtype=out_dtype)
        w4 = subpixel_phase_kernel(
            folded["final" if name == "final" else name + "_w"])
        z = torch.cat([_leaky(p) if leaky else p for p in parts], 1)
        _, _, h, w = z.shape
        y = F.conv2d(F.pad(z, (1, 1, 1, 1), mode="replicate"),
                     w4.permute(3, 2, 0, 1).to(z.dtype))
        u = subpixel_depth_to_space(y, h, w, w4.shape[-1] // 4)
        if b is not None:
            u = (u + b.view(1, -1, 1, 1)).to(cd)
        return u.to(out_dtype)

    with _full_f32():
        x = x.to(cd).contiguous(memory_format=torch.channels_last)
        obs("stem", x)
        y = conv_s2(x, "stem", None)
        links = []
        for i in range(depth):
            a = _leaky(y)
            links.append(a)
            obs(f"down{i}", a)
            y = conv_s2(a, f"down{i}", bias(f"down{i}"))
        # ups[j] is the j-th APPLIED block (innermost first) and sits
        # beside links[depth-1-j]
        parts = (y,)
        for j in range(depth):
            if observe:
                obs(f"up{j}", *[_leaky(p) for p in parts])
            u = phase_conv(parts, f"up{j}", True, bias(f"up{j}"), cd)
            parts = (u, links[depth - 1 - j])
        obs("final", *parts)
        y = phase_conv(parts, "final", False, None, torch.float32)
    if activation == "tanh":
        y = torch.tanh(y)
    elif activation == "sigmoid":
        y = torch.sigmoid(y)
    elif activation == "htanh":
        y = torch.clamp(y, -1.0, 1.0)
    return (y, amax) if observe else y


@torch.no_grad()
def calibrate_mnet(folded: dict, batches, depth: int = 4,
                   activation: str = "tanh",
                   return_outputs: bool = False):
    """Run representative batches, return per-site activation amaxes
    (and, with ``return_outputs``, the forward outputs: the observe pass
    computes them anyway, so stacked calibration reuses them as G2
    inputs instead of re-running G1)."""
    scales: dict | None = None
    outputs = []
    for x in batches:
        y, amax = mnet_apply_folded(folded, x, depth=depth,
                                    activation=activation, observe=True)
        outputs.append(y)
        scales = amax if scales is None else {
            k: torch.maximum(scales[k], amax[k]) for k in scales}
    if scales is None:
        raise ValueError("need at least one calibration batch")
    return (scales, outputs) if return_outputs else scales


# ---------------------------------------------------------------------------
# Stacked G1+G2 pair


def fold_stacked(state):
    """The port's TrainState (anything with ``models.g1``/``models.g2``)
    -> (folded_g1, folded_g2)."""
    return fold_mnet(state.models.g1), fold_mnet(state.models.g2)


def quantize_stacked(state, calib_batches, depth: int = 4,
                     activation: str = "tanh"):
    """PTQ the stacked pair; returns (q1, q2) int8 packs.

    ``calib_batches``: iterable of (N, 3, H, W) inputs in [-1, 1]. G2's
    calibration inputs are G1's folded-f32 outputs beside the image, as
    served."""
    f1, f2 = fold_stacked(state)
    batches = list(calib_batches)
    s1, m1 = calibrate_mnet(f1, batches, depth=depth,
                            activation=activation, return_outputs=True)
    g2_in = [torch.cat([x.float(), m], 1) for x, m in zip(batches, m1)]
    s2 = calibrate_mnet(f2, g2_in, depth=depth, activation=activation)
    return quantize_mnet(f1, s1, depth=depth), \
        quantize_mnet(f2, s2, depth=depth)


def make_stacked_int8(q1: dict, q2: dict, depth: int = 4,
                      activation: str = "tanh",
                      compute_dtype: torch.dtype = torch.bfloat16):
    """(q1, q2) -> ``fn(x) -> (matte, shadow_free)``, both f32 NCHW; the
    weights are padded for the kernels once, here, and the finals' (Co 1
    and 3) expanded to the 3x3 window, where ``int8_conv`` takes their
    four phases in one tile (``all_phase_weight``)."""
    def prepare(k, v):
        if not k.endswith("_w"):
            return v
        return all_phase_weight(pad_weight(v)) if k == "final_w" \
            else pad_weight(v)

    q1, q2 = ({k: prepare(k, v) for k, v in q.items()} for q in (q1, q2))

    def fn(x):
        m = mnet_apply_folded(None, x, depth=depth, activation=activation,
                              qparams=q1, compute_dtype=compute_dtype)
        y = mnet_apply_folded(None, torch.cat([x.float(), m], 1),
                              depth=depth, activation=activation,
                              qparams=q2, compute_dtype=compute_dtype)
        return m, y

    return fn
