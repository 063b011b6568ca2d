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
4. :func:`mnet_apply_folded` with ``qparams``: every conv runs on
   ``ops/int8_conv`` (s8 x s8 -> s32 on the tensor cores). The serving
   route (no ``quant_sites``) quantizes each conv's output in its
   epilogue (``int8_conv_quantized``) straight into the padded int8
   inputs of the sites that read it, with their LeakyReLUs in
   ``compute_dtype``; only the stems' inputs go through ``quantize_pad``
   and only the finals return a (f32) tensor. The selective form quantizes
   each int8 site's input by ``quantize_pad`` and returns its output in
   ``compute_dtype``, the elementwise chain between them in that dtype.
   The decoder's ``(u, link)`` pairs stay apart: two channel ranges of
   one int8 tensor, or two parts.

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
    int8_conv_quantized,
    pad_weight,
    padded_input,
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


def int8_wiring(co: dict, depth: int = 4) -> dict:
    """The int8 MNet's graph as the fused route wires it: for each site
    whose output feeds other sites (the stem, ``down{i}``, ``up{j}``;
    not the final), its output's destinations in order, each
    ``(site, channels, c_off, leaky, reflect)``: the padded input of
    ``site``, which holds ``channels`` real channels, written from
    channel ``c_off`` after ``leaky`` LeakyReLUs, reflect-padded (the
    encoder) or edge-padded (the decoder). ``co`` maps each site to its
    output's channels. The stem's ``y`` feeds down0 (``leaky(y)``) and
    the final's second part (the link ``leaky(y)``; the final applies
    none); down_i's feeds down_{i+1} and its link's decoder site
    (``leaky(leaky(y))``: the link, then the site's own LeakyReLU), the
    last one's up0 (``leaky(y)``); up_j's ``u`` the next site's first
    part (``leaky(u)``), the last one's the final's (``u``): the graph
    of :func:`mnet_apply_folded`'s int8 sites."""
    enc = ["stem"] + [f"down{i}" for i in range(depth)]
    dec = [f"up{j}" for j in range(depth)] + ["final"]
    # decoder site j reads (u of dec[j - 1], the link of enc[depth - j])
    first = {dec[j]: co[dec[j - 1]] for j in range(1, depth + 1)}
    first["up0"] = co[enc[depth]]
    width = {enc[i + 1]: co[enc[i]] for i in range(depth)}
    width["up0"] = first["up0"]
    for j in range(1, depth + 1):
        width[dec[j]] = first[dec[j]] + co[enc[depth - j]]
    wiring = {}
    for i, site in enumerate(enc):
        if i < depth:       # y_i: the next encoder site, y_i's link
            link = dec[depth - i]
            wiring[site] = [(enc[i + 1], width[enc[i + 1]], 0, 1, True),
                            (link, width[link], first[link],
                             1 if link == "final" else 2, False)]
        else:
            wiring[site] = [("up0", width["up0"], 0, 1, False)]
    for j in range(depth):
        nxt = dec[j + 1]
        wiring[dec[j]] = [(nxt, width[nxt], 0, int(nxt != "final"), False)]
    return wiring


def _int8_fused(q: dict, x: torch.Tensor, depth: int,
                cd: torch.dtype) -> torch.Tensor:
    """The int8 forward with each conv's output quantized in its epilogue
    into the padded int8 inputs that read it (``int8_conv_quantized``),
    as :func:`int8_wiring` wires them, bit for bit the graph of
    :func:`mnet_apply_folded`'s int8 sites. Each site's input is
    allocated once, a decoder site's when its link is produced. Only
    the stem's input goes through ``quantize_pad``; the final returns
    f32 ``(N, Co, H, W)``."""
    n = x.shape[0]
    sites = ["stem"] + [f"down{i}" for i in range(depth)] + \
        [f"up{j}" for j in range(depth)]
    co = {s: q[s + "_w"].shape[0] // (4 if s.startswith("up") else 1)
          for s in sites}
    xq = quantize_pad((x,), q["stem_sx"], leaky=False, reflect=True)
    bufs = {"stem": xq}
    for site, dests in int8_wiring(co, depth).items():
        xq = bufs[site]
        phase = site.startswith("up")
        h, w = xq.shape[1] - 2, xq.shape[2] - 2
        h, w = (2 * h, 2 * w) if phase else (h // 2, w // 2)
        for to, channels, *_ in dests:
            if to not in bufs:
                bufs[to] = padded_input(n, h, w, channels, x.device)
        int8_conv_quantized(
            xq, pad_weight(q[site + "_w"]), q[site + "_s"],
            q.get(site + "_b"), phase=phase, compute_dtype=cd,
            dests=[(bufs[to], q[to + "_sx"], leaky, reflect, c_off)
                   for to, _, c_off, leaky, reflect in dests])
    return int8_conv(bufs["final"], pad_weight(q["final_w"]), q["final_s"],
                     phase=True, out_dtype=torch.float32)


def mnet_apply_folded(folded: dict | None, x: torch.Tensor, depth: int = 4,
                      activation: str = "tanh", observe: bool = False,
                      qparams: dict | None = None,
                      quant_sites: frozenset | None = None,
                      compute_dtype: torch.dtype = torch.float32):
    """Eval-mode MNet forward from folded (or quantized) params; ``x`` is
    (N, C, H, W).

    - folded params, ``observe=False``  -> y          (f32 reference)
    - folded params, ``observe=True``   -> (y, amax)  (calibration)
    - ``qparams`` set                   -> y          (int8 convs, each
      quantizing its output in its epilogue into the next sites' padded
      inputs: ``_int8_fused``; with ``observe`` the unfused route, as the
      selective form runs it)
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
        if qparams is not None and quant_sites is None and not observe:
            y = _int8_fused(qparams, x, depth, cd)
            return _activate(y, activation)
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
    y = _activate(y, activation)
    return (y, amax) if observe else y


def _activate(y: torch.Tensor, activation: str) -> torch.Tensor:
    """The output activation, in f32."""
    if activation == "tanh":
        return torch.tanh(y)
    if activation == "sigmoid":
        return torch.sigmoid(y)
    if activation == "htanh":
        return torch.clamp(y, -1.0, 1.0)
    return y


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


def kernel_pack(q: dict) -> dict:
    """An int8 pack with its weights as the kernels take them, made once:
    padded (``pad_weight``), and the final's (Co 1 or 3) expanded to the
    3x3 window, where ``int8_conv`` takes its four phases in one tile
    (``all_phase_weight``)."""
    def prepare(k, v):
        if not k.endswith("_w"):
            return v
        return all_phase_weight(pad_weight(v)) if k == "final_w" \
            else pad_weight(v)

    return {k: prepare(k, v) for k, v in q.items()}


def make_stacked_int8(q1: dict, q2: dict, depth: int = 4,
                      activation: str = "tanh",
                      compute_dtype: torch.dtype = torch.bfloat16):
    """(q1, q2) -> ``fn(x) -> (matte, shadow_free)``, both f32 NCHW, on
    the packs' :func:`kernel_pack`."""
    q1, q2 = kernel_pack(q1), kernel_pack(q2)

    def fn(x):
        m = mnet_apply_folded(None, x, depth=depth, activation=activation,
                              qparams=q1, compute_dtype=compute_dtype)
        y = mnet_apply_folded(None, torch.cat([x.float(), m], 1),
                              depth=depth, activation=activation,
                              qparams=q2, compute_dtype=compute_dtype)
        return m, y

    return fn
