"""The yardstick's arithmetic: published peaks, and the operations and
bytes that the measured work needs, counted from shapes.

Conventions (frozen here, so that later changes to the program cannot
move them):

- a convolution costs 2 * output positions * Cout * Cin * KH * KW; a
  transposed convolution its useful FLOPs only, 2 * input positions *
  Cin * Cout * KH * KW;
- an inference MNet decoder step (the K1 op) counts, for MFU, the 2x2
  phase convolution over the one-padded input, 2 * N * (H+1) * (W+1) *
  4Co * 4Ci, as the program's ``utils/flops.py`` counts it; for its
  roofline, the useful 32 * N * H * W * Ci * Co;
- a roofline's least time is the larger of the operations at the peak
  rate and the bytes at the memory rate, each input byte read once and
  each output byte written once.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
PEAK_BF16 = 989e12      # FLOP/s on the tensor cores
PEAK_F32 = 67e12        # FLOP/s outside the tensor cores (TF32 off)
PEAK_BYTES = 3.35e12    # HBM3 bytes/s


def conv(n, cin, cout, k, hout, wout) -> float:
    return 2.0 * n * hout * wout * cout * cin * k * k


def conv_t(n, cin, cout, k, hin, win) -> float:
    return 2.0 * n * hin * win * cin * cout * k * k


# -- MNet ---------------------------------------------------------------

def mnet_encoder(h, w, cin, ngf):
    """(cin, cout, k, hout, wout) of MNet's stem and 4 down convs."""
    feats = [2 * ngf, 4 * ngf, 8 * ngf, 8 * ngf]
    cins = [ngf, 2 * ngf, 4 * ngf, 8 * ngf]
    out = [(cin, ngf, 4, h // 2, w // 2)]
    for i in range(4):
        out.append((cins[i], feats[i], 4, h // 2 ** (i + 2), w // 2 ** (i + 2)))
    return out


def mnet_decoder_steps(h, w, ngf, cout):
    """The decoder steps of one MNet at h x w: (H, W, part channels, Co,
    final), input size H x W, output 2H x 2W."""
    f = [ngf, 2 * ngf, 4 * ngf, 8 * ngf]
    steps = [(h // 32, w // 32, (f[3],), f[3], False)]
    for lvl in (2, 1, 0):
        s = 2 ** (lvl + 2)
        steps.append((h // s, w // s, (f[lvl + 1],) * 2, f[lvl], False))
    steps.append((h // 2, w // 2, (ngf, ngf), cout, True))
    return steps


def stacked_mnet_flops(h, w, ngf=64, batch=1) -> float:
    """FLOPs of the stacked inference forward (G1 3->1, G2 4->3) at h x w,
    in the program's counting (the decoder steps as phase convs over the
    one-padded input)."""
    total = 0.0
    for cin, cout in ((3, 1), (4, 3)):
        total += sum(conv(batch, *c[:3], c[3], c[4])
                     for c in mnet_encoder(h, w, cin, ngf))
        for sh, sw, parts, co, _ in mnet_decoder_steps(h, w, ngf, cout):
            total += 2.0 * batch * (sh + 1) * (sw + 1) * 4 * co * 4 * sum(parts)
    return total


def k1_cost(n, h, w, parts, co, final, elt=2) -> tuple[float, float]:
    """(operations, bytes) of one K1 launch: every input byte read once
    (the parts, the phase weight, the tiled affine) and the output written
    once."""
    ci = sum(parts)
    ops = 32.0 * n * h * w * ci * co
    nbytes = (n * h * w * ci * elt + 16 * ci * co * elt
              + (0 if final else 2 * 4 * co * 4) + n * 4 * h * w * co * elt)
    return ops, float(nbytes)


def k1_least_s(n, h, w, ngf=64) -> float:
    """The least time of the 10 bf16 K1 launches of one stacked forward
    of n images at h x w."""
    total = 0.0
    for cout in (1, 3):
        for sh, sw, parts, co, final in mnet_decoder_steps(h, w, ngf, cout):
            ops, nbytes = k1_cost(n, sh, sw, parts, co, final)
            total += max(ops / PEAK_BF16, nbytes / PEAK_BYTES)
    return total


# -- training -------------------------------------------------------------

def mnet_train_layers(h, w, cin, cout, ngf):
    """[(flops per image, input needs a gradient)] of MNet's train forward
    (ConvTranspose decoder), first layer first."""
    enc = [(conv(1, *c[:3], c[3], c[4]), True) for c in mnet_encoder(h, w, cin, ngf)]
    dec = []
    up_feats = [ngf, 2 * ngf, 4 * ngf, 8 * ngf]
    cin_up = 8 * ngf
    for i in (3, 2, 1, 0):
        hin, win = h // 2 ** (i + 2), w // 2 ** (i + 2)
        dec.append((conv_t(1, cin_up, up_feats[i], 4, hin, win), True))
        cin_up = 2 * up_feats[i]
    dec.append((conv_t(1, 2 * ngf, cout, 4, h // 2, w // 2), True))
    return enc + dec


def patchgan_layers(h, w, cin, ndf):
    chans = [(cin, ndf, 4, h // 2, w // 2), (ndf, 2 * ndf, 4, h // 4, w // 4),
             (2 * ndf, 4 * ndf, 4, h // 8, w // 8),
             (4 * ndf, 8 * ndf, 3, h // 8, w // 8), (8 * ndf, 1, 3, h // 8, w // 8)]
    return [(conv(1, *c[:3], c[3], c[4]), True) for c in chans]


def pix2pix_layers(h, w, cin, cout, ngf, num_downs=8):
    inner = [ngf, 2 * ngf, 4 * ngf] + [8 * ngf] * (num_downs - 3)
    out = []
    for lv in range(num_downs):
        c0 = cin if lv == 0 else inner[lv - 1]
        out.append((conv(1, c0, inner[lv], 4, h // 2 ** (lv + 1), w // 2 ** (lv + 1)), True))
    for lv in range(num_downs):
        ci = inner[lv] if lv == num_downs - 1 else 2 * inner[lv]
        co = cout if lv == 0 else inner[lv - 1]
        out.append((conv_t(1, ci, co, 4, h // 2 ** (lv + 1), w // 2 ** (lv + 1)), True))
    return out


def nlayer_layers(h, w, cin, ndf, n_layers=3):
    mults = [min(2 ** n, 8) for n in range(n_layers + 1)]
    out, hh, ww = [], h // 2, w // 2
    out.append((conv(1, cin, ndf, 4, hh, ww), True))
    for n in range(1, n_layers + 1):
        if n < n_layers:
            hh, ww = hh // 2, ww // 2
        else:
            hh, ww = hh - 1, ww - 1
        out.append((conv(1, ndf * mults[n - 1], ndf * mults[n], 4, hh, ww), True))
    out.append((conv(1, ndf * mults[n_layers], 1, 4, hh - 1, ww - 1), True))
    return out


VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M")


def vgg_flops(h, w) -> float:
    total, cin = 0.0, 3
    for spec in VGG_CFG:
        if spec == "M":
            h, w = h // 2, w // 2
        else:
            total += conv(1, cin, spec, 3, h, w)
            cin = spec
    return total


def _fwd(layers):
    return sum(f for f, _ in layers)


def _bwd(layers, weights: bool, input_grad: bool):
    """Backward FLOPs: each layer's weight gradient (``weights``) and its
    input gradient, the first layer's only where ``input_grad``."""
    total = _fwd(layers) if weights else 0.0
    total += sum(f for i, (f, _) in enumerate(layers) if i > 0 or input_grad)
    return total


def train_step_flops_per_image(net_g, net_d, h, w, ngf, ndf,
                               visual: bool) -> float:
    """FLOPs per training image of one adversarial step (engine/steps.py's
    order): the G forward; the D phase (4 D forwards on detached inputs,
    their weight and input gradients, no input gradient at the stem); the
    G phase (4 D forwards against the updated D, input gradients through
    the two fake branches, no D weight gradient); the VGG passes (per
    visual term: prediction forward, target forward, input gradient of the
    prediction); the G backward (weight and input gradients, none into
    G1's input). Convolutions only; the augmentation's scale matmuls are
    not counted."""
    if net_g == "mnet":
        g1 = mnet_train_layers(h, w, 3, 1, ngf)
        g2 = mnet_train_layers(h, w, 4, 3, ngf)
    else:
        g1 = pix2pix_layers(h, w, 3, 1, ngf)
        g2 = pix2pix_layers(h, w, 4, 3, ngf)
    if net_d == "patchgan":
        d1, d2 = patchgan_layers(h, w, 4, ndf), patchgan_layers(h, w, 7, ndf)
    else:
        d1, d2 = nlayer_layers(h, w, 4, ndf), nlayer_layers(h, w, 7, ndf)
    g = _fwd(g1) + _fwd(g2) + _bwd(g1, True, False) + _bwd(g2, True, True)
    d_phase = 2 * (_fwd(d1) + _fwd(d2)) + 2 * (_bwd(d1, True, False)
                                               + _bwd(d2, True, False))
    g_phase = 2 * (_fwd(d1) + _fwd(d2)) + _bwd(d1, False, True) + _bwd(d2, False, True)
    vis = 6 * vgg_flops(h, w) if visual else 0.0
    return g + d_phase + g_phase + vis


# -- hshear ---------------------------------------------------------------

def shear_geometry(h, w, max_angle_deg):
    """(margin, wx, pad1, pad2, pad3) of the three-shear rotation."""
    t_max = math.radians(min(abs(max_angle_deg), 89.0))
    a_max, b_max = math.tan(t_max / 2.0), math.sin(t_max)
    margin = -(-(math.ceil(a_max * h / 2.0) + 2) // 4) * 4
    wx = w + 2 * margin
    return margin, wx, 2 * margin, math.ceil(b_max * wx / 2.0) + 4, 4


def hshear_bytes(shifts, c: int, w0: int, out_w: int, pad: int) -> float:
    """Bytes one ``hshear`` launch must move: the image columns each row's
    taps reach, read once, the output written once, the per-row start and
    fraction read once. ``shifts``: (B, H) float32 tensor."""
    import torch

    bsz, h = shifts.shape
    src = shifts.float() + pad
    kint = torch.clamp(torch.floor(src), 0, w0 + 2 * pad - out_w - 1)
    lo = (kint - pad).clamp(min=0)
    hi = (kint + out_w - pad).clamp(max=w0 - 1)
    cols = float((hi - lo + 1).clamp(min=0).sum())
    return 4.0 * c * cols + 4.0 * bsz * c * h * out_w + 8.0 * bsz * h
