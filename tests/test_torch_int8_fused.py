"""The fused quantize of the port's int8 forward on the CPU:
``ops/int8_conv.int8_conv_quantized`` (``int8_conv`` whose epilogue
writes the padded int8 inputs of the sites that read its output) and the
serving route of ``models/quant.mnet_apply_folded`` built on it.

- The op's plain spec (what the CPU runs, and what the CUDA kernel is
  held to on the card) against the composition it replaces:
  ``int8_conv_plain`` in the compute dtype, LeakyReLU 0, 1 or 2 times,
  ``quantize_pad_plain``, in the encoder and phase forms, with one and
  two destinations, reflect and edge pads, channel offsets, ragged
  channels, f32 and bf16 compute; two producers filling one decoder
  site's input equal ``quantize_pad_plain`` of its two parts.
- The fused forward against the selective all-sites forward (each int8
  site's input by ``quantize_pad``, its output in the compute dtype), bit
  for bit, for G1 and G2 inputs at ngf 8 and depth 4, in both dtypes;
  its calls (1 ``quantize_pad``, 9 fused convs, 1 final ``int8_conv``)
  and its FLOP count.
- ``int8_wiring`` (the graph the fused route and the card smoke both
  read) fills every site's input channels once, at depths 2 to 4.

Everything is integer or one rounding per step, so every comparison is
exact. Inputs and weights come from numpy seeds.
"""
from unittest import mock

import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu_torch.models import get_generator
from shadow_removal_istd_tpu_torch.models import quant as tq
from shadow_removal_istd_tpu_torch.ops.int8_conv import (
    all_phase_weight,
    channels_padded,
    int8_conv_plain,
    int8_conv_quantized,
    int8_conv_quantized_plain,
    leaky_relu,
    pad_weight,
    padded_input,
    quantize_pad_plain,
)
from shadow_removal_istd_tpu_torch.utils import flops

SITES = frozenset({"stem", "down0", "down1", "down2", "down3", "up0", "up1",
                   "up2", "up3", "final"})
DTYPES = [torch.float32, torch.bfloat16]


def _conv_operands(rng, n, h, w, ci, co, phase):
    """Random padded int8 input (the conv's input grid h x w), weight,
    scale and bias; the outputs lie around +-1."""
    cp = channels_padded(ci)
    xq = rng.integers(-127, 128, (n, h + 2, w + 2, cp)).astype(np.int8)
    xq[..., ci:] = 0
    rows, k = (4 * co, 2) if phase else (co, 4)
    wk = rng.integers(-127, 128, (rows, k, k, ci)).astype(np.int8)
    scale = rng.uniform(0.2, 1.0, rows).astype(np.float32) / (
        127.0 * 127.0 * np.sqrt(k * k * ci) / 2)
    bias = rng.normal(0, 0.3, co).astype(np.float32)
    return (torch.from_numpy(xq), pad_weight(torch.from_numpy(wk)),
            torch.from_numpy(scale), torch.from_numpy(bias))


def _sentinel(rng, shape):
    return torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8))


def _leaky_n(y, k):
    for _ in range(k):
        y = leaky_relu(y)
    return y


# (phase, n, h, w, ci, co, destinations as (leaky, reflect, c_off, cp))
CASES = [
    (False, 2, 12, 16, 16, 16, [(1, True, 0, 16)]),          # encoder input
    (False, 1, 16, 12, 32, 24, [(1, True, 0, 32),            # + a link at
                                (2, False, 24, 48)]),        # its decoder
    (False, 2, 8, 8, 16, 12, [(0, False, 20, 32)]),          # ragged Co 12
    (False, 1, 4, 6, 48, 24, [(2, True, 5, 32)]),            # odd offset
    (True, 2, 3, 5, 32, 16, [(1, False, 0, 16)]),            # up_j -> up_j+1
    (True, 1, 4, 3, 48, 24, [(0, False, 0, 32),              # up3 -> final,
                             (2, True, 8, 32)]),             # two scales
    (True, 2, 2, 2, 16, 12, [(1, True, 4, 16)]),             # ragged, 4x4
    (True, 1, 1, 1, 16, 8, [(1, False, 8, 16)]),             # a 2x2 output
]


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("phase,n,h,w,ci,co,spec", CASES)
def test_plain_spec_is_the_composition(phase, n, h, w, ci, co, spec,
                                       compute_dtype):
    """Each destination's channel range holds ``quantize_pad_plain`` of
    the conv's output (in the compute dtype) after its LeakyReLUs; its
    other channels keep what they held."""
    rng = np.random.default_rng(n * 100 + h * 10 + co)
    xq, wk, scale, bias = _conv_operands(rng, n, h, w, ci, co, phase)
    oh, ow = (2 * h, 2 * w) if phase else (h // 2, w // 2)
    y = int8_conv_plain(xq, wk, scale, bias, phase=phase,
                        out_dtype=compute_dtype)
    dests, before = [], []
    for leaky, reflect, c_off, cp in spec:
        buf = _sentinel(rng, (n, oh + 2, ow + 2, cp))
        before.append(buf.clone())
        # the top ~30 % of the range saturates
        amax = _leaky_n(y, leaky).float().abs().max()
        sx = amax * float(rng.uniform(0.6, 0.8)) / 127
        dests.append((buf, sx, leaky, reflect, c_off))
    # the wrapper (on the CPU, the op's plain kernel) and the spec itself
    copies = [(b.clone(), *rest) for b, *rest in dests]
    int8_conv_quantized(xq, wk, scale, bias, phase=phase,
                        compute_dtype=compute_dtype, dests=dests)
    int8_conv_quantized_plain(xq, wk, scale, bias, phase=phase,
                              compute_dtype=compute_dtype, dests=copies)
    for (buf, *_), (twin, *_) in zip(dests, copies):
        assert torch.equal(buf, twin)
    for (buf, sx, leaky, reflect, c_off), old in zip(dests, before):
        want = quantize_pad_plain((_leaky_n(y, leaky),), sx, leaky=False,
                                  reflect=reflect)[..., :co]
        assert torch.equal(buf[..., c_off:c_off + co], want)
        assert int(want.abs().max()) == 127      # some values saturate
        assert torch.equal(buf[..., :c_off], old[..., :c_off])
        assert torch.equal(buf[..., c_off + co:], old[..., c_off + co:])


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("co_u,co_link", [(16, 16), (12, 8)])
def test_two_producers_fill_a_decoder_input(co_u, co_link, compute_dtype):
    """A decoder site's input from its two producers (up_j's ``u`` at
    channel 0, leaky once; the encoder's link after it, leaky twice) and
    the encoder's next input from the same call equal ``quantize_pad``
    of the unfused route: ``(u, link)`` with the site's LeakyReLU, edge;
    ``leaky(y)``, reflect. Channels past the concat stay zero."""
    rng = np.random.default_rng(co_u + co_link)
    n, h, w = 2, 4, 6
    xu, wu, su, bu = _conv_operands(rng, n, h // 2, w // 2, 32, co_u, True)
    xe, we, se, be = _conv_operands(rng, n, 2 * h, 2 * w, 16, co_link, False)
    sx_up, sx_down = torch.tensor(0.011), torch.tensor(0.007)
    site = padded_input(n, h, w, co_u + co_link, "cpu")
    down = padded_input(n, h, w, co_link, "cpu")
    int8_conv_quantized(xe, we, se, be, phase=False,
                        compute_dtype=compute_dtype,
                        dests=[(down, sx_down, 1, True, 0),
                               (site, sx_up, 2, False, co_u)])
    int8_conv_quantized(xu, wu, su, bu, phase=True,
                        compute_dtype=compute_dtype,
                        dests=[(site, sx_up, 1, False, 0)])
    u = int8_conv_plain(xu, wu, su, bu, phase=True, out_dtype=compute_dtype)
    link = leaky_relu(int8_conv_plain(xe, we, se, be, phase=False,
                                      out_dtype=compute_dtype))
    assert torch.equal(site, quantize_pad_plain(
        (u, link), sx_up, leaky=True, reflect=False))
    assert torch.equal(down, quantize_pad_plain(
        (link,), sx_down, leaky=False, reflect=True))
    assert site.shape[3] == channels_padded(co_u + co_link)


@pytest.mark.parametrize("bad", ["all_phase", "three", "c_off", "leaky",
                                 "reflect_1x1", "no_scale", "shape",
                                 "dtype"])
def test_fused_wrapper_refuses_bad_operands(bad):
    rng = np.random.default_rng(0)
    xq, wk, scale, bias = _conv_operands(rng, 1, 1, 1, 16, 8, True)
    buf = torch.zeros(1, 4, 4, 16, dtype=torch.int8)
    sx = torch.tensor(0.01)
    dests = [(buf, sx, 1, False, 0)]
    kw = dict(phase=True, compute_dtype=torch.bfloat16)
    if bad == "all_phase":
        wk = all_phase_weight(wk)
    elif bad == "three":
        dests = dests * 3
    elif bad == "c_off":
        dests = [(buf, sx, 1, False, 9)]
    elif bad == "leaky":
        dests = [(buf, sx, 3, False, 0)]
    elif bad == "reflect_1x1":       # the phase form of a 1x1 grid: 2x2
        xq, wk, scale, bias = _conv_operands(rng, 1, 2, 2, 16, 8, False)
        kw["phase"] = False
        dests = [(torch.zeros(1, 3, 3, 16, dtype=torch.int8), sx, 1, True,
                  0)]
    elif bad == "no_scale":
        scale = bias = None
    elif bad == "shape":
        dests = [(torch.zeros(1, 4, 5, 16, dtype=torch.int8), sx, 1, False,
                  0)]
    elif bad == "dtype":
        kw["compute_dtype"] = torch.float16
    with pytest.raises((ValueError, TypeError)):
        int8_conv_quantized(xq, wk, scale, bias, dests=dests, **kw)


def _random_mnet(in_ch, out_ch, seed, ngf=8):
    """The port's eval MNet (nearest-upsample decoder) with numpy-drawn
    weights and BatchNorm statistics."""
    rng = np.random.default_rng(seed)
    m = get_generator("mnet", in_channels=in_ch, out_channels=out_ch,
                      ngf=ngf)
    with torch.no_grad():
        for name, t in [*m.named_parameters(), *m.named_buffers()]:
            if not t.is_floating_point():
                continue
            if t.dim() == 4:
                v = rng.normal(0, 1 / np.sqrt(t[0].numel()), t.shape)
            elif name.endswith("running_var") or name.endswith("weight"):
                v = rng.uniform(0.5, 1.5, t.shape)
            else:
                v = rng.normal(0, 0.1, t.shape)
            t.copy_(torch.from_numpy(v.astype(np.float32)))
    return m.eval()


@pytest.fixture(scope="module", params=[(3, 1), (4, 3)], ids=["G1", "G2"])
def net(request):
    """A folded and quantized MNet at ngf 8 and its 32x64 batch of 2."""
    in_ch, out_ch = request.param
    folded = tq.fold_mnet(_random_mnet(in_ch, out_ch, seed=in_ch))
    x = torch.from_numpy(np.random.default_rng(in_ch + 10).uniform(
        -1, 1, (2, in_ch, 32, 64)).astype(np.float32))
    q = tq.quantize_mnet(folded, tq.calibrate_mnet(folded, [x]))
    return folded, q, x


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_fused_forward_equals_selective_all_sites(net, compute_dtype):
    """The serving route (``qparams``, no ``quant_sites``) equals the
    selective forward with every site int8 bit for bit, through 1
    ``quantize_pad`` (the stem), 9 fused convs and the final's
    ``int8_conv``; the innermost level is 1x2 (edge pad of one row)."""
    folded, q, x = net
    calls = {"quantize_pad": 0, "int8_conv_quantized": 0, "int8_conv": 0}

    def counted(name):
        real = getattr(tq, name)

        def fn(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return fn

    with mock.patch.multiple(tq, **{k: counted(k) for k in calls}):
        got = tq.mnet_apply_folded(None, x, qparams=q,
                                   compute_dtype=compute_dtype)
    assert calls == {"quantize_pad": 1, "int8_conv_quantized": 9,
                     "int8_conv": 1}
    want = tq.mnet_apply_folded(folded, x, qparams=q, quant_sites=SITES,
                                compute_dtype=compute_dtype)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


def test_fused_forward_counts_the_unfused_flops(net):
    """``srit::int8_conv_quantized``'s formula is ``srit::int8_conv``'s,
    so the fused forward counts what the selective all-sites one does."""
    folded, q, x = net
    fused = flops.count_flops(tq.mnet_apply_folded, None, x, qparams=q)
    unfused = flops.count_flops(tq.mnet_apply_folded, folded, x, qparams=q,
                                quant_sites=SITES)
    assert fused == unfused > 0


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_stacked_int8_is_the_fused_pair(compute_dtype):
    """``make_stacked_int8`` (weights padded once, the finals expanded to
    the 3x3 window) equals the selective all-sites pair bit for bit."""
    f1 = tq.fold_mnet(_random_mnet(3, 1, seed=7))
    f2 = tq.fold_mnet(_random_mnet(4, 3, seed=8))
    x = torch.from_numpy(np.random.default_rng(9).uniform(
        -1, 1, (1, 3, 64, 32)).astype(np.float32))
    s1, (m1,) = tq.calibrate_mnet(f1, [x], return_outputs=True)
    s2 = tq.calibrate_mnet(f2, [torch.cat([x, m1], 1)])
    q1, q2 = tq.quantize_mnet(f1, s1), tq.quantize_mnet(f2, s2)
    m, y = tq.make_stacked_int8(q1, q2, compute_dtype=compute_dtype)(x)
    m_want = tq.mnet_apply_folded(f1, x, qparams=q1, quant_sites=SITES,
                                  compute_dtype=compute_dtype)
    y_want = tq.mnet_apply_folded(f2, torch.cat([x, m_want], 1), qparams=q2,
                                  quant_sites=SITES,
                                  compute_dtype=compute_dtype)
    assert torch.equal(m, m_want) and torch.equal(y, y_want)


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_wiring_fills_every_input_once(depth):
    """``int8_wiring`` on a folded MNet's widths: every site after the
    stem is fed, each of its input channels (the folded weight's second
    axis) by exactly one destination, reflect-padded in the encoder and
    edge-padded in the decoder, and every producer is listed before the
    sites it feeds."""
    from shadow_removal_istd_tpu_torch.models.mnet import MNet

    f = tq.fold_mnet(MNet(4, 3, ngf=8, depth=depth).eval())
    key = {"stem": "stem", "final": "final"}
    co = {s: f[key.get(s, s + "_w")].shape[0] for s in
          ["stem"] + [f"{p}{i}" for i in range(depth)
                      for p in ("down", "up")]}
    wiring = tq.int8_wiring(co, depth)
    order = list(wiring) + ["final"]
    assert order == (["stem"] + [f"down{i}" for i in range(depth)]
                     + [f"up{j}" for j in range(depth)] + ["final"])
    filled: dict = {}
    for site, dests in wiring.items():
        for to, channels, c_off, leaky, reflect in dests:
            assert order.index(to) > order.index(site)
            assert reflect == to.startswith("down") and leaky in (0, 1, 2)
            assert channels == f[key.get(to, to + "_w")].shape[1]
            filled.setdefault(to, []).extend(range(c_off, c_off + co[site]))
    assert sorted(filled) == sorted(order[1:])
    for to, chans in filled.items():
        assert sorted(chans) == list(range(len(chans))), to
