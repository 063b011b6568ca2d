"""The int8 kernels (``csrc/int8_conv.cu``: ``quantize_pad`` and
``int8_conv``) against their plain versions, on the card, at shapes the
MNet path at ngf 64 never gives them.

``chip_smoke.py`` holds the kernels to their plain versions at every conv
site of the stacked pair. These cases cut the tiles instead: pixel counts
that are no multiple of the 128-row tile, thin inputs (Ci 3, padded to 16
channels), channel counts that are no multiple of the 64-byte K tile,
narrow outputs (Co 1 and 3 in the phase form: 4*Co = 4 and 12) and odd
ones, unequal two-part inputs with one part below 16 channels, odd H and
W, both pads and both compute dtypes; and each path of the kernel's
plan (``conv_plan``): the stems' (tap, channel) K walk at Cp 16, K split
over taps at the deep sites, ragged Cp (48, 80) that the weight's zero
fill makes exact, tiles that cross images (a TMA box of 2 images, a
gathered tile), Co 512 on four N tiles, the finals' form (a weight
expanded by ``all_phase_weight``: all four phases in one tile over the 3x3
window; the narrow 2x2 cases above take a tile per phase), and the
activation tiles by TMA boxes (``a_tma``) or by the ``cp.async`` gather.
The fused call (``int8_conv_quantized``: the conv whose epilogue writes
the padded int8 inputs of the sites that read it) is held to its plain
composition on a grid of its own: the split-K levels (16x16 and 8x8 of
256x256, 30x40 and 15x20 of 480x640), images smaller than a tile, ragged
Co and channel offsets (byte stores), one and two destinations with
different scales, LeakyReLU 0, 1 and 2, reflect and edge pads down to a
1-pixel grid, in both compute dtypes.

Everything is integer or one rounding per step, so every comparison is
exact: the int8 tensors, the s32 sums and the dequantized outputs bit for
bit.

Marked ``cuda``; skips without a card. On a machine with one (the tests'
conftest imports JAX, which that machine need not have)::

    python -m pytest --noconftest -m cuda tests/test_torch_int8_cuda.py
"""
import pytest
import torch

from shadow_removal_istd_tpu_torch.ops.int8_conv import (
    all_phase_weight,
    channels_padded,
    conv_plan,
    int8_conv,
    int8_conv_plain,
    int8_conv_quantized,
    int8_conv_quantized_plain,
    leaky_relu,
    pad_weight,
    quantize_pad,
    quantize_pad_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _parts(n, h, w, chans, dtype, gen, dev):
    return [(torch.randn(n, c, h, w, generator=gen) * 2).to(dtype).to(dev)
            .contiguous(memory_format=torch.channels_last) for c in chans]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chans,h,w,leaky,reflect", [
    ((3,), 17, 23, False, True),       # the stem: scalar loads
    ((4,), 6, 5, False, True),
    ((64,), 9, 13, True, True),        # 16-channel vector loads
    ((48, 16), 7, 11, True, False),    # two parts, vector loads
    ((40, 5), 8, 3, True, False),      # two ragged parts
    ((1, 3), 10, 12, False, False),    # the final step's width at ngf 1
])
def test_quantize_pad_matches_plain(cuda, dtype, chans, h, w, leaky,
                                    reflect):
    gen = torch.Generator().manual_seed(sum(chans) + h)
    parts = _parts(2, h, w, chans, dtype, gen, cuda)
    sx = torch.tensor(0.037, device=cuda)
    before = quantize_pad.launches
    got = quantize_pad(parts, sx, leaky=leaky, reflect=reflect)
    want = quantize_pad_plain(parts, sx, leaky=leaky, reflect=reflect)
    torch.cuda.synchronize()
    assert quantize_pad.launches == before + 1
    assert got.shape == (2, h + 2, w + 2, channels_padded(sum(chans)))
    assert torch.equal(got, want)
    # values beyond +-127 * sx saturate in both
    assert int(got.abs().max()) == 127


def _conv_inputs(n, h, w, ci, rows, k, gen, dev):
    xq = torch.randint(-127, 128, (n, h + 2, w + 2, channels_padded(ci)),
                       generator=gen, dtype=torch.int8)
    xq[..., ci:] = 0
    wk = torch.randint(-127, 128, (rows, k, k, ci), generator=gen,
                       dtype=torch.int8)
    scale = torch.rand(rows, generator=gen) * 1e-4
    return xq.to(dev), pad_weight(wk).to(dev), scale.to(dev)


@pytest.mark.parametrize("phase,n,h,w,ci,co", [
    (False, 2, 30, 46, 3, 64),     # stem: Ci 3, M = 690 (ragged tile)
    (False, 1, 18, 10, 4, 5),      # Ci 4, odd Co on the narrow tile
    (False, 3, 14, 22, 80, 96),    # K tile cut (80 channels), Co % 64
    (False, 1, 4, 6, 512, 512),    # K = 8192, the innermost site's
    (True, 2, 9, 13, 128, 1),      # final G1: 4*Co = 4
    (True, 1, 11, 7, 128, 3),      # final G2: 4*Co = 12
    (True, 2, 5, 6, 1024, 64),     # two 512 parts' width, Co 64
    (True, 1, 7, 9, 40, 17),       # ragged Ci and Co
])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_conv_matches_plain(cuda, phase, n, h, w, ci, co, out_dtype):
    _check_conv(cuda, phase, n, h, w, ci, co, out_dtype)


def _check_conv(dev, phase, n, h, w, ci, co, out_dtype, all_phase=False):
    """The kernel against the plain version in s32, with a bias and
    without, bit for bit (the phase weight expanded by
    ``all_phase_weight`` with ``all_phase``); returns the plan it ran."""
    gen = torch.Generator().manual_seed(ci * 7 + co)
    if not phase:
        h, w = 2 * h, 2 * w        # the encoder form halves an even input
    rows = 4 * co if phase else co
    xq, wk, scale = _conv_inputs(n, h, w, ci, rows, 2 if phase else 4, gen,
                                 dev)
    if all_phase:
        wk = all_phase_weight(wk)
    bias = (torch.randn(co, generator=gen) * 0.1).to(dev)
    before = int8_conv.launches
    acc = int8_conv(xq, wk, phase=phase)
    got = int8_conv(xq, wk, scale, bias, phase=phase, out_dtype=out_dtype)
    plain_acc = int8_conv_plain(xq, wk, phase=phase)
    want = int8_conv_plain(xq, wk, scale, bias, phase=phase,
                           out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert int8_conv.launches == before + 2
    oh, ow = (2 * h, 2 * w) if phase else (h // 2, w // 2)
    assert acc.dtype == torch.int32 and acc.shape == (n, co, oh, ow)
    assert torch.equal(acc, plain_acc)
    assert got.dtype == out_dtype and torch.equal(got, want)
    nobias = int8_conv(xq, wk, scale, phase=phase, out_dtype=out_dtype)
    assert torch.equal(nobias, int8_conv_plain(xq, wk, scale, phase=phase,
                                               out_dtype=out_dtype))
    return conv_plan(xq, wk, phase=phase)


# each path of the plan, with what the plan must take for it
@pytest.mark.parametrize("phase,n,h,w,ci,co,path", [
    (False, 2, 128, 128, 3, 64, "stem"),     # G1's stem at 256x256
    (False, 1, 32, 32, 4, 64, "stem"),       # G2's stem, 64x64
    (False, 8, 16, 16, 512, 512, "split"),   # down3: M 2048, K 8192
    (True, 2, 8, 8, 512, 512, "split"),      # up0's form at Ci 512, 8x8
    (False, 2, 9, 7, 45, 40, "ragged"),      # Cp 48, Co 40 on a 64 tile
    (True, 2, 6, 10, 48, 32, "ragged"),      # Cp 48, phase: K 192
    (True, 1, 9, 11, 70, 24, "ragged"),      # Cp 80, phase: K 320
    (True, 4, 8, 8, 256, 128, "cross"),      # a TMA box of 2 images
    (False, 4, 8, 8, 128, 64, "cross"),
    (True, 4, 8, 8, 80, 32, "cross"),        # a gathered tile: 2 images
    (False, 9, 32, 32, 64, 512, "co512"),    # 4 N tiles of 128, unsplit
    (False, 2, 20, 12, 64, 128, "tma"),      # down0's Cp 64: pixel pairs
    (True, 2, 15, 20, 512, 512, "tma"),      # 480x640's up0 grid
    (True, 2, 64, 64, 128, 1, "final"),      # G1's final, 4 phases at once
    (True, 1, 64, 48, 128, 3, "final"),      # G2's: 12 columns
    (True, 3, 5, 7, 16, 4, "final"),         # Cp 16: K 144, ragged
    (True, 2, 8, 8, 64, 8, "all_phase"),     # the form past the finals:
    (True, 1, 6, 10, 64, 40, "all_phase"),   # 32, and 160 on 2 N tiles
])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_conv_paths_match_plain(cuda, phase, n, h, w, ci, co, path,
                                     out_dtype):
    plan = _check_conv(cuda, phase, n, h, w, ci, co, out_dtype,
                       all_phase=path in ("final", "all_phase"))
    assert plan["bm"] == 128
    if path == "stem":
        assert channels_padded(ci) == 16 and plan["splits"] == 1
        assert plan["a_tma"] == 0     # taps share a K tile: gathered
    elif path == "split":
        assert plan["splits"] > 1 and plan["ws_words"] > 0
    elif path == "co512":
        assert plan["bn"] == 128 and plan["splits"] == 1
    elif path == "cross":        # a tile holds rows of two images
        if plan["a_tma"]:
            assert plan["images"] > 1
        else:
            assert plan["m_tiles"] < n
    elif path == "ragged":
        assert plan["a_tma"] == 0
    elif path == "tma":
        assert plan["a_tma"] == 1
    elif path == "final":
        assert plan["taps"] == 9 and plan["bn"] == (8 if co <= 2 else 16)
    elif path == "all_phase":
        assert plan["taps"] == 9


# (phase, n, h, w, ci, co, destinations as (leaky, reflect, c_off, cp)):
# h x w the phase form's input grid, the encoder's output grid (as
# _check_conv takes them)
FUSED_CASES = [
    (False, 2, 128, 128, 3, 64, [(1, True, 0, 64),       # G1's stem at
                                 (1, False, 64, 128)]),  # 256²: down0, link
    (False, 2, 64, 64, 64, 128, [(1, True, 0, 128),      # down0: down1 and
                                 (2, False, 128, 256)]),  # up3's link
    (False, 8, 16, 16, 256, 512, [(1, True, 0, 512),     # 256²'s 16x16
                                  (2, False, 512, 1024)]),  # level, split
    (False, 8, 8, 8, 512, 512, [(1, False, 0, 512)]),    # down3 -> up0
    (True, 2, 8, 8, 512, 512, [(1, False, 0, 1024)]),    # up0 -> up1, split
    (False, 2, 30, 40, 256, 512, [(1, True, 0, 512),     # 480x640's 30x40
                                  (2, False, 512, 1024)]),
    (False, 2, 15, 20, 512, 512, [(1, False, 0, 512)]),  # its 15x20
    (True, 2, 15, 20, 512, 512, [(1, False, 0, 1024)]),
    (True, 2, 64, 64, 256, 64, [(0, False, 0, 128)]),    # up3 -> final
    (True, 4, 4, 4, 256, 128, [(1, False, 0, 256)]),     # 8x8 images
    (False, 4, 4, 4, 128, 64, [(1, True, 0, 64),         # 4x4 images
                               (2, False, 32, 96)]),
    (False, 2, 9, 5, 16, 12, [(1, True, 0, 16),          # ragged Co 12
                              (2, False, 12, 32)]),
    (True, 1, 7, 9, 40, 24, [(0, False, 8, 32)]),        # Co 24, Cp 32
    (True, 2, 5, 6, 48, 40, [(1, True, 3, 48)]),         # odd offset
    (True, 1, 1, 1, 32, 16, [(1, False, 0, 16)]),        # 1x1 -> 2x2
    (False, 2, 1, 1, 32, 16, [(2, False, 0, 32)]),       # a 1x1 output
]
# activation scales that take the kernel's exact division (outside its
# fast path's [2^-96, 2^96]): the conv's scale times 2^-110 or 2^110
EXTREME = [(False, 2, 6, 10, 64, 32, [(1, True, 0, 32), (2, False, 0, 64)]),
           (True, 1, 5, 3, 32, 24, [(0, False, 8, 32)])]


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("phase,n,h,w,ci,co,spec,exp", [
    *[(*case, 0) for case in FUSED_CASES],
    *[(*case, e) for case in EXTREME for e in (-110, 110)]])
def test_int8_conv_quantized_matches_plain(cuda, phase, n, h, w, ci, co,
                                           spec, exp, compute_dtype):
    """The fused kernel against its plain composition, bit for bit: each
    destination's channels and pad ring, the other channels untouched
    (a random sentinel), one launch counted."""
    gen = torch.Generator().manual_seed(ci * 7 + co + h)
    if not phase:
        h, w = 2 * h, 2 * w
    rows = 4 * co if phase else co
    xq, wk, scale = _conv_inputs(n, h, w, ci, rows, 2 if phase else 4, gen,
                                 cuda)
    scale = scale * 2.0 ** exp
    bias = (torch.randn(co, generator=gen) * 0.1 * 2.0 ** exp).to(cuda)
    oh, ow = (2 * h, 2 * w) if phase else (h // 2, w // 2)
    y = int8_conv_plain(xq, wk, scale, bias, phase=phase,
                        out_dtype=compute_dtype)
    dests, plain = [], []
    for i, (leaky, reflect, c_off, cp) in enumerate(spec):
        buf = torch.randint(-128, 128, (n, oh + 2, ow + 2, cp),
                            generator=gen, dtype=torch.int8).to(cuda)
        a = y
        for _ in range(leaky):
            a = leaky_relu(a)
        # some of the top of the range saturates; each scale its own
        sx = a.float().abs().max() * (0.7 - 0.1 * i) / 127
        dests.append((buf, sx, leaky, reflect, c_off))
        plain.append((buf.clone(), sx, leaky, reflect, c_off))
    before = int8_conv.launches, int8_conv_quantized.launches
    int8_conv_quantized(xq, wk, scale, bias, phase=phase,
                        compute_dtype=compute_dtype, dests=dests)
    int8_conv_quantized_plain(xq, wk, scale, bias, phase=phase,
                              compute_dtype=compute_dtype, dests=plain)
    torch.cuda.synchronize()
    assert (int8_conv.launches, int8_conv_quantized.launches) == (
        before[0] + 1, before[1] + 1)
    for (got, *_), (want, *_) in zip(dests, plain):
        assert torch.equal(got, want)
    assert int(plain[0][0][..., spec[0][2]:spec[0][2] + co].abs().max()) \
        == 127


def test_wrappers_refuse_bad_operands(cuda):
    xq = torch.zeros(1, 6, 6, 16, dtype=torch.int8, device=cuda)
    wk = torch.zeros(8, 4, 4, 16, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):        # a 2x2 weight for the s2 form
        int8_conv(xq, wk[:, :2, :2], phase=False)
    with pytest.raises(ValueError):        # a 4x4 weight for the phase form
        int8_conv(xq, wk[:, :4, :4], phase=True)
    with pytest.raises(ValueError):        # channels differ
        int8_conv(xq, wk[..., :8].contiguous(), phase=False)
    with pytest.raises(ValueError):        # sx on the host
        quantize_pad([torch.zeros(1, 3, 4, 4, device=cuda)],
                     torch.tensor(1.0), leaky=False, reflect=True)
