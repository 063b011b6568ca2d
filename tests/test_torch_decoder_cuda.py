"""The decoder kernels (``csrc/decoder_upsample.cu``, the CUDA-core
variant, ``csrc/decoder_upsample_tc.cu``, the tensor-core one, and
``csrc/decoder_upsample_narrow.cu``, the Co <= 4 one) against their plain
version, on the card, at ragged shapes the MNet path never gives them.

``chip_smoke.py`` holds the kernels to their plain version at the MNet
decoder shapes, which tile evenly. These cases cut every tile edge
instead: pixel counts that are no multiple of the block's rows, channel
counts that are no multiple of the K step, the output tile or the
narrow kernel's channel chunk, spatial sizes that are no multiple of the
narrow kernel's tile, unequal split-skip parts, both padding forms and
both epilogues; the CUDA-core kernel's three tiles (128x128, 128x64,
128x16) on its 16-byte and its scalar loads, and at K = 4096; the
narrow kernel's routes in both dtypes (TMA against element loads, one
part of each, the weights resident or rebuilt per chunk) and its
edge-form tiles on every image border, with persistent blocks that walk
several tiles, each read off its plan (``narrow_plan``). Each case asserts which variant ran. Tolerances as in
chip_smoke.py: 2e-5 in f32 (TF32 off), 3e-2 in bf16.

Marked ``cuda``; skips without a card. On a machine with one (the tests'
conftest imports JAX, which that machine need not have)::

    python -m pytest --noconftest -m cuda tests/test_torch_decoder_cuda.py
"""
import pytest
import torch

from shadow_removal_istd_tpu_torch.ops.decoder import (
    decoder_upsample,
    decoder_upsample_plain,
    _launch,
    decoder_variant,
    narrow_plan,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = prev


def _inputs(n, h, w, parts, co, affine, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    xs = [torch.randn(n, c, h, w, generator=gen).to(dtype).cuda()
          .contiguous(memory_format=torch.channels_last) for c in parts]
    ci = sum(parts)
    w4 = (torch.randn(2, 2, ci, 4 * co, generator=gen)
          / (4 * ci) ** 0.5).to(dtype).cuda()
    if not affine:
        return xs, w4, None, None
    s4 = (torch.rand(co, generator=gen) + 0.5).repeat(4).cuda()
    b4 = (torch.randn(co, generator=gen) * 0.1).repeat(4).cuda()
    return xs, w4, s4, b4


def _check(xs, w4, s4, b4, zero_pad, leaky, variant):
    """One launch through the wrapper: ``variant``'s counter rose by one,
    the output matches the plain version."""
    kw = dict(leaky=leaky, zero_pad=zero_pad)
    before = decoder_upsample.launches
    by_variant = dict(decoder_upsample.launches_by_variant)
    got = decoder_upsample(xs, w4, s4, b4, **kw)
    assert decoder_upsample.launches == before + 1
    by_variant[variant] += 1
    assert decoder_upsample.launches_by_variant == by_variant
    want = decoder_upsample_plain(xs, w4, s4, b4, **kw)
    torch.cuda.synchronize()
    n, _, h, w = xs[0].shape
    assert got.shape == want.shape == (n, w4.shape[-1] // 4, 2 * h, 2 * w)
    assert got.dtype == xs[0].dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[xs[0].dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,parts,co", [
    (1, 5, 7, (20,), 40),          # 35 pixels; Ci, Co off every tile
    (2, 3, 9, (24, 13), 70),       # unequal parts, Co past one tile
    (3, 4, 6, (9, 5), 3),          # narrow kernel, Co 3
    (1, 11, 13, (16, 16), 1),      # narrow kernel, Co 1
    (2, 1, 1, (33,), 32),          # 1x1 input: every tap clamps
    (2, 3, 5, (7,), 8),            # CUDA-core kernel below Co 32
])
@pytest.mark.parametrize("zero_pad", [False, True])
@pytest.mark.parametrize("final", [False, True])
def test_kernel_matches_plain(cuda, n, h, w, parts, co, zero_pad, final,
                              dtype):
    xs, w4, s4, b4 = _inputs(n, h, w, parts, co, not final, dtype)
    ci1 = parts[1] if len(parts) == 2 else 0
    _check(xs, w4, s4, b4, zero_pad, not final,
           decoder_variant(dtype, parts[0], ci1, co, True))


@pytest.mark.parametrize("n,h,w,parts,co", [
    (1, 5, 7, (24,), 40),            # 35 pixels: M < one tile; Co ragged
    (2, 15, 20, (512, 512), 256),    # 600 pixels: M ragged, 64 K tiles
    (2, 3, 9, (24, 16), 72),         # parts no multiple of BK; Co > BN
    (2, 1, 1, (32,), 32),            # 1x1 input: every tap clamps
])
@pytest.mark.parametrize("zero_pad", [False, True])
@pytest.mark.parametrize("final", [False, True])
def test_tensor_core_variant_matches_plain(cuda, n, h, w, parts, co,
                                           zero_pad, final):
    """bf16 with every channel count a multiple of 8 and Co >= 32: the
    tensor-core kernel, with and without LeakyReLU and the affine."""
    xs, w4, s4, b4 = _inputs(n, h, w, parts, co, not final, torch.bfloat16)
    _check(xs, w4, s4, b4, zero_pad, not final, "tensor_core")


def _check_tc_into_nan(xs, w4, s4, b4, zero_pad, leaky):
    """The tensor-core C entry called on an output prefilled with NaN, so
    a tile the kernel leaves unwritten fails; held to the plain
    version."""
    from shadow_removal_istd_tpu_torch.ops import decoder

    n, ci0, h, w = xs[0].shape
    ci1 = xs[1].shape[1] if len(xs) == 2 else 0
    co = w4.shape[-1] // 4
    assert decoder_variant(torch.bfloat16, ci0, ci1, co, True) \
        == "tensor_core"
    out = torch.full((n, co, 2 * h, 2 * w), float("nan"),
                     dtype=torch.bfloat16, device=xs[0].device).contiguous(
                         memory_format=torch.channels_last)
    rc = decoder._kernel_fn("tensor_core")(
        1, xs[0].data_ptr(), xs[1].data_ptr() if ci1 else None, ci0, ci1,
        w4.data_ptr(), s4.data_ptr() if s4 is not None else None,
        b4.data_ptr() if b4 is not None else None, out.data_ptr(), n, h, w,
        co, int(leaky), int(zero_pad),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    want = decoder_upsample_plain(xs, w4, s4, b4, leaky=leaky,
                                  zero_pad=zero_pad)
    torch.cuda.synchronize()
    assert not out.isnan().any()
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOL[torch.bfloat16], err


@pytest.mark.parametrize("n,h,w,parts,co", [
    (1, 5, 7, (24,), 40),           # Co 40 on a 64-wide tile; Ci 24
    (2, 3, 9, (8, 16), 72),         # Co 72 on a 128-wide tile; Ci 8
    (1, 9, 17, (72,), 136),         # Co 136: two tiles; Ci 72
    (3, 3, 5, (16, 8), 264),        # 4 images a tile, batch 3; Co 264
    (1, 8, 8, (32, 32), 520),       # Co 520: five tiles
    (3, 1, 1, (24, 40), 64),        # 1x1: 16 images a tile, batch 3
    (1, 15, 20, (64, 64), 128),     # 15x20: ragged tiles, batch 1
    (3, 8, 8, (128,), 64),          # 8x8: 2 images a tile, batch 3
    (2, 16, 16, (64, 64), 256),     # whole 8x16 tiles
])
@pytest.mark.parametrize("zero_pad", [False, True])
@pytest.mark.parametrize("leaky", [False, True])
@pytest.mark.parametrize("affine", [False, True])
def test_tensor_core_hopper_edges(cuda, n, h, w, parts, co, zero_pad, leaky,
                                  affine):
    """The wgmma kernel's edges: Co off its 64- and 128-wide tiles, Ci
    off its 32-channel stage, unequal parts, position tiles that cross
    image and batch boundaries, both pads, LeakyReLU and the affine each
    on and off; every output written (NaN-prefilled)."""
    xs, w4, s4, b4 = _inputs(n, h, w, parts, co, affine, torch.bfloat16)
    _check_tc_into_nan(xs, w4, s4, b4, zero_pad, leaky)


@pytest.mark.parametrize("n,h,w,parts,co", [
    (2, 16, 16, (512, 512), 256),   # MNet's K = 4096 step
    (2, 8, 8, (512,), 512),         # MNet's K = 2048 step, one part
])
@pytest.mark.parametrize("zero_pad", [False, True])
def test_tensor_core_long_k(cuda, n, h, w, parts, co, zero_pad):
    """K = 4096 and 2048 (a fresh accumulator a stage, added in f32
    round-to-nearest) in both pads, held to the plain version."""
    xs, w4, s4, b4 = _inputs(n, h, w, parts, co, True, torch.bfloat16)
    _check_tc_into_nan(xs, w4, s4, b4, zero_pad, True)


def _misaligned(x):
    """A channels_last copy of ``x`` whose data starts one element past a
    16-byte boundary."""
    n, c, h, w = x.shape
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf.as_strided((n, c, h, w), (h * w * c, 1, w * c, c), 1)
    y.copy_(x)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert y.data_ptr() % 16
    return y


def _check_cuda_core(xs, w4, s4, b4, zero_pad, leaky):
    """The CUDA-core kernel on these inputs: through the wrapper (its
    count rises) where the rule picks it, else forced, as chip_smoke
    forces it for its side-by-side timings."""
    ci1 = xs[1].shape[1] if len(xs) == 2 else 0
    co = w4.shape[-1] // 4
    if decoder_variant(xs[0].dtype, xs[0].shape[1], ci1, co,
                       all(x.data_ptr() % 16 == 0 for x in xs)) \
            == "cuda_core":
        _check(xs, w4, s4, b4, zero_pad, leaky, "cuda_core")
        return
    got, variant = _launch(tuple(xs), w4, s4, b4, co, leaky, zero_pad,
                           "cuda_core")
    assert variant == "cuda_core"
    want = decoder_upsample_plain(xs, w4, s4, b4, leaky=leaky,
                                  zero_pad=zero_pad)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[xs[0].dtype], err


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,n,h,w,parts,co,misaligned", [
    (F32, 1, 13, 11, (16,), 64, False),    # 143 pixels: M off the 128 rows
    (BF16, 1, 13, 11, (16,), 64, False),
    (F32, 1, 9, 17, (24, 8), 96, False),   # Co 96: off the 64-wide tile
    (BF16, 1, 9, 17, (24, 8), 96, False),
    (F32, 1, 9, 17, (16,), 136, False),    # Co 136: off both wide tiles
    (BF16, 1, 9, 17, (16,), 136, False),
    (F32, 1, 10, 15, (44,), 128, False),   # Ci 44: a ragged 8-channel chunk
    (BF16, 1, 10, 15, (44,), 128, False),
    (F32, 1, 9, 15, (13, 6), 70, False),   # f32 channels off 4: scalar loads
    (F32, 2, 5, 7, (16, 8), 40, True),     # misaligned f32: scalar loads
    (F32, 2, 15, 20, (512, 512), 256, False),  # K = 4096
    (F32, 1, 4, 5, (12, 20), 5, False),    # Co 5: the narrow-N instance
    (BF16, 1, 4, 5, (12, 20), 5, False),
    (F32, 1, 4, 5, (16,), 24, False),      # Co 24
    (BF16, 1, 4, 5, (16,), 24, False),
])
@pytest.mark.parametrize("zero_pad", [False, True])
@pytest.mark.parametrize("final", [False, True])
def test_cuda_core_tiles_match_plain(cuda, dtype, n, h, w, parts, co,
                                     misaligned, zero_pad, final):
    """The CUDA-core kernel's tiles (128x128, 128x64, 128x16) cut at
    every edge, on its 16-byte and its scalar loads, with and without
    LeakyReLU and the affine, in both padding forms."""
    xs, w4, s4, b4 = _inputs(n, h, w, parts, co, not final, dtype)
    if misaligned:
        xs = [_misaligned(xs[0])] + xs[1:]
    _check_cuda_core(xs, w4, s4, b4, zero_pad, not final)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("co", [1, 3])
@pytest.mark.parametrize("zero_pad", [False, True])
def test_cuda_core_forced_at_final_widths(cuda, dtype, co, zero_pad):
    """The final layer's Co 1 and 3 forced onto the CUDA-core kernel, as
    chip_smoke times it beside the narrow one."""
    xs, w4, _, _ = _inputs(2, 11, 13, (64, 64), co, False, dtype)
    _check_cuda_core(xs, w4, None, None, zero_pad, False)


def test_misaligned_bf16_runs_on_cuda_cores(cuda):
    """A wide bf16 step whose input is not 16-byte aligned takes the
    CUDA-core kernel; the tensor-core entry refuses it."""
    xs, w4, s4, b4 = _inputs(2, 4, 6, (32, 32), 64, True, torch.bfloat16)
    parts = (_misaligned(xs[0]), xs[1])
    _check(parts, w4, s4, b4, False, True, "cuda_core")
    with pytest.raises(RuntimeError, match="tensor_core kernel launch"):
        _launch(parts, w4, s4, b4, 64, True, False, "tensor_core")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("co", [1, 2, 3, 4])
@pytest.mark.parametrize("n,h,w,parts", [
    (1, 1, 1, (5,)),            # 1x1 input: every tap clamps
    (2, 3, 9, (9, 5)),          # unequal parts, chunks that do not divide
    (1, 11, 13, (64, 64)),      # the final layer's parts; one ragged tile
    (2, 9, 35, (130,)),         # W past one tile; a ragged last chunk
    (1, 37, 33, (16, 8)),       # H past one tile; 16-byte vector loads
])
@pytest.mark.parametrize("zero_pad", [False, True])
@pytest.mark.parametrize("final", [False, True])
def test_narrow_variant_matches_plain(cuda, n, h, w, parts, co, zero_pad,
                                      final, dtype):
    """Co <= 4: the narrow kernel, with and without LeakyReLU and the
    affine, in both dtypes and padding forms."""
    xs, w4, s4, b4 = _inputs(n, h, w, parts, co, not final, dtype)
    _check(xs, w4, s4, b4, zero_pad, not final, "narrow")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_input_runs_narrow(cuda, dtype):
    """An input that is not 16-byte aligned takes the narrow kernel's
    scalar loads."""
    xs, w4, s4, b4 = _inputs(2, 5, 7, (16, 8), 3, True, dtype)
    _check((_misaligned(xs[0]), xs[1]), w4, s4, b4, False, True, "narrow")


def test_narrow_entry_refuses_wide_outputs(cuda):
    xs, w4, s4, b4 = _inputs(1, 4, 4, (8,), 5, True, torch.float32)
    with pytest.raises(RuntimeError, match="narrow kernel launch"):
        _launch(tuple(xs), w4, s4, b4, 5, True, False, "narrow")


def test_kernel_rejects_what_it_does_not_take(cuda):
    """The launcher refuses another layout; the op
    ``srit::decoder_upsample`` makes its inputs ``channels_last`` before
    it, so an NCHW input runs (as an exported graph may hand it one).
    Another dtype or a w4 of another dtype is refused."""
    xs, w4, s4, b4 = _inputs(1, 4, 4, (8,), 8, True, torch.float32)
    with pytest.raises(ValueError, match="channels_last"):
        _launch((xs[0].contiguous(),), w4, s4, b4, 8, True, False)
    _check([xs[0].contiguous()], w4, s4, b4, False, True, "cuda_core")
    with pytest.raises(ValueError, match="w4"):
        decoder_upsample(xs, w4.to(torch.bfloat16), s4, b4, leaky=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        decoder_upsample([xs[0].half()], w4.half(), s4, b4, leaky=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("parts,misaligned,loads", [
    ((64, 64), False, ("tma", "tma")),      # the final layer's parts
    ((16, 13), False, ("tma", "scalar")),   # Ci 13: rows off 16 bytes
    ((9, 5), False, ("scalar", "scalar")),
    ((16, 8), True, ("scalar", "tma")),     # part 0 one element past
    ((40,), False, ("tma",)),               # one part, a ragged chunk
    # channels a multiple of 4 but not of 8 or 16: TMA in f32 only
    ((12, 20), False, {F32: ("tma", "tma"), BF16: ("scalar", "scalar")}),
])
@pytest.mark.parametrize("co", [1, 3])
@pytest.mark.parametrize("zero_pad", [False, True])
@pytest.mark.parametrize("final", [False, True])
def test_narrow_load_routes(cuda, dtype, parts, misaligned, loads, co,
                            zero_pad, final):
    """Each part arrives by TMA where it is 16-byte aligned with channels
    a multiple of 8 (bf16) or 4 (f32), else element by element into the
    same ring, as the kernel's plan says; the output matches the plain
    version either way."""
    if isinstance(loads, dict):
        loads = loads[dtype]
    xs, w4, s4, b4 = _inputs(2, 19, 37, parts, co, not final, dtype)
    if misaligned:
        xs = [_misaligned(xs[0])] + xs[1:]
    plan = narrow_plan(xs, co)
    assert plan["loads"] == loads
    if dtype == BF16:
        assert plan["route"] == "tensor_core" and plan["stages"] >= 3
        assert plan["n_cols"] == (8 if co <= 2 else 16)
    else:  # 2 stages of 32 channels (the kernel's header says why)
        assert plan["route"] == "cuda_core" and plan["stages"] == 2
        assert plan["n_cols"] == 4 * co
    _check(xs, w4, s4, b4, zero_pad, not final, "narrow")


def _sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w", [
    (3, 16, 32),     # tiles end exactly on each image's edge
    (2, 32, 64),     # 2 x 2 whole tiles an image
    (2, 37, 70),     # ragged last tile row and column: every border
    (1, 3, 50),      # H under one tile
    (2, 40, 5),      # W under one tile
    (5, 1, 1),       # one pixel an image: every tap clamps
    (1, 15, 31),     # one ragged tile
    (3, 96, 256),    # 144 tiles: a block walks several
])
@pytest.mark.parametrize("co", [1, 2, 3, 4])
@pytest.mark.parametrize("zero_pad", [False, True])
def test_narrow_tiles_at_every_border(cuda, dtype, n, h, w, co, zero_pad):
    """The edge form clamps the halo pixel of every tile on an image
    border (top, bottom, left, right, corners), the zero form reads TMA's
    zero fill; images smaller than one tile, batches whose tiles end on
    an image boundary and persistent blocks that walk several tiles
    included."""
    xs, w4, s4, b4 = _inputs(n, h, w, (64, 64), co, False, dtype)
    plan = narrow_plan(xs, co)
    assert plan["loads"] == ("tma", "tma")
    tiles = n * -(-h // plan["tile"][0]) * -(-w // plan["tile"][1])
    assert plan["tiles"] == tiles
    assert plan["blocks"] == min(tiles, _sm_count())
    _check(xs, w4, s4, b4, zero_pad, True, "narrow")


@pytest.mark.parametrize("parts,co,resident", [
    ((64, 64), 3, True),
    ((200, 120), 3, False),   # 11 chunks of B past shared memory at N 16
    ((200, 120), 1, True),    # the same fit at N 8
    ((300, 260), 1, False),
])
def test_narrow_bf16_expanded_weight_slots(cuda, parts, co, resident):
    """The expanded weight stays resident where every chunk's slice fits,
    else it is rebuilt per chunk into two slots; both match."""
    xs, w4, s4, b4 = _inputs(2, 20, 40, parts, co, True, torch.bfloat16)
    assert narrow_plan(xs, co)["resident"] is resident
    _check(xs, w4, s4, b4, False, True, "narrow")


@pytest.mark.parametrize("parts,co,resident", [
    ((64, 64), 3, True),
    ((200, 120), 3, False),   # 11 chunks of weights past shared memory
    ((200, 120), 1, True),    # the same fit at Co 1
    ((300, 260), 4, False),
])
def test_narrow_f32_weight_slots(cuda, parts, co, resident):
    """f32: every chunk's weights stay resident where they fit, else each
    chunk's are rebuilt into two slots; both match."""
    xs, w4, s4, b4 = _inputs(2, 20, 40, parts, co, True, torch.float32)
    assert narrow_plan(xs, co)["resident"] is resident
    _check(xs, w4, s4, b4, False, True, "narrow")


@pytest.mark.parametrize("misaligned,loads", [
    (False, ("tma", "tma")), (True, ("scalar", "tma"))])
def test_narrow_f32_stays_on_cuda_cores(cuda, misaligned, loads):
    """f32 keeps FMAs on the CUDA cores, fed like bf16: a persistent grid
    of at most one block an SM over 16 x 32 tiles, a ring of 2 stages of
    32 channels by TMA (element loads for the misaligned part), every
    chunk's weights resident at the final layer's width."""
    xs, w4, s4, b4 = _inputs(2, 9, 35, (64, 64), 3, True, torch.float32)
    if misaligned:
        xs = [_misaligned(xs[0])] + xs[1:]
    plan = narrow_plan(xs, 3)
    assert plan["route"] == "cuda_core" and plan["loads"] == loads
    assert plan["stages"] == 2 and plan["tile"] == (16, 32)
    assert plan["resident"] is True and plan["n_cols"] == 12
    assert plan["tiles"] == 2 * 1 * 2
    assert plan["blocks"] == min(plan["tiles"], _sm_count())
    _check(xs, w4, s4, b4, True, True, "narrow")
