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
128x16) on its 16-byte and its scalar loads, and at K = 4096. Each case
asserts which variant ran. Tolerances as in chip_smoke.py: 2e-5 in f32
(TF32 off), 3e-2 in bf16.

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
