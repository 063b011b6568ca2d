"""The decoder kernel (``csrc/decoder_upsample.cu``) against its plain
version, on the card, at ragged shapes the MNet path never gives it.

``chip_smoke.py`` holds the kernel to its plain version at the MNet
decoder shapes, which tile evenly. These cases cut every tile edge
instead: pixel counts that are no multiple of the block's rows, channel
counts that are no multiple of the K step or the output tile, unequal
split-skip parts, both padding forms and both epilogues. Tolerances as
in chip_smoke.py: 2e-5 in f32 (TF32 off), 3e-2 in bf16.

Marked ``cuda``; skips without a card. On a machine with one (the tests'
conftest imports JAX, which that machine need not have)::

    python -m pytest --noconftest -m cuda tests/test_torch_decoder_cuda.py
"""
import pytest
import torch

from shadow_removal_istd_tpu_torch.ops.decoder import (
    decoder_upsample,
    decoder_upsample_plain,
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,parts,co", [
    (1, 5, 7, (20,), 40),          # 35 pixels; Ci, Co off every tile
    (2, 3, 9, (24, 13), 70),       # unequal parts, Co past one tile
    (3, 4, 6, (9, 5), 3),          # narrow config, Co 3
    (1, 11, 13, (16, 16), 1),      # narrow config, Co 1
    (2, 1, 1, (33,), 32),          # 1x1 input: every tap clamps
])
@pytest.mark.parametrize("zero_pad", [False, True])
@pytest.mark.parametrize("final", [False, True])
def test_kernel_matches_plain(cuda, n, h, w, parts, co, zero_pad, final,
                              dtype):
    xs, w4, s4, b4 = _inputs(n, h, w, parts, co, not final, dtype)
    kw = dict(leaky=not final, zero_pad=zero_pad)
    before = decoder_upsample.launches
    got = decoder_upsample(xs, w4, s4, b4, **kw)
    assert decoder_upsample.launches == before + 1
    want = decoder_upsample_plain(xs, w4, s4, b4, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, co, 2 * h, 2 * w)
    assert got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


def test_kernel_rejects_what_it_does_not_take(cuda):
    xs, w4, s4, b4 = _inputs(1, 4, 4, (8,), 8, True, torch.float32)
    with pytest.raises(ValueError, match="channels_last"):
        decoder_upsample([xs[0].contiguous()], w4, s4, b4, leaky=True)
    with pytest.raises(ValueError, match="w4"):
        decoder_upsample(xs, w4.to(torch.bfloat16), s4, b4, leaky=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        decoder_upsample([xs[0].half()], w4.half(), s4, b4, leaky=True)
