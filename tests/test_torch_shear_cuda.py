"""The shear kernel (``csrc/hshear.cu``) against its plain version, on
the card, at ragged shapes: ``out_w`` off the block width, B = 1, C in
{1, 3, 7}, H not a multiple of 8, and shifts past both clip bounds.
The lerp is written without FMA contraction, so the two agree to the
bit; the bound is 3e-5 on 0-255 data (one f32 ulp at 255).

Marked ``cuda``; skips without a card. On a machine with one (the tests'
conftest imports JAX, which that machine need not have)::

    python -m pytest --noconftest -m cuda tests/test_torch_shear_cuda.py
"""
import pytest
import torch

from shadow_removal_istd_tpu_torch.ops.shear import hshear, hshear_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("b,c,h,w0,out_w,pad,lo,hi", [
    (1, 1, 5, 37, 29, 3, -9.0, 40.0),          # clips both ends
    (2, 3, 13, 300, 257, 11, -20.0, 60.0),     # out_w one past a block
    (3, 7, 9, 64, 700, 400, -400.0, 100.0),    # out_w > W0, wide border
    (1, 7, 17, 255, 1, 0, -3.0, 300.0),        # one output column
    (2, 7, 8, 640, 712, 72, -75.0, 5.0),       # pass-1 form, ragged B
])
def test_kernel_matches_plain(cuda, b, c, h, w0, out_w, pad, lo, hi):
    gen = torch.Generator(device=cuda).manual_seed(0)
    img = torch.rand(b, c, h, w0, device=cuda, generator=gen) * 255.0
    shifts = lo + (hi - lo) * torch.rand(b, h, device=cuda, generator=gen)
    before = hshear.launches
    got = hshear(img, shifts, out_w, pad)
    assert hshear.launches == before + 1
    want = hshear_plain(img, shifts, out_w, pad)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, c, h, out_w)
    err = (got - want).abs().max().item()
    assert err <= 3e-5, err


def test_kernel_rejects_what_it_does_not_take(cuda):
    img = torch.rand(1, 2, 4, 10, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        hshear(img.transpose(2, 3).contiguous().transpose(2, 3),
               torch.zeros(1, 4, device=cuda), 8, 2)
    with pytest.raises(ValueError, match="shifts"):
        hshear(img, torch.zeros(1, 4), 8, 2)          # shifts on the CPU
