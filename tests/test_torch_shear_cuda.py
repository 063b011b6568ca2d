"""The shear kernel (``csrc/hshear.cu``) against its plain version, on
the card, in both layouts (normal, and ``transpose_out``'s (B, C, out_w,
H)) at ragged shapes: H off the 32-row tile, out_w off the 64-column
tile and off 4, W0 off 4 (the 4-byte-copy instance), every residue of
``(k - pad) mod 4``, pad 0, out_w > W0, C in {1, 3, 7, 8}, B = 1,
shifts past both clip bounds, and a misaligned ``img`` view. The lerp is
written without FMA contraction, so the two agree to the bit
(``torch.equal``); the 3e-5 bound on 0-255 data (one f32 ulp at 255) is
checked beside it.

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


def _check(img, shifts, out_w, pad, transpose_out):
    before = hshear.launches
    got = hshear(img, shifts, out_w, pad, transpose_out=transpose_out)
    assert hshear.launches == before + 1
    want = hshear_plain(img, shifts, out_w, pad, transpose_out=transpose_out)
    torch.cuda.synchronize()
    b, c, h, _ = img.shape
    shape = (b, c, out_w, h) if transpose_out else (b, c, h, out_w)
    assert got.shape == want.shape == shape
    err = (got - want).abs().max().item()
    assert err <= 3e-5, err
    assert torch.equal(got, want), int((got != want).sum())


def _inputs(dev, b, c, h, w0, lo, hi):
    gen = torch.Generator(device=dev).manual_seed(0)
    img = torch.rand(b, c, h, w0, device=dev, generator=gen) * 255.0
    shifts = lo + (hi - lo) * torch.rand(b, h, device=dev, generator=gen)
    return img, shifts


@pytest.mark.parametrize("transpose_out", [False, True],
                         ids=["normal", "transposed"])
@pytest.mark.parametrize("b,c,h,w0,out_w,pad,lo,hi", [
    (1, 1, 5, 37, 29, 3, -9.0, 40.0),          # clips both ends
    (2, 3, 13, 300, 257, 11, -20.0, 60.0),     # out_w one past a block
    (3, 7, 9, 64, 700, 400, -400.0, 100.0),    # out_w > W0, wide border
    (1, 7, 17, 255, 1, 0, -3.0, 300.0),        # one output column
    (2, 7, 8, 640, 712, 72, -75.0, 5.0),       # pass-1 form, ragged B
])
def test_kernel_matches_plain(cuda, b, c, h, w0, out_w, pad, lo, hi,
                              transpose_out):
    img, shifts = _inputs(cuda, b, c, h, w0, lo, hi)
    _check(img, shifts, out_w, pad, transpose_out)


@pytest.mark.parametrize("transpose_out", [False, True],
                         ids=["normal", "transposed"])
@pytest.mark.parametrize("b,c,h,w0,out_w,pad,lo,hi", [
    (2, 7, 33, 64, 65, 8, -12.0, 6.0),     # H one past a tile, out_w too
    (1, 7, 95, 128, 130, 8, -9.0, 9.0),    # out_w % 4 == 2, 3 row tiles
    (2, 8, 40, 66, 70, 5, -8.0, 8.0),      # W0 % 4 == 2: 4-byte copies
    (1, 1, 31, 37, 31, 0, -1.0, 7.0),      # W0 odd, pad 0, out_w odd
    (1, 3, 64, 480, 256, 0, 0.0, 223.0),   # pad 0, no clip at all
    (2, 1, 64, 40, 100, 40, -40.0, 0.0),   # out_w > W0, C 1
    (3, 3, 1, 20, 20, 1, -1.0, 1.0),       # one row
    (1, 7, 40, 480, 256, 97, -97.0, 320.0),  # pass-2 form, clips
    (2, 7, 36, 712, 256, 4, -4.0, 460.0),  # pass-3 form
])
def test_kernel_tile_edges(cuda, b, c, h, w0, out_w, pad, lo, hi,
                           transpose_out):
    img, shifts = _inputs(cuda, b, c, h, w0, lo, hi)
    _check(img, shifts, out_w, pad, transpose_out)


@pytest.mark.parametrize("transpose_out", [False, True],
                         ids=["normal", "transposed"])
@pytest.mark.parametrize("w0", [64, 63])
def test_kernel_every_start_residue(cuda, w0, transpose_out):
    """Rows whose first tap ``k - pad`` covers every residue mod 4, with
    fractions 0, 1/4, 1/2 and 3/4 and integer starts on both sides of 0
    and of W0 - out_w."""
    b, c, h, out_w, pad = 2, 7, 64, 40, 6
    r = torch.arange(b * h, device=cuda, dtype=torch.float32)
    shifts = (torch.remainder(r * 3, 2 * pad + w0 - out_w + 4) - pad - 2
              + 0.25 * (r % 4)).view(b, h)
    img, _ = _inputs(cuda, b, c, h, w0, 0.0, 1.0)
    _check(img, shifts, out_w, pad, transpose_out)


@pytest.mark.parametrize("transpose_out", [False, True],
                         ids=["normal", "transposed"])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_misaligned_img(cuda, offset, transpose_out):
    """A contiguous ``img`` view 4, 8 or 12 bytes past a 16-byte boundary
    takes the 4-byte-copy instance; nothing outside the view is read (the
    storage around it holds NaN, which would reach the output)."""
    b, c, h, w0, out_w, pad = 2, 7, 40, 64, 72, 8
    n = b * c * h * w0
    buf = torch.full((n + 8,), float("nan"), device=cuda)
    img = buf[offset:offset + n].view(b, c, h, w0)
    img.copy_(_inputs(cuda, b, c, h, w0, 0.0, 1.0)[0])
    assert img.data_ptr() % 16 != 0 and img.is_contiguous()
    shifts = _inputs(cuda, b, 1, h, 4, -12.0, 12.0)[1]
    _check(img, shifts, out_w, pad, transpose_out)


def test_kernel_rejects_what_it_does_not_take(cuda):
    img = torch.rand(1, 2, 4, 10, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        hshear(img.transpose(2, 3).contiguous().transpose(2, 3),
               torch.zeros(1, 4, device=cuda), 8, 2)
    with pytest.raises(ValueError, match="shifts"):
        hshear(img, torch.zeros(1, 4), 8, 2)          # shifts on the CPU
