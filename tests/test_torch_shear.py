"""The port's shear augmentation (``ops/shear.py``, ``ops/augment.py``)
against the JAX package's (``ops/pallas_shear.py`` in interpret mode) and
the numpy lerp oracle of tests/test_pallas_shear.py.

On the CPU ``hshear`` runs its plain version, the CUDA kernel's spec
(tests/test_torch_shear_cuda.py holds the kernel to it on the card).
Tolerances: the plain shear 1e-6 on [0, 1] data (f32 lerp, the same
ops); the fused augmentation 1e-5 on its [-1, 1] output (the angle's
tan/sin and the scale matmuls round differently in XLA and PyTorch); the
gather path, which shapes off multiples of 8 take, 1e-3 (as in
tests/test_torch_warp.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.ops import pallas_shear as jshear
from shadow_removal_istd_tpu.ops.augment import (
    AugmentConfig as JAugmentConfig,
)
from shadow_removal_istd_tpu.ops.augment import (
    sample_augment_params as j_sample,
)
from shadow_removal_istd_tpu_torch.ops import shear
from shadow_removal_istd_tpu_torch.ops.augment import (
    AugmentConfig,
    augment_batch,
    normalize_batch,
    sample_augment_params,
)

from test_torch_warp import jax_augment


def _oracle(img, shifts, out_w, pad):
    """tests/test_pallas_shear.py's numpy lerp, with the clip of k."""
    b_, c_, h_, w_ = img.shape
    padded = np.pad(img, ((0, 0), (0, 0), (0, 0), (pad, pad)))
    out = np.zeros((b_, c_, h_, out_w), np.float32)
    for b in range(b_):
        for r in range(h_):
            src = np.float32(shifts[b, r]) + np.float32(pad)
            fl = np.floor(src)
            k = int(np.clip(fl, 0, w_ + 2 * pad - out_w - 1))
            f = np.float32(src - fl)
            row = padded[b, :, r, :]
            out[b, :, r, :] = (row[:, k:k + out_w] * (np.float32(1) - f)
                               + row[:, k + 1:k + 1 + out_w] * f)
    return out


# (B, C, H, W0, out_w, pad, shift range): ragged H (not a multiple of 8
# for the port; the JAX kernel needs H % 8 == 0, so it is compared at the
# multiples), out_w off 128/256, and ranges past both clip bounds
SHAPES = [
    (2, 7, 16, 64, 64, 8, (-4.0, 4.0)),
    (1, 3, 8, 40, 52, 9, (-30.0, 30.0)),     # clips low and high
    (3, 1, 24, 33, 17, 5, (-12.5, 25.0)),
    (1, 7, 13, 20, 21, 3, (-2.0, 2.0)),      # H 13
]


@pytest.mark.parametrize("b,c,h,w0,out_w,pad,rng_", SHAPES)
def test_plain_matches_oracle_and_jax(b, c, h, w0, out_w, pad, rng_):
    rng = np.random.default_rng(b * 1000 + h)
    img = rng.uniform(0, 1, (b, c, h, w0)).astype(np.float32)
    shifts = rng.uniform(*rng_, (b, h)).astype(np.float32)
    got = shear.hshear(torch.from_numpy(img), torch.from_numpy(shifts),
                       out_w, pad).numpy()
    assert got.shape == (b, c, h, out_w)
    np.testing.assert_allclose(got, _oracle(img, shifts, out_w, pad),
                               atol=1e-6)
    if h % 8 == 0:
        want = np.asarray(jshear.hshear(jnp.asarray(img), jnp.asarray(shifts),
                                        out_w, pad, interpret=True))
        np.testing.assert_allclose(got, want, atol=1e-6)
    plain = shear.hshear_plain(torch.from_numpy(img),
                               torch.from_numpy(shifts), out_w, pad)
    assert torch.equal(plain, torch.from_numpy(got))


@pytest.mark.parametrize("b,c,h,w0,out_w,pad,rng_", SHAPES)
def test_transposed_layout_matches(b, c, h, w0, out_w, pad, rng_):
    """``transpose_out`` lays out the same values as (B, C, out_w, H),
    exactly, in the wrapper and in the plain version; the JAX kernel,
    transposed, agrees where it runs (H % 8 == 0)."""
    rng = np.random.default_rng(b * 1000 + h + 1)
    img = torch.from_numpy(rng.uniform(0, 1, (b, c, h, w0)).astype(
        np.float32))
    shifts = torch.from_numpy(rng.uniform(*rng_, (b, h)).astype(np.float32))
    normal = shear.hshear(img, shifts, out_w, pad)
    got = shear.hshear(img, shifts, out_w, pad, transpose_out=True)
    assert got.shape == (b, c, out_w, h) and got.is_contiguous()
    assert torch.equal(got, normal.transpose(2, 3))
    assert torch.equal(shear.hshear_plain(img, shifts, out_w, pad,
                                          transpose_out=True), got)
    assert torch.equal(shear.hshear_plain(img, shifts, out_w, pad), normal)
    if h % 8 == 0:
        want = np.asarray(jshear.hshear(jnp.asarray(img.numpy()),
                                        jnp.asarray(shifts.numpy()), out_w,
                                        pad, interpret=True))
        np.testing.assert_allclose(got.numpy(), want.transpose(0, 1, 3, 2),
                                   atol=1e-6)


def _recording_hshear(monkeypatch, fold: bool):
    """Patch ``shear.hshear`` to record each call's ``transpose_out``;
    with ``fold`` False, run each transposed pass unfolded: the normal
    layout, then an explicit transpose copy."""
    calls, real = [], shear.hshear

    def rec(img, shifts, out_w, pad, *, transpose_out=False):
        calls.append(transpose_out)
        if fold:
            return real(img, shifts, out_w, pad, transpose_out=transpose_out)
        out = real(img, shifts, out_w, pad)
        return out.transpose(2, 3).contiguous() if transpose_out else out

    monkeypatch.setattr(shear, "hshear", rec)
    return calls


@pytest.mark.parametrize("angle", [0.0, 9.0, -14.0])
def test_shear_rotate_crop_folds_the_transposes(monkeypatch, angle):
    """Passes 1 and 2 write transposed and pass 3 normal, and the folded
    composition equals the unfolded one (explicit transposes) exactly."""
    img = torch.from_numpy(_smooth(48, 64)).permute(0, 3, 1, 2)
    args = (torch.tensor([angle]), torch.tensor([5]), torch.tensor([9]), 32)
    outs = {}
    for fold in (True, False):
        with monkeypatch.context() as m:
            calls = _recording_hshear(m, fold)
            outs[fold] = shear.shear_rotate_crop(img, *args)
        assert calls == [True, True, False]
    assert outs[True].shape == (1, 3, 32, 32)
    assert torch.equal(outs[True], outs[False])


def test_zero_shift_identity():
    img = np.random.default_rng(1).uniform(0, 1, (1, 3, 8, 128)).astype(
        np.float32)
    out = shear.hshear(torch.from_numpy(img), torch.zeros(1, 8), 128, 8)
    np.testing.assert_allclose(out.numpy(), img, atol=1e-6)


def test_hshear_rejects_bad_arguments():
    img = torch.zeros(1, 2, 4, 10)
    with pytest.raises(ValueError, match="shifts"):
        shear.hshear(img, torch.zeros(1, 5), 8, 2)
    with pytest.raises(ValueError, match="out_w"):
        shear.hshear(img, torch.zeros(1, 4), 14, 2)
    with pytest.raises(ValueError, match="float32"):
        shear.hshear(img.double(), torch.zeros(1, 4), 8, 2)


def _smooth(h=96, w=128, n=1):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (127 + 60 * np.sin(xx / 11) * np.cos(yy / 13)).astype(np.float32)
    return np.stack([img] * 3, -1)[None].repeat(n, 0)


@pytest.mark.parametrize("angle,max_angle", [(0.0, 15.0), (7.0, 15.0),
                                             (-12.0, 15.0), (25.0, 25.0),
                                             (-40.0, 40.0)])
def test_shear_rotate_crop_matches_jax(angle, max_angle):
    img = _smooth()                                  # (1, 96, 128, 3)
    h, w = img.shape[1:3]
    crop = 48
    ro, co = (20, 30) if max_angle == 15.0 else (h - crop, w - crop)
    args = (np.array([angle], np.float32), np.array([ro], np.int32),
            np.array([co], np.int32))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jshear.shear_rotate_crop(
            jnp.asarray(img), *map(jnp.asarray, args), crop,
            max_angle_deg=max_angle, interpret=True))
    got = shear.shear_rotate_crop(
        torch.from_numpy(img).permute(0, 3, 1, 2),
        *map(torch.from_numpy, args), crop, max_angle_deg=max_angle)
    # 0..255 data: 2e-3 is 1e-5 of the augmentation's [-1, 1] scale
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=2e-3)


def _params(rng, b, h, w, crop, flips):
    return {"scale": rng.uniform(0.93, 1.07, b).astype(np.float32),
            "angle": rng.uniform(-15, 15, b).astype(np.float32),
            "flip": np.array(flips),
            "row_off": rng.integers(0, h - crop, b).astype(np.int32),
            "col_off": rng.integers(0, w - crop, b).astype(np.int32)}


def test_fused_augment_shear_matches_jax():
    rng = np.random.default_rng(4)
    b, h, w, crop = 4, 48, 64, 32
    u8 = rng.integers(0, 256, (b, h, w, 7), dtype=np.uint8)
    p = _params(rng, b, h, w, crop, [False, True, True, False])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(
            lambda x, p: jshear.fused_augment_shear(x, p, crop,
                                                    interpret=True))(
            jnp.asarray(u8), {k: jnp.asarray(v) for k, v in p.items()}))
    got = shear.fused_augment_shear(
        torch.from_numpy(u8), {k: torch.from_numpy(v) for k, v in p.items()},
        crop)
    assert got.shape == (b, 7, crop, crop) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5)


def test_flip_mirrors_the_crop_exactly():
    """No rotation, no scale: the flipped crop is the column mirror of
    the crop at the mirrored offset."""
    rng = np.random.default_rng(5)
    u8 = torch.from_numpy(rng.integers(0, 256, (1, 40, 48, 3),
                                       dtype=np.uint8))
    p = {"scale": torch.ones(1), "angle": torch.zeros(1),
         "row_off": torch.tensor([3]), "col_off": torch.tensor([5])}
    a = shear.fused_augment_shear(u8, {**p, "flip": torch.tensor([False])},
                                  32)
    b = shear.fused_augment_shear(
        u8, {**p, "flip": torch.tensor([True]),
             "col_off": torch.tensor([48 - 32 - 5])}, 32)
    assert torch.equal(a, b.flip(-1))
    want = u8[0, 3:35, 5:37].permute(2, 0, 1).float() * (2.0 / 255.0) - 1.0
    torch.testing.assert_close(a[0], want, atol=1e-5, rtol=0)


def test_augment_batch_synchronises_streams():
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.integers(0, 256, (3, 48, 64, 3),
                                        dtype=np.uint8))
    cfg = AugmentConfig(crop_size=32, method="shear")
    a, m, b = augment_batch(torch.Generator().manual_seed(7),
                            (img, img[..., :1], img), cfg)
    assert a.shape == b.shape == (3, 3, 32, 32) and m.shape == (3, 1, 32, 32)
    assert torch.equal(a, b) and torch.equal(a[:, :1], m)


@pytest.mark.parametrize("h,w,crop", [(480, 640, 256), (256, 300, 256),
                                      (200, 256, 256)])
def test_sample_augment_params_ranges(h, w, crop):
    cfg = AugmentConfig(crop_size=crop, method="shear")
    p = sample_augment_params(torch.Generator().manual_seed(0), 4096,
                              (h, w), cfg)
    assert p["scale"].min() >= 0.95 and p["scale"].max() <= 1.05
    assert p["angle"].min() >= -15 and p["angle"].max() <= 15
    assert 0.45 < p["flip"].float().mean() < 0.55
    # the JAX package's ranges, drawn there too
    jp = j_sample(jax.random.key(0), 4096, (h, w),
                  JAugmentConfig(crop_size=crop))
    for k in ("row_off", "col_off"):
        lo, hi = int(np.min(jp[k])), int(np.max(jp[k]))
        assert (int(p[k].min()), int(p[k].max())) == (lo, hi), k
    if h == crop:
        assert int(p["row_off"].abs().max()) == 0
    if h < crop:       # crop larger than the image: negative offsets
        assert int(p["row_off"].min()) == -(crop - h)


@pytest.mark.parametrize("method,h,w,crop", [("gather", 48, 64, 32),
                                             ("shear", 44, 64, 32),
                                             ("shear", 48, 60, 32),
                                             ("shear", 48, 64, 30)])
def test_gather_path_matches_jax(method, h, w, crop, monkeypatch):
    """``method="gather"``, and ``"shear"`` with H, W or the crop not a
    multiple of 8, take the exact gather path in both packages (no
    ``hshear`` call), and agree on the same explicit parameters."""
    rng = np.random.default_rng(h + w + crop)
    u8 = rng.integers(0, 256, (2, h, w, 7), dtype=np.uint8)
    streams = (u8[..., :3], u8[..., 3:4], u8[..., 4:])
    p = _params(rng, 2, h, w, crop, [True, False])
    want = jax_augment(streams, p, JAugmentConfig(crop_size=crop,
                                                  method=method))
    monkeypatch.setattr(shear, "hshear", None)      # must not be reached
    got = augment_batch(None, tuple(map(torch.from_numpy, streams)),
                        AugmentConfig(crop_size=crop, method=method),
                        params={k: torch.from_numpy(v) for k, v in p.items()})
    for g, w_ in zip(got, want):
        assert g.shape == (2, w_.shape[-1], crop, crop)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w_,
                                   atol=1e-3, rtol=0)


def test_normalize_batch():
    x = torch.tensor([[[[0, 255]]]], dtype=torch.uint8)     # (1,1,1,2)
    (y,) = normalize_batch((x,))
    assert y.shape == (1, 2, 1, 1)
    assert y.flatten().tolist() == [-1.0, 1.0]
