"""The port's resize (``ops/resize.py``), inverse-affine warp
(``ops/warp.py``) and gather augmentation (``ops/augment.py``) against
the JAX package's, on the same seeded numpy inputs and explicit
augmentation parameters.

Tolerances: the resize 1e-5 on [0, 1] data and 1e-4 on 0-255 data (the
same f32 weights, two f32 contractions summed in other orders; JAX at
"highest" precision); the warp and the augmentation 1e-3 on the [-1, 1]
output scale (0.1275 on 0-255 data: cos/sin and the coordinate
arithmetic round differently in XLA and PyTorch, and a bilinear weight
moves with them), flips and integer offsets exact.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.ops import augment as jaugment
from shadow_removal_istd_tpu_torch.ops import resize as tresize
from shadow_removal_istd_tpu_torch.ops import warp as twarp
from shadow_removal_istd_tpu_torch.ops.augment import (
    AugmentConfig,
    augment_batch,
    augment_gather,
    uses_shear,
)

# the JAX ops package re-exports functions under its modules' names
jresize = importlib.import_module("shadow_removal_istd_tpu.ops.resize")
jwarp = importlib.import_module("shadow_removal_istd_tpu.ops.warp")

WARP_TOL = 1e-3 * 127.5      # 1e-3 of [-1, 1] on 0-255 data


@pytest.mark.parametrize("n_in,n_out", [(32, 16), (64, 24), (30, 7),
                                        (16, 40), (5, 5), (480, 256)])
def test_resize_matrices_equal_jax(n_in, n_out):
    for name in ("resize_matrix_linear", "resize_matrix_area"):
        got = getattr(tresize, name)(n_in, n_out)
        want = getattr(jresize, name)(n_in, n_out)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)


RESIZE_CASES = [((2, 32, 64, 3), (16, 32)), ((1, 32, 64, 7), (12, 20)),
                ((2, 24, 40, 1), (48, 80)), ((1, 32, 64, 3), (20, 100))]


@pytest.mark.parametrize("method", ["linear", "area", "auto"])
@pytest.mark.parametrize("shape,size", RESIZE_CASES)
@pytest.mark.parametrize("scale,tol", [(1.0, 1e-5), (255.0, 1e-4)])
def test_resize_matches_jax(method, shape, size, scale, tol):
    x = (np.random.default_rng(0).random(shape) * scale).astype(np.float32)
    fn = {"linear": jresize.resize_linear, "area": jresize.resize_area,
          "auto": jresize.resize}[method]
    want = np.asarray(fn(jnp.asarray(x), size))
    tfn = {"linear": tresize.resize_linear, "area": tresize.resize_area,
           "auto": tresize.resize}[method]
    got = tfn(torch.from_numpy(x), size)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=tol * scale,
                               rtol=0)


def test_resize_ignores_the_global_matmul_setting(monkeypatch):
    """A caller's TF32 setting does not reach the resize's matmuls, and
    is restored after them."""
    seen = []

    def spy(real):
        def inner(*a):
            seen.append(torch.get_float32_matmul_precision())
            return real(*a)
        return inner

    monkeypatch.setattr(torch.Tensor, "__matmul__",
                        spy(torch.Tensor.__matmul__))
    monkeypatch.setattr(torch, "einsum", spy(torch.einsum))
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        tresize.resize_linear(torch.rand(1, 8, 8, 3), (4, 4))
        assert seen == ["highest", "highest"]
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    with pytest.raises(ValueError, match="unknown resize method"):
        tresize.resize(torch.rand(1, 8, 8, 3), (4, 4), method="cubic")


def test_resize_on_the_grid_is_exact():
    """Identity sizes give the input, and an integer area shrink is the
    block mean."""
    x = torch.from_numpy(np.random.default_rng(1).random(
        (1, 8, 12, 2)).astype(np.float32))
    torch.testing.assert_close(tresize.resize(x, (8, 12)), x, atol=0,
                               rtol=0)
    want = x.reshape(1, 4, 2, 6, 2, 2).mean(dim=(2, 4))
    torch.testing.assert_close(tresize.resize(x, (4, 6)), want, atol=1e-6,
                               rtol=0)


MATRIX_CASES = [(0.0, 1.0), (15.0, 1.05), (-12.5, 0.95), (90.0, 1.0),
                (-3.0, 0.97)]


@pytest.mark.parametrize("angle,scale", MATRIX_CASES)
def test_rotation_scale_matrix_and_inverse_match_jax(angle, scale):
    center = (31.5, 15.5)
    want = np.asarray(jwarp.rotation_scale_matrix(
        jnp.float32(angle), jnp.float32(scale), center))
    got = twarp.rotation_scale_matrix(torch.tensor([angle]),
                                      torch.tensor([scale]), center)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)
    want_inv = np.asarray(jwarp.invert_affine(jnp.asarray(want)))
    got_inv = twarp.invert_affine(got[None])[0]
    np.testing.assert_allclose(got_inv.numpy(), want_inv, atol=1e-4,
                               rtol=1e-5)


def _smooth_u8(rng, n, h, w, c):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([127.5 + 120 * np.sin(xx / (5 + i) + i)
                     * np.cos(yy / (7 + i)) for i in range(n * c)])
    noise = rng.integers(-6, 7, base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8).reshape(
        n, c, h, w).transpose(0, 2, 3, 1).copy()


# (angle, scale, row_off, col_off, flip, out (rows, cols)); offsets past
# the image and a crop larger than it exercise the zero border
WARP_CASES = [
    (0.0, 1.0, 0, 0, False, (32, 64)),
    (10.0, 1.0, 3, 5, False, (24, 40)),
    (-14.0, 1.04, 8, 20, True, (24, 40)),
    (7.5, 0.96, -6, -9, False, (40, 80)),
    (45.0, 1.0, 0, 0, True, (32, 64)),
    (-90.0, 1.02, 2, 2, False, (28, 28)),
]


@pytest.mark.parametrize("angle,scale,ro,co,flip,out", WARP_CASES)
def test_affine_warp_matches_jax(angle, scale, ro, co, flip, out):
    rng = np.random.default_rng(2)
    img = _smooth_u8(rng, 1, 32, 64, 3)[0]
    h, w = img.shape[:2]
    center = ((w - 1) / 2.0, (h - 1) / 2.0)
    jinv = jwarp.invert_affine(jwarp.rotation_scale_matrix(
        jnp.float32(angle), jnp.float32(scale), center))
    want = np.asarray(jax.jit(
        lambda i, m: jwarp.affine_warp(
            i, m, out_shape=out, offset=(jnp.float32(ro), jnp.float32(co)),
            flip=jnp.asarray(flip)))(jnp.asarray(img), jinv))
    tinv = twarp.invert_affine(twarp.rotation_scale_matrix(
        torch.tensor([angle]), torch.tensor([scale]), center))
    got = twarp.affine_warp(
        torch.from_numpy(img)[None], tinv, out_shape=out,
        offset=(torch.tensor([ro]), torch.tensor([co])),
        flip=torch.tensor([flip]))[0]
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=WARP_TOL, rtol=0)


def test_affine_warp_identity_flip_and_offset_are_exact():
    """No rotation, no scale: the output is the source shifted by the
    integer offsets (zero outside), and a flip mirrors the plane."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(_smooth_u8(rng, 2, 20, 30, 2))
    eye = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]]).expand(2, 2, 3)
    out = twarp.affine_warp(img, eye, out_shape=(12, 16),
                            offset=(torch.tensor([3, -2]),
                                    torch.tensor([5, 20])),
                            flip=torch.tensor([False, False]))
    assert torch.equal(out[0], img[0, 3:15, 5:21].float())
    want = torch.zeros(12, 16, 2)
    want[2:, :10] = img[1, 0:10, 20:30].float()
    assert torch.equal(out[1], want)
    flipped = twarp.affine_warp(img, eye, flip=torch.tensor([True, True]))
    assert torch.equal(flipped, img.flip(2).float())


def _params(rng, b, h, w, crop, flips):
    return {"scale": rng.uniform(0.95, 1.05, b).astype(np.float32),
            "angle": rng.uniform(-15, 15, b).astype(np.float32),
            "flip": np.array(flips),
            "row_off": rng.integers(min(0, h - crop), max(h - crop, 1),
                                    b).astype(np.int32),
            "col_off": rng.integers(min(0, w - crop), max(w - crop, 1),
                                    b).astype(np.int32)}


def jax_augment(streams, params, cfg):
    """JAX ``augment_batch`` with its parameter draw replaced by
    ``params`` (jitted; matmuls at "highest" precision)."""
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    orig = jaugment.sample_augment_params
    jaugment.sample_augment_params = lambda *a, **k: jparams
    try:
        with jax.default_matmul_precision("highest"):
            out = jax.jit(lambda s: jaugment.augment_batch(
                jax.random.key(0), s, cfg))(
                tuple(jnp.asarray(s) for s in streams))
    finally:
        jaugment.sample_augment_params = orig
    return [np.asarray(o) for o in out]


def _compare(got, want):
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w_,
                                   atol=1e-3, rtol=0)


@pytest.mark.parametrize("h,w,crop", [(32, 64, 24), (36, 52, 32),
                                      (32, 64, 40)])
def test_gather_augment_batch_matches_jax(h, w, crop):
    """The triplet (img, matte, target) through the gather path with the
    same explicit parameters, crops inside and larger than the image."""
    rng = np.random.default_rng(h + w + crop)
    u8 = _smooth_u8(rng, 3, h, w, 7)
    streams = (u8[..., :3], u8[..., 3:4], u8[..., 4:])
    p = _params(rng, 3, h, w, crop, [True, False, True])
    want = jax_augment(streams, p, jaugment.AugmentConfig(crop_size=crop))
    got = augment_batch(None, tuple(map(torch.from_numpy, streams)),
                        AugmentConfig(crop_size=crop),
                        params={k: torch.from_numpy(v) for k, v in p.items()})
    assert [tuple(g.shape) for g in got] == [(3, c, crop, crop)
                                             for c in (3, 1, 3)]
    _compare(got, want)


def test_gather_flip_and_offsets_are_exact():
    """No rotation, no scale: the crop is the source at the offsets
    exactly, and the flipped crop its mirror at the mirrored offset."""
    rng = np.random.default_rng(4)
    u8 = torch.from_numpy(_smooth_u8(rng, 1, 40, 48, 3))
    p = {"scale": torch.ones(1), "angle": torch.zeros(1),
         "row_off": torch.tensor([3]), "col_off": torch.tensor([5])}
    a = augment_gather(u8, {**p, "flip": torch.tensor([False])}, 32)
    b = augment_gather(u8, {**p, "flip": torch.tensor([True]),
                            "col_off": torch.tensor([48 - 32 - 5])}, 32)
    assert torch.equal(a, b.flip(-1))
    want = u8[0, 3:35, 5:37].permute(2, 0, 1).float() * (2.0 / 255.0) - 1.0
    assert torch.equal(a[0], want)


@pytest.mark.parametrize("size", [(24, 40), (40, 72)])
def test_pre_augmentation_resize_matches_jax(size):
    """``AugmentConfig.resize`` resamples the group (area shrinking,
    linear enlarging) before the warp, with the offsets drawn for the
    resized shape."""
    rng = np.random.default_rng(5)
    u8 = _smooth_u8(rng, 2, 32, 64, 7)
    streams = (u8[..., :3], u8[..., 3:4], u8[..., 4:])
    crop = 16
    p = _params(rng, 2, *size, crop, [False, True])
    want = jax_augment(streams, p, jaugment.AugmentConfig(
        crop_size=crop, resize=size))
    got = augment_batch(None, tuple(map(torch.from_numpy, streams)),
                        AugmentConfig(crop_size=crop, resize=size),
                        params={k: torch.from_numpy(v) for k, v in p.items()})
    _compare(got, want)


def test_gather_draws_offsets_for_the_resized_shape():
    cfg = AugmentConfig(crop_size=16, resize=(20, 24))
    img = torch.zeros(64, 64, 96, 3, dtype=torch.uint8)
    out, = augment_batch(torch.Generator().manual_seed(0), (img,), cfg)
    assert out.shape == (64, 3, 16, 16)
    assert uses_shear(AugmentConfig(method="shear", crop_size=16), 24, 32)
    assert not uses_shear(AugmentConfig(method="shear", crop_size=16),
                          20, 24)
    assert not uses_shear(AugmentConfig(crop_size=16), 24, 32)
    with pytest.raises(ValueError, match="unknown augmentation method"):
        AugmentConfig(method="cubic")
