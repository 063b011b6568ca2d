"""The port's int8 post-training quantization (``models/quant.py``,
``ops/int8_conv.py``'s plain versions, ``tools/convert.py::
jax_int8_pack_to_torch`` and the int8 ``InferenceEngine``) against the
JAX package's ``models/quant.py`` and int8 engine, on the CPU.

MNets at ngf 8 and 32x32 (ngf 4 for the engines), with BatchNorm
statistics from three train-mode passes of the JAX MNet (as
tests/test_quant.py makes them) and LeCun-normal kernels drawn with
numpy; inputs from a numpy seed go through both packages. Measured here:
the fold within ~1.5e-7 relative of JAX's; every int8 weight and every
scale of a pack equal to JAX's; the quantized forward within ~1.2e-7 of
JAX's in f32 and in bf16 compute (the port's LeakyReLU multiplies by the
slope rounded to the compute dtype, as JAX's does); int8 against the
folded f32 forward ~48 dB PSNR. Tolerances are stated per test.
"""
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.models import quant as jq
from shadow_removal_istd_tpu.models.layers import (
    subpixel_depth_to_space as jax_depth_to_space,
)
from shadow_removal_istd_tpu.models.mnet import MNet as JaxMNet
from shadow_removal_istd_tpu.serving import (
    InferenceEngine as JaxInferenceEngine,
)
from shadow_removal_istd_tpu_torch.models import get_generator
from shadow_removal_istd_tpu_torch.models import quant as tq
from shadow_removal_istd_tpu_torch.ops.int8_conv import (
    all_phase_weight,
    channels_padded,
    int8_conv,
    int8_conv_plain,
    pad_weight,
    quantize_pad_plain,
)
from shadow_removal_istd_tpu_torch.serving import InferenceEngine
from shadow_removal_istd_tpu_torch.tools.convert import (
    flax_tree_to_torch,
    jax_int8_pack_to_torch,
)

SITES = {"stem", "down0", "down1", "down2", "down3",
         "up0", "up1", "up2", "up3", "final"}


def _psnr(a, b):
    rms = float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))
    return 20 * np.log10(2.0 / max(rms, 1e-12))


def _trained_like(in_ch, out_ch, ngf, seed, steps=3):
    """A JAX MNet's variables as numpy trees: LeCun-normal kernels drawn
    by numpy into the shapes of ``jax.eval_shape(init)``, BatchNorm
    statistics from ``steps`` jitted train-mode passes over numpy
    inputs."""
    model = JaxMNet(out_channels=out_ch, ngf=ngf, drop_rate=0.0)
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, in_ch)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        return (np.ones if name in ("scale", "var") else np.zeros)(
            s.shape, np.float32)

    v = jax.tree_util.tree_map_with_path(leaf, shapes)
    step = jax.jit(lambda p, s, x: model.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        mutable=["batch_stats"])[1]["batch_stats"])
    stats = v["batch_stats"]
    for _ in range(steps):
        x = np.tanh(rng.standard_normal((2, 32, 32, in_ch))).astype(
            np.float32)
        stats = step(v["params"], stats, x)
    return {"params": v["params"],
            "batch_stats": jax.tree.map(np.asarray, stats)}


def _port_mnet(v, in_ch, out_ch, ngf):
    m = get_generator("mnet", in_channels=in_ch, out_channels=out_ch,
                      ngf=ngf)
    flax_tree_to_torch(v, m)
    return m.eval()


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _oihw(folded):
    """JAX's folded dict (HWIO) in the port's layout (OIHW)."""
    return {k: torch.from_numpy(np.array(
        np.asarray(a).transpose(3, 2, 0, 1) if np.ndim(a) == 4 else a))
        for k, a in folded.items()}


@pytest.fixture(scope="module")
def g1():
    """G1 (3 -> 1) at ngf 8 in both packages, one 32x32 batch of 2, and
    JAX's fold, calibration and pack of it."""
    v = _trained_like(3, 1, 8, seed=0)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    params, stats = v["params"], v["batch_stats"]
    with jax.default_matmul_precision("highest"):
        folded = jq.fold_mnet(params, stats)
        ref, amax = jax.jit(lambda f, t: jq.mnet_apply_folded(
            f, t, observe=True))(folded, x)
    pack = jq.quantize_mnet(folded, amax)
    return types.SimpleNamespace(
        v=v, x=x, xt=_nchw(x), folded=folded, ref=np.asarray(ref),
        amax=amax, pack=jax.tree.map(np.asarray, pack),
        port=_port_mnet(v, 3, 1, 8))


def test_fold_matches_jax(g1):
    """(a) The port's fold of the port MNet equals JAX's fold of the same
    tree within 1e-6 relative, after HWIO -> OIHW."""
    got = tq.fold_mnet(g1.port)
    assert set(got) == set(g1.folded)
    for k, want in _oihw(g1.folded).items():
        scale = float(want.abs().max())
        assert float((got[k] - want).abs().max()) <= 1e-6 * scale, k


def test_folded_forward_matches_eval_mnet_and_jax(g1):
    """(a) The folded f32 forward equals the port's eval MNet and JAX's
    ``mnet_apply_folded`` (precision "highest") within 2e-5."""
    got = tq.mnet_apply_folded(tq.fold_mnet(g1.port), g1.xt)
    with torch.no_grad():
        eval_y = g1.port(g1.xt)
    assert got.shape == (2, 1, 32, 32)
    np.testing.assert_allclose(_nhwc(got), _nhwc(eval_y), atol=2e-5)
    np.testing.assert_allclose(_nhwc(got), g1.ref, atol=2e-5)


def test_observe_sites_match_jax(g1):
    """(b) ``observe`` gives JAX's 10 sites, amaxes within 1e-5 rel."""
    _, amax = tq.mnet_apply_folded(tq.fold_mnet(g1.port), g1.xt,
                                   observe=True)
    assert set(amax) == set(g1.amax) == SITES
    for k in SITES:
        np.testing.assert_allclose(float(amax[k]), float(g1.amax[k]),
                                   rtol=1e-5, err_msg=k)


def test_quantize_matches_jax(g1):
    """(c) Fed JAX's folded params and amaxes, ``quantize_mnet`` gives
    JAX's int8 weights (at most 1e-4 of them one off a rounding
    boundary, none further; 0 measured) and its scales (rtol 1e-6)."""
    got = tq.quantize_mnet(_oihw(g1.folded), {
        k: torch.tensor(float(a)) for k, a in g1.amax.items()})
    assert set(got) == set(g1.pack)
    off = total = 0
    for k, want in g1.pack.items():
        a = got[k].numpy()
        if k.endswith("_w"):
            assert a.dtype == np.int8
            d = np.abs(a.transpose(1, 2, 3, 0).astype(int) - want)
            assert d.max() <= 1, k
            off += int(d.sum())
            total += d.size
        else:
            np.testing.assert_allclose(a, want, rtol=1e-6, err_msg=k)
    assert off <= 1e-4 * total, f"{off} of {total} weights off by one"


@pytest.mark.parametrize("phase,ci,co", [
    (False, 3, 8),       # the G1 stem: K = 48
    (False, 4, 8),       # the G2 stem: K = 64
    (False, 40, 24),     # a K tile cut
    (True, 16, 1),       # G1's final step: 4*Co = 4
    (True, 24, 3),       # G2's final step: 4*Co = 12
    (True, 64, 16),
])
def test_plain_int8_conv_equals_lax_conv(phase, ci, co):
    """(d) ``int8_conv_plain``'s s32 sums equal ``lax.conv_general_dilated
    (..., preferred_element_type=int32)`` exactly, in both forms (the
    phase form after JAX's ``subpixel_depth_to_space``), and its
    dequantize equals JAX's ``acc.astype(f32) * s (+ b)`` bit for bit."""
    rng = np.random.default_rng(ci * 10 + co)
    h, w = (9, 7) if phase else (18, 14)
    k, rows = (2, 4 * co) if phase else (4, co)
    xp = rng.integers(-127, 128, (2, h + 2, w + 2, ci), dtype=np.int8)
    w_hwio = rng.integers(-127, 128, (k, k, ci, rows), dtype=np.int8)
    s = (rng.random(rows) * 1e-3).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    acc = jax.lax.conv_general_dilated(
        xp, w_hwio, (1, 1) if phase else (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    deq = acc.astype(jnp.float32) * s
    if phase:
        acc = jax_depth_to_space(acc, h, w, co)
        deq = jax_depth_to_space(deq, h, w, co)
    deq = deq + b
    xq = torch.from_numpy(np.pad(xp, ((0, 0),) * 3 + ((
        0, channels_padded(ci) - ci),)))
    wk = pad_weight(torch.from_numpy(w_hwio.transpose(3, 0, 1, 2).copy()))
    got = int8_conv_plain(xq, wk, phase=phase)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(acc))
    got = int8_conv_plain(xq, wk, torch.from_numpy(s), torch.from_numpy(b),
                          phase=phase)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(deq))


@pytest.mark.parametrize("co", [1, 3])
def test_all_phase_weight_is_the_phase_conv(co):
    """The finals' kernel form (all four phases over the 3x3 window):
    a 3x3 stride-1 conv of the padded input with ``all_phase_weight``
    gives, in its column block p, JAX's 2x2 phase conv of phase p exactly,
    and ``int8_conv_plain`` takes the expanded weight to the 2x2 weight's
    result, in s32 sums and dequantized, bit for bit."""
    rng = np.random.default_rng(co)
    h, w, ci = 7, 9, 16
    xp = rng.integers(-127, 128, (2, h + 2, w + 2, ci), dtype=np.int8)
    w_hwio = rng.integers(-127, 128, (2, 2, ci, 4 * co), dtype=np.int8)
    want = jax_depth_to_space(jax.lax.conv_general_dilated(
        xp, w_hwio, (1, 1), "VALID", dimension_numbers=(
            "NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32),
        h, w, co)
    wk = torch.from_numpy(w_hwio.transpose(3, 0, 1, 2).copy())
    w9 = all_phase_weight(wk)
    assert w9.shape == (4 * co, 3, 3, ci) and w9.is_contiguous()
    got = jax.lax.conv_general_dilated(
        xp, w9.permute(1, 2, 3, 0).numpy(), (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    for p in range(4):
        np.testing.assert_array_equal(
            np.asarray(got)[..., p * co:(p + 1) * co],
            np.asarray(want)[:, p // 2::2, p % 2::2])
    xq = torch.from_numpy(xp)
    acc = int8_conv_plain(xq, w9, phase=True)
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))
    s = torch.from_numpy((rng.random(4 * co) * 1e-3).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(co).astype(np.float32))
    for out_dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(
            int8_conv(xq, w9, s, b, phase=True, out_dtype=out_dtype),
            int8_conv_plain(xq, wk, s, b, phase=True, out_dtype=out_dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chans,leaky,reflect", [
    ((3,), False, True), ((40,), True, True), ((24, 8), True, False),
    ((16, 16), False, False)])
def test_quantize_pad_plain_equals_jax(dtype, chans, leaky, reflect):
    """``quantize_pad_plain`` equals JAX's ``pad(_quantize(act(concat)))``
    (quant.py's encoder and phase-conv inputs) bit for bit, channels past
    the concat zero."""
    rng = np.random.default_rng(sum(chans))
    jdt = getattr(jnp, dtype)
    xs = [jnp.asarray(rng.standard_normal((2, 6, 5, c)) * 3, jdt)
          for c in chans]
    sx = jnp.asarray(0.023, jnp.float32)
    z = jnp.concatenate(xs, -1)
    want = jnp.pad(jq._quantize(jq._leaky(z) if leaky else z, sx),
                   ((0, 0), (1, 1), (1, 1), (0, 0)),
                   mode="reflect" if reflect else "edge")
    parts = [_nchw(np.asarray(x.astype(jnp.float32))).to(getattr(torch,
                                                               dtype))
             for x in xs]
    got = quantize_pad_plain(parts, torch.tensor(0.023), leaky=leaky,
                             reflect=reflect)
    assert got.shape[-1] == channels_padded(sum(chans))
    np.testing.assert_array_equal(got[..., :sum(chans)].numpy(),
                                  np.asarray(want))
    assert not got[..., sum(chans):].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_forward_matches_jax(g1, dtype):
    """(e) On JAX's own pack (carried by ``jax_int8_pack_to_torch``) the
    port's quantized forward tracks JAX's ``mnet_apply_folded(None, x,
    qparams=q)`` above 45 dB PSNR and within 1e-5 (measured 1.2e-7 in
    both dtypes); int8 against the folded f32 forward above 35 dB."""
    q = jax_int8_pack_to_torch(g1.pack, g1.port)
    want = np.asarray(jax.jit(lambda p, t: jq.mnet_apply_folded(
        None, t, qparams=p, compute_dtype=getattr(jnp, dtype)))(
            g1.pack, g1.x))
    got = _nhwc(tq.mnet_apply_folded(None, g1.xt, qparams=q,
                                     compute_dtype=getattr(torch, dtype)))
    assert _psnr(got, want) > 45.0
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert _psnr(got, g1.ref) > 35.0


def test_selective_int8(g1):
    """(f) An empty ``quant_sites`` is the folded forward bit for bit;
    ``ENCODER_SITES`` lies between full int8 and f32 (above 35 dB, and
    no worse than full int8)."""
    folded = tq.fold_mnet(g1.port)
    q = tq.quantize_mnet(folded, tq.calibrate_mnet(folded, [g1.xt]))
    ref = tq.mnet_apply_folded(folded, g1.xt)
    none = tq.mnet_apply_folded(folded, g1.xt, qparams=q,
                                quant_sites=frozenset())
    assert torch.equal(none, ref)
    enc = tq.mnet_apply_folded(folded, g1.xt, qparams=q,
                               quant_sites=tq.ENCODER_SITES)
    full = tq.mnet_apply_folded(None, g1.xt, qparams=q)
    p_enc = _psnr(_nhwc(enc), _nhwc(ref))
    assert p_enc > 35.0
    assert p_enc >= _psnr(_nhwc(full), _nhwc(ref))


def test_stacked_int8_matches_jax():
    """(g) ``quantize_stacked`` and ``make_stacked_int8`` against JAX's on
    one G1/G2 pair: the packs agree (int8 weights at most one apart, on
    at most 1e-3 of them: the two folds differ in the last bits), the
    stacked outputs within 45 dB of JAX's, and both track the folded
    f32 pair above 30 dB."""
    v1, v2 = _trained_like(3, 1, 8, seed=2), _trained_like(4, 3, 8, seed=3)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    jstate = types.SimpleNamespace(
        g_params={"g1": v1["params"], "g2": v2["params"]},
        batch_stats={"g1": v1["batch_stats"], "g2": v2["batch_stats"]})
    tstate = types.SimpleNamespace(models=types.SimpleNamespace(
        g1=_port_mnet(v1, 3, 1, 8), g2=_port_mnet(v2, 4, 3, 8)))
    jq1, jq2 = jq.quantize_stacked(jstate, [x])
    q1, q2 = tq.quantize_stacked(tstate, [_nchw(x)])
    for want, got in ((jq1, q1), (jq2, q2)):
        assert set(got) == set(want)
        for k in want:
            a, b = got[k].numpy(), np.asarray(want[k])
            if k.endswith("_w"):
                d = np.abs(a.transpose(1, 2, 3, 0).astype(int) - b)
                assert d.max() <= 1 and d.sum() <= 1e-3 * d.size, k
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=k)
    jm, jy = jax.jit(jq.make_stacked_int8(jq1, jq2))(x)
    m, y = tq.make_stacked_int8(q1, q2)(_nchw(x))
    assert m.shape == (2, 1, 32, 32) and y.shape == (2, 3, 32, 32)
    assert _psnr(_nhwc(m), np.asarray(jm)) > 45.0
    assert _psnr(_nhwc(y), np.asarray(jy)) > 45.0
    f1, f2 = tq.fold_stacked(tstate)
    m_ref = tq.mnet_apply_folded(f1, _nchw(x))
    y_ref = tq.mnet_apply_folded(f2, torch.cat([_nchw(x), m_ref], 1))
    assert _psnr(_nhwc(y), _nhwc(y_ref)) > 30.0


def test_int8_pack_conversion_refuses_mismatches(g1):
    """``jax_int8_pack_to_torch`` raises on a missing or extra key, a
    shape mismatch and float weights, as ``flax_tree_to_torch`` does."""
    good = dict(g1.pack)
    q = jax_int8_pack_to_torch(good, g1.port)
    assert q["down1_w"].shape == (32, 4, 4, 16)
    assert q["up1_w"].shape == (128, 2, 2, 128)
    for bad in ({k: v for k, v in good.items() if k != "up2_b"},
                {**good, "extra_w": good["stem_w"]},
                {**good, "final_s": good["final_s"][:2]},
                {**good, "down0_w": good["down0_w"].astype(np.float32)}):
        with pytest.raises(ValueError):
            jax_int8_pack_to_torch(bad, g1.port)


_JIT_INIT = jax.jit(JaxMNet.init, static_argnums=0)


def test_int8_engine_matches_jax_engine(tmp_path):
    """(h) The port's int8 engine and JAX's, given the same weights and
    calibration images, answer within 2 gray levels; the port quantizes
    once the weights land (``load_weights``: exactly once), not at
    construction, and not again per request."""
    rng = np.random.default_rng(5)
    calib = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
             for _ in range(2)]
    imgs = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
            for _ in range(2)]
    with mock.patch.object(JaxMNet, "init", _JIT_INIT):
        jeng = JaxInferenceEngine("mnet", ngf=4, dtype="int8", max_batch=2,
                                  calib_images=calib)
    paths = []
    for name, v in (("g1", jeng.v1), ("g2", jeng.v2)):
        flat = jax.tree_util.tree_flatten_with_path(
            {"params": v["params"], "batch_stats": v["batch_stats"]})[0]
        path = tmp_path / f"{name}.npz"
        np.savez(path, **{"/".join(k.key for k in p): np.asarray(a)
                          for p, a in flat})
        paths.append(str(path))
    calls = []
    orig = InferenceEngine._maybe_quantize

    def counted(self):
        calls.append(self)
        return orig(self)

    with mock.patch.object(InferenceEngine, "_maybe_quantize", counted):
        eng = InferenceEngine(ngf=4, dtype="int8", max_batch=2,
                              calib_images=calib, device="cpu")
        assert not calls and eng._int8_fn is None
        eng.load_weights(*paths)
        assert len(calls) == 1 and eng._int8_fn is not None
        got = eng.infer_group(imgs)
        assert len(calls) == 1
    want = jeng.infer_group(imgs)
    for (m, y), (wm, wy) in zip(got, want):
        assert m.shape == (32, 48) and y.shape == (32, 48, 3)
        assert np.abs(m.astype(int) - wm).max() <= 2
        assert np.abs(y.astype(int) - wy).max() <= 2
