"""The port's decoder op (plain path on the CPU) vs the JAX decoder step.

Same numpy inputs through ``fused_decoder_upsample`` (Pallas, interpret
mode), ``reference_decoder_upsample`` and the port's
``ops/decoder.decoder_upsample``; tolerances are those of
tests/test_pallas_decoder.py (2e-5 in f32, 3e-2 in bf16, where only the
accumulation order and the bf16 rounding of the conv output differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.models import layers as jl
from shadow_removal_istd_tpu.ops.pallas_decoder import (
    fused_decoder_upsample,
    reference_decoder_upsample,
)
from shadow_removal_istd_tpu_torch.models import layers as tl
from shadow_removal_istd_tpu_torch.models.mnet import MNet
from shadow_removal_istd_tpu_torch.ops.decoder import (
    _aligned,
    decoder_upsample,
    decoder_upsample_all_phase,
    decoder_upsample_plain,
    decoder_variant,
    narrow_weight,
    subpixel_depth_to_space,
)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(n, h, w, ci, co, dtype, seed=0):
    """numpy inputs, rounded to ``dtype`` so both sides see equal values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, ci)) * 0.5
    w4 = rng.standard_normal((2, 2, ci, 4 * co)) * 0.05
    s4 = np.tile(rng.uniform(0.5, 1.5, co), 4).astype(np.float32)
    b4 = np.tile(rng.standard_normal(co) * 0.1, 4).astype(np.float32)
    rnd = lambda a: np.array(  # noqa: E731
        jnp.asarray(a, JDT[dtype]).astype(jnp.float32))
    return rnd(x), rnd(w4), s4, b4


def _t(x_nhwc, dtype):
    """NHWC numpy -> NCHW channels_last torch tensor of ``dtype``."""
    return (torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).to(TDT[dtype])
            .contiguous(memory_format=torch.channels_last))


def _np(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _jax_step(x, w4, s4, b4, dtype, fused):
    args = (jnp.asarray(x, JDT[dtype]), jnp.asarray(w4, JDT[dtype]),
            jnp.asarray(s4), jnp.asarray(b4))
    with jax.default_matmul_precision("highest"):
        out = (fused_decoder_upsample(*args, interpret=True) if fused
               else reference_decoder_upsample(*args))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (2, 8, 8, 16, 8),
    (1, 12, 16, 8, 8),
    (2, 6, 10, 8, 16),
    (1, 16, 16, 32, 8),
    (1, 6, 10, 16, 1),    # Co 1 and 3: the narrow kernel's shapes
    (2, 8, 8, 16, 3),
])
def test_one_part_matches_jax(shape, dtype):
    n, h, w, ci, co = shape
    x, w4, s4, b4 = _inputs(n, h, w, ci, co, dtype)
    got = decoder_upsample([_t(x, dtype)], torch.from_numpy(w4).to(TDT[dtype]),
                           torch.from_numpy(s4), torch.from_numpy(b4),
                           leaky=True)
    assert got.shape == (n, co, 2 * h, 2 * w) and got.dtype == TDT[dtype]
    assert got.is_contiguous(memory_format=torch.channels_last)
    tol = TOL[dtype]
    for fused in (False, True):
        np.testing.assert_allclose(_np(got),
                                   _jax_step(x, w4, s4, b4, dtype, fused),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_parts_match_jax_on_concat(dtype):
    """(y, link) parts with one shared w4 == the op on their concat."""
    n, h, w, ca, cb, co = 2, 8, 12, 16, 8, 8
    x, w4, s4, b4 = _inputs(n, h, w, ca + cb, co, dtype, seed=1)
    got = decoder_upsample([_t(x[..., :ca], dtype), _t(x[..., ca:], dtype)],
                           torch.from_numpy(w4).to(TDT[dtype]),
                           torch.from_numpy(s4), torch.from_numpy(b4),
                           leaky=True)
    tol = TOL[dtype]
    for fused in (False, True):
        np.testing.assert_allclose(_np(got),
                                   _jax_step(x, w4, s4, b4, dtype, fused),
                                   atol=tol, rtol=tol)


_UPSAMPLE_CASES = [(split, no_conv_t, dtype, co)
                   for dtype in ("float32", "bfloat16")
                   for no_conv_t in (True, False)
                   for split in (False, True) for co in (3, 1)]


@pytest.mark.parametrize(
    "split,no_conv_t,dtype,co", _UPSAMPLE_CASES,
    ids=[f"{s}-{n}-{d}" + ("" if co == 3 else f"-co{co}")
         for s, n, d, co in _UPSAMPLE_CASES])
def test_upsample_module_matches_jax(split, no_conv_t, dtype, co):
    """The final-layer form (no LeakyReLU, no affine, Co 3 or 1) through
    ``layers.Upsample`` vs the JAX ``Upsample``, in both upsample forms:
    this holds ``subpixel_phase_kernel`` and the ConvTranspose phase
    kernel (zero padding) to flax's own convs."""
    n, h, w, ca, cb = 2, 6, 8, 8, 8
    rng = np.random.default_rng(2)
    k = 3 if no_conv_t else 4
    wk = (rng.standard_normal((k, k, ca + cb, co)) * 0.1).astype(np.float32)
    x = rng.standard_normal((n, h, w, ca + cb)).astype(np.float32)
    mod = jl.Upsample(co, no_conv_t=no_conv_t, dtype=JDT[dtype])
    params = ({"ConvReflect_0": {"Conv_0": {"kernel": wk}}} if no_conv_t
              else {"ConvTranspose_0": {"kernel": wk}})
    params = jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), params)
    xj = jnp.asarray(x, JDT[dtype])
    arg = (xj[..., :ca], xj[..., ca:]) if split and no_conv_t else xj
    with jax.default_matmul_precision("highest"):
        want = np.asarray(mod.apply({"params": params}, arg)
                          .astype(jnp.float32))
    up = tl.Upsample(ca + cb, co, no_conv_t=no_conv_t)
    with torch.no_grad():
        up.weight.copy_(torch.from_numpy(wk.transpose(3, 2, 0, 1)))
    up.to(TDT[dtype])
    xr = np.array(xj.astype(jnp.float32))
    parts = ((_t(xr[..., :ca], dtype), _t(xr[..., ca:], dtype)) if split
             else _t(xr, dtype))
    got = up(parts)
    assert got.shape == (n, co, 2 * h, 2 * w)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phase_kernel_equals_jax(dtype):
    """Same sums in the same order and dtype: bit-equal."""
    rng = np.random.default_rng(3)
    wk = rng.standard_normal((3, 3, 8, 5)).astype(np.float32)
    want = np.asarray(jl.subpixel_phase_kernel(jnp.asarray(wk, JDT[dtype]))
                      .astype(jnp.float32))
    wt = torch.from_numpy(np.array(jnp.asarray(wk, JDT[dtype])
                                     .astype(jnp.float32)))
    got = tl.subpixel_phase_kernel(wt.permute(3, 2, 0, 1).to(TDT[dtype]))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_depth_to_space_equals_jax():
    rng = np.random.default_rng(4)
    h, w, co = 5, 7, 3
    y = rng.standard_normal((2, h + 1, w + 1, 4 * co)).astype(np.float32)
    want = np.asarray(jl.subpixel_depth_to_space(jnp.asarray(y), h, w, co))
    got = subpixel_depth_to_space(torch.from_numpy(y).permute(0, 3, 1, 2),
                                  h, w, co)
    np.testing.assert_array_equal(_np(got), want)


def test_cpu_path_launches_no_kernel():
    x, w4, s4, b4 = _inputs(1, 4, 4, 8, 4, "float32")
    before = decoder_upsample.launches
    decoder_upsample([_t(x, "float32")], torch.from_numpy(w4),
                     torch.from_numpy(s4), torch.from_numpy(b4), leaky=True)
    assert decoder_upsample.launches == before


def test_rejects_bad_arguments():
    x, w4, s4, b4 = _inputs(1, 4, 4, 8, 4, "float32")
    xt, wt = _t(x, "float32"), torch.from_numpy(w4)
    with pytest.raises(ValueError, match="w4"):
        decoder_upsample([xt], wt[:, :, :4], leaky=True)
    with pytest.raises(ValueError, match="1 or 2"):
        decoder_upsample([xt, xt, xt], wt, leaky=True)
    with pytest.raises(ValueError, match="together"):
        decoder_upsample([xt], wt, torch.from_numpy(s4), leaky=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        decoder_upsample([xt.to("meta")], wt.to("meta"), leaky=True)


def test_zero_pad_form_is_torch_conv_transpose():
    """The ConvTranspose phase kernel over zero padding equals torch's
    ConvTranspose2d(4, 2, 1) with the (unflipped, flax) kernel flipped."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((3, 5, 4, 4)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 5, 6, 7)).astype(np.float32))
    up = tl.Upsample(5, 3, no_conv_t=False)
    with torch.no_grad():
        up.weight.copy_(w)
        got = up(x)
    want = torch.nn.functional.conv_transpose2d(
        x, w.flip(2, 3).permute(1, 0, 2, 3), stride=2, padding=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def _mnet_steps(ngf):
    """Every decoder step of a split-skip G1 (out 1) and G2 (out 3) MNet
    at ``ngf``: (label, k, part channels, Co), ``k`` counting from the
    innermost step (0) to the final one (4), read off the port's modules
    (built on the meta device: no weights are allocated)."""
    steps = []
    for out in (1, 3):
        with torch.device("meta"):
            net = MNet(3 if out == 1 else 4, out, ngf=ngf, split_skip=True)
        for k, up in enumerate([u.up for u in net.ups] + [net.final]):
            co, ci = up.weight.shape[:2]
            parts = (ci,) if k == 0 else (ci // 2, ci // 2)
            steps.append((f"G{1 if out == 1 else 2}-step{k}", k, parts, co))
    return steps


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ngf,k,parts,co", [
    (ngf, k, parts, co) for ngf in (64, 4)
    for _, k, parts, co in _mnet_steps(ngf)], ids=[
    f"ngf{ngf}-{label}" for ngf in (64, 4)
    for label, *_ in _mnet_steps(ngf)])
def test_decoder_variant_at_mnet_steps(ngf, k, parts, co, dtype, aligned):
    """The narrow kernel takes every step with Co <= 4 in both dtypes: at
    ngf 64 the final one (Co 1, 3), at ngf 4 also the outermost (Co 4).
    The tensor-core kernel takes the bf16 steps on aligned tensors whose
    Co is at least 32: at ngf 64 every other step (Co 512, 256, 128, 64),
    at ngf 4 only the innermost (Co 32). The rest, f32 included, takes
    the CUDA-core kernel."""
    wide = k < 4 if ngf == 64 else k == 0
    if co <= 4:
        want = "narrow"
    elif dtype == torch.bfloat16 and wide and aligned:
        want = "tensor_core"
    else:
        want = "cuda_core"
    ci1 = parts[1] if len(parts) == 2 else 0
    assert decoder_variant(dtype, parts[0], ci1, co, aligned) == want


@pytest.mark.parametrize("ngf,tensor_core", [(64, 8), (4, 2)])
def test_stacked_forward_launches_by_variant(ngf, tensor_core):
    """One bf16 stacked G1+G2 forward: 10 decoder launches. At ngf 64, 8
    on the tensor cores and the 2 final ones narrow; at ngf 4, 2 on the
    tensor cores (Co 32), 4 narrow (the Co 4 step and the final one of
    each G) and 4 on the CUDA cores (Co 16 and 8)."""
    narrow = {64: 2, 4: 4}[ngf]
    got = [decoder_variant(torch.bfloat16, parts[0],
                           parts[1] if len(parts) == 2 else 0, co, True)
           for _, _, parts, co in _mnet_steps(ngf)]
    assert len(got) == 10
    assert got.count("tensor_core") == tensor_core
    assert got.count("narrow") == narrow
    assert got.count("cuda_core") == 10 - tensor_core - narrow


@pytest.mark.parametrize("parts", [(3,), (9, 5), (130,), (64, 64)])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("co", [1, 2, 3, 4, 5, 8])
def test_narrow_rule(co, dtype, aligned, parts):
    """Co 1..4 take the narrow kernel whatever the dtype, channel counts
    and alignment; Co 5 and 8 stay on the CUDA cores."""
    ci1 = parts[1] if len(parts) == 2 else 0
    want = "narrow" if co <= 4 else "cuda_core"
    assert decoder_variant(dtype, parts[0], ci1, co, aligned) == want


@pytest.mark.parametrize("parts,co", [
    ((20,), 64),          # Ci no multiple of 8
    ((32, 12), 64),       # second part no multiple of 8
    ((32,), 36),          # Co no multiple of 8
    ((32,), 24),          # Co below 32
])
def test_ragged_channels_run_on_cuda_cores(parts, co):
    ci1 = parts[1] if len(parts) == 2 else 0
    assert decoder_variant(torch.bfloat16, parts[0], ci1, co,
                           True) == "cuda_core"


def test_alignment_is_read_off_the_data_pointers():
    """A channels_last bf16 tensor that starts 2 bytes past a 16-byte
    boundary is not aligned; a fresh one is."""
    x = torch.zeros(1, 32, 4, 4, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    buf = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    y = buf.as_strided(x.shape, x.stride(), 1)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert _aligned(x)
    assert not _aligned(y) and not _aligned(x, y)
    assert decoder_variant(torch.bfloat16, 32, 0, 64,
                           _aligned(y)) == "cuda_core"


# the narrow kernel's weight map: Co 1..4; both pads; with LeakyReLU and
# the affine (a wide step) or without both (the final layer); the final
# layer's channel split, a ragged split and one part
_TWIN_PARTS = [(64, 64), (9, 5), (20,)]


def _twin_inputs(parts, co, final, seed):
    """numpy inputs (f32) for a narrow step: NHWC parts, w4, s4, b4."""
    n, h, w = 2, 5, 7
    x, w4, s4, b4 = _inputs(n, h, w, sum(parts), co, "float32", seed)
    if final:
        s4, b4 = np.ones_like(s4), np.zeros_like(b4)
    bounds = np.cumsum((0,) + parts)
    xs = [x[..., a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    return x, xs, w4, s4, b4


def _jax_step_form(x, w4, s4, b4, leaky, zero_pad):
    """The JAX decoder step in the form the Pallas kernel lacks (no
    LeakyReLU, or zero padding): JAX's reference composition with its
    activation and pad swapped (f32, highest precision)."""
    a = jnp.asarray(x)
    if leaky:
        a = jnp.maximum(a, 0.2 * a)
    ap = jnp.pad(a, ((0, 0), (1, 1), (1, 1), (0, 0)),
                 mode="constant" if zero_pad else "edge")
    with jax.default_matmul_precision("highest"):
        y = jax.lax.conv_general_dilated(
            ap, jnp.asarray(w4), (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
    y = y * jnp.asarray(s4) + jnp.asarray(b4)
    n, h, w, _ = x.shape
    return np.asarray(jl.subpixel_depth_to_space(y, h, w, w4.shape[-1] // 4))


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("parts", _TWIN_PARTS)
@pytest.mark.parametrize("zero_pad", [False, True])
@pytest.mark.parametrize("co", [1, 2, 3, 4])
def test_narrow_weight_twin_matches_plain(co, zero_pad, parts, final):
    """The kernel's all-phase 3x3 form (its B, :func:`narrow_weight`) is
    the step: equal to ``decoder_upsample_plain`` within 1e-5 in f32."""
    _, xs, w4, s4, b4 = _twin_inputs(parts, co, final, seed=10 + co)
    args = ([_t(x, "float32") for x in xs], torch.from_numpy(w4),
            None if final else torch.from_numpy(s4),
            None if final else torch.from_numpy(b4))
    kw = dict(leaky=not final, zero_pad=zero_pad)
    got = decoder_upsample_all_phase(*args, **kw)
    want = decoder_upsample_plain(*args, **kw)
    assert got.shape == want.shape == (2, co, 10, 14)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("parts", _TWIN_PARTS)
@pytest.mark.parametrize("zero_pad", [False, True])
@pytest.mark.parametrize("co", [1, 2, 3, 4])
def test_narrow_weight_twin_matches_jax(co, zero_pad, parts, final):
    """The all-phase form against JAX on the same numpy inputs, within
    1e-5 in f32: JAX's ``fused_decoder_upsample`` (Pallas, interpret
    mode) where it applies, the edge form with LeakyReLU (the final
    layer's identity affine as scale 1, bias 0); JAX's reference
    composition with its pad and activation swapped elsewhere."""
    x, xs, w4, s4, b4 = _twin_inputs(parts, co, final, seed=20 + co)
    got = decoder_upsample_all_phase(
        [_t(p, "float32") for p in xs], torch.from_numpy(w4),
        None if final else torch.from_numpy(s4),
        None if final else torch.from_numpy(b4), leaky=not final,
        zero_pad=zero_pad)
    if not zero_pad and not final:
        with jax.default_matmul_precision("highest"):
            want = np.asarray(fused_decoder_upsample(
                jnp.asarray(x), jnp.asarray(w4), jnp.asarray(s4),
                jnp.asarray(b4), interpret=True))
    else:
        want = _jax_step_form(x, w4, s4, b4, not final, zero_pad)
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("co", [1, 2, 3, 4])
def test_narrow_weight_layout(co):
    """(3, 3, Ci, 8 or 16): phase p = (pr, pc) holds w4[di, dj] at tap
    (pr + di, pc + dj), zeros at its other 5 taps and past 4 Co."""
    rng = np.random.default_rng(co)
    w4 = torch.from_numpy(rng.standard_normal((2, 2, 6, 4 * co))).float()
    b = narrow_weight(w4)
    assert b.shape == (3, 3, 6, 8 if co <= 2 else 16)
    assert not b[..., 4 * co:].any()
    for p in range(4):
        pr, pc = divmod(p, 2)
        cols = slice(p * co, (p + 1) * co)
        for dr in range(3):
            for dc in range(3):
                di, dj = dr - pr, dc - pc
                if 0 <= di <= 1 and 0 <= dj <= 1:
                    assert torch.equal(b[dr, dc, :, cols], w4[di, dj, :, cols])
                else:
                    assert not b[dr, dc, :, cols].any()
