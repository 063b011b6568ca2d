"""Analytic FLOP counting; port of ``shadow_removal_istd_tpu/utils/flops.py``.

:func:`count_flops` runs one call under ``torch.utils.flop_counter.
FlopCounterMode`` and returns the matmul and convolution FLOPs it saw, in
the JAX module's conventions: 2·M·N·K for a product, 2·out·(KH·KW·Cin/
groups) for a convolution, a transposed convolution's useful FLOPs only
(its input's positions, not the zeros a dilated input would hold), and no
elementwise work. A module's parameters and the inputs may be fake
tensors (:func:`abstract`: meta storage, shapes only), so a full-size
count allocates and computes nothing.

The port's own ops get formulas here, since FlopCounterMode sees an op,
not what its kernel does:

- ``srit::decoder_upsample`` (K1, ``ops/decoder.py``): the 2x2 phase conv
  of its spec over the one-padded input, 2·N·(H+1)·(W+1)·4Co·4Ci, which is
  how the JAX package's XLA formulation (``layers._subpixel_nn_conv_phase``)
  counts the same step;
- ``srit::int8_conv`` (``ops/int8_conv.py``): the conv of its plain
  version over the padded int8 input, 2·out·(KH·KW·Cp), the phase form at
  (H+1)·(W+1) positions as above; ``srit::int8_conv_quantized`` (the same
  conv with the next sites' quantize in its epilogue) the same, so the
  fused int8 forward counts what the unfused one does.

At 256x256 the stacked MNet pair (G1 3->1, G2 4->3, ngf 64) counts
23.229 GFLOP per image, the JAX count per image (:func:`stacked_mnet_flops`).
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

# importing the modules registers the ops srit::decoder_upsample,
# srit::int8_conv and srit::int8_conv_quantized
from shadow_removal_istd_tpu_torch.ops import decoder, int8_conv  # noqa: F401


@register_flop_formula(torch.ops.srit.decoder_upsample)
def _decoder_flops(parts, w4, scale4, bias4, leaky, zero_pad,
                   out_shape=None, **kwargs) -> int:
    n, _, h, w = parts[0]
    return 2 * n * (h + 1) * (w + 1) * math.prod(w4)


@register_flop_formula(torch.ops.srit.int8_conv)
def _int8_conv_flops(xq, wk, scale, bias, phase, out_dtype,
                     out_shape=None, **kwargs) -> int:
    n, hp, wp, _ = xq
    rows, kh, kw, cp = wk
    # the phase form is stride 1 over the padded input (2x2, or 3x3 for
    # an all-phase weight); the encoder's 4x4 stride 2
    positions = (hp - kh + 1) * (wp - kw + 1) if phase else (hp - 2) // 2 * (
        (wp - 2) // 2)
    return 2 * n * positions * rows * kh * kw * cp


@register_flop_formula(torch.ops.srit.int8_conv_quantized)
def _int8_conv_quantized_flops(xq, wk, scale, bias, phase, compute_dtype,
                               bufs, sxs, leaky, reflect, c_off,
                               out_shape=None, **kwargs) -> int:
    return _int8_conv_flops(xq, wk, scale, bias, phase, compute_dtype)


@contextlib.contextmanager
def abstract():
    """Inside, new tensors and modules are fake: shapes and dtypes on
    meta storage, nothing allocated or computed (a module built inside
    counts its forward at any size for free)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=False):
        yield


def count_flops(fn, *args, **kwargs) -> float:
    """Matmul and convolution FLOPs of one call of ``fn(*args,
    **kwargs)``."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def stacked_mnet_flops(h: int, w: int, *, ngf: int = 64,
                       batch: int = 1) -> float:
    """FLOPs of the stacked inference forward (``engine/steps.
    infer_step``: G1 then G2 on the image and the matte) of the
    split-skip MNet pair at ``h`` x ``w``, counted on fake tensors (the
    count does not depend on the dtype)."""
    from shadow_removal_istd_tpu_torch.engine.steps import infer_step
    from shadow_removal_istd_tpu_torch.models import MNet

    with abstract():
        g1 = MNet(3, 1, ngf=ngf, split_skip=True).eval()
        g2 = MNet(4, 3, ngf=ngf, split_skip=True).eval()
        x = torch.zeros(batch, 3, h, w)
        with torch.no_grad():
            return count_flops(infer_step, g1, g2, x)
