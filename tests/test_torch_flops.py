"""The port's analytic FLOP counter (``utils/flops.py``) against the JAX
package's (``shadow_removal_istd_tpu/utils/flops.py``): the cases of JAX
``tests/test_models.py::TestFlopCounter``, the formulas of the port's ops
(K1 ``srit::decoder_upsample`` and ``srit::int8_conv``) against their
plain versions, and the stacked MNet pair against JAX ``count_flops`` on
the same shapes.

JAX's count of the stacked pair is a per-image term times the batch plus
a batch-independent one (convolutions on 4x4 inputs of the weights
alone, whatever the image size); ``bench.py`` divides by 2048 images, so
its 23.23 GFLOP/image at 256x256 (``BENCH_r05.json``) is the per-image
term, which the port counts exactly.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmarks.common import fill_params_bf16
from shadow_removal_istd_tpu.models import get_generator
from shadow_removal_istd_tpu.utils.flops import count_flops as j_count
from shadow_removal_istd_tpu_torch.ops.decoder import (
    decoder_upsample,
    decoder_upsample_plain,
)
from shadow_removal_istd_tpu_torch.ops.int8_conv import (
    int8_conv,
    int8_conv_plain,
)
from shadow_removal_istd_tpu_torch.utils import flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dot_and_conv():
    a, b = torch.zeros(4, 8), torch.zeros(8, 16)
    assert flops.count_flops(torch.matmul, a, b) == 2 * 4 * 8 * 16
    x, k = torch.zeros(2, 3, 10, 10), torch.zeros(7, 3, 3, 3)
    assert flops.count_flops(F.conv2d, x, k, padding=1) \
        == 2 * (2 * 10 * 10 * 7) * (3 * 3 * 3)
    ja, jb = jnp.zeros((4, 8)), jnp.zeros((8, 16))
    assert j_count(jnp.matmul, ja, jb) == flops.count_flops(torch.matmul,
                                                            a, b)


def test_loop_multiplies_and_transposed_conv_counts_useful_flops():
    a, b = torch.zeros(4, 8), torch.zeros(8, 16)

    def looped(a, b):
        c = torch.zeros(4, 16)
        for _ in range(5):
            c = c + a @ b
        return c
    assert flops.count_flops(looped, a, b) == 5 * 2 * 4 * 8 * 16
    # JAX's lhs_dilation rule: 1/prod(stride) of the dilated taps are real
    x, k = torch.zeros(1, 4, 8, 8), torch.zeros(4, 6, 4, 4)
    got = flops.count_flops(F.conv_transpose2d, x, k, stride=2, padding=1)
    assert got == 2 * (1 * 16 * 16 * 6) * (4 * 4 * 4) / 4
    jx, jk = jnp.zeros((1, 8, 8, 4)), jnp.zeros((4, 4, 4, 6))
    assert got == j_count(lambda x, k: jax.lax.conv_transpose(
        x, k, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jx, jk)


@pytest.mark.parametrize("zero_pad", [False, True])
def test_decoder_op_counts_its_plain_spec(zero_pad):
    """K1's formula equals what FlopCounterMode sees in its plain spec
    (the 2x2 phase conv over the one-padded input), on fake tensors."""
    with flops.abstract():
        parts = [torch.zeros(2, 6, 5, 7), torch.zeros(2, 10, 5, 7)]
        w4 = torch.zeros(2, 2, 16, 4 * 3)
        got = flops.count_flops(decoder_upsample, parts, w4, leaky=True,
                                zero_pad=zero_pad)
        plain = flops.count_flops(decoder_upsample_plain, parts, w4,
                                  leaky=True, zero_pad=zero_pad)
    assert got == plain == 2 * 2 * 6 * 8 * (4 * 3) * (4 * 16)


@pytest.mark.parametrize("phase,k", [(False, 4), (True, 2), (True, 3)])
def test_int8_conv_op_counts_its_plain_spec(phase, k):
    xq = torch.zeros(2, 10, 12, 16, dtype=torch.int8)
    wk = torch.zeros(8, k, k, 16, dtype=torch.int8)
    got = flops.count_flops(int8_conv, xq, wk, phase=phase)
    plain = flops.count_flops(int8_conv_plain, xq, wk, phase=phase)
    positions = {4: 4 * 5, 2: 9 * 11, 3: 8 * 10}[k]
    assert got == plain == 2 * 2 * positions * 8 * k * k * 16


def _jax_stacked(h, w, batch, ngf):
    g1 = get_generator("mnet", in_channels=3, out_channels=1, ngf=ngf,
                       split_skip=True)
    g2 = get_generator("mnet", in_channels=4, out_channels=3, ngf=ngf,
                       split_skip=True)
    v1 = fill_params_bf16(g1, (1, h, w, 3))
    v2 = fill_params_bf16(g2, (1, h, w, 4))

    def stacked(v1, v2, x):
        m = g1.apply(v1, x)
        return g2.apply(v2, jnp.concatenate([x, m], axis=-1))
    return j_count(stacked, v1, v2, jnp.zeros((batch, h, w, 3),
                                              jnp.bfloat16))


def test_stacked_mnet_equals_jax_per_image():
    h, w, ngf = 64, 96, 4
    j1, j2 = (_jax_stacked(h, w, b, ngf) for b in (1, 2))
    per_image, constant = j2 - j1, 2 * j1 - j2
    assert constant > 0           # JAX's convolutions on the weights alone
    assert flops.stacked_mnet_flops(h, w, ngf=ngf) == per_image
    assert flops.stacked_mnet_flops(h, w, ngf=ngf, batch=3) == 3 * per_image


def test_bench_configuration_is_23_23_gflop_per_image():
    """256x256, ngf 64, counted on fake tensors (nothing allocated)."""
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        want = json.load(f)["parsed"]["gflop_per_image"]
    got = flops.stacked_mnet_flops(256, 256) / 1e9
    assert round(got, 2) == want == 23.23
    assert got == pytest.approx(23.229120512, abs=0)
