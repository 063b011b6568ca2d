"""Library functions of the port against the JAX package's on the CPU:
``utils/image_io.py::normalize_percentile`` (equal uint8 images) and
``engine/state.py::param_count`` (a module's parameter elements against
the JAX ``params`` count of ``tests/test_models.py``'s helper, which
traces flax init abstractly, on the same model definitions)."""
import numpy as np
import pytest

from shadow_removal_istd_tpu.models import get_discriminator as j_disc
from shadow_removal_istd_tpu.models import get_generator as j_gen
from shadow_removal_istd_tpu.utils.image_io import (
    normalize_percentile as j_normalize_percentile,
)
from shadow_removal_istd_tpu_torch.engine.state import param_count
from shadow_removal_istd_tpu_torch.models import (
    get_discriminator,
    get_generator,
)
from shadow_removal_istd_tpu_torch.utils.image_io import (
    normalize_percentile,
)

from test_models import param_count as jax_param_count


def test_normalize_percentile_matches_jax():
    """The cases of ``tests/test_data.py::TestImageIOUtils``: a normal
    map stretched from [p3, p97] onto [0, 255], and other percentiles."""
    a = np.random.default_rng(5).normal(size=(40, 30)).astype(np.float32)
    got = normalize_percentile(a)
    lo, hi = np.percentile(a, 3), np.percentile(a, 97)
    want = (np.clip((a - lo) / (hi - lo), 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, j_normalize_percentile(a))
    b = np.random.default_rng(6).random((3, 17, 9)) * 40.0 - 7.0
    np.testing.assert_array_equal(normalize_percentile(b, 10.0, 80.0),
                                  j_normalize_percentile(b, 10.0, 80.0))


def test_normalize_percentile_of_a_constant_input():
    """A constant input has hi == lo: divided by 1e-12, not by zero, so
    every pixel maps to 0, as in JAX."""
    flat = np.full((4, 4), 2.5)
    got = normalize_percentile(flat)
    assert got.dtype == np.uint8 and not got.any()
    np.testing.assert_array_equal(got, j_normalize_percentile(flat))


@pytest.mark.parametrize("kind,key,kwargs,channels,want", [
    ("G", "unet", dict(in_channels=3, out_channels=1, ngf=64,
                       drop_rate=0.05, no_conv_t=False, activation="tanh"),
     3, 39_392_512),
    ("G", "mnet", dict(in_channels=3, out_channels=1, ngf=64,
                       drop_rate=0.05, no_conv_t=True, activation="tanh"),
     3, 12_411_648),
    ("G", "mnet", dict(in_channels=3, out_channels=1, ngf=64,
                       drop_rate=0.05, no_conv_t=False, activation="tanh"),
     3, 16_656_000),
    ("G", "denseunet", dict(in_channels=3, out_channels=1, ngf=48,
                            drop_rate=0.0, no_conv_t=False, activation=None),
     3, 820_800),
    ("D", "patchgan", dict(in_channels=4, out_channels=1, ndf=64,
                           use_sigmoid=False), 4, 1_845_568),
    ("D", "began", dict(in_channels=4, out_channels=1, ndf=64), 4, 335_937),
])
def test_param_count_matches_jax(kind, key, kwargs, channels, want):
    build, j_build = ((get_generator, j_gen) if kind == "G"
                      else (get_discriminator, j_disc))
    got = param_count(build(key, **kwargs))
    assert got == jax_param_count(j_build(key, **kwargs),
                                  (1, 64, 64, channels)) == want
