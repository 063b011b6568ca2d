"""``parallel/prefetch.py`` on the card: pinned staging, the side
stream's copies and the consumer's wait.

Marked ``cuda``; skips without a card. On a machine with one (the tests'
conftest imports JAX, which that machine need not have)::

    python -m pytest --noconftest -m cuda tests/test_torch_prefetch_cuda.py
"""
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu_torch.parallel.prefetch import (
    prefetch_to_device,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _batches(sizes):
    rng = np.random.default_rng(0)
    return [tuple(rng.integers(0, 256, (b, 48, 64, c), dtype=np.uint8)
                  for c in (3, 1)) for b in sizes]


@pytest.mark.parametrize("sizes", [(4, 4, 4, 4, 4, 2), (3,), ()])
def test_uploads_land_in_order(cuda, sizes):
    """Every batch, the short last one included, equal to its host
    arrays, even when the consumer writes into the batch it holds while
    the next ones are in flight (the pinned slots are reused)."""
    batches = _batches(sizes)
    seen = []
    for dev in prefetch_to_device(iter(batches), 2, cuda):
        assert all(t.is_cuda and t.dtype == torch.uint8 for t in dev)
        seen.append(tuple(t.cpu().numpy() for t in dev))
        dev[0].mul_(0)
    assert len(seen) == len(batches)
    for got, want in zip(seen, batches):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_consumer_waits_for_the_copy(cuda):
    """A kernel on the consumer's stream right after the yield reads the
    uploaded values (the stream waits on the copy's event)."""
    batches = _batches((16, 16, 16))
    for dev, host in zip(prefetch_to_device(iter(batches), 2, cuda),
                         batches):
        total = int(dev[0].sum(dtype=torch.int64))
        assert total == int(host[0].sum(dtype=np.int64))
