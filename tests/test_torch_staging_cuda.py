"""The serving engine's page-locked staging on the card
(``serving/engine.py``): answers byte-identical to the pageable path's,
views of page-locked blocks that no later dispatch writes, and no new
page-locked block once the engine is warm.

Marked ``cuda``; skips without a card. On a machine with one (the tests'
conftest imports JAX, which that machine need not have)::

    python -m pytest --noconftest -m cuda tests/test_torch_staging_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from pageable_reference import pageable

from shadow_removal_istd_tpu_torch.serving import InferenceEngine
from shadow_removal_istd_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

FULL = (480, 640)
MIXED = [(480, 640), (470, 630), (450, 620)]     # one bucket, padded to 4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _imgs(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in sizes]


@pytest.fixture(scope="module", params=["bfloat16", "int8"])
def engine(request, cuda):
    calib = _imgs([FULL] * 4, 0) if request.param == "int8" else None
    e = InferenceEngine(dtype=request.param, max_batch=8,
                        calib_images=calib, device=cuda)
    e.warmup([FULL], [4, 8])
    return e


def _equal(got, want):
    assert len(got) == len(want)
    for (m, y), (m0, y0) in zip(got, want):
        assert m.shape == m0.shape and y.shape == y0.shape
        assert np.array_equal(m, m0) and np.array_equal(y, y0)


def _owner(a: np.ndarray) -> torch.Tensor:
    """The torch tensor whose memory the array views."""
    while not isinstance(a, torch.Tensor):
        a = a.base
    return a


@pytest.mark.parametrize("sizes", [[FULL] * 8, MIXED], ids=["b8", "mixed"])
def test_answers_equal_the_pageable_path(engine, sizes):
    imgs = _imgs(sizes, 1)
    got = engine.infer_group(imgs)
    _equal(got, pageable(engine, imgs))
    for m, y in got:
        assert _owner(m).is_pinned() and _owner(y).is_pinned()


def test_two_replicas_on_one_card_fill_one_block(cuda):
    two = InferenceEngine(max_batch=8, devices=[cuda, cuda], device=cuda)
    imgs = _imgs(MIXED, 2)
    got = two.infer_group(imgs)
    _equal(got, pageable(two, imgs))
    assert len({id(_owner(a)) for pair in got for a in pair}) == 2


def test_held_answers_survive_later_dispatches(engine):
    first = engine.infer_group(_imgs([FULL] * 8, 3))
    kept = [(m.copy(), y.copy()) for m, y in first]
    for k in range(20):
        engine.infer_group(_imgs([FULL] * 8 if k % 2 else MIXED, 4 + k))
    torch.cuda.synchronize()
    _equal(first, kept)


def test_no_new_page_locked_block_once_warm(engine):
    """20 dispatches, each dropping the last one's answers, make no new
    page-locked block; each dispatch says so on its span."""
    if not hasattr(torch.cuda, "host_memory_stats"):
        pytest.skip("this torch does not count page-locked blocks")
    imgs = _imgs([FULL] * 8, 5)
    for _ in range(3):
        out = engine.infer_group(imgs)
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    profiling.enable()
    try:
        for k in range(20):
            with profiling.span("dispatch", k=k):
                out = engine.infer_group(imgs)
    finally:
        profiling.disable()
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == before
    spans = [s for s in profiling.drain() if s["name"] == "dispatch"]
    assert len(spans) == 20
    for s in spans:
        assert s["attrs"]["staging"] == "pinned"
        assert s["attrs"]["pinned_allocs"] == 0
    assert len(out) == 8
