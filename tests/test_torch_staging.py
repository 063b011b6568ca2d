"""The serving engine's dispatch staging (``serving/engine.py``) on the
CPU: the padded batch assembled in place, 128 written only where the
images leave room, and answers handed back as views of the dispatch's
outputs with no host concatenation.

Every answer is held against the answer the dispatch computed before
(``pageable_reference.py``: a fresh ``np.full`` batch, ``.cpu()`` and
``np.concatenate``), byte for byte: a full same-size group, a group of
3 padded to 4, mixed sizes in one bucket assembled into a block full of
stale bytes, two CPU replicas, and answers held across a later
dispatch. The card's page-locked path is held by
``test_torch_staging_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from pageable_reference import full_batch, pageable

from shadow_removal_istd_tpu_torch.serving import InferenceEngine
from shadow_removal_istd_tpu_torch.serving import engine as engine_mod

ENGINE_KW = dict(ngf=4, dtype="float32", max_batch=4, device="cpu")
BUCKET = (64, 96)       # pad_multiple 32
MIXED = [(64, 96), (50, 90), (64, 70), (33, 65)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine(**ENGINE_KW)


def _imgs(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in sizes]


def _equal(got, want):
    assert len(got) == len(want)
    for (m, y), (m0, y0) in zip(got, want):
        assert m.dtype == y.dtype == np.uint8
        assert m.shape == m0.shape and y.shape == y0.shape
        assert np.array_equal(m, m0) and np.array_equal(y, y0)


@pytest.fixture
def stale_blocks(monkeypatch):
    """Every host block the engine takes arrives full of stale bytes,
    as a reused page-locked block would."""
    real = engine_mod._host_block
    seeds = iter(range(10_000))

    def stale(shape, pinned):
        block = real(shape, pinned)
        rng = np.random.default_rng(next(seeds))
        block.numpy()[...] = rng.integers(0, 256, block.shape, np.uint8)
        return block

    monkeypatch.setattr(engine_mod, "_host_block", stale)


@pytest.mark.parametrize("sizes", [[BUCKET] * 4, [BUCKET] * 3, MIXED,
                                   MIXED[1:]],
                         ids=["full", "three_of_four", "mixed",
                              "mixed_three"])
def test_answers_match_the_pageable_dispatch(engine, stale_blocks, sizes):
    imgs = _imgs(sizes, 1)
    _equal(engine.infer_group(imgs), pageable(engine, imgs))


@pytest.mark.parametrize("sizes", [[BUCKET] * 4, [BUCKET] * 3, MIXED,
                                   [(33, 65), (64, 65), (33, 96)]],
                         ids=["full", "three_of_four", "mixed", "slivers"])
def test_assembly_into_stale_bytes_is_exact(engine, sizes):
    """The whole padded batch, margins and spare rows included, equals a
    fresh ``np.full`` batch, whatever the block held before."""
    imgs = _imgs(sizes, 2)
    want = full_batch(engine, imgs)
    block = np.random.default_rng(3).integers(0, 256, want.shape, np.uint8)
    engine_mod._assemble(block, imgs)
    assert np.array_equal(block, want)


def test_two_cpu_replicas_fill_one_block(stale_blocks):
    """Each replica's answers land in its slice of one output block: no
    concatenation, the same bytes."""
    two = InferenceEngine(**ENGINE_KW, devices=2)
    imgs = _imgs(MIXED[:3], 4)
    got = two.infer_group(imgs)
    _equal(got, pageable(two, imgs))
    bases = {id(_owner(a)) for pair in got for a in pair}
    assert len(bases) == 2      # one matte block, one shadow-free block


def test_held_answers_survive_a_later_dispatch(engine):
    first = engine.infer_group(_imgs([BUCKET] * 4, 5))
    kept = [(m.copy(), y.copy()) for m, y in first]
    engine.infer_group(_imgs([BUCKET] * 4, 6))
    engine.infer_group(_imgs(MIXED, 7))
    _equal(first, kept)


def test_exact_bucket_answers_are_contiguous_views(engine):
    """An image that fills its bucket gets C-contiguous answers, and the
    answers of one dispatch view the forward's two outputs."""
    imgs = _imgs([BUCKET, BUCKET, (50, 90)], 8)
    got = engine.infer_group(imgs)
    for m, y in got[:2]:
        assert m.flags.c_contiguous and y.flags.c_contiguous
    assert len({id(_owner(a)) for pair in got for a in pair}) == 2


@pytest.mark.parametrize("view", ["channels_reversed", "read_only"])
def test_assembly_of_exact_bucket_views_is_exact(engine, view):
    """Exact-bucket images that are not plain C-contiguous writable
    arrays (a reversed-channel view, a read-only array) land in the
    block as a fresh ``np.full`` batch would hold them."""
    imgs = _imgs([BUCKET, BUCKET, (50, 90)], 9)
    if view == "channels_reversed":
        imgs[0] = imgs[0][..., ::-1]
    else:
        imgs[0].flags.writeable = False
    want = full_batch(engine, imgs)
    block = np.random.default_rng(10).integers(0, 256, want.shape, np.uint8)
    engine_mod._assemble(block, imgs)
    assert np.array_equal(block, want)


def _owner(a: np.ndarray) -> torch.Tensor:
    """The torch tensor whose memory the array views."""
    while not isinstance(a, torch.Tensor):
        a = a.base
    return a
