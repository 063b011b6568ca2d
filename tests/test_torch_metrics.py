"""The port's evaluation metrics (``ops/color.py``, ``metrics/``) against
the JAX package's, on the same seeded numpy inputs and on the same
directories written by the port (32x64 images).

Tolerances: LAB 1e-4 units (torch has no ``cbrt``: ``t ** (1/3)``
rounds 1/3 to f32 and differs from ``jnp.cbrt`` by a few ulps of f,
~2e-5 of L); sums, PSNR, SSIM and the dataset metrics rtol 1e-5 (f32
reductions in other orders).
"""
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.metrics import eval_cli as jcli
from shadow_removal_istd_tpu.metrics import metrics as jmetrics
from shadow_removal_istd_tpu.ops import color as jcolor
from shadow_removal_istd_tpu_torch.data.synthetic import write_istd_layout
from shadow_removal_istd_tpu_torch.metrics import eval_cli as tcli
from shadow_removal_istd_tpu_torch.metrics import metrics as tmetrics
from shadow_removal_istd_tpu_torch.ops import color as tcolor
from shadow_removal_istd_tpu_torch.utils.image_io import (
    imread_color,
    imread_gray,
    imwrite,
)

RTOL = 1e-5


def _rgb(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    # values at and around the companding and f(t) thresholds, and the
    # ends of the range
    x.reshape(-1)[:8] = [0.0, 1.0, 0.04045, 0.0404, 0.0405, 1e-4, 0.08,
                         0.5]
    return x


@pytest.mark.parametrize("shape", [(4, 16, 3), (2, 8, 8, 3)])
def test_rgb_to_lab_matches_jax(shape):
    x = _rgb(0, shape)
    want = np.asarray(jcolor.rgb_to_lab(jnp.asarray(x)))
    got = tcolor.rgb_to_lab(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert torch.isfinite(got).all()


def test_lab_branches_and_channel_order():
    """The stages one by one, and no NaN from the branch not taken."""
    x = _rgb(1, (64, 3))
    for name in ("srgb_to_linear", "rgb_to_xyz"):
        np.testing.assert_allclose(
            getattr(tcolor, name)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(jcolor, name)(jnp.asarray(x))), atol=1e-6,
            rtol=0, err_msg=name)
    xyz = np.concatenate([x, -x[:4]]).astype(np.float32)   # negative t
    got = tcolor.xyz_to_lab(torch.from_numpy(xyz))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jcolor.xyz_to_lab(jnp.asarray(xyz))),
        atol=1e-4, rtol=0)
    bgr = torch.from_numpy(x)
    assert torch.equal(tcolor.bgr_to_rgb(bgr), bgr[:, [2, 1, 0]])


def _labs(seed, shape):
    rng = np.random.default_rng(seed)
    lab1 = (rng.random(shape + (3,)) * [100, 80, 80]).astype(np.float32)
    lab2 = (lab1 + rng.normal(0, 3, lab1.shape)).astype(np.float32)
    mask = rng.random(shape) > 0.6
    return lab1, lab2, mask


@pytest.mark.parametrize("shape", [(32, 64), (3, 32, 64)])
def test_region_metrics_match_jax(shape):
    lab1, lab2, mask = _labs(2, shape)
    want = jmetrics.region_metrics(jnp.asarray(lab1), jnp.asarray(lab2),
                                   jnp.asarray(mask))
    got = tmetrics.region_metrics(torch.from_numpy(lab1),
                                  torch.from_numpy(lab2),
                                  torch.from_numpy(mask))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)


def test_aggregate_regions_matches_jax_and_gives_nan_on_empty():
    parts_np = []
    for seed in range(3):
        lab1, lab2, mask = _labs(10 + seed, (16, 32))
        parts_np.append((lab1, lab2, mask))
    want = jmetrics.aggregate_regions([
        jmetrics.region_metrics(*map(jnp.asarray, p)) for p in parts_np])
    got = tmetrics.aggregate_regions([
        tmetrics.region_metrics(*map(torch.from_numpy, p))
        for p in parts_np])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    # a maskless run: every pixel is shadow, the non-shadow part is empty
    lab1, lab2, _ = parts_np[0]
    ones = torch.ones(16, 32, dtype=torch.bool)
    agg = tmetrics.aggregate_regions([tmetrics.region_metrics(
        torch.from_numpy(lab1), torch.from_numpy(lab2), ones)])
    assert np.isnan(agg["rmse_non"]) and np.isnan(agg["mae_non"])
    assert agg["rmse_all"] == agg["rmse"]


@pytest.mark.parametrize("shape", [(32, 64, 3), (20, 30, 1)])
def test_psnr_and_ssim_match_jax(shape):
    rng = np.random.default_rng(3)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    for name in ("psnr", "ssim"):
        want = float(getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b)))
        got = float(getattr(tmetrics, name)(torch.from_numpy(a),
                                            torch.from_numpy(b)))
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)
    box = tmetrics._uniform_filter_valid(torch.from_numpy(a[..., 0]), 7)
    np.testing.assert_allclose(
        box.numpy(), np.asarray(jmetrics._uniform_filter_valid(
            jnp.asarray(a[..., 0]), 7)), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A port-written ISTD test split (5 triplets, 32x64), and its masks
    and predictions again at 64x128."""
    root = tmp_path_factory.mktemp("eval")
    write_istd_layout(str(root / "istd"), n_train=1, n_test=5, h=32, w=64)
    test = root / "istd" / "test"
    big_mask, big_pred = root / "masks_64x128", root / "pred_64x128"
    big_mask.mkdir()
    big_pred.mkdir()
    for f in sorted(os.listdir(test / "test_B")):
        for src, dst, read in ((test / "test_B", big_mask, imread_gray),
                               (test / "test_A", big_pred, imread_color)):
            img = read(str(src / f))
            imwrite(str(dst / f), np.repeat(np.repeat(img, 2, 0), 2, 1))
    return {"target": str(test / "test_C_fixed"),
            "pred": str(test / "test_A"), "mask": str(test / "test_B"),
            "mask_big": str(big_mask), "pred_big": str(big_pred)}


def _compare(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       err_msg=k)


# (predictions, masks, size, batch size): the batched path with the size
# and without it, masks at another resolution, predictions at another
# resolution, the per-image path (batch 1) and the maskless PSNR/SSIM
ALL_METRICS_CASES = [
    ("pred", "mask", 16, 16),
    ("pred", "mask", None, 16),
    ("pred", "mask_big", 16, 16),
    ("pred", "mask_big", None, 4),
    ("pred_big", "mask", 16, 16),
    ("pred", "mask", 16, 1),
    ("pred", "mask_big", None, 1),
    ("pred", None, 16, 16),
    ("pred", None, None, 16),
    ("pred_big", None, 16, 16),
]


@pytest.mark.parametrize("pred,mask,size,batch", ALL_METRICS_CASES)
def test_all_metrics_matches_jax(dirs, pred, mask, size, batch):
    kw = dict(size=size, maskdir=dirs[mask] if mask else None,
              batch_size=batch)
    want = jcli.all_metrics(dirs["target"], dirs[pred], **kw)
    got = tcli.all_metrics(dirs["target"], dirs[pred], device="cpu", **kw)
    _compare(got, want)
    if mask is None:
        assert {"psnr", "ssim"} <= got.keys()


def test_all_metrics_without_card_raises(dirs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.all_metrics(dirs["target"], dirs["pred"])


def _run_main(fn, argv, capsys):
    root = logging.getLogger()
    handlers = list(root.handlers)
    try:
        fn(argv)
    finally:        # each run adds its log handlers to the root logger
        for h in root.handlers[len(handlers):]:
            h.close()
        root.handlers[:] = handlers
    out = capsys.readouterr().out.splitlines()
    return dict(line.split(": ", 1) for line in out if ": " in line)


@pytest.mark.parametrize("with_mask", [True, False])
def test_eval_cli_main_prints_the_jax_keys_and_values(dirs, tmp_path,
                                                      capsys, with_mask):
    args = [dirs["target"], dirs["pred"], "--image-size", "16"]
    if with_mask:
        args += ["-m", dirs["mask"]]
    want = _run_main(jcli.main, [*args, "--logfile",
                                 str(tmp_path / "jax" / "eval.log")], capsys)
    got = _run_main(tcli.main, [*args, "--device", "cpu", "--logfile",
                                str(tmp_path / "port" / "eval.log")], capsys)
    assert list(got) == list(want) and len(want) == (6 if with_mask else 8)
    _compare({k: float(v) for k, v in got.items()},
             {k: float(v) for k, v in want.items()})
    snap = tmp_path / "port" / "eval_args.json"
    assert snap.is_file() and (tmp_path / "port" / "eval.log").is_file()
