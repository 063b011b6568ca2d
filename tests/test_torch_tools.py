"""The port's host tools against the JAX package's, on the cases of
tests/test_tools.py: sp preprocessing (ratio and polyfit), color
adjustment, the VGG conversion and the experiment runner.

Both packages get the same seeded numpy inputs; the tools are host numpy
code in both, so their outputs must be equal, not just close.
"""
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.tools import color_adjustment as jca
from shadow_removal_istd_tpu.tools import convert_vgg as jvgg
from shadow_removal_istd_tpu.tools import experiments as jexp
from shadow_removal_istd_tpu.tools import preprocess as jpre
from shadow_removal_istd_tpu_torch.data.synthetic import write_istd_layout
from shadow_removal_istd_tpu_torch.tools import color_adjustment as ca
from shadow_removal_istd_tpu_torch.tools import convert_vgg
from shadow_removal_istd_tpu_torch.tools import experiments as exp
from shadow_removal_istd_tpu_torch.tools import preprocess as pre
from shadow_removal_istd_tpu_torch.utils.image_io import (
    imread_color,
    imwrite,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = [64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512]


def _tree_equal(a: str, b: str, sub: str) -> int:
    """The files under ``a/sub`` and ``b/sub``: same names, same
    contents (``.npy`` arrays or PNG pixels); returns their count."""
    names = sorted(os.listdir(os.path.join(a, sub)))
    assert names == sorted(os.listdir(os.path.join(b, sub)))
    for n in names:
        pa, pb = os.path.join(a, sub, n), os.path.join(b, sub, n)
        if n.endswith(".npy"):
            x, y = np.load(pa), np.load(pb)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=n)
        else:
            np.testing.assert_array_equal(imread_color(pa), imread_color(pb),
                                          err_msg=n)
    return len(names)


@pytest.fixture
def two_roots(tmp_path):
    """The same synthetic ISTD directory twice: one for each package."""
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    write_istd_layout(a, n_train=2, n_test=1, h=24, w=32)
    shutil.copytree(a, b)
    return a, b


class TestPreprocess:
    def test_sp_roundtrip(self, rng):
        shadowed = rng.integers(1, 255, (16, 16, 3), np.uint8)
        free = rng.integers(0, 256, (16, 16, 3), np.uint8)
        sp = pre.compute_sp(shadowed, free)
        np.testing.assert_array_equal(sp, jpre.compute_sp(shadowed, free))
        restored = pre.apply_sp(shadowed, sp)
        np.testing.assert_array_equal(restored, jpre.apply_sp(shadowed, sp))
        np.testing.assert_allclose(restored, free, atol=1)

    def test_apply_sp_float(self, rng):
        shadowed = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
        sp = rng.uniform(0.5, 2.5, (8, 8, 3)).astype(np.float32)
        got = pre.apply_sp(shadowed, sp)
        assert got.dtype == np.float32 and got.max() <= 1
        np.testing.assert_array_equal(got, jpre.apply_sp(shadowed, sp))

    def test_zero_pixels_clamped(self):
        shadowed = np.zeros((2, 2, 3), np.uint8)
        free = np.full((2, 2, 3), 100, np.uint8)
        sp = pre.compute_sp(shadowed, free)
        assert np.isfinite(sp).all()
        np.testing.assert_array_equal(sp, 100.0)
        assert (shadowed == 0).all()         # the input is left as it was

    def test_tables_match_jax(self):
        np.testing.assert_array_equal(pre._HAT_LUT, jpre._HAT_LUT)
        for k in (3, 5, 7):
            np.testing.assert_array_equal(pre._pyramid_weight(k),
                                          jpre._pyramid_weight(k))

    @pytest.mark.parametrize("gray_path", ["cv2", "fixed_point"])
    def test_gray_matches_jax(self, rng, monkeypatch, gray_path):
        """cv2 when it imports, else the fixed-point form: each path of
        the port equals the JAX package's same path."""
        if gray_path == "fixed_point":
            monkeypatch.setitem(sys.modules, "cv2", None)
        bgr = rng.integers(0, 256, (13, 17, 3), np.uint8)
        got = pre._bgr_to_gray_u8(bgr)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jpre._bgr_to_gray_u8(bgr))

    def test_process_split(self, two_roots):
        a, b = two_roots
        assert pre.process_split(a, "train", save_sp=True,
                                 save_img=True) == 2
        jpre.process_split(b, "train", save_sp=True, save_img=True)
        assert _tree_equal(a, b, "train/sp") == 2
        assert _tree_equal(a, b, "train/sp_restored_img") == 2
        sp = np.load(os.path.join(a, "train", "sp",
                                  sorted(os.listdir(os.path.join(
                                      a, "train", "sp")))[0]))
        assert sp.shape == (24, 32, 3)

    def test_process_split_prefers_official_target(self, two_roots, rng):
        """``<subset>_C_fixed_official`` is the target when it exists,
        else ``<subset>_C_fixed``."""
        a, b = two_roots
        for root in (a, b):
            src = os.path.join(root, "train", "train_C_fixed")
            dst = os.path.join(root, "train", "train_C_fixed_official")
            os.makedirs(dst)
            for n in sorted(os.listdir(src)):
                img = imread_color(os.path.join(src, n))
                imwrite(os.path.join(dst, n), 255 - img)
        pre.process_split(a, "train")
        jpre.process_split(b, "train")
        assert _tree_equal(a, b, "train/sp") == 2
        name = sorted(os.listdir(os.path.join(a, "train", "train_A")))[0]
        img = imread_color(os.path.join(a, "train", "train_A", name))
        off = imread_color(os.path.join(a, "train", "train_C_fixed_official",
                                        name))
        np.testing.assert_array_equal(
            np.load(os.path.join(a, "train", "sp",
                                 name.replace(".png", ".npy"))),
            pre.compute_sp(img, off))

    @pytest.mark.parametrize("ksize,deg", [(5, 1), (3, 2)])
    def test_polyfit_sp_matches_per_pixel_oracle(self, rng, ksize, deg):
        """The batched closed-form polyfit sp equals the reference's
        per-pixel ``numpy.polynomial`` fit run pixel by pixel, and the
        JAX package's batched fit exactly."""
        from numpy.polynomial import polynomial as P

        shadowed = rng.integers(40, 200, (8, 9, 3), np.uint8)
        free = rng.integers(40, 200, (8, 9, 3), np.uint8)
        got = pre.compute_sp_polyfit(shadowed, free, ksize=ksize, deg=deg)
        assert got.shape == (8, 9, 3, deg + 1) and got.dtype == np.float32
        np.testing.assert_array_equal(
            got, jpre.compute_sp_polyfit(shadowed, free, ksize=ksize,
                                         deg=deg))

        border = (ksize - 1) // 2
        pad2 = ((border, border), (border, border))
        img = np.pad(shadowed, pad2 + ((0, 0),), mode="edge")
        gt = np.pad(free, pad2 + ((0, 0),), mode="edge")
        weight = pre._HAT_LUT[pre._bgr_to_gray_u8(gt)]
        w2 = np.array(
            [ksize - abs(i - border) - abs(j - border)
             for i in range(ksize) for j in range(ksize)], float)
        for r in range(0, 8, 3):
            for c in range(0, 9, 4):
                for ch in range(3):
                    x = img[r:r + ksize, c:c + ksize, ch].ravel()
                    y = gt[r:r + ksize, c:c + ksize, ch].ravel()
                    w1 = weight[r:r + ksize, c:c + ksize].ravel()
                    coef = P.polyfit(x.astype(float), y.astype(float),
                                     deg, w=w1 * w2)
                    np.testing.assert_allclose(
                        got[r, c, ch], coef, rtol=1e-4, atol=1e-4,
                        err_msg=f"pixel ({r},{c},{ch})")

    def test_polyfit_sp_float_input(self, rng):
        """[0, 1] float images: the gray level is taken on the 0..255
        scale, and the restore clips to [0, 1]."""
        shadowed = rng.uniform(0.1, 0.9, (7, 6, 3)).astype(np.float32)
        free = rng.uniform(0.1, 0.9, (7, 6, 3)).astype(np.float32)
        got = pre.compute_sp_polyfit(shadowed, free)
        np.testing.assert_array_equal(
            got, jpre.compute_sp_polyfit(shadowed, free))
        restored = pre.apply_sp_poly(shadowed, got)
        assert restored.dtype == np.float32
        np.testing.assert_array_equal(restored,
                                      jpre.apply_sp_poly(shadowed, got))

    @pytest.mark.parametrize("free_level", [0, 255])
    def test_polyfit_sp_degenerate_windows_finite(self, free_level):
        """Gray 0 or 255 has hat weight 0 everywhere: the fit is
        underdetermined and takes the min-norm solution, finite, as JAX
        does."""
        shadowed = np.full((6, 6, 3), 100, np.uint8)   # constant patch
        free = np.full((6, 6, 3), free_level, np.uint8)
        sp = pre.compute_sp_polyfit(shadowed, free)
        assert np.isfinite(sp).all()
        np.testing.assert_array_equal(
            sp, jpre.compute_sp_polyfit(shadowed, free))

    def test_polyfit_sp_roundtrip_and_cli(self, two_roots):
        """--method polyfit: the CLI writes sp_poly/ (H, W, 3, deg+1) and
        sp_poly_restored_img/ as JAX's does, and the restored image
        approximates the shadow-free target."""
        a, b = two_roots
        pre.main(["--path", a, "--subset", "train", "--method", "polyfit",
                  "--save-img", "true"])
        jpre.main(["--path", b, "--subset", "train", "--method", "polyfit",
                   "--save-img", "true"])
        assert _tree_equal(a, b, "train/sp_poly") == 2
        assert _tree_equal(a, b, "train/sp_poly_restored_img") == 2
        assert not os.path.isdir(os.path.join(a, "train", "sp_restored_img"))
        files = sorted(os.listdir(os.path.join(a, "train", "sp_poly")))
        assert np.load(os.path.join(a, "train", "sp_poly",
                                    files[0])).shape == (24, 32, 3, 2)
        png = files[0].replace(".npy", ".png")
        img = imread_color(os.path.join(a, "train", "train_A", png))
        tgt = imread_color(os.path.join(a, "train", "train_C_fixed", png))
        restored = pre.apply_sp_poly(img, pre.compute_sp_polyfit(img, tgt))
        err = np.abs(restored.astype(float) - tgt.astype(float)).mean()
        base = np.abs(img.astype(float) - tgt.astype(float)).mean()
        assert err < base * 0.5 and err < 10.0

    @pytest.mark.parametrize("flags,sp,img", [
        (["--save-sp", "false", "--save-img", "false"], False, False),
        (["--save-sp", "no", "--save-img", "yes"], False, True),
        (["--save-img"], True, True),
        ([], True, False),
    ])
    def test_save_flags_parse(self, two_roots, flags, sp, img):
        """The str2bool flags (the reference's type=bool took "false" as
        True); a bare flag means yes."""
        a, b = two_roots
        pre.main(["--path", a, "--subset", "train", *flags])
        jpre.main(["--path", b, "--subset", "train", *flags])
        for root in (a, b):
            assert os.path.isdir(os.path.join(root, "train", "sp")) == sp
            assert os.path.isdir(
                os.path.join(root, "train", "sp_restored_img")) == img


class TestColorAdjustment:
    def test_recovers_known_affine(self, rng):
        free = rng.integers(30, 220, (32, 32, 3), np.uint8)
        coef = np.array([1.1, 0.95, 1.05])
        offs = np.array([0.02, -0.01, 0.03])
        shadow = np.clip(free / 255.0 * coef + offs, 0, 1)
        shadow = (shadow * 255).astype(np.uint8)
        mask = np.zeros((32, 32), np.uint8)
        mask[:8, :8] = 255                  # a small shadow region
        corrected, params = ca.color_adjustment(free, shadow, mask)
        want_img, want_params = jca.color_adjustment(free, shadow, mask)
        np.testing.assert_array_equal(corrected, want_img)
        np.testing.assert_array_equal(params, want_params)
        got = params.reshape(3, 2)
        np.testing.assert_allclose(got[:, 1], coef, atol=0.02)
        np.testing.assert_allclose(got[:, 0], offs, atol=0.02)
        ns = mask == 0
        diff = np.abs(corrected.astype(int) - shadow.astype(int))[ns]
        assert diff.mean() < 3

    def test_fix_split(self, tmp_path, rng):
        roots = [str(tmp_path / "port"), str(tmp_path / "jax")]
        base = tmp_path / "port" / "train"
        for d in ("train_A", "train_B", "train_C"):
            os.makedirs(base / d)
        for i in range(2):
            imwrite(str(base / "train_A" / f"{i}.png"),
                    rng.integers(0, 256, (16, 16, 3), np.uint8))
            imwrite(str(base / "train_B" / f"{i}.png"),
                    (rng.uniform(size=(16, 16)) > 0.7).astype(np.uint8)
                    * 255)
            imwrite(str(base / "train_C" / f"{i}.png"),
                    rng.integers(0, 256, (16, 16, 3), np.uint8))
        shutil.copytree(roots[0], roots[1])
        assert ca.fix_split(roots[0], "train") == 2
        jca.fix_split(roots[1], "train")
        assert _tree_equal(*roots, "train/train_C_fixed_official") == 2
        ca.main(["--path", roots[0], "--out-dirname", "fixed"])
        jca.main(["--path", roots[1], "--out-dirname", "fixed"])
        assert _tree_equal(*roots, "train/fixed") == 2


def _vgg_state_dict(rng, prefix: str = "", scale: float = 1.0) -> dict:
    """A state dict with torchvision's ``vgg19_bn.features[:40]`` names."""
    prev, sd = 3, {}
    for (ci, bi), ch in zip(convert_vgg.CONV_BN_INDICES, CFG):
        sd[f"{prefix}{ci}.weight"] = rng.normal(size=(ch, prev, 3, 3),
                                                scale=scale)
        sd[f"{prefix}{ci}.bias"] = rng.normal(size=(ch,))
        for suffix in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{prefix}{bi}.{suffix}"] = rng.uniform(0.5, 1.5, size=(ch,))
        prev = ch
    return sd


class TestConvertVGG:
    def test_conversion_layout(self, rng):
        sd = _vgg_state_dict(rng)
        out = convert_vgg.convert_state_dict(sd)
        want = jvgg.convert_state_dict(sd)
        assert out.keys() == want.keys()
        for k in out:
            np.testing.assert_array_equal(out[k], want[k], err_msg=k)
        assert out["conv0_kernel"].shape == (3, 3, 3, 64)      # HWIO
        assert out["conv11_kernel"].shape == (3, 3, 512, 512)
        assert out["bn0_mean"].shape == (64,)
        np.testing.assert_array_equal(out["conv0_kernel"][..., 0, 0],
                                      sd["0.weight"][0, 0])

    def test_loads_into_both_vgg_loaders(self, tmp_path, rng):
        """The port's ``.npz`` loads through the port's ``load_vgg_npz``
        and through the JAX package's loader to the same leaves."""
        from shadow_removal_istd_tpu.models.vgg import load_vgg_variables
        from shadow_removal_istd_tpu_torch.models.vgg import load_vgg_npz

        path = str(tmp_path / "vgg.npz")
        np.savez(path, **convert_vgg.convert_state_dict(
            _vgg_state_dict(rng, scale=0.05)))
        module = load_vgg_npz(path)
        jv = load_vgg_variables(path)
        layers = list(module.convbns())
        assert len(layers) == len(jv["params"]) // 2 == 12
        for i, m in enumerate(layers):
            conv = jv["params"][f"Conv_{i}"]
            bn = jv["params"][f"BatchNorm_{i}"]
            st = jv["batch_stats"][f"BatchNorm_{i}"]
            for got, want in (
                    (m.weight.permute(2, 3, 1, 0), conv["kernel"]),
                    (m.bias, conv["bias"]), (m.bn_weight, bn["scale"]),
                    (m.bn_bias, bn["bias"]), (m.running_mean, st["mean"]),
                    (m.running_var, st["var"])):
                np.testing.assert_array_equal(got.detach().numpy(),
                                              np.asarray(want))

    def test_cli_accepts_raw_torchvision_checkpoint(self, tmp_path, rng):
        """``--state-dict`` takes the raw torchvision download (full-model
        ``features.`` keys) or a features-only dict: the port's ``.npz``
        equals the JAX tool's from the same file."""
        for prefix in ("features.", ""):
            sd = {k: torch.from_numpy(v).float() for k, v in
                  _vgg_state_dict(rng, prefix=prefix).items()}
            pth = str(tmp_path / f"vgg19_bn{prefix}.pth")
            torch.save(sd, pth)
            out, want = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
            convert_vgg.main(["--state-dict", pth, "--out", out])
            jvgg.main(["--state-dict", pth, "--out", want])
            with np.load(out) as a, np.load(want) as b:
                assert sorted(a.files) == sorted(b.files)
                assert a["conv0_kernel"].shape == (3, 3, 3, 64)
                assert a["bn11_var"].shape == (512,)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    def test_refuses_to_download(self, tmp_path):
        out = tmp_path / "vgg19_bn.npz"
        with pytest.raises(SystemExit, match="--state-dict"):
            convert_vgg.main(["--out", str(out)])
        assert not out.exists()


class TestExperiments:
    def test_grid_expansion(self):
        flags = {"a": [1, 2], "b": "x", "c": [True, False]}
        combos = exp.expand_grid(flags)
        assert combos == jexp.expand_grid(flags)
        assert len(combos) == 4
        assert {"a": 1, "b": "x", "c": True} in combos

    def test_format_label(self):
        flags = {"net-G": "mnet", "tasks": "train", "x": 3}
        for tpl in ("t_{net-G}", "{tasks}_{x}_{missing}", "plain"):
            assert exp.format_label(tpl, flags) == jexp.format_label(
                tpl, flags)

    @staticmethod
    def _mapped(cmds):
        """The JAX commands with the module mapped to the port's."""
        return [(d, [c.replace(exp.JAX_PREFIX, exp.PORT_PREFIX, 1)
                     if i == 2 else c for i, c in enumerate(cmd)])
                for d, cmd in cmds]

    def test_build_commands(self, tmp_path):
        spec = {"operations": {"op": {
            "main": "shadow_removal_istd_tpu.cli.main",
            "label": "t_{net-G}",
            "flags": {"tasks": "train", "net-G": ["unet", "mnet"],
                      "SELU": False, "data-dir": "/a /b"},
        }}}
        cmds = exp.build_commands(spec, "op", str(tmp_path))
        assert cmds == self._mapped(jexp.build_commands(spec, "op",
                                                        str(tmp_path)))
        assert len(cmds) == 2
        run_dir, cmd = cmds[0]
        assert run_dir.endswith("t_unet")
        assert cmd[1:3] == ["-m", "shadow_removal_istd_tpu_torch.cli.main"]
        assert "--net-G" in cmd and "unet" in cmd
        assert cmd[cmd.index("--SELU") + 1] == "no"
        assert cmd[cmd.index("--data-dir") + 1:][:2] == ["/a", "/b"]

    @pytest.mark.parametrize("op", ["shadow-removal-train",
                                    "shadow-removal-infer", "STCGAN-train",
                                    "STCGAN-infer"])
    def test_repo_experiments_yaml(self, op):
        """``experiments.yaml`` (YAML, not JSON): every operation launches
        the port's CLI with the JAX runner's flags."""
        path = os.path.join(REPO, "experiments.yaml")
        spec = exp._load(path)
        assert spec == jexp._load(path)
        cmds = exp.build_commands(spec, op)
        assert cmds and cmds == self._mapped(jexp.build_commands(spec, op))
        assert all(c[2].startswith(exp.PORT_PREFIX) for _, c in cmds)

    def test_main_lists_json_spec(self, tmp_path, capsys):
        spec = tmp_path / "spec.json"
        spec.write_text('{"operations": {"op": {"main": "other.module", '
                        '"flags": {"k": [1, 2]}}}}')
        exp.main(["list", str(spec), "op", "--run-root", str(tmp_path)])
        out = capsys.readouterr().out.splitlines()
        assert len(out) == 2 and "-m other.module --k 1" in out[0]
        assert not (tmp_path / "op").exists()
