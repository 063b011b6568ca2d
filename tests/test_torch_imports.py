"""Import hygiene of the port: no JAX, no JAX package, no silent CPU.

Walks the AST of every module of ``shadow_removal_istd_tpu_torch`` and
of ``chip_smoke.py``: none may import ``jax``, ``flax``, ``optax``,
``msgpack`` or ``h5py`` (absent on a CUDA host; the port has its own
codecs) or anything of ``shadow_removal_istd_tpu`` (modules without JAX
included).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from shadow_removal_istd_tpu_torch.serving import InferenceEngine

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "flax", "optax", "msgpack", "h5py",
             "shadow_removal_istd_tpu"}
FILES = sorted(p.relative_to(REPO).as_posix() for p in
               [*(REPO / "shadow_removal_istd_tpu_torch").rglob("*.py"),
                REPO / "chip_smoke.py"])


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_found():
    assert "chip_smoke.py" in FILES
    for rel in ("ops/decoder.py", "ops/shear.py", "ops/augment.py",
                "losses/adversarial.py", "losses/visual.py",
                "data/device_cache.py", "data/synthetic.py",
                "data/istd.py", "data/pipeline.py", "engine/loop.py",
                "engine/checkpoint.py", "utils/msgpack_codec.py",
                "cli/main.py", "models/patchgan.py", "models/vgg.py",
                "ops/color.py", "ops/resize.py", "ops/warp.py",
                "metrics/metrics.py", "metrics/eval_cli.py",
                "data/h5.py", "data/hdf5_codec.py", "tools/preprocess.py",
                "tools/export.py", "tools/color_adjustment.py",
                "tools/convert_vgg.py", "tools/experiments.py",
                "serving/engine.py"):
        assert f"shadow_removal_istd_tpu_torch/{rel}" in FILES, rel


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_imports(rel):
    bad = _imported_roots(REPO / rel) & FORBIDDEN
    assert not bad, f"{rel} imports {sorted(bad)}"


def test_engine_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(ngf=4)


def test_trainer_without_card_raises(monkeypatch):
    from shadow_removal_istd_tpu_torch.data.synthetic import (
        synthetic_triplets,
    )
    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
    from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainConfig(ngf=4, ndf=4, batch_size=2, image_size=32,
                            aug_method="shear"),
                RunConfig(seed=0, allow_missing_vgg=True),
                train_streams=synthetic_triplets(2, 32, 32))


def test_init_state_without_card_raises(monkeypatch):
    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
    from shadow_removal_istd_tpu_torch.engine.state import init_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(TrainConfig(ngf=4, ndf=4), torch.Generator())


def test_chip_smoke_fails_without_card():
    """``chip_smoke.py`` exits non-zero and prints no result line when
    CUDA is unavailable."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
