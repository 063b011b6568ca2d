"""The port's CLI (``cli/main.py``) on the CPU: the JAX CLI's flag surface
(its ``TestFlagSurface`` cases that need no mesh), ``--tasks train infer
serve`` end to end on a synthetic ISTD directory (64x64, 4 train and 2
test triplets, MNet ngf 4, PatchGAN ndf 4, 32x32 crops, batch 2), a
resumed run equal bit for bit to the uninterrupted one, inference PNGs
against the JAX package's ``Trainer.infer`` from the same weight files,
``--eval-metrics``, ``--aug-method gather``, ``--device-cache false`` and
``--profile-dir`` through a resumed run, ``--checkpoint-backend orbax``
resumed from its directory equal bit for bit to the uninterrupted run, and
the device lists the port refuses.
"""
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from shadow_removal_istd_tpu.cli.main import _select_mesh as j_select_mesh
from shadow_removal_istd_tpu.cli.main import build_parser as j_build_parser
from shadow_removal_istd_tpu.engine.config import TrainConfig as JConfig
from shadow_removal_istd_tpu.engine.loop import RunConfig as JRunConfig
from shadow_removal_istd_tpu.engine.loop import Trainer as JTrainer
from shadow_removal_istd_tpu_torch.cli.main import (
    build_parser,
    load_args,
    main,
    makedirs,
    prepare_run_dirs,
    select_devices,
    select_mesh,
    snapshotargs,
    str2bool,
)
from shadow_removal_istd_tpu_torch.data.h5 import build_h5
from shadow_removal_istd_tpu_torch.data.synthetic import write_istd_layout
from shadow_removal_istd_tpu_torch.serving import InferenceEngine
from shadow_removal_istd_tpu_torch.utils.image_io import (
    imdecode_color,
    imencode_png,
    imread_color,
    imread_gray,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--ngf", "4", "--ndf", "4", "--image-size", "32",
        "--batch-size", "2", "--log-every", "1", "--valid-every", "1",
        "--save-every", "1"]
SUFFIX = "_lr0.00050_SGAN"


class TestFlagSurface:
    def test_every_jax_flag_with_its_default(self):
        """Same option strings, destinations, defaults and choices as the
        JAX CLI; only ``--devices`` defaults to the card."""
        def actions(parser):
            return {tuple(a.option_strings): a for a in parser._actions
                    if a.option_strings and a.dest != "help"}
        got, want = actions(build_parser()), actions(j_build_parser())
        assert got.keys() == want.keys()
        for opts, a in want.items():
            b = got[opts]
            assert (b.dest, b.choices, b.nargs, b.const, b.required) == (
                a.dest, a.choices, a.nargs, a.const, a.required), opts
            if opts != ("--devices",):
                assert b.default == a.default, opts
        assert build_parser().parse_args(
            ["--tasks", "train"]).devices == ["cuda"]

    def test_reference_flags_accepted(self):
        args = build_parser().parse_args([
            "--tasks", "train", "infer", "--devices", "cpu",
            "--batch-size", "4", "--epochs", "2000",
            "--data-dir", "/data/ISTD", "--workers", "4",
            "--image-size", "256", "--aug-scale", "0.05",
            "--aug-angle", "15", "--net-G", "mnet", "--net-D", "patchgan",
            "--ngf", "64", "--ndf", "64", "--droprate", "0.05",
            "--lr-D", "0.0001", "--lr-G", "0.0005", "--decay", "0.003",
            "--beta1", "0.5", "--beta2", "0.999",
            "--lambda1", "5", "--lambda2", "0.5", "--lambda3", "0.5",
            "--lambda4", "5", "--lambda5", "50",
            "--manual_seed", "38107943",
            "--D-loss-fn", "leastsquare", "--D-type", "rel_avg",
            "--softadapt", "--SELU", "no", "--NN-upconv", "yes",
            "--activation", "tanh", "--log-every", "3", "--valid-every",
            "10", "--vis-every", "50", "--save-every", "50",
            "--weights", "./w", "--infered", "./i", "--logs", "./l",
        ])
        assert args.tasks == ["train", "infer"] and args.devices == ["cpu"]
        assert args.net_G == "mnet" and args.NN_upconv is True
        assert args.D_loss_fn == "leastsquare" and args.softadapt is True

    def test_defaults_match_reference(self):
        args = build_parser().parse_args(["--tasks", "train"])
        assert args.batch_size == 16 and args.epochs == 100000
        assert args.lr_G == 0.0005 and args.lr_D == 0.0001
        assert args.lambda1 == 5 and args.lambda5 == 50
        assert args.manual_seed == 38107943
        assert args.net_G == "mnet" and args.net_D == "patchgan"
        assert args.activation == "tanh" and args.aug_method == "shear"
        assert args.remat is False

    def test_str2bool(self):
        assert str2bool("yes") and str2bool("True") and str2bool("1")
        assert not str2bool("no") and not str2bool("0")

    def test_rundir_naming(self, tmp_path):
        args = build_parser().parse_args(
            ["--tasks", "train", "--D-type", "rel_avg",
             "--D-loss-fn", "leastsquare",
             "--weights", str(tmp_path / "w"), "--logs", str(tmp_path / "l")])
        makedirs(args)
        assert args.weights.endswith("_lr0.00050_RaLSGAN")
        assert os.path.isdir(args.weights) and os.path.isdir(args.logs)

    def test_args_snapshot_and_reload(self, tmp_path):
        args = build_parser().parse_args(
            ["--tasks", "train", "--ngf", "32", "--logs", str(tmp_path)])
        snapshotargs(args)
        snap = tmp_path / "args.json"
        assert json.loads(snap.read_text())["ngf"] == 32
        args2 = build_parser().parse_args(
            ["--tasks", "infer", "--ngf", "64",
             "--logs", "/other", "--load-args", str(snap)])
        load_args(args2)
        assert args2.ngf == 32          # restored
        assert args2.logs == "/other"   # preserved

    def test_snapshot_and_dirs_precede_load_args(self, tmp_path):
        old = build_parser().parse_args(
            ["--tasks", "train", "--lr-G", "0.001", "--logs", str(tmp_path)])
        snapshotargs(old)
        new = build_parser().parse_args(
            ["--tasks", "train", "--load-args", str(tmp_path / "args.json"),
             "--weights", str(tmp_path / "w"),
             "--logs", str(tmp_path / "new")])
        prepare_run_dirs(new)
        assert "_lr0.00050_" in new.logs and os.path.isdir(new.logs)
        with open(os.path.join(new.logs, "args.json")) as fp:
            assert json.load(fp)["lr_G"] == 0.0005
        assert new.lr_G == 0.001


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs several workers on few cores,
    where torch's default pool (one thread a core, in every worker)
    oversubscribes them many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def istd_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("istd")
    write_istd_layout(str(root / "istd"), n_train=4, n_test=2, h=64, w=64)
    return str(root / "istd")


def _argv(istd_root, base, *extra):
    return [*extra, "--data-dir", istd_root, "--devices", "cpu", *TINY,
            "--weights", f"{base}/w", "--logs", f"{base}/l",
            "--infered", f"{base}/out"]


def _run(*argv):
    main(build_parser().parse_args(list(argv)))


@pytest.fixture(scope="module")
def trained(istd_root, tmp_path_factory):
    """``--tasks train infer --epochs 2`` once; its run directory."""
    base = str(tmp_path_factory.mktemp("run"))
    _run(*_argv(istd_root, base, "--tasks", "train", "infer", "--epochs",
                "2", "--allow-missing-vgg"))
    return base


def test_missing_vgg_raises(istd_root, tmp_path):
    with pytest.raises(ValueError, match="visual loss"):
        _run(*_argv(istd_root, str(tmp_path), "--tasks", "train",
                    "--epochs", "1"))


def test_train_infer_end_to_end(trained):
    weights = os.listdir(f"{trained}/w{SUFFIX}")
    assert sorted(weights) == sorted(
        [f"{n}_{c}_{s}.msgpack" for n, c in
         (("G1", "MNet"), ("G2", "MNet"), ("D1", "PatchGAN"),
          ("D2", "PatchGAN")) for s in ("best", "latest")]
        + ["checkpoint.msgpack"])
    for sub, read, shape in (("shadowless", imread_color, (64, 64, 3)),
                             ("matte", imread_gray, (64, 64))):
        files = sorted(os.listdir(f"{trained}/out/{sub}/istd"))
        assert files == ["000-test.png", "001-test.png"]
        for f in files:
            assert read(f"{trained}/out/{sub}/istd/{f}").shape == shape
    logs = os.listdir(f"{trained}/l{SUFFIX}")
    assert "args.json" in logs
    text = "".join(open(f"{trained}/l{SUFFIX}/{f}").read()
                   for f in logs if f.endswith(".log"))
    assert "train epoch 1:" in text and "valid epoch 1:" in text


def test_resume_is_bit_exact(istd_root, tmp_path):
    """2 epochs in one run against 1 epoch, then a run resumed from its
    checkpoint: the same weight files and checkpoint, byte for byte
    (randomness is a function of seed, epoch and step; the checkpoint
    carries the weights, BN statistics, both Adam states with their
    step, the step count and the best validation loss)."""
    common = ("--tasks", "train", "--allow-missing-vgg")
    _run(*_argv(istd_root, f"{tmp_path}/a", *common, "--epochs", "2"))
    _run(*_argv(istd_root, f"{tmp_path}/b", *common, "--epochs", "1"))
    ckpt = f"{tmp_path}/b/w{SUFFIX}/checkpoint.msgpack"
    _run(*_argv(istd_root, f"{tmp_path}/b", *common, "--epochs", "2",
                "--load-checkpoint", ckpt))
    a, b = f"{tmp_path}/a/w{SUFFIX}", f"{tmp_path}/b/w{SUFFIX}"
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b)) and len(files) == 9
    for f in files:
        with open(f"{a}/{f}", "rb") as fa, open(f"{b}/{f}", "rb") as fb:
            assert fa.read() == fb.read(), f


def test_orbax_backend_resumes_bit_exact(istd_root, tmp_path):
    """``--checkpoint-backend orbax`` at its default path
    (``<weights>/checkpoint_orbax``): 2 epochs in one run against 1
    epoch, then a run resumed from the backend's directory; the weight
    files byte for byte, and the two ``step_2`` directories leaf for leaf,
    with ``meta_step_N.json`` beside each step."""
    from shadow_removal_istd_tpu_torch.engine.orbax_format import read_step
    from shadow_removal_istd_tpu_torch.tools.convert import flatten_tree

    common = ("--tasks", "train", "--allow-missing-vgg",
              "--checkpoint-backend", "orbax")
    _run(*_argv(istd_root, f"{tmp_path}/a", *common, "--epochs", "2"))
    _run(*_argv(istd_root, f"{tmp_path}/b", *common, "--epochs", "1"))
    root = f"{tmp_path}/b/w{SUFFIX}/checkpoint_orbax"
    assert sorted(os.listdir(root)) == ["meta_step_1.json", "step_1"]
    _run(*_argv(istd_root, f"{tmp_path}/b", *common, "--epochs", "2",
                "--load-checkpoint", root))
    a, b = f"{tmp_path}/a/w{SUFFIX}", f"{tmp_path}/b/w{SUFFIX}"
    files = sorted(f for f in os.listdir(a) if f.endswith(".msgpack"))
    assert files == sorted(f for f in os.listdir(b)
                           if f.endswith(".msgpack")) and len(files) == 8
    for f in files:
        with open(f"{a}/{f}", "rb") as fa, open(f"{b}/{f}", "rb") as fb:
            assert fa.read() == fb.read(), f
    for w in (a, b):
        assert sorted(os.listdir(f"{w}/checkpoint_orbax")) == [
            "meta_step_1.json", "meta_step_2.json", "step_1", "step_2"]
    ta, tb = (flatten_tree(read_step(f"{w}/checkpoint_orbax/step_2"))
              for w in (a, b))
    assert ta.keys() == tb.keys()
    assert ta.pop(("softadapt",)) is tb.pop(("softadapt",)) is None
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=str(k))
    with open(f"{b}/checkpoint_orbax/meta_step_2.json") as f:
        assert json.load(f)["epoch"] == 2


def test_infer_pngs_match_jax(trained, istd_root, tmp_path):
    """The JAX package's ``Trainer.infer`` from the port's weight files:
    the same file names, uint8 within 1 gray level."""
    g1, g2 = (f"{trained}/w{SUFFIX}/{n}_MNet_latest.msgpack"
              for n in ("G1", "G2"))
    _run(*_argv(istd_root, f"{tmp_path}/port", "--tasks", "infer",
                "--load-weights-g1", g1, "--load-weights-g2", g2))
    jt = JTrainer(JConfig(ngf=4, ndf=4, image_size=32, batch_size=2),
                  JRunConfig(data_dirs=(istd_root,), tasks=("infer",),
                             infered_dir=f"{tmp_path}/jax"))
    jt.load_weights(g1=g1, g2=g2)
    assert jt.infer() == 2
    for sub in ("shadowless", "matte"):
        got_dir = f"{tmp_path}/port/out/{sub}/istd"
        want_dir = f"{tmp_path}/jax/{sub}/istd"
        names = sorted(os.listdir(want_dir))
        assert sorted(os.listdir(got_dir)) == names == [
            "000-test.png", "001-test.png"]
        read = imread_color if sub == "shadowless" else imread_gray
        for f in names:
            got = read(f"{got_dir}/{f}").astype(np.int16)
            want = read(f"{want_dir}/{f}").astype(np.int16)
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1, (sub, f)


def test_serve_task_answers_on_the_trained_generators(trained, tmp_path):
    """``--tasks serve --load-checkpoint``: the daemon serves the
    checkpoint's generators (f32), as an engine loading the same
    weights does, and exits 0 on SIGTERM."""
    w = f"{trained}/w{SUFFIX}"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "shadow_removal_istd_tpu_torch.cli.main",
         "--tasks", "serve", "--devices", "cpu", "--ngf", "4", "--ndf", "4",
         "--load-checkpoint", f"{w}/checkpoint.msgpack",
         "--serve-port", str(port), "--weights", f"{tmp_path}/w",
         "--logs", f"{tmp_path}/l"], cwd=REPO)
    try:
        deadline, up = time.time() + 60, False
        while time.time() < deadline and not up:
            assert proc.poll() is None, "serve process died"
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=5)
                conn.request("GET", "/healthz")
                up = conn.getresponse().status == 200
                conn.close()
            except OSError:
                time.sleep(0.2)
        assert up, "daemon never became healthy"
        img = np.random.default_rng(4).integers(0, 256, (64, 64, 3),
                                                np.uint8)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/unshadow", body=imencode_png(img))
        resp = conn.getresponse()
        assert resp.status == 200
        got = imdecode_color(resp.read())
        conn.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    engine = InferenceEngine(ngf=4, nn_upconv=False, dtype="float32",
                             device="cpu")
    engine.load_weights(f"{w}/G1_MNet_latest.msgpack",
                        f"{w}/G2_MNet_latest.msgpack")
    np.testing.assert_array_equal(got, engine.infer_group([img])[0][1])


@pytest.mark.parametrize("extra,exc,match", [
    (["--devices", "cuda,cpu"], RuntimeError, "no CUDA device"),
    (["--devices", "tpu"], ValueError, "cuda or cpu"),
    (["--devices", "2"], RuntimeError, "no CUDA device"),
])
def test_unported_flags_raise(istd_root, tmp_path, extra, exc, match):
    argv = _argv(istd_root, str(tmp_path), "--tasks", "train",
                 "--epochs", "1", "--allow-missing-vgg")
    with pytest.raises(exc, match=match):
        _run(*argv[:argv.index("--devices")], *argv[argv.index("--devices")
                                                    + 2:],
             *(["--devices", "cpu"] if "--devices" not in extra else []),
             *extra)


def test_device_lists_take_their_first_entry(monkeypatch):
    """``--devices`` lists as the JAX CLI reads them (its ``_select_mesh``
    takes ``devices[0]``): ``cpu`` first runs on the CPU whatever
    follows, through both CLIs' parsers."""
    from shadow_removal_istd_tpu_torch.cli.stcgan_main import (
        build_parser as legacy_parser,
    )

    # a host without a card: the ignored cuda entry is never resolved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert select_devices(["cpu", "cuda"], 16) == select_devices(["cpu"],
                                                                 16)
    assert select_mesh(["cpu", "cuda"], 16) == select_mesh(["cpu"], 16)
    assert select_mesh(["cpu", "cuda"], 16) == ([torch.device("cpu")],
                                                (1, 1, 1))
    main_args = build_parser().parse_args(["--tasks", "train", "--devices",
                                           "cpu,cuda"])
    legacy = legacy_parser().parse_args(["--tasks", "train", "--devices",
                                         "cpu", "cuda"])
    for args in (main_args, legacy):
        assert args.devices == ["cpu", "cuda"]
        assert select_devices(list(args.devices), args.batch_size) == [
            torch.device("cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        select_devices(["cuda", "cpu"], 16)


@pytest.mark.parametrize("extra,logged", [
    (["--eval-metrics"], "eval protocol @ epoch 1: RMSE shadow"),
    (["--aug-method", "gather"], "train epoch 1:"),
    (["--net-G", "unet", "--net-D", "began", "--softadapt", "--SELU",
      "yes"], "train epoch 1:"),
    (["--device-cache", "false"], "train epoch 1:"),
    (["--profile-dir", "{tmp}/prof"], "train epoch 1:"),
    (["--remat"], "train epoch 1:"),
    (["--data-h5", "{tmp}/istd.h5"], "istd.h5: 4 train + 2 test samples"),
])
def test_formerly_unported_flags_run(istd_root, tmp_path, extra, logged):
    """The in-training eval protocol (``Eval/*`` in the log, against the
    directory's ``test_B`` masks), the gather augmentation, the zoo with
    BEGAN, SoftAdapt and SELU, the host-pipeline epoch and the profiler
    trace run; a run resumed from the first epoch's checkpoint ends with
    the same files, byte for byte, as the uninterrupted one (the gather
    path draws its parameters from the same (seed, epoch, step) streams;
    the host pipeline's order is a function of (seed, epoch); the
    checkpoint carries k1/k2 and the SoftAdapt state). ``--remat`` (at
    the CLI's droprate 0.05) and ``--data-h5`` (a file the port's
    ``build_h5`` wrote from the same directory, which it takes in place
    of ``--data-dir``) resume the same way."""
    extra = [a.format(tmp=tmp_path) for a in extra]
    if "--data-h5" in extra:
        build_h5(extra[1], istd_root)
    common = ("--tasks", "train", "--allow-missing-vgg", *extra)
    _run(*_argv(istd_root, f"{tmp_path}/a", *common, "--epochs", "2"))
    _run(*_argv(istd_root, f"{tmp_path}/b", *common, "--epochs", "1"))
    _run(*_argv(istd_root, f"{tmp_path}/b", *common, "--epochs", "2",
                "--load-checkpoint",
                f"{tmp_path}/b/w{SUFFIX}/checkpoint.msgpack"))
    a, b = f"{tmp_path}/a/w{SUFFIX}", f"{tmp_path}/b/w{SUFFIX}"
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b)) and len(files) == 9
    for f in files:
        with open(f"{a}/{f}", "rb") as fa, open(f"{b}/{f}", "rb") as fb:
            assert fa.read() == fb.read(), f
    logs = f"{tmp_path}/a/l{SUFFIX}"
    text = "".join(open(f"{logs}/{f}").read() for f in os.listdir(logs)
                   if f.endswith(".log"))
    assert logged in text
    if "--profile-dir" in extra:        # the uninterrupted run's epoch 1
        (trace,) = os.listdir(f"{tmp_path}/prof")
        assert trace.endswith(".pt.trace.json")


@pytest.mark.parametrize("extra,message", [
    (["--coordinator", "h:1"],
     "--coordinator needs --num-processes and --process-id"),
    (["--num-processes", "2"],
     "--num-processes needs --coordinator host:port and --process-id"),
    (["--coordinator", "h:1", "--process-id", "0"],
     "--coordinator needs --num-processes and --process-id"),
])
def test_multihost_flags_go_together(istd_root, tmp_path, extra, message):
    """Some of ``--coordinator``/``--num-processes``/``--process-id``
    without the others: exit with the JAX CLI's message."""
    argv = _argv(istd_root, str(tmp_path), "--tasks", "train",
                 "--epochs", "1", "--allow-missing-vgg", *extra)
    with pytest.raises(SystemExit, match=re.escape(message)):
        _run(*argv)


@pytest.mark.parametrize("want,cards,batch,got", [
    (2, 4, 16, 2), (8, 4, 16, 4), (4, 4, 6, 3), (3, 4, 4, 2)])
def test_devices_count_caps_to_cards_and_batch(monkeypatch, want, cards,
                                               batch, got):
    """``--devices N``: the first N cards, capped to the cards present
    and to the largest count whose ranks split the batch equally (JAX's
    ``_select_mesh``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    devices = select_devices([str(want)], batch)
    assert devices == [torch.device("cuda", i) for i in range(got)]


# (--devices, --batch-size, --spatial-shard, --model-shard)
MESH_CASES = [("8", 8, 1, 1), ("8", 8, 2, 1), ("8", 8, 4, 1),
              ("8", 8, 1, 2), ("8", 8, 2, 2), ("8", 8, 3, 1),
              ("8", 6, 2, 1), ("8", 4, 1, 4), ("4", 8, 2, 2),
              ("2", 8, 2, 2), ("8", 8, 16, 1), ("8", 8, 1, 16),
              ("8", 8, 4, 4), ("8", 3, 2, 1), ("5", 8, 2, 1),
              ("cpu", 8, 2, 2), ("8", 1, 2, 2), ("3", 8, 1, 1)]


@pytest.mark.parametrize("devices,batch,sp,mp", MESH_CASES)
def test_mesh_shape_caps_as_jax(caplog, devices, batch, sp, mp):
    """``--spatial-shard``/``--model-shard`` size the mesh as the JAX
    CLI's ``_select_mesh`` does on the conftest's 8 host devices: the
    same (data, spatial, model) shape and the same warnings."""
    import jax

    from shadow_removal_istd_tpu_torch.cli.main import mesh_shape

    with caplog.at_level("WARNING"):
        mesh = j_select_mesh([devices], batch, sp, mp)
    j_logs = [r.getMessage() for r in caplog.records]
    caplog.clear()
    shape = (1, 1, 1) if mesh is None else tuple(
        mesh.shape.get(a, 1) for a in ("data", "spatial", "model"))
    avail = len(jax.devices())
    want = int(devices) if devices.isdigit() else avail
    with caplog.at_level("WARNING"):
        got = mesh_shape(want, avail, batch, sp, mp)
    assert got == shape
    assert [r.getMessage() for r in caplog.records] == j_logs


def test_pipeline_infer_on_one_device_runs_fused(trained, istd_root,
                                                  tmp_path):
    """``--pipeline-infer`` with one selected device warns and writes the
    fused path's PNGs (the trained run's, byte for byte)."""
    g1, g2 = (f"{trained}/w{SUFFIX}/{n}_MNet_latest.msgpack"
              for n in ("G1", "G2"))
    base = f"{tmp_path}/pipe"
    _run(*_argv(istd_root, base, "--tasks", "infer", "--pipeline-infer",
                "--load-weights-g1", g1, "--load-weights-g2", g2))
    text = "".join(open(f"{base}/l{SUFFIX}/{f}").read()
                   for f in os.listdir(f"{base}/l{SUFFIX}")
                   if f.endswith(".log"))
    assert "--pipeline-infer needs >= 2 selected devices" in text
    for sub in ("shadowless", "matte"):
        for f in ("000-test.png", "001-test.png"):
            with open(f"{base}/out/{sub}/istd/{f}", "rb") as a, \
                    open(f"{trained}/out/{sub}/istd/{f}", "rb") as b:
                assert a.read() == b.read(), (sub, f)


def test_without_card_the_cli_raises(istd_root, tmp_path, monkeypatch):
    """No ``--devices cpu`` and no card: no silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(istd_root, str(tmp_path), "--tasks", "train",
                 "--epochs", "1", "--allow-missing-vgg")
    i = argv.index("--devices")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(*argv[:i], *argv[i + 2:])


def test_inference_needs_weights(istd_root, tmp_path):
    with pytest.raises(ValueError, match="--load-weights-g1/g2"):
        _run(*_argv(istd_root, str(tmp_path), "--tasks", "infer"))
