"""Multi-process training through the port's CLI: two ``cli.main``
processes on the CPU with ``--devices cpu --coordinator 127.0.0.1:<port>
--num-processes 2 --process-id i`` rendezvous, train data-parallel over
2 gloo ranks and log identical validation lines; rank 0 alone writes the
checkpoint, the weight files and the event files (the JAX package's
``tests/test_multihost_cli.py`` check, run here in tier-1: ~15 s). A
SIGTERM to the process that launched two ranks reaches both (~10 s).
``--spatial-shard 2`` and ``--model-shard 2`` on two CPU ranks launched
by one process train, validate and infer as one process does (~12 s
each).
"""
import contextlib
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from shadow_removal_istd_tpu_torch.data.synthetic import write_istd_layout
from shadow_removal_istd_tpu_torch.utils.msgpack_codec import from_bytes

REPO = Path(__file__).resolve().parent.parent
SUFFIX = "_lr0.00050_SGAN"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(rank: int, port: int, root: str, base: Path, *extra: str,
            epochs: int = 2):
    argv = [sys.executable, "-m", "shadow_removal_istd_tpu_torch.cli.main",
            "--tasks", "train", "--devices", "cpu",
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
            "--process-id", str(rank), "--data-dir", root,
            "--ngf", "4", "--ndf", "4", "--image-size", "32",
            "--batch-size", "4", "--epochs", str(epochs), "--log-every",
            "1", "--valid-every", "1", "--vis-every", "1", "--save-every",
            "1", "--allow-missing-vgg",
            "--weights", str(base / f"w{rank}"),
            "--logs", str(base / f"logs{rank}"),
            "--infered", str(base / f"out{rank}"), *extra]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=str(base))


def _metric_lines(out: str) -> list[str]:
    """The validation lines and the improvements, without their rank
    and time prefix."""
    return [m.group(0) for m in re.finditer(
        r"(valid epoch \d+: .*|improvement after epoch \d+, error=.*)",
        out)]


def _files(d: Path) -> list[str]:
    return sorted(str(p.relative_to(d)) for p in d.rglob("*")
                  if p.is_file())


def test_two_process_cli_trains_alike_and_rank0_writes(tmp_path):
    root = str(tmp_path / "istd")
    write_istd_layout(root, n_train=8, n_test=4, h=64, w=64)
    port = _free_port()
    procs = [_launch(r, port, root, tmp_path) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    m0, m1 = _metric_lines(outs[0]), _metric_lines(outs[1])
    assert len([m for m in m0 if m.startswith("valid epoch")]) == 2, outs[0]
    assert m0 == m1
    assert "backend gloo (CPU ranks)" in outs[0]

    w0, w1 = tmp_path / f"w0{SUFFIX}", tmp_path / f"w1{SUFFIX}"
    assert _files(w1) == []
    files = _files(w0)
    assert "checkpoint.msgpack" in files and len(files) == 9, files
    ckpt = from_bytes((w0 / "checkpoint.msgpack").read_bytes())
    assert int(ckpt["epoch"]) == 2 and int(ckpt["state"]["step"]) == 4

    def events(d: Path) -> list[str]:
        return [f for f in _files(d) if "tfevents" in f]

    assert events(tmp_path / f"logs0{SUFFIX}")
    assert not events(tmp_path / f"logs1{SUFFIX}")
    # each rank logs to its own file, as the JAX CLI's processes do
    assert any(re.fullmatch(r"main-.*-p1\.log", f)
               for f in os.listdir(tmp_path / f"logs1{SUFFIX}"))


def _run_pair(root: str, base: Path, *extra: str, epochs: int):
    """Both ranks to their end (bounded); their outputs."""
    port = _free_port()
    procs = [_launch(r, port, root, base, *extra, epochs=epochs)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def test_two_process_orbax_rank0_writes_every_rank_resumes(tmp_path):
    """``--checkpoint-backend orbax`` over two gloo ranks: both runs end
    (the JAX package's trainer deadlocks here, rank 0 alone entering
    orbax's barriers), rank 0 alone writes ``step_N`` and its meta file,
    and both ranks of a second run resume from rank 0's directory and
    train the next epoch alike."""
    root = str(tmp_path / "istd")
    write_istd_layout(root, n_train=8, n_test=4, h=64, w=64)
    _run_pair(root, tmp_path, "--checkpoint-backend", "orbax", epochs=1)
    w0, w1 = tmp_path / f"w0{SUFFIX}", tmp_path / f"w1{SUFFIX}"
    assert _files(w1) == []
    orbax = w0 / "checkpoint_orbax"
    assert sorted(os.listdir(orbax)) == ["meta_step_1.json", "step_1"]
    outs = _run_pair(root, tmp_path, "--checkpoint-backend", "orbax",
                     "--load-checkpoint", str(orbax), epochs=2)
    for out in outs:
        assert "checkpoint loaded (epoch 1)" in out, out[-4000:]
        assert "valid epoch 1:" in out and "valid epoch 0:" not in out
    assert _metric_lines(outs[0]) == _metric_lines(outs[1])
    assert _files(w1) == []
    assert sorted(os.listdir(orbax)) == [
        "meta_step_1.json", "meta_step_2.json", "step_1", "step_2"]


# the CLI's launch of a mesh's ranks from one process (``--devices N``
# with --spatial-shard / --model-shard on the cards) with CPU ranks
SPAWN_CPU_MESH = (
    "import sys, torch\n"
    "from shadow_removal_istd_tpu_torch.cli import main as m\n"
    "pick = m.select_mesh\n"
    "def cpu_mesh(devices, batch, processes, sp, mp):\n"
    "    _, shape = pick(devices, batch, processes, sp, mp)\n"
    "    n = shape[0] * shape[1] * shape[2]\n"
    "    return [torch.device('cpu')] * n, shape\n"
    "torch.cuda.device_count = lambda: 8\n"
    "m.resolve_device = lambda d: torch.device('cpu')\n"
    "m.select_mesh = cpu_mesh\n"
    "m.main(m.build_parser().parse_args(sys.argv[1:]))\n")


@pytest.mark.parametrize("flags,shape", [
    (["--spatial-shard", "2"], "{'data': 1, 'spatial': 2, 'model': 1}"),
    (["--model-shard", "2", "--pipeline-infer"],
     "{'data': 1, 'spatial': 1, 'model': 2}")])
def test_cli_shards_match_one_process(tmp_path, flags, shape):
    """``--spatial-shard 2`` (validation and inference on row slabs) and
    ``--model-shard 2`` (channel-split training; ``--pipeline-infer``
    then gathers the weights and warns, as the JAX trainer does) on two
    CPU ranks launched by one process: one epoch of ``train infer`` logs
    the validation lines of a one-process run, rank 0 alone writes the
    weight files and the PNGs, and the PNGs are the one-process run's,
    byte for byte."""
    root = str(tmp_path / "istd")
    write_istd_layout(root, n_train=8, n_test=4, h=64, w=64)
    common = ["--tasks", "train", "infer", "--data-dir", root,
              "--ngf", "4", "--ndf", "4", "--image-size", "32",
              "--batch-size", "4", "--epochs", "1", "--log-every", "1",
              "--valid-every", "1", "--vis-every", "1",
              "--allow-missing-vgg"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    runs = {}
    for name, head in (("one", ["-m", "shadow_removal_istd_tpu_torch.cli"
                                ".main", "--devices", "cpu"]),
                       ("mesh", ["-c", SPAWN_CPU_MESH, "--devices", "2",
                                 *flags])):
        d = tmp_path / name
        d.mkdir()
        runs[name] = (d, subprocess.Popen(
            [sys.executable, *head, *common, "--weights", str(d / "w"),
             "--logs", str(d / "logs"), "--infered", str(d / "out")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(d)))
    outs = {}
    try:
        for name, (_, p) in runs.items():
            outs[name] = p.communicate(timeout=300)[0]
    finally:
        for _, p in runs.values():
            if p.poll() is None:
                p.kill()
    for name, (_, p) in runs.items():
        assert p.returncode == 0, outs[name][-4000:]
    one, mesh = tmp_path / "one", tmp_path / "mesh"
    logs = {n: "".join(p.read_text() for p in sorted(
        (d / f"logs{SUFFIX}").glob("main-*.log"))) for n, d in
        (("one", one), ("mesh", mesh))}
    assert f"mesh {shape}" in logs["mesh"]
    if "--pipeline-infer" in flags:
        assert "--pipeline-infer discards --model-shard" in logs["mesh"]
    r0 = [ln for ln in logs["mesh"].splitlines() if "[rank 0]" in ln]
    assert _metric_lines("\n".join(r0)) == _metric_lines(logs["one"])
    assert _metric_lines(logs["one"])
    assert _files(mesh / f"w{SUFFIX}") == _files(one / f"w{SUFFIX}")
    pngs = _files(one / "out")
    assert len(pngs) == 8 and _files(mesh / "out") == pngs
    for f in pngs:
        assert (mesh / "out" / f).read_bytes() == (
            one / "out" / f).read_bytes(), f


# the CLI's launch of several ranks from one process (``--devices N`` on
# the card) with two CPU ranks in place of two cards
SPAWN_TWO_CPU_RANKS = (
    "import sys, torch\n"
    "from shadow_removal_istd_tpu_torch.cli import main as m\n"
    "m.select_devices = lambda *a: [torch.device('cpu')] * 2\n"
    "m.main(m.build_parser().parse_args(sys.argv[1:]))\n")


def _rank_logs(d: Path) -> list[str]:
    return [(p.read_text() if p.exists() else "")
            for p in (next(iter(sorted(d.glob(f"main-*-p{r}.log"))), d / "-")
                      for r in (0, 1))]


def test_sigterm_to_launcher_reaches_every_rank(tmp_path):
    """A SIGTERM to the process that spawned the ranks goes on to both;
    each stops at the same epoch boundary, rank 0 writes the preemption
    checkpoint, rank 1 writes nothing and says so, and the launch exits
    0."""
    root = str(tmp_path / "istd")
    write_istd_layout(root, n_train=48, n_test=4, h=64, w=64)
    argv = [sys.executable, "-c", SPAWN_TWO_CPU_RANKS,
            "--tasks", "train", "--data-dir", root,
            "--ngf", "4", "--ndf", "4", "--image-size", "32",
            "--batch-size", "4", "--epochs", "50", "--save-every", "1000",
            "--allow-missing-vgg", "--weights", str(tmp_path / "w"),
            "--logs", str(tmp_path / "logs"),
            "--infered", str(tmp_path / "out")]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    # a session of its own: the ranks go with the launcher whatever fails
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=str(tmp_path), start_new_session=True)
    logs = tmp_path / f"logs{SUFFIX}"
    try:
        deadline = time.monotonic() + 120
        while not all("start training" in t for t in _rank_logs(logs)):
            assert proc.poll() is None, proc.communicate()[0][-4000:]
            assert time.monotonic() < deadline, "the ranks did not start"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=60)[0]
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
    assert proc.returncode == 0, out[-4000:]
    log0, log1 = _rank_logs(logs)
    for text in (log0, log1):
        assert "received signal SIGTERM" in text, text[-2000:]
    done = re.search(r"preemption checkpoint written after epoch (\d+)",
                     log0)
    assert done, log0[-2000:]
    assert f"preempted: stopping after epoch {done.group(1)}; rank 0 " \
           "writes the checkpoint" in log1, log1[-2000:]
    assert "checkpoint written" not in log1
    ckpt = from_bytes((tmp_path / f"w{SUFFIX}" / "checkpoint.msgpack")
                      .read_bytes())
    assert int(ckpt["epoch"]) == int(done.group(1)) + 1
