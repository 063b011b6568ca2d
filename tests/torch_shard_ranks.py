"""One rank of the port's spatial and tensor-parallel CPU tests
(tests/test_torch_spatial.py, tests/test_torch_tensor_parallel.py).

    python tests/torch_shard_ranks.py RANK WORLD DIR

joins a gloo group of WORLD CPU ranks at ``file://DIR/rendezvous``,
builds the mesh of ``config.json``'s ``shape`` (data, spatial, model),
runs each case of ``config["cases"]`` on the inputs the test wrote into
DIR (``inputs.npz``) and saves what the test compares as
``DIR/out<RANK>.npz`` (keys ``<case>/...``). It imports torch and the
port only: the test modules import JAX. Run in the test process with
:func:`run_cases` and a one-rank mesh, the cases give the one-device
results.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer
from shadow_removal_istd_tpu_torch.engine.steps import (
    eval_step,
    infer_step,
    train_step,
)
from shadow_removal_istd_tpu_torch.models import get_generator
from shadow_removal_istd_tpu_torch.models.vgg import VGG19Features
from shadow_removal_istd_tpu_torch.parallel import mesh as pmesh
from shadow_removal_istd_tpu_torch.parallel import spatial, tensor
from shadow_removal_istd_tpu_torch.parallel.mesh import (
    barrier,
    distributed_init,
    make_mesh,
    shard_batch,
    shard_images,
    shard_state,
    unshard_state,
)
from shadow_removal_istd_tpu_torch.tools.convert import (
    flax_tree_to_torch,
    train_state_to_flax,
)

from torch_dp_ranks import flat, nested, new_state


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _state(mesh, inputs, name: str, kw: dict, split_skip: bool = False):
    """The port's train state of ``kw`` from the JAX variables under
    ``<name>.vars`` (split-skip MNet generators with ``split_skip``),
    placed on ``mesh`` (``shard_state``)."""
    cfg = TrainConfig(**kw)
    variables = nested(inputs, f"{name}.vars")
    state = new_state(cfg, variables, mesh)
    if any(k.startswith(f"{name}.vgg/") for k in inputs):
        state.vgg = flax_tree_to_torch(nested(inputs, f"{name}.vgg"),
                                       VGG19Features())
    if split_skip:
        g = dict(ngf=cfg.ngf, drop_rate=0.0, no_conv_t=cfg.nn_upconv,
                 split_skip=True)
        state.models.g1 = get_generator("mnet", in_channels=3,
                                        out_channels=1, **g)
        state.models.g2 = get_generator("mnet", in_channels=4,
                                        out_channels=3, **g)
        flax_tree_to_torch(variables["g1"], state.models.g1)
        flax_tree_to_torch(variables["g2"], state.models.g2)
    shard_state(mesh, state)
    return cfg, state


def case_infer(mesh, inputs, spec) -> dict:
    """``infer_step`` on this rank's block of ``x`` (``shard_images``),
    split-skip MNets when ``spec["split_skip"]``; the rank's output
    blocks and the row gathers it made."""
    _, state = _state(mesh, inputs, spec["vars"], spec["cfg"],
                      spec.get("split_skip", False))
    g1, g2 = state.models.g1, state.models.g2
    g1.eval()
    g2.eval()
    x = shard_images(mesh, _nchw(inputs[spec["x"]]))
    before = spatial.gather_rows.count
    with torch.no_grad():
        m, y = infer_step(g1, g2, x, mesh)
    return {"m": m.numpy(), "y": y.numpy(),
            "gathers": np.int64(spatial.gather_rows.count - before)}


def case_eval(mesh, inputs, spec) -> dict:
    """``eval_step`` metrics on this rank's block of the batch."""
    _, state = _state(mesh, inputs, spec["vars"], spec["cfg"])
    batch = shard_images(mesh, tuple(_nchw(inputs[f"{spec['batch']}_{i}"])
                                     for i in range(3)))
    metrics, (m, y) = eval_step(state, batch, return_preds=True,
                                mesh=mesh if mesh.world > 1 else None)
    return {**{f"metrics/{k}": v.numpy() for k, v in metrics.items()},
            "m": m.numpy(), "y": y.numpy()}


@contextlib.contextmanager
def _planted(fault: str | None):
    """A backward fault of the column-parallel pair: ``no_reduce``, the
    identity before a split conv passes its partial input gradient on
    unsummed; ``gather_sums``, the channel gather's backward sums the
    gradient over the model ranks before keeping its slice."""
    if fault is None:
        yield
        return
    import torch.distributed as dist

    cls = (tensor._CopyToModel if fault == "no_reduce"
           else tensor._GatherChannels)
    old = cls.backward

    def no_reduce(ctx, grad):
        return grad, None

    def gather_sums(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=tensor._active.groups["model"])
        return old(ctx, grad)

    cls.backward = staticmethod(no_reduce if fault == "no_reduce"
                                else gather_sums)
    try:
        yield
    finally:
        cls.backward = staticmethod(old)


def case_train(mesh, inputs, spec) -> dict:
    """``spec["steps"]`` train steps on this rank's data rows of each
    batch (under a planted fault when ``spec["fault"]``); the metrics,
    the state as a flax tree (gathered to full), and this rank's bytes
    of parameters, BatchNorm statistics and Adam moments."""
    out = {}
    _, state = _state(mesh, inputs, spec["vars"], spec["cfg"])
    with _planted(spec.get("fault")):
        for s in range(spec["steps"]):
            b = tuple(inputs[f"{spec['batch']}{s}_{i}"] for i in range(3))
            local = tuple(_nchw(a) for a in shard_batch(
                mesh if mesh.world > 1 else None, b))
            for k, v in train_step(state, local).items():
                out[f"metrics{s}/{k}"] = v.numpy()
    out["bytes"] = np.int64(_state_bytes(state))
    unshard_state(mesh, state)
    out.update({f"state/{k}": v
                for k, v in flat(train_state_to_flax(state)).items()})
    return out


def _state_bytes(state) -> int:
    """This rank's bytes of the networks' tensors and Adam's moments."""
    total = 0
    for net in state.models.all():
        for t in (*net.parameters(), *net.buffers()):
            total += t.numel() * t.element_size()
    for opt in (state.opt_g, state.opt_d):
        for st in opt.state.values():
            total += sum(v.numel() * v.element_size() for k, v in st.items()
                         if k != "step")
    return total


def case_trainer(mesh, inputs, spec) -> dict:
    """A ``Trainer`` on injected streams: ``spec["epochs"]`` epochs (none:
    one validation epoch), in this rank's directory; the history, the
    validation metrics and the weight files' directory."""
    d = Path(spec["dir"]) / f"rank{mesh.rank}"
    streams = {s: {k: inputs[f"{s}/{k}"] for k in ("img", "matte",
                                                    "target")}
               for s in ("train", "valid")}
    run = RunConfig(seed=3, logs_dir=str(d / "logs"),
                    weights_dir=str(d / "weights"),
                    infered_dir=str(d / "infered"),
                    checkpoint_path=str(d / "weights" / "checkpoint.msgpack"),
                    log_every=1, valid_every=1, vis_every=100,
                    save_every=1, allow_missing_vgg=True,
                    preempt_save=False, device_cache=True)
    trainer = Trainer(TrainConfig(**spec["cfg"]), run,
                      train_streams=streams["train"],
                      valid_streams=streams["valid"], device="cpu",
                      mesh=mesh if mesh.world > 1 else None)
    out = {}
    if spec.get("epochs"):
        trainer.train(spec["epochs"])
        trainer.close()
        out.update({f"history{e}/{k}": np.float64(v)
                    for e, h in enumerate(trainer.history)
                    for k, v in h.items()})
        out["weights"] = np.str_(str(d / "weights"))
    out["valid_total"] = np.float64(trainer.run_valid_epoch(0))
    out.update({f"valid/{k}": np.float64(v)
                for k, v in trainer.last_valid.items()})
    return out


def case_halo(mesh, inputs, spec) -> dict:
    """``exchange_halo``/``gather_rows`` on this rank's slab of ``x``;
    and whether a slab that requires grad is refused."""
    with spatial.spatial_parallel(mesh):
        x = shard_images(mesh, torch.from_numpy(inputs["halo_x"]))
        halo, above, below = spatial.exchange_halo(x, 2, 1)
        whole = spatial.gather_rows(x)
        try:
            spatial.exchange_halo(x.clone().requires_grad_(True), 1, 1)
            refused = False
        except RuntimeError:
            refused = True
    return {"halo": halo.numpy(), "above": np.int64(above),
            "below": np.int64(below), "whole": whole.numpy(),
            "refused": np.bool_(refused)}


CASES = {"infer": case_infer, "eval": case_eval, "train": case_train,
         "trainer": case_trainer, "halo": case_halo}


def run_cases(mesh, inputs, config) -> dict:
    """Every case of ``config["cases"]`` (name -> spec with its kind
    under ``"case"``, and optionally the gathers' collective form under
    ``"form"``: ``"native"``, or ``"reduce"``, the zero-filled
    ``all_reduce`` that gloo runs for CUDA tensors), keyed
    ``<name>/...``."""
    out = {}
    for name, spec in config["cases"].items():
        pmesh.GATHER_FORM = spec.get("form")
        try:
            res = CASES[spec["case"]](mesh, inputs, spec)
        finally:
            pmesh.GATHER_FORM = None
        out.update({f"{name}/{k}": v for k, v in res.items()})
    return out


REPO = Path(__file__).resolve().parent.parent


def spawn(d: Path, shape, inputs: dict, cases: dict) -> list[dict]:
    """Run ``cases`` on a mesh of ``shape`` (data, spatial, model), one
    gloo CPU rank per process (one torch thread each), in ``d``; each
    rank's outputs, in rank order."""
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / "inputs.npz", **inputs)
    (d / "config.json").write_text(json.dumps({"shape": list(shape),
                                               "cases": cases}))
    world = int(np.prod(shape))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(r), str(world),
         str(d)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(d / f"out{r}.npz")) for r in range(world)]


def assemble(outs: list[dict], key: str) -> np.ndarray:
    """The global NCHW array of the ranks' blocks of ``key``: batch rows
    by data coordinate, image rows by spatial coordinate (the model
    ranks of one block hold the same values; the first is taken)."""
    blocks = {}
    for o in outs:
        blocks.setdefault((int(o["coord/data"]), int(o["coord/spatial"])),
                          o[key])
    nd = 1 + max(d for d, _ in blocks)
    ns = 1 + max(s for _, s in blocks)
    return np.concatenate([np.concatenate([blocks[(i, j)]
                                           for j in range(ns)], axis=2)
                           for i in range(nd)], axis=0)


def main() -> None:
    rank, world, d = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
    torch.set_num_threads(1)
    logging.basicConfig(level=logging.WARNING)
    config = json.loads((d / "config.json").read_text())
    distributed_init(f"file://{d}/rendezvous", world, rank,
                     timeout=datetime.timedelta(seconds=180))
    mesh = make_mesh("cpu", processes=world, shape=tuple(config["shape"]))
    with np.load(d / "inputs.npz") as z:
        inputs = {k: z[k] for k in z.files}
    out = run_cases(mesh, inputs, config)
    out.update({"coord/data": np.int64(mesh.coord("data")),
                "coord/spatial": np.int64(mesh.coord("spatial")),
                "coord/model": np.int64(mesh.coord("model"))})
    np.savez(d / f"out{rank}.npz", **out)
    barrier(mesh)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
