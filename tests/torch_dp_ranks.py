"""One rank of the port's data-parallel CPU tests (tests/test_torch_parallel.py).

    python tests/torch_dp_ranks.py CASE RANK WORLD DIR

joins a gloo group of WORLD CPU ranks at ``file://DIR/rendezvous``, runs
CASE on the inputs the test wrote into DIR (``inputs.npz``,
``config.json``) and saves what the test compares as
``DIR/out<RANK>.npz``. It imports torch and the port only: the test
module, which imports JAX, stays out of the ranks.
"""

from __future__ import annotations

import datetime
import json
import sys
from pathlib import Path

import numpy as np
import torch

from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer
from shadow_removal_istd_tpu_torch.engine.state import (
    TrainState,
    build_models,
    make_optimizers,
)
from shadow_removal_istd_tpu_torch.engine.steps import train_step
from shadow_removal_istd_tpu_torch.losses import make_adversarial_loss
from shadow_removal_istd_tpu_torch.models.layers import BatchNorm
from shadow_removal_istd_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    barrier,
    data_parallel,
    distributed_init,
    make_mesh,
    shard_batch,
)
from shadow_removal_istd_tpu_torch.tools.convert import (
    flatten_tree,
    flax_tree_to_torch,
    train_state_to_flax,
    unflatten_tree,
)

NETS = ("g1", "g2", "d1", "d2")


def flat(tree) -> dict[str, np.ndarray]:
    """A nested tree as ``{"a/b/c": array}`` (None leaves dropped)."""
    return {"/".join(k): np.asarray(v) for k, v in flatten_tree(tree).items()
            if v is not None}


def nested(arrays, prefix: str) -> dict:
    """The tree under ``prefix/`` of an npz written by :func:`flat`."""
    n = len(prefix) + 1
    return unflatten_tree({tuple(k[n:].split("/")): arrays[k]
                           for k in arrays
                           if k.startswith(prefix + "/")})


def new_state(cfg: TrainConfig, variables: dict, mesh) -> TrainState:
    """The port's train state from the JAX variables of the four nets."""
    models = build_models(cfg)
    for k in NETS:
        flax_tree_to_torch(variables[k], getattr(models, k))
    opt_g, opt_d = make_optimizers(cfg, models)
    return TrainState(cfg=cfg, models=models, opt_g=opt_g, opt_d=opt_d,
                      adv=make_adversarial_loss(cfg.d_loss_fn, cfg.d_type,
                                                cfg.loss_mode),
                      mesh=mesh if mesh.world > 1 else None)


def case_bn(mesh, inputs, config) -> dict:
    """A train-mode BatchNorm forward and backward on this rank's rows
    of ``x`` against ``sum(y * g)``."""
    bn = BatchNorm(inputs["x"].shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs["weight"]))
        bn.bias.copy_(torch.from_numpy(inputs["bias"]))
    x, g = (torch.from_numpy(a) for a in shard_batch(
        mesh, (inputs["x"], inputs["g"])))
    x.requires_grad_(True)
    with data_parallel(mesh):
        y = bn(x)
        (y * g).sum().backward()
    all_reduce_grads(list(bn.parameters()), mesh)
    return {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
            "weight_grad": bn.weight.grad.numpy(),
            "bias_grad": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


def case_steps(mesh, inputs, config) -> dict:
    """``config["steps"]`` train steps of every configuration in
    ``config["cfgs"]``, each rank on its rows of the global batches;
    the metrics of each step and the final state as a flax tree."""
    out = {}
    batches = [tuple(inputs[f"batch{s}_{i}"] for i in range(3))
               for s in range(config["steps"])]
    for name, kw in config["cfgs"].items():
        cfg = TrainConfig(**kw)
        state = new_state(cfg, nested(inputs, f"{name}.vars"), mesh)
        if cfg.began:       # from 0.5, so that k's updates show
            state.k1, state.k2 = torch.tensor(0.5), torch.tensor(0.5)
        for s, b in enumerate(batches):
            local = tuple(torch.from_numpy(a).permute(0, 3, 1, 2)
                          for a in shard_batch(mesh, b))
            for k, v in train_step(state, local).items():
                out[f"{name}.metrics{s}/{k}"] = v.numpy()
        out.update({f"{name}.state/{k}": v
                    for k, v in flat(train_state_to_flax(state)).items()})
    return out


def case_trainer(mesh, inputs, config) -> dict:
    """For each run of ``config["runs"]`` (its name and whether the epoch
    takes the device cache), epochs of a ``Trainer`` on injected streams
    into this rank's own directories; keyed ``<run>.<what>``."""
    out = {}
    for name, cache in config["runs"].items():
        run_out = _trainer_run(mesh, inputs, {**config, "name": name,
                                              "cache": cache})
        out.update({f"{name}.{k}": v for k, v in run_out.items()})
    return out


def _trainer_run(mesh, inputs, config) -> dict:
    """One run: the history, last validation and ``Eval/*``, the
    validation batches, whether ``infer`` raised, the final state."""
    d = Path(config["dir"]) / f"rank{mesh.rank}" / config["name"]
    streams = {s: {k: inputs[f"{s}/{k}"] for k in ("img", "matte",
                                                    "target")}
               for s in ("train", "valid")}
    run = RunConfig(seed=3, logs_dir=str(d / "logs"),
                    weights_dir=str(d / "weights"),
                    infered_dir=str(d / "infered"),
                    checkpoint_path=str(d / "weights" / "checkpoint.msgpack"),
                    log_every=1, valid_every=1, vis_every=1, save_every=1,
                    allow_missing_vgg=True, device_cache=config["cache"],
                    eval_metrics=True)
    trainer = Trainer(TrainConfig(**config["cfg"]), run,
                      train_streams=streams["train"],
                      valid_streams=streams["valid"], device="cpu",
                      mesh=mesh)
    trainer.train(config["epochs"])
    trainer.close()
    out = {f"history{e}/{k}": np.float64(v)
           for e, h in enumerate(trainer.history) for k, v in h.items()}
    out.update({f"valid/{k}": np.float64(v)
                for k, v in trainer.last_valid.items()})
    out.update({f"eval/{k}": np.float64(v)
                for k, v in trainer.last_eval.items()})
    out["valid_batches"] = np.int64(len(trainer.valid_pipe))
    try:
        trainer.infer()
        out["infer_raised"] = np.str_("")
    except NotImplementedError as exc:
        out["infer_raised"] = np.str_(str(exc))
    out.update({f"state/{k}": v
                for k, v in flat(train_state_to_flax(trainer.state)).items()})
    return out


CASES = {"bn": case_bn, "steps": case_steps, "trainer": case_trainer}


def main() -> None:
    case, rank, world, d = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                            Path(sys.argv[4]))
    torch.set_num_threads(1)
    distributed_init(f"file://{d}/rendezvous", world, rank,
                     timeout=datetime.timedelta(seconds=120))
    mesh = make_mesh("cpu", processes=world)
    config = json.loads((d / "config.json").read_text())
    with np.load(d / "inputs.npz") as inputs:
        out = CASES[case](mesh, inputs, config)
    np.savez(d / f"out{rank}.npz", **out)
    barrier(mesh)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
