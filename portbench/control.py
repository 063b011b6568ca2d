"""Readings that set a cell's limits: the program's, the control's and
planted faults', over several seeds in one process.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 --what program,control[,half_batch,unchanged] [--seconds 3]

For each seed and each kind it prints one JSON line of the numbers that
decide ``correct`` (no limit applied):

- ``program``: the cell as the benchmark runs it (serving: a window of
  ``--seconds`` at the cell's load; training: the checked steps, which
  need no window);
- ``control``: the nearest precision below the configuration's, put in
  the program's place: for bf16 serving the program's own int8 path
  (``InferenceEngine(dtype="int8")``, calibrated on 8 of the requests'
  images); for f32 training the reference itself with TF32 on;
- ``half_batch`` (training): the program's step given half of each
  batch, so its loss is the mean over the rest;
- ``unchanged`` (training): the program's step with every parameter set
  back after it, so the state does not move.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _serve(ctx, what):
    from portbench.drivers import serve

    res = serve.run(ctx, dtype="int8" if what == "control" else None)
    return {name: value for name, value, _, _ in res["checks"]}


def _train_planted(what, epoch_mod):
    plain = epoch_mod.train_step

    def half(state, batch, gens=(None, None), **kw):
        return plain(state, tuple(t[:t.shape[0] // 2] for t in batch), gens, **kw)

    def unchanged(state, batch, gens=(None, None), **kw):
        before = [p.detach().clone() for net in state.models.all() for p in net.parameters()]
        out = plain(state, batch, gens, **kw)
        for p, b in zip((p for net in state.models.all() for p in net.parameters()), before):
            p.data.copy_(b)
        return out

    return {"half_batch": half, "unchanged": unchanged}[what], plain


def _reference_got(ctx, raw, seed):
    """What the checked steps give with the reference in the program's
    place, under TF32."""
    from portbench.drivers import train
    from portbench.lib import weights
    from portbench.reference import augment as ref_augment
    from portbench.reference.train import Trainer

    torch, t, tr = ctx.torch, ctx.config["train"], ctx.traffic
    batch, crop = t["batch_size"], t["image_size"]
    h, w = t["data_hw"]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        wts = weights.make(train.leaves(ctx.config), ctx.generator("weights"), ctx.device)
        ref = Trainer({**ctx.config["model"], **t, "steps_per_epoch": t["n_train"] // batch},
                      {k: wts[k] for k in ("g1", "g2", "d1", "d2")}, wts.get("vgg"))
        start = {k: v.clone() for k, v in ref.params().items()}
        got = {"metrics": [], "augmented": []}
        for k in range(tr["check_steps"]):
            part = tuple(a[k * batch:(k + 1) * batch] for a in raw)
            gen = ref_augment.generator(seed, k, 0, "augment", ctx.device)
            p = ref_augment.draw_params(gen, batch, h, w, t["aug_scale"], t["aug_angle"],
                                        crop, ctx.device)
            b = ref_augment.augment(part, p, crop, t["aug_angle"])
            got["augmented"].append(b)
            gens = tuple(ref_augment.generator(seed, k, 0, s, ctx.device)
                         for s in ("dropout_g1", "dropout_g2"))
            metrics, g = ref.step(b, gens)
            got["metrics"].append(metrics)
            if k == 0:
                got["grad"] = {n: float(v.norm()) for n, v in g.items()}
        got["change"] = {n: float((v - start[n]).norm()) for n, v in ref.params().items()}
        return got
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def _train(ctx, what):
    from portbench.drivers import train

    torch = ctx.torch
    if what == "control":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        rows = train.Order(ctx, ctx.config["train"]["n_train"],
                           ctx.config["train"]["batch_size"]).take(ctx.traffic["check_steps"])
        raw = tuple(a.index_select(0, rows.flatten()) for a in train.dataset(ctx))
        seed = ctx.seed % 2 ** 63
        got = _reference_got(ctx, raw, seed)
    else:
        from shadow_removal_istd_tpu_torch.engine import epoch as epoch_mod

        plain = None
        if what != "program":
            planted, plain = _train_planted(what, epoch_mod)
            epoch_mod.train_step = planted
        try:
            p = train.prepare(ctx)
        finally:
            if plain is not None:
                epoch_mod.train_step = plain
        got, raw, seed = p["got"], p["raw"], p["seed"]
        del p
    ctx.free()
    out = train.readings(ctx, got, raw, seed)
    del got, raw
    ctx.free()
    return out


def main(argv=None) -> int:
    from portbench.run import Ctx, cache_env

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program,control")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    root = Path.cwd()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cache_env(root)
    for what in args.what.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            ctx = Ctx(root, bench, cell, seed, args.seconds, False, args.device)
            kind = _train if ctx.traffic["driver"] == "train" else _serve
            row = {"workload": args.workload, "what": what, "seed": seed, **kind(ctx, what)}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
