"""Training: the program's fused epoch over a dataset on the card.

The system under test: ``engine/epoch.py::make_epoch``'s ``epoch_fn``
(gather on the card, the ``hshear`` augmentation, ``train_step``) over
the (shadow, matte, shadow-free) uint8 streams held on the card, as the
CLI's device cache holds them, with the train state that
``engine/state.py`` builds (the configuration's networks, both Adam
chains, the frozen VGG).

Set-up makes the weights and the ``n_train`` triplets on the card from
the seed and drives the state through its first ``check_steps`` steps,
each one call of ``epoch_fn`` over one row of a shuffled order (rows
that all differ): those are the steps the reference follows, and they
warm every shape. The window then calls ``epoch_fn`` on
``chunk_steps`` rows of the order at a time (a new order once an epoch's
rows are spent), synchronises after each call, and counts the images
of every step completed until ``--seconds`` have passed; the rate is
over all the time taken.
"""

from __future__ import annotations

import sys
import time

from portbench.lib import costs
from portbench.lib import trace as tracing
from portbench.lib import weights
from portbench.reference import augment as ref_augment
from portbench.reference import nets
from portbench.reference.train import METRICS, Trainer

KERNELS = ("hshear",)


def leaves(cfg):
    m, t = cfg["model"], cfg["train"]
    if m["net_g"] == "mnet":
        g1 = nets.mnet_leaves(3, 1, m["ngf"], nearest=t["nn_upconv"])
        g2 = nets.mnet_leaves(4, 3, m["ngf"], nearest=t["nn_upconv"])
    else:
        g1, g2 = nets.pix2pix_leaves(3, 1, m["ngf"]), nets.pix2pix_leaves(4, 3, m["ngf"])
    if m["net_d"] == "patchgan":
        d1, d2 = nets.patchgan_leaves(4, m["ndf"]), nets.patchgan_leaves(7, m["ndf"])
    else:
        d1, d2 = nets.nlayer_leaves(4, m["ndf"]), nets.nlayer_leaves(7, m["ndf"])
    out = {"g1": g1, "g2": g2, "d1": d1, "d2": d2}
    if t["visual"]:
        out["vgg"] = nets.vgg_leaves()
    return out


def train_config(cfg):
    """The program's TrainConfig for the configuration."""
    from shadow_removal_istd_tpu_torch.engine.config import TrainConfig

    m, t = cfg["model"], cfg["train"]
    keys = ("droprate", "nn_upconv", "activation", "lr_g", "lr_d", "decay",
            "beta1", "beta2", "adam_eps", "lambda1", "lambda2", "lambda3",
            "lambda4", "lambda5", "d_loss_fn", "d_type", "loss_mode",
            "image_size", "batch_size", "aug_scale", "aug_angle", "aug_method",
            "compute_dtype")
    return TrainConfig(net_g=m["net_g"], net_d=m["net_d"], ngf=m["ngf"], ndf=m["ndf"],
                       use_visual_loss=t["visual"],
                       steps_per_epoch=t["n_train"] // t["batch_size"],
                       **{k: t[k] for k in keys})


def build_state(ctx, w):
    """The train state of the configuration, holding the benchmark's
    weights ``w`` (name -> leaf map per network)."""
    from shadow_removal_istd_tpu_torch.engine.state import (
        TrainState, build_models, make_optimizers)
    from shadow_removal_istd_tpu_torch.losses.adversarial import make_adversarial_loss
    from shadow_removal_istd_tpu_torch.models.vgg import VGG19Features

    cfg = train_config(ctx.config)
    models = build_models(cfg)
    for name, net in zip(("g1", "g2", "d1", "d2"), models.all()):
        net.to(ctx.device)
        weights.load_into(net, w[name])
    ctx.phase("networks")
    vgg = None
    if "vgg" in w:
        vgg = VGG19Features().to(ctx.device)
        weights.load_into(vgg, w["vgg"])
        ctx.phase("vgg")
    opt_g, opt_d = make_optimizers(cfg, models)
    ctx.phase("optimizers")
    return TrainState(cfg=cfg, models=models, opt_g=opt_g, opt_d=opt_d,
                      adv=make_adversarial_loss(cfg.d_loss_fn, cfg.d_type, cfg.loss_mode),
                      vgg=vgg)


def dataset(ctx):
    """(img, matte, target) uint8 streams on the card, in the program's
    sorted stream order."""
    torch, t = ctx.torch, ctx.config["train"]
    gen = ctx.generator("data")
    n, (h, w) = t["n_train"], t["data_hw"]
    return tuple(torch.randint(0, 256, (n, h, w, c), generator=gen, device=ctx.device,
                               dtype=torch.uint8) for c in (3, 1, 3))


class Order:
    """Rows of shuffled epochs, ``batch`` at a time, the ragged end of
    each epoch dropped, as the program's device cache orders them."""

    def __init__(self, ctx, n, batch):
        self.torch, self.gen, self.dev = ctx.torch, ctx.generator("order"), ctx.device
        self.n, self.batch, self.rows = n, batch, []

    def take(self, steps):
        while len(self.rows) < steps:
            perm = self.torch.randperm(self.n, generator=self.gen, device=self.dev)
            k = self.n // self.batch
            self.rows += list(perm[:k * self.batch].view(k, self.batch))
        out, self.rows = self.rows[:steps], self.rows[steps:]
        return self.torch.stack(out)


def prepare(ctx):
    """Set-up: the state, the data on the card, the order and the epoch
    function; then the checked steps. Returns a dict of them, with what
    the checked steps produced under ``got`` and their raw rows under
    ``raw``."""
    torch = ctx.torch
    from shadow_removal_istd_tpu_torch.engine import epoch as epoch_mod
    from shadow_removal_istd_tpu_torch.ops.augment import AugmentConfig

    if ctx.device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    ctx.phase("start")
    ctx.build(KERNELS)
    ctx.phase("build")
    t, tr = ctx.config["train"], ctx.traffic
    batch = t["batch_size"]
    w = weights.make(leaves(ctx.config), ctx.generator("weights"), ctx.device)
    ctx.phase("weights")
    state = build_state(ctx, w)
    arrays = dataset(ctx)
    ctx.phase("data")
    order = Order(ctx, t["n_train"], batch)
    epoch_fn = epoch_mod.make_epoch(AugmentConfig(
        scale=t["aug_scale"], angle=t["aug_angle"], flip_prob=0.5,
        crop_size=t["image_size"], method=t["aug_method"]))
    seed = ctx.seed % 2 ** 63

    def streams(epoch):
        return epoch_mod.RngStreams(seed, epoch, ctx.device)

    # the steps the reference follows, through the window's own call
    rows = order.take(tr["check_steps"])
    raw = tuple(a.index_select(0, rows.flatten()) for a in arrays)
    seen = []
    plain_augment = epoch_mod.augment_batch
    epoch_mod.augment_batch = lambda *a, **k: seen.append(plain_augment(*a, **k)) or seen[-1]
    got = {"metrics": [], "augmented": seen}
    try:
        for k in range(tr["check_steps"]):
            _, sums = epoch_fn(state, arrays, rows[k:k + 1], streams(k))
            got["metrics"].append({m: float(sums[m]) for m in METRICS})
            if k == 0:
                got["grad"] = _first_grads(state)
    finally:
        epoch_mod.augment_batch = plain_augment
    got["change"] = _changes(state, w)
    ctx.phase("checked steps")
    return {"state": state, "arrays": arrays, "order": order, "epoch_fn": epoch_fn,
            "streams": streams, "epoch_mod": epoch_mod, "seed": seed, "got": got,
            "raw": raw}


def run(ctx):
    torch = ctx.torch
    p = prepare(ctx)
    tracer = _Tracer(ctx, p["epoch_mod"]) if ctx.trace else None
    ctx.mark_setup()
    tr, batch = ctx.traffic, ctx.config["train"]["batch_size"]
    state, arrays, order, epoch_fn = p["state"], p["arrays"], p["order"], p["epoch_fn"]
    steps, epoch, traced = 0, tr["check_steps"], None
    w0 = time.perf_counter()
    while True:
        if tracer is not None and tracer.due(w0):
            tracer.begin()
        idx = order.take(tr["chunk_steps"])
        epoch_fn(state, arrays, idx, p["streams"](epoch))
        if tracer is not None and tracer.on:
            tracer.steps += [(epoch, s) for s in range(idx.shape[0])]
        epoch += 1
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        steps += idx.shape[0]
        now = time.perf_counter()
        if tracer is not None and tracer.on and tracer.long_enough():
            traced = tracer.end()
        if now - w0 >= ctx.seconds:
            break
    elapsed = now - w0
    if tracer is not None and tracer.on:
        traced = tracer.end()
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    got, raw, seed = p["got"], p["raw"], p["seed"]
    del p, state, arrays, epoch_fn, tracer
    ctx.free()
    return {"e2e": {"train_img_per_s": steps * batch / elapsed},
            "attempted": steps, "failed": 0, "memory_peak_bytes": peak,
            "obs": _obs(ctx, traced, seed) if traced else {},
            "extra": {"window_s": elapsed},
            "checks": check(ctx, got, raw, seed)}


def _named(state):
    nets_ = dict(zip(("g1", "g2", "d1", "d2"), state.models.all()))
    return {f"{n}.{k}": p for n, net in nets_.items() for k, p in net.named_parameters()}


def _first_grads(state):
    """Each leaf's first gradient as its Adam got it: the first moment
    after one step over (1 - beta1)."""
    b1 = state.cfg.beta1
    out = {}
    for name, p in _named(state).items():
        opt = state.opt_g if name.startswith("g") else state.opt_d
        out[name] = float(opt.state[p]["exp_avg"].norm()) / (1.0 - b1)
    return out


def _changes(state, w):
    out = {}
    for name, p in _named(state).items():
        net, leaf = name.split(".", 1)
        out[name] = float((p.detach() - w[net][leaf]).norm())
    return out


class _Tracer:
    """A traced stretch of whole ``epoch_fn`` calls, with each step's
    phases marked by CUDA events through ``train_step``'s ``mark`` hook."""

    def __init__(self, ctx, epoch_mod):
        self.ctx, self.epoch_mod = ctx, epoch_mod
        self.on, self.started, self.steps = False, False, []
        self.marks = []

    def due(self, w0):
        tr = self.ctx.traffic
        return not self.started and time.perf_counter() - w0 >= min(tr["trace_lead_s"],
                                                                  self.ctx.seconds / 4)

    def begin(self):
        torch = self.ctx.torch
        cuda = self.ctx.device.type == "cuda"
        self.plain_step = self.epoch_mod.train_step
        marks = self.marks

        def mark(name):
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((name, ev))

        def marked(state, batch, gens=(None, None)):
            return self.plain_step(state, batch, gens, mark=mark)

        self.prof = tracing.start(self.ctx.device.type)
        self.t0 = time.time_ns()
        self.tp = time.perf_counter()
        mark("start")
        self.epoch_mod.train_step = marked
        self.on = self.started = True

    def long_enough(self):
        tr = self.ctx.traffic
        return time.perf_counter() - self.tp >= min(tr["trace_s"], self.ctx.seconds / 2)

    def end(self):
        self.epoch_mod.train_step = self.plain_step
        self.on = False
        win = tracing.stop(self.prof, self.t0, time.time_ns())
        vis = step = 0.0
        last = None
        for i, (name, ev) in enumerate(self.marks):
            if name == "g_visual":
                vis += self.marks[i - 1][1].elapsed_time(ev)
            if name in ("start", "adam_g"):
                if last is not None:
                    step += last.elapsed_time(ev)
                last = ev
        return {"window": win, "steps": self.steps, "vis_ms": vis, "step_ms": step}


def _obs(ctx, traced, seed):
    m, t = ctx.config["model"], ctx.config["train"]
    crop, batch = t["image_size"], t["batch_size"]
    h, w = t["data_hw"]
    nbytes = 0.0
    for epoch, step in traced["steps"]:
        gen = ref_augment.generator(seed, epoch, step, "augment", ctx.device)
        p = ref_augment.draw_params(gen, batch, h, w, t["aug_scale"], t["aug_angle"],
                                    crop, ctx.device)
        for shifts, out_w, pad, src_w in ref_augment.shear_shifts(p, h, w, crop, t["aug_angle"]):
            nbytes += costs.hshear_bytes(shifts, 7, src_w, out_w, pad)
    return {"window": traced["window"], "images": len(traced["steps"]) * batch,
            "flops_per_image": costs.train_step_flops_per_image(
                m["net_g"], m["net_d"], crop, crop, m["ngf"], m["ndf"], t["visual"]),
            "peak_flops": costs.PEAK_F32, "hshear_bytes": nbytes,
            "vis_ms": traced["vis_ms"], "step_ms": traced["step_ms"]}


def _gap(a, b, floor):
    return abs(a - b) / max(abs(b), floor)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else 0.0


def check(ctx, got, raw, seed):
    """The readings of :func:`readings` that the configuration holds to
    a limit, each with its limit."""
    return limited(readings(ctx, got, raw, seed), ctx.config["limits"]["train"])


def readings(ctx, got, raw, seed):
    """The steps set-up ran, followed by the reference from the same
    weights and rows, after the program's state is freed."""
    torch, t, tr = ctx.torch, ctx.config["train"], ctx.traffic
    batch, crop = t["batch_size"], t["image_size"]
    h, w = t["data_hw"]
    wts = weights.make(leaves(ctx.config), ctx.generator("weights"), ctx.device)
    ref = Trainer({**ctx.config["model"], **t,
                   "steps_per_epoch": t["n_train"] // batch},
                  {k: wts[k] for k in ("g1", "g2", "d1", "d2")}, wts.get("vgg"))
    start = {k: v.clone() for k, v in ref.params().items()}
    aug_gap, loss_gaps, grads = 0.0, [], None
    for k in range(tr["check_steps"]):
        part = tuple(a[k * batch:(k + 1) * batch] for a in raw)
        gen = ref_augment.generator(seed, k, 0, "augment", ctx.device)
        p = ref_augment.draw_params(gen, batch, h, w, t["aug_scale"], t["aug_angle"],
                                    crop, ctx.device)
        b = ref_augment.augment(part, p, crop, t["aug_angle"])
        aug_gap = max(aug_gap, max(float((x - y).abs().max())
                                   for x, y in zip(got["augmented"][k], b)))
        gens = tuple(ref_augment.generator(seed, k, 0, s, ctx.device)
                     for s in ("dropout_g1", "dropout_g2"))
        metrics, g = ref.step(b, gens)
        if k == 0:
            grads = {n: float(v.norm()) for n, v in g.items()}
        floor = _median([abs(v) for v in metrics.values()])
        loss_gaps.append(max(_gap(got["metrics"][k][m], metrics[m], floor) for m in METRICS))
    change = {n: float((v - start[n]).norm()) for n, v in ref.params().items()}
    g_floor = _median(grads.values())
    moved = [n for n in change if grads[n] >= 1e-3 * g_floor]
    c_floor = _median([change[n] for n in moved])
    return {
        "aug_max_abs": aug_gap, "loss1_gap": loss_gaps[0], "loss23_gap": max(loss_gaps[1:]),
        "grad1_gap": max(_gap(got["grad"][n], grads[n], g_floor) for n in grads),
        "change3_gap": max(_gap(got["change"][n], change[n], c_floor) for n in moved)}


def limited(readings, limits):
    """(name, reading, limit, "max") of each reading the configuration
    holds to a limit; one whose limit is null is read but not compared
    (it has no upper reading, PERF.md), and goes to standard error."""
    for name, value in readings.items():
        if limits.get(name) is None:
            print(f"reading {name}: {value!r} (not compared)", file=sys.stderr)
    return [(n, v, limits[n], "max") for n, v in readings.items()
            if limits.get(n) is not None]
