"""Serving traffic through the program's micro-batcher.

The system under test: ``serving.engine.InferenceEngine`` (the stacked
G1 -> G2 pair, bucketed, uint8 in and out) behind
``serving.server.MicroBatcher`` (one thread owns the engine, requests
coalesce within the batch window up to the engine's batch).

Traffic parameters (``portbench/traffic/<mix>.json``):

- ``loop``: ``closed`` (``clients`` callers, each sending its next
  request when its answer arrives) or ``open`` (Poisson arrivals at
  ``rate_per_s``, each due at a time fixed before the window: the gaps
  are one draw from ``gap_seed`` scaled to the window, put in an order
  drawn from the run's seed, so every seed offers the same work);
- ``height``, ``width``: the request size; ``pool``: distinct images
  made on the card from the seed, requests cycling through them in an
  order drawn from the seed;
- ``keep_share``, ``keep_max``, ``sample``: the answers kept for the
  check (a share of requests marked before the window, at most
  ``keep_max``) and how many of those the check compares, drawn from the
  seed among those answered in the window.

Every request is timed from when it was due (open loop) or sent (closed
loop) to when its answer arrived; a request that failed or was refused
counts as later than every limit.
"""

from __future__ import annotations

import itertools
import threading
import time

import numpy as np

from portbench.lib import costs, stats
from portbench.lib import trace as tracing
from portbench.lib import weights
from portbench.reference import nets
from portbench.reference import serve as reference

KERNELS = ("decoder_upsample_tc", "decoder_upsample_narrow")


def _next_pow2(n):
    return 1 << max(0, (n - 1).bit_length())


class _Recorder:
    """Wraps the engine's ``infer_group`` (the batcher calls it by
    attribute): stamps each call, and starts or stops the profiler
    between calls on the batcher thread, whose host operations it then
    records."""

    def __init__(self, engine, batcher, device_type):
        self.engine, self.batcher = engine, batcher
        self.inner = engine.infer_group
        self.device_type = device_type
        self.calls = []         # (t_enter_ns, t_exit_ns, n, padded batch)
        self.want = None        # "start" | "stop"
        self.prof = None
        self.window = None
        self.stats = None
        self.done = threading.Event()
        engine.infer_group = self

    def _control(self):
        if self.want == "start" and self.prof is None:
            self.prof = tracing.start(self.device_type)
            self.stats = [self.batcher.stats.snapshot()]
            self.t0 = time.time_ns()
            self.calls_at = len(self.calls)
            self.want = None
        elif self.want == "stop" and self.prof is not None:
            t1 = time.time_ns()
            self.stats.append(self.batcher.stats.snapshot())
            self.window = tracing.stop(self.prof, self.t0, t1)
            self.traced_calls = self.calls[self.calls_at:]
            self.prof, self.want = None, None
            self.done.set()

    def __call__(self, imgs):
        self._control()
        if not imgs:
            return self.inner(imgs)
        a = time.time_ns()
        out = self.inner(imgs)
        n = len(imgs)
        self.calls.append((a, time.time_ns(), n,
                           min(_next_pow2(n), max(self.engine.max_batch, n))))
        return out


def _images(torch, gen, dev, n, h, w):
    return torch.randint(0, 256, (n, h, w, 3), generator=gen, device=dev,
                         dtype=torch.uint8)


def build_engine(ctx, gen, dtype, calib=None):
    """The program's engine with the benchmark's weights, made on the
    card from ``gen``."""
    from shadow_removal_istd_tpu_torch.serving.engine import InferenceEngine

    m, s = ctx.config["model"], ctx.config["serve"]
    ngf = m["ngf"]
    leaves = {"g1": nets.mnet_leaves(3, 1, ngf, nearest=True),
              "g2": nets.mnet_leaves(4, 3, ngf, nearest=True)}
    w = weights.make(leaves, gen, ctx.device)
    engine = InferenceEngine(m["net_g"], ngf=ngf, nn_upconv=True,
                             split_skip=s["split_skip"], dtype=dtype,
                             activation=s["activation"], max_batch=s["max_batch"],
                             calib_images=calib, device=ctx.device)
    # the master pair and the replicas the engine serves (copies of it
    # where the engine's device names no card index)
    pairs = {(id(a), id(b)): (a, b) for a, b in [(engine.g1, engine.g2), *engine.replicas]}
    for g1, g2 in pairs.values():
        weights.load_into(g1, w["g1"])
        weights.load_into(g2, w["g2"])
        if dtype != "int8":
            g1.freeze()
            g2.freeze()
    if dtype == "int8":
        engine._maybe_quantize()
    return engine


def check_kernel_path(ctx, engine, h, w):
    """On the card, one stacked bf16 forward must launch K1 8 times on
    the tensor cores and twice on the narrow kernel."""
    from shadow_removal_istd_tpu_torch.ops.decoder import decoder_upsample

    if ctx.device.type != "cuda" or engine.dtype != "bfloat16":
        return
    before = dict(decoder_upsample.launches_by_variant)
    engine.infer_group([np.full((h, w, 3), 128, np.uint8)] * engine.max_batch)
    got = {k: decoder_upsample.launches_by_variant[k] - before[k] for k in before}
    want = {"tensor_core": 8, "cuda_core": 0, "narrow": 2}
    if got != want:
        raise RuntimeError(f"K1 launches a forward {got}, expected {want}")


def run(ctx, dtype=None):
    torch = ctx.torch
    tr, s = ctx.traffic, ctx.config["serve"]
    dtype = dtype or s["dtype"]
    h, w = tr["height"], tr["width"]
    dev = ctx.device
    ctx.phase("start")
    ctx.build(KERNELS)
    ctx.phase("build")
    pool = _images(torch, ctx.generator("data"), dev, tr["pool"], h, w)
    pool_np = pool.cpu().numpy()
    del pool
    ctx.phase("requests")
    calib = list(pool_np[:8]) if dtype == "int8" else None
    engine = build_engine(ctx, ctx.generator("weights"), dtype, calib)
    ctx.phase("engine")
    for b in [1, 2, 4, 8][:s["max_batch"].bit_length()]:
        engine.warmup([(h, w)], [b])
        ctx.phase(f"warm-up b{b}")
    check_kernel_path(ctx, engine, h, w)
    ctx.phase("warm-up")

    from shadow_removal_istd_tpu_torch.serving.server import MicroBatcher

    batcher = MicroBatcher(engine, window_ms=s["batch_window_ms"],
                           max_queue=s.get("max_queue"))
    rec = _Recorder(engine, batcher, dev.type)
    rng = ctx.rng("order")
    order = rng.permutation(tr["pool"])
    for f in [batcher.submit(pool_np[i % tr["pool"]]) for i in range(2 * s["max_batch"])]:
        f.result()
    ctx.mark_setup()

    loop = _closed if tr["loop"] == "closed" else _open
    res = loop(ctx, batcher, rec, pool_np, order, rng)
    batcher.close()
    res["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if dev.type == "cuda" else 0)
    del engine, batcher, rec
    ctx.free()
    res["checks"] = _check(ctx, res.pop("sample"), pool_np)
    return res


def _keep_mask(rng, tr, n):
    return rng.random(n) < tr["keep_share"]


def _trace_plan(ctx, rec, w0):
    """Ask the recorder for a traced sub-window from ``lead_s`` after the
    window's start, ``trace_s`` long."""
    if not ctx.trace:
        return None
    tr = ctx.traffic
    lead = min(tr["trace_lead_s"], ctx.seconds / 4)
    length = min(tr["trace_s"], ctx.seconds / 2)

    def plan():
        time.sleep(max(0.0, w0 + lead - time.perf_counter()))
        rec.want = "start"
        while rec.prof is None and rec.want == "start":
            time.sleep(0.001)
        time.sleep(length)
        rec.want = "stop"

    th = threading.Thread(target=plan, daemon=True)
    th.start()
    return th


def _closed(ctx, batcher, rec, pool_np, order, rng):
    tr = ctx.traffic
    keep = _keep_mask(rng, tr, 10 ** 6)
    counter = itertools.count()
    stop = threading.Event()
    recs, kept = [], {}
    lock = threading.Lock()

    def client():
        mine = []
        while not stop.is_set():
            rid = next(counter)
            k = int(order[rid % len(order)])
            img = pool_np[k]
            t = time.perf_counter()
            try:
                out = batcher.submit(img).result()
                ok = True
            except Exception:
                out, ok = None, False
            done = time.perf_counter()
            mine.append((rid, k, t, done, ok))
            if ok and keep[rid] and len(kept) < tr["keep_max"]:
                kept[rid] = (k, out)
        with lock:
            recs.extend(mine)

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(tr["clients"])]
    w0 = time.perf_counter()
    planner = _trace_plan(ctx, rec, w0)
    for t in threads:
        t.start()
    w1 = w0 + ctx.seconds
    time.sleep(max(0.0, w1 - time.perf_counter()))
    stop.set()
    for t in threads:
        t.join(timeout=120)
    if planner is not None:
        planner.join()
        _finish_trace(rec)
    in_window = [r for r in recs if r[3] <= w1]
    answered = [r for r in in_window if r[4]]
    attempted = [r for r in recs if r[2] < w1]
    return {"e2e": {"serve_img_per_s": len(answered) / ctx.seconds},
            "attempted": len(attempted),
            "failed": sum(1 for r in attempted if not r[4]),
            "sample": _sample(ctx, rng, kept, {r[0] for r in answered}),
            "obs": _obs(ctx, rec),
            "extra": {}}


def open_schedule(rate, seconds, gap_seed, rng):
    """Due times (s from the window's start) of a Poisson stream at
    ``rate`` over ``seconds``: ``rate * seconds`` exponential gaps drawn
    once from ``gap_seed``, scaled to end at ``seconds``, in an order
    drawn from ``rng`` (the run's seed): every seed offers the same
    gaps."""
    n = int(round(rate * seconds))
    gaps = np.random.default_rng(gap_seed).exponential(1.0 / rate, n)
    gaps = gaps[rng.permutation(n)] * (seconds / gaps.sum())
    return np.cumsum(gaps)


def _open(ctx, batcher, rec, pool_np, order, rng):
    tr = ctx.traffic
    offsets = open_schedule(tr["rate_per_s"], ctx.seconds, tr["gap_seed"], rng)
    n = len(offsets)
    keep = _keep_mask(rng, tr, n)
    due = np.empty(n)
    sent = np.full(n, np.nan)
    done = np.full(n, np.nan)
    ok = np.zeros(n, bool)
    kept = {}
    futs = []

    def finish(i, fut):
        done[i] = time.perf_counter()
        if fut.exception() is None:
            ok[i] = True
            if keep[i] and len(kept) < tr["keep_max"]:
                kept[i] = (int(order[i % len(order)]), fut.result())

    from shadow_removal_istd_tpu_torch.serving.server import OverloadedError

    w0 = time.perf_counter()
    due[:] = w0 + offsets
    planner = _trace_plan(ctx, rec, w0)
    for i in range(n):
        delay = due[i] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        img = pool_np[int(order[i % len(order)])]
        sent[i] = time.perf_counter()
        try:
            fut = batcher.submit(img)
        except OverloadedError:
            done[i] = sent[i]
            continue
        fut.add_done_callback(lambda f, i=i: finish(i, f))
        futs.append(fut)
    w1 = w0 + ctx.seconds
    deadline = max(w1, time.perf_counter()) + 60.0
    for f in futs:
        try:
            f.result(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception:
            pass
    if planner is not None:
        planner.join()
        _finish_trace(rec)
    lat = np.where(ok & np.isfinite(done), done - due, stats.FAILED_S)
    late = sent - due
    return {"e2e": {"serve_p95_ms": 1e3 * stats.p95(lat)}, "latencies_s": lat,
            "attempted": n, "failed": int((~ok).sum()),
            "sample": _sample(ctx, rng, kept, set(np.flatnonzero(ok).tolist())),
            "obs": _obs(ctx, rec),
            "extra": {"generator_late_ms": {
                "p50": 1e3 * float(np.nanpercentile(late, 50)),
                "p99": 1e3 * float(np.nanpercentile(late, 99)),
                "max": 1e3 * float(np.nanmax(late))}}}


def _finish_trace(rec):
    """The traced window closes at the batcher's next call; if traffic
    has ended, one more call closes it."""
    if not rec.done.wait(timeout=5.0):
        rec.batcher.run_on_batcher(lambda: rec([])).result(timeout=60.0)


def _sample(ctx, rng, kept, answered):
    ids = sorted(i for i in kept if i in answered)
    take = min(ctx.traffic["sample"], len(ids))
    pick = rng.choice(len(ids), size=take, replace=False) if take else []
    return [kept[ids[j]] for j in sorted(pick)]


def _obs(ctx, rec):
    """What the per-layer readers read, from the traced window."""
    if rec.window is None:
        return {}
    t0, t1 = rec.window.t0, rec.window.t1
    calls = [c for c in rec.traced_calls if c[0] >= t0 and c[1] <= t1]
    a, b = rec.stats
    tr = ctx.traffic
    return {"window": rec.window, "calls": calls,
            "images": b["images"] - a["images"], "batches": b["batches"] - a["batches"],
            "flops_per_image": costs.stacked_mnet_flops(tr["height"], tr["width"],
                                                         ctx.config["model"]["ngf"]),
            "k1_least_s": lambda bp: costs.k1_least_s(bp, tr["height"], tr["width"],
                                                      ctx.config["model"]["ngf"])}


def _check(ctx, sample, pool_np):
    """The sampled answers of the window against the reference, computed
    after the program's state is freed."""
    torch = ctx.torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = ctx.traffic
    ngf = ctx.config["model"]["ngf"]
    w = weights.make({"g1": nets.mnet_leaves(3, 1, ngf, nearest=True),
                      "g2": nets.mnet_leaves(4, 3, ngf, nearest=True)},
                     ctx.generator("weights"), ctx.device)
    lim = ctx.config["limits"]["serve"]
    if not sample:
        return [("answers_compared", 0.0, 1.0, "min")]
    idx = torch.as_tensor([k for k, _ in sample])
    imgs = torch.from_numpy(pool_np[idx.numpy()]).to(ctx.device)
    m_ref, y_ref = reference.stacked(w["g1"], w["g2"], imgs)
    m_got = torch.from_numpy(np.stack([o[0] for _, o in sample])).to(ctx.device)
    y_got = torch.from_numpy(np.stack([o[1] for _, o in sample])).to(ctx.device)
    diff = torch.cat([(m_got.int() - m_ref.int()).abs().flatten(),
                      (y_got.int() - y_ref.int()).abs().flatten()]).float()
    return [("mean_abs_gray", float(diff.mean()), lim["mean_abs_gray"], "max"),
            ("share_off_gt4", float((diff > 4).float().mean()), lim["share_off_gt4"], "max"),
            ("answers_compared", float(len(sample)), float(tr["sample"]), "min")]
