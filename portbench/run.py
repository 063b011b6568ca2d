"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell names a configuration and a
traffic mix; the mix's ``driver`` key names the generator in
``portbench/drivers/`` that sets the program up from the seed, warms the
cell's shapes, measures for ``--seconds`` and checks the window's
outputs against the plain reference. With ``--trace 1`` the window also
holds a traced stretch, and the line carries the cell's per-layer
metrics (each read by ``portbench/metrics/<name>.py``) instead of its
end-to-end ones.

Exits with a nonzero code, and prints no result, when the card or the
cards the cell asks for are missing, or when ``jax``, ``jaxlib``,
``flax``, ``optax`` or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()     # the set-up clock starts before torch loads

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "shadow_removal_istd_tpu")
STREAMS = {"weights": 1, "data": 2, "order": 3}


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Ctx:
    """What a driver gets: the cell, its configuration and traffic, the
    run's arguments, the device, and generators drawn from the seed."""

    def __init__(self, root, bench, cell, seed, seconds, trace, device,
                 overrides=None):
        import numpy as np
        import torch

        self.torch, self.np = torch, np
        self.root, self.bench, self.cell = Path(root), bench, cell
        over = overrides or {}
        conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
        self.config = _merge(json.loads((self.root / conf["file"]).read_text()),
                             over.get("config", {}))
        self.traffic = _merge(json.loads(
            (self.root / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text()),
            over.get("traffic", {}))
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.setup_s = None
        self._phases, self._t = [], time.perf_counter()

    def phase(self, name):
        """Note the set-up time since the last note (printed to standard
        error once set-up ends)."""
        now = time.perf_counter()
        self._phases.append(f"{name} {now - self._t:.2f}s")
        self._t = now

    def _seq(self, stream):
        return self.np.random.SeedSequence([self.seed % 2 ** 64, STREAMS[stream]])

    def generator(self, stream):
        """A generator on the device, seeded from (seed, stream)."""
        g = self.torch.Generator(device=self.device)
        g.manual_seed(int(self._seq(stream).generate_state(1, self.np.uint64)[0]) & (2 ** 63 - 1))
        return g

    def rng(self, stream):
        return self.np.random.default_rng(self._seq(stream))

    def build(self, names):
        """Build the program's kernel libraries in parallel (reused from
        the checkout's build directory after a checkout's first run)."""
        if self.device.type != "cuda" or not names:
            return
        from concurrent.futures import ThreadPoolExecutor

        from shadow_removal_istd_tpu_torch.ops import _build

        with ThreadPoolExecutor(len(names)) as pool:
            list(pool.map(_build.build, names))

    def mark_setup(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        self.phase("rest")
        self.setup_s = time.perf_counter() - T_PROCESS
        print(f"[setup] {self.setup_s:.2f}s: " + ", ".join(self._phases), file=sys.stderr)

    def free(self):
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = root / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def _reader(root: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", root / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench, cell_name):
    """(end-to-end, per-layer) metric entries that the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per


def forbidden_loaded() -> list[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({exc})"


def run_cell(ctx: Ctx) -> dict:
    """Drive the cell once; returns the result line as a dict (``checks``
    last)."""
    torch = ctx.torch
    driver = importlib.import_module(f"portbench.drivers.{ctx.traffic['driver']}")
    res = driver.run(ctx)
    e2e, per = cell_metrics(ctx.bench, ctx.cell["name"])
    values = {"setup_s": ctx.setup_s, **res["e2e"]}
    obs = res.get("obs", {})
    if ctx.trace:
        metrics = {}
        for m in per:
            v = _reader(ctx.root, m["name"])(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    cuda = ctx.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": int(ctx.cell["chips"]),
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": None, "attempted": int(res["attempted"]), "failed": int(res["failed"]),
            "metrics": metrics, "device": device}
    if ctx.trace and "window" in obs:
        win = obs["window"]
        device["busy_s"], device["window_s"] = win.busy_s(), win.seconds
        line["breakdown"] = {"device_ops": win.top_ops(), "idle_gaps": win.top_gaps()}
    line.update(res.get("extra", {}))
    checks = {}
    ok = True
    for name, value, limit, kind in res["checks"]:
        passed = value <= limit if kind == "max" else value >= limit
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit,
                        "bound": "at most" if kind == "max" else "at least"}
    line["correct"] = bool(ok)
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cache_env(root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    card = power_limit()
    print(f"[card] {card}", file=sys.stderr)
    ctx = Ctx(root, bench, cell, args.seed, args.seconds, args.trace, "cuda:0")
    line = run_cell(ctx)
    found = forbidden_loaded()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 4
    line["power_limit"] = card
    emit(line)
    return 0


def _finite(x):
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return None if isinstance(x, float) and x != x or x in (float("inf"), -float("inf")) else x


def emit(line: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output
    (``checks`` its last key)."""
    line = _finite(dict(line))
    line["checks"] = line.pop("checks")
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} ({c['bound']} {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
