"""The rate sweep that finds the highest rate a serving configuration
sustains, for an open-loop cell's rate.

    python3 -m portbench.sweep --workload mnet.serve.sat --rates 200,250,300 --seconds 51 --seed 1

For each rate, one run of the cell's configuration and request size
under Poisson arrivals at that rate (its own set-up, the same seed):
the p50, p95 and p99 latency from the due time, the failed requests,
how late the generator ran, and the p95 of the window's first and last
thirds (a backlog that grows shows as a last third later than the
first). An open-loop cell's rate is 4/5 of the highest rate whose p95
keeps within the limit with no failure and no growing backlog.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    from portbench.drivers import serve
    from portbench.run import Ctx, cache_env

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    root = Path.cwd()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cache_env(root)
    for rate in (float(r) for r in args.rates.split(",")):
        ctx = Ctx(root, bench, cell, args.seed, args.seconds, False, "cuda:0",
                  overrides={"traffic": {"loop": "open", "rate_per_s": rate, "gap_seed": 0,
                                         "keep_share": 0.05}})
        res = serve.run(ctx)
        lat = 1e3 * np.asarray(res["latencies_s"])
        third = len(lat) // 3
        print(json.dumps({
            "rate_per_s": rate, "requests": len(lat), "failed": res["failed"],
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "p95_first_third_ms": float(np.percentile(lat[:third], 95)),
            "p95_last_third_ms": float(np.percentile(lat[-third:], 95)),
            "generator_late_ms": res["extra"]["generator_late_ms"],
            "checks": {n: v for n, v, _, _ in res["checks"]}}), flush=True)
        ctx.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
