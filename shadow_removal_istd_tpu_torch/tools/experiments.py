"""Experiment runner, the guild.ai front end's counterpart; port of
``shadow_removal_istd_tpu/tools/experiments.py``.

Reads a declaration of operations and flag grids (JSON, else YAML, as
the repository's ``experiments.yaml``) and launches the named CLI once
per flag combination, each in a run directory named by the operation's
label template::

    operations:
      shadow-removal-train:
        main: shadow_removal_istd_tpu.cli.main
        label: "{tasks}_{D-loss-fn}_{D-type}_{net-D}-{net-G}"
        flags:
          tasks: train
          D-loss-fn: [standard, leastsquare]
          net-G: [unet, mnet]

List-valued flags form a grid (cartesian product). A ``main`` under the
JAX package (``shadow_removal_istd_tpu.``) launches the port's module of
the same path (``shadow_removal_istd_tpu_torch.``), so one declaration
serves both packages::

    python -m shadow_removal_istd_tpu_torch.tools.experiments run \\
        experiments.yaml shadow-removal-train [--dry-run]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

JAX_PREFIX = "shadow_removal_istd_tpu."
PORT_PREFIX = "shadow_removal_istd_tpu_torch."


def _load(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        try:
            import yaml
        except ImportError as e:
            raise SystemExit(
                "experiments file is not JSON and pyyaml is unavailable"
            ) from e
        return yaml.safe_load(text)


def expand_grid(flags: dict) -> list[dict]:
    """Cartesian product over the list-valued flags."""
    keys, value_lists = [], []
    for k, v in flags.items():
        keys.append(k)
        value_lists.append(v if isinstance(v, list) else [v])
    return [dict(zip(keys, combo))
            for combo in itertools.product(*value_lists)]


def format_label(template: str, flags: dict) -> str:
    label = template
    for k, v in flags.items():
        label = label.replace("{" + k + "}", str(v))
    return label


def port_module(main: str) -> str:
    """The port's module for a ``main`` of the JAX package; any other
    module as it is."""
    if main.startswith(JAX_PREFIX):
        return PORT_PREFIX + main[len(JAX_PREFIX):]
    return main


def build_commands(spec: dict, operation: str,
                   run_root: str = "./runs") -> list[tuple[str, list[str]]]:
    """(run directory, command) per flag combination of ``operation``."""
    op = spec["operations"][operation]
    commands = []
    for flags in expand_grid(op.get("flags", {})):
        label = format_label(op.get("label", operation), flags)
        cmd = [sys.executable, "-m", port_module(op["main"])]
        for k, v in flags.items():
            if isinstance(v, bool):
                v = "yes" if v else "no"
            cmd.extend([f"--{k}"] + str(v).split())
        commands.append((os.path.join(run_root, label), cmd))
    return commands


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="experiment runner")
    parser.add_argument("action", choices=["run", "list"])
    parser.add_argument("spec")
    parser.add_argument("operation")
    parser.add_argument("--run-root", default="./runs")
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)

    spec = _load(args.spec)
    for run_dir, cmd in build_commands(spec, args.operation, args.run_root):
        print(f"[{run_dir}] {' '.join(cmd)}")
        if args.action == "run" and not args.dry_run:
            os.makedirs(run_dir, exist_ok=True)
            subprocess.run(cmd, cwd=run_dir, check=True)


if __name__ == "__main__":
    main()
