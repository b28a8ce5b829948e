#!/usr/bin/env python3
"""Start times of the port's control-plane processes, for one or more
checkouts of this repository:

    python3 chip_start_times.py [--repeats N] CHECKOUT [CHECKOUT ...]

For each checkout (a directory holding ``pyproject.toml`` and
``instaslice_tpu_torch/``) and each control-plane console script
(``tpuslice-gpu-controller``, ``-agent``, ``-deviceplugin``,
``-telemetry``, ``tpuslice-gpu``), resolved through the checkout's
``[project.scripts]``, it runs in a fresh interpreter, ``--repeats``
times (default 5):

- ``import_s``: the seconds the import of the script's module takes,
  read inside the process (``time.perf_counter`` around the import);
- ``help_s``: the seconds from spawning ``<script> --help`` to its exit
  (interpreter start, the imports, the parser), on the parent's clock;

and whether torch and numpy were loaded. The checkouts are measured in
turns (the first, the second, ... then the same again in reverse), and
the medians printed as one JSON line per checkout, then the card's name
and power limit as ``nvidia-smi`` gives them. Nothing runs on the card:
these are host-clock times of the machine that holds it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import tomllib
from pathlib import Path

SCRIPTS = ("tpuslice-gpu-controller", "tpuslice-gpu-agent",
           "tpuslice-gpu-deviceplugin", "tpuslice-gpu-telemetry",
           "tpuslice-gpu")

_IMPORT = """
import sys, time
t = time.perf_counter()
import {module}
dt = time.perf_counter() - t
print(dt, 'torch' in sys.modules, 'numpy' in sys.modules)
"""
_HELP = """
import sys
from {module} import {func}
try:
    sys.exit({func}(['--help']))
except SystemExit as e:
    sys.exit(e.code)
"""


def targets(checkout: Path) -> dict:
    with open(checkout / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return {s: scripts[s].split(":") for s in SCRIPTS}


def once(checkout: Path, module: str, func: str) -> dict:
    r = subprocess.run([sys.executable, "-c", _IMPORT.format(module=module)],
                       cwd=checkout, capture_output=True, text=True,
                       timeout=300, check=True)
    dt, torch, numpy = r.stdout.split()
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c",
                    _HELP.format(module=module, func=func)],
                   cwd=checkout, capture_output=True, timeout=300,
                   check=True)
    return {"import_s": float(dt), "help_s": time.perf_counter() - t0,
            "torch": torch == "True", "numpy": numpy == "True"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="+", type=Path)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    runs = {str(c): {s: [] for s in SCRIPTS} for c in args.checkouts}
    order = list(args.checkouts) + list(reversed(args.checkouts))
    for _ in range((args.repeats + 1) // 2):
        for c in order:
            for script, (module, func) in targets(c).items():
                runs[str(c)][script].append(once(c, module, func))
    for c, by_script in runs.items():
        line = {"checkout": c}
        for script, rs in by_script.items():
            line[script] = {
                "import_s": statistics.median(r["import_s"] for r in rs),
                "help_s": statistics.median(r["help_s"] for r in rs),
                "runs": len(rs),
                "torch": any(r["torch"] for r in rs),
                "numpy": any(r["numpy"] for r in rs)}
        print(json.dumps(line))
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    except FileNotFoundError:
        smi = ""
    print(smi or "nvidia-smi: no card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
