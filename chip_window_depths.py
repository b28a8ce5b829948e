"""The window phase of ``chip_smoke.py`` at several depths, in one process
on one card: its seconds at each, so that a depth cut is measured on one
host.

    python3 chip_window_depths.py 2 32 32 2

Builds the kernels (``phase_build``), then runs ``phase_window`` with
every check at each given number of layers in turn (the 7B's widths;
``chip_smoke.WINDOW_LAYERS`` is the smoke's). Prints the card's name and
power limit first, one JSON line a run (its seconds, the eager twin's
decode rates, the launches on the card's trace, the bf16 rows' error),
and last one JSON line of the seconds by depth.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

if __name__ == "__main__":
    import torch

    import chip_smoke as c
    from instaslice_tpu_torch import ops
    from instaslice_tpu_torch.ops import build

    print(c.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip(), flush=True)
    c.phase_build(build)
    secs = {}
    for n in (int(x) for x in sys.argv[1:]):
        t0 = time.perf_counter()
        out = c.phase_window(torch, ops, n_layers=n)
        secs.setdefault(n, []).append(time.perf_counter() - t0)
        c.free_memory(torch)
        print(json.dumps({"n_layers": n, "seconds": secs[n][-1],
                          "eager_tok_s": out["eager"], "counts": out["counts"],
                          "rows_bf16": out["rows_bf16"]}), flush=True)
    print(json.dumps({"window_seconds": secs}), flush=True)
