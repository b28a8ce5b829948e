"""The depth cuts that pay for ``chip_smoke.py``'s chaos step, each at its
old depth and at the smoke's, in one process on one card: their seconds,
so that a cut is measured on one host.

    python3 chip_cut_depths.py

Builds the kernels (``phase_build``), then runs with every check, each
at the old depth and then at the new: the parallel_rest phase's ring CLI
part (rows of 2048 tokens; tried at 1024, which saved nothing and was
not kept, so it runs once), the 871M CPU-against-card train cut
(``phase_train_cut``: 2 layers at rows of 256, then
``TRAIN_CUT_LAYERS`` at ``TRAIN_CUT_ROWS``), the MoE one (2 at 256, then
``MOE_CUT_LAYERS`` at ``MOE_CUT_ROWS``) and the MoE int8 cache-forward
cut (``phase_cut``: 2 layers, then ``MOE_INT8_CUT_LAYERS``). Prints the
card's name and power limit first, one JSON line a run, and last one
JSON line of the seconds by run.
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

if __name__ == "__main__":
    import torch

    import chip_smoke as c
    from instaslice_tpu_torch.models.lm import init_params
    from instaslice_tpu_torch.models.quant import quantize_params
    from instaslice_tpu_torch.ops import build

    print(c.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True).stdout.strip(), flush=True)
    c.phase_build(build)

    def ring(seq_len):
        def run():
            kept = c.REST_RING_FLAGS
            c.REST_RING_FLAGS = kept.replace("--seq-len 2047",
                                             f"--seq-len {seq_len}")
            try:
                return c.rest_ring_cli(torch)
            finally:
                c.REST_RING_FLAGS = kept
        return run

    def train_cut(config, layers, rows, what):
        return lambda: c.phase_train_cut(torch, config(
            torch, n_layers=layers, dtype=torch.float32, param_dtype=None),
            f"{what} {layers} x {rows}", rows=rows)

    def moe_int8(layers):
        def run():
            cfg = c.moe_config(torch, param_dtype=None, remat=False)
            cut = dataclasses.replace(cfg, n_layers=layers,
                                      dtype=torch.float32)
            return c.phase_cut(torch, cut, quantize_params(init_params(
                cut, 0, device="cpu")), f"moe int8 cut {layers}",
                n_layers=layers)
        return run

    runs = (
        ("ring_cli rows 2048", ring(2047)),
        ("ring_cli rows 1024", ring(1023)),
        ("train_cut 2 x 256", train_cut(c.train_config, 2, 256,
                                        "train cut")),
        (f"train_cut {c.TRAIN_CUT_LAYERS} x {c.TRAIN_CUT_ROWS}",
         train_cut(c.train_config, c.TRAIN_CUT_LAYERS, c.TRAIN_CUT_ROWS,
                   "train cut")),
        ("moe train_cut 2 x 256", train_cut(c.moe_config, 2, 256,
                                            "moe train cut")),
        (f"moe train_cut {c.MOE_CUT_LAYERS} x {c.MOE_CUT_ROWS}",
         train_cut(c.moe_config, c.MOE_CUT_LAYERS, c.MOE_CUT_ROWS,
                   "moe train cut")),
        ("moe int8_cut 2", moe_int8(2)),
        (f"moe int8_cut {c.MOE_INT8_CUT_LAYERS}",
         moe_int8(c.MOE_INT8_CUT_LAYERS)),
    )
    secs = {}
    for name, run in runs:
        t0 = time.perf_counter()
        out = run()
        secs[name] = time.perf_counter() - t0
        c.free_memory(torch)
        print(json.dumps({"run": name, "seconds": secs[name],
                          "result": out}, default=str), flush=True)
    print(json.dumps({"cut_seconds": secs}), flush=True)
