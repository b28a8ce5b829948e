"""Sweep of the w8a16 tensor-core kernels over K splits, on the card.

    python3 -m instaslice_tpu_torch.ops.qmm_probe [M ...]      # default 8 128

Builds ``csrc/quant_matmul.cu`` alone and times the tensor-core entries
at every 7B shape over a range of K splits (CUDA graph replay between
CUDA events, the layer of a stack rotating so the weight comes from
device memory; each split's output first held against the plain version)
beside the planner's own choice: the numbers the planner's model in
``ops/quant_matmul.py`` was set against. Needs one NVIDIA card; prints
the card's name and power limit.
"""

from __future__ import annotations

import math
import subprocess
import sys

import torch

from instaslice_tpu_torch.ops import build
from instaslice_tpu_torch.ops import quant_matmul as qm

#: (name, K, N, transposed) of the 7B int8 configuration
SHAPES = (("wq", 4096, 4096, False), ("wk", 4096, 1024, False),
          ("w_in", 4096, 20480, False), ("w_out", 20480, 4096, False),
          ("embed", 4096, 32000, True))


def graph_us(fn, n: int, replays: int = 3) -> float:
    """Device microseconds per call of ``fn(i)``, n calls captured in one
    CUDA graph and replayed between CUDA events."""
    fn(0)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (n * replays) * 1e3


def _stack(K, N, transposed, layers, gen):
    shape = (layers, N, K) if transposed else (layers, K, N)
    q3 = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                       dtype=torch.int8)
    s3 = (torch.rand((layers, 1, N), generator=gen, device="cuda") * 0.02
          + 0.001).to(torch.bfloat16)
    return q3, s3


def _call(x, q3, s3, li, transposed):
    if transposed:
        return qm.quant_matmul_t(x, q3[li], s3[li])
    return qm.quant_matmul_stacked(x, q3, s3, li)


def sweep(ms) -> None:
    lib = build.library("quant_matmul", qm._SIGNATURES)
    gen = torch.Generator(device="cuda").manual_seed(2)
    step = qm.TC_K_STEP
    for name, K, N, t in SHAPES:
        layers = max(2, math.ceil(3e8 / (K * N)))    # rotate past the L2
        q3, s3 = _stack(K, N, t, layers, gen)
        for M in ms:
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            out = torch.empty((M, N), dtype=torch.float32, device="cuda")
            want_out = qm.quant_matmul_ref(x, q3[1], s3[1], transpose_w=t)
            chosen = qm.plan(torch.bfloat16, M, K, N, t)
            tile = chosen.tile
            fn = getattr(lib, chosen.entry)
            nbytes = K * N + 2 * N + 2 * M * K + 4 * M * N
            seen = {}
            for want in (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32):
                k_len = math.ceil(math.ceil(K / want) / step) * step
                splits = math.ceil(K / k_len)
                if (k_len, splits) in seen:
                    continue
                part = torch.empty((splits, M, N), dtype=torch.float32,
                                   device="cuda")

                def run(i, k_len=k_len, splits=splits, part=part):
                    li = i % layers
                    rc = fn(x.data_ptr(), q3.data_ptr() + li * K * N,
                            s3.data_ptr() + li * N * 2, 1, out.data_ptr(),
                            part.data_ptr(), M, K, N, k_len, splits,
                            torch.cuda.current_stream().cuda_stream)
                    build.check_launch(rc, "sweep")

                run(1)
                torch.cuda.synchronize()
                err = float((out - want_out).norm() / want_out.norm())
                if err > 2e-5:
                    raise SystemExit(f"{name} M={M} {splits}x{k_len}: "
                                     f"rel L2 {err}")
                seen[(k_len, splits)] = graph_us(run, layers)
                del part
            best = min(seen, key=seen.get)
            mine = seen[(chosen.k_len, chosen.splits)]
            row = ", ".join(f"{s}x{k}: {us:.1f}" for (k, s), us in
                            seen.items())
            print(f"sweep {name} M={M} ct={tile.ct} threads={tile.threads} "
                  f"smem={tile.smem} tiles={math.ceil(N / tile.ct)}: {row}")
            print(f"sweep {name} M={M}: best {best[1]}x{best[0]} "
                  f"{seen[best]:.1f} us = {nbytes / seen[best] / 1e3:.0f} "
                  f"GB/s; planner {chosen.splits}x{chosen.k_len} "
                  f"{mine:.1f} us; bytes bound {nbytes / 3.35e6:.1f} us",
                  flush=True)
        del q3, s3
        torch.cuda.empty_cache()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("qmm_probe: needs one NVIDIA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    sweep([int(a) for a in argv] or [8, 128])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
