"""Decode attention (B1) on the card: where its time goes.

    python3 instaslice_tpu_torch/ops/fd_probe.py              # this checkout
    python3 instaslice_tpu_torch/ops/fd_probe.py --root DIR   # another one

Times ``quant_decode_attention`` at the three batch-8 shapes
``chip_smoke.py`` times (the 7B configuration: 8 KV heads, G 4, hd 128,
bf16 q over a 32-layer int8 cache of 1024 positions, the layer rotating
so the cache comes from device memory): staggered lengths and full depth
at s_attn 1024, the engine's lengths at s_attn 256. Each time is CUDA
graph replay between CUDA events, beside the device time of each of the
call's kernels from torch.profiler. With ``--root DIR`` the port is
imported from another checkout (an earlier commit unpacked with
``git archive``) and only its wrapper is timed, so two versions compare
within one card's run (run them in turns). Without it, a variant of
``csrc/flash_decode.cu`` is also built from a patched copy of the source
(never used by the port) and timed the same way: ``bytes_only``, in
which each block copies its chunk and writes the empty partial with no
arithmetic, the floor of this grid and copy plan. Needs one NVIDIA card;
prints its name and power limit, and last one JSON line of every
reading.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

#: (label, lengths, s_attn) at batch 8, as chip_smoke.py's check_b1
SHAPES = (("staggered", [0, 1, 17, 128, 300, 511, 777, 1000], 1024),
          ("full depth", [1024] * 8, 1024),
          ("engine", [256, 200, 129, 100, 64, 33, 17, 5], 256))

_SCORES = "  // scores s[g][p] = (q_g . k_p) * k_scale_p\n"


def _kernel_name(key: str) -> str:
    """``fd_kernel`` / ``fd_combine_kernel`` from a profiler key (the
    demangled signature), any other key cut to 40 characters."""
    for name in ("fd_combine_kernel", "fd_kernel"):
        if name in key:
            return name
    return key[:40]


def bytes_only(src: str) -> str:
    """``csrc/flash_decode.cu`` whose split kernel, once its chunk has
    landed, writes the empty partial and computes nothing."""
    if src.count(_SCORES) != 1:
        raise RuntimeError("fd_probe: the scores comment of fd_kernel is "
                           "not found once in csrc/flash_decode.cu")
    return src.replace(_SCORES, """  cp_async_wait<0>();
  __syncthreads();
  put_empty<HD, G>(part);
  if (tid < FD_THREADS) return;
""" + _SCORES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose port to import (default: this one)")
    args = ap.parse_args(argv)
    root = Path(args.root or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from instaslice_tpu_torch.ops import build
    from instaslice_tpu_torch.ops import flash_decode as fd

    if not torch.cuda.is_available():
        print("fd_probe: needs one NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"port from {root}", flush=True)

    def graph_us(fn, n: int, replays: int = 3) -> float:
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

    gen = torch.Generator(device="cuda").manual_seed(3)
    B, Hkv, G, hd, S, L = 8, 8, 4, 128, 1024, 32
    k3, v3 = (torch.randint(-127, 128, (L, B, Hkv, S, hd), generator=gen,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))
    ks3, vs3 = (torch.rand((L, B, Hkv, S), generator=gen, device="cuda")
                * 0.02 for _ in range(2))
    q4 = torch.randn((B, Hkv, G, hd), generator=gen, device="cuda").to(
        torch.bfloat16)

    def measure(name: str, check: bool) -> dict:
        out = {}
        for label, lens, s_attn in SHAPES:
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")

            def call(i):
                return fd.quant_decode_attention(q4, k3, ks3, v3, vs3,
                                                 lengths, i % L, s_attn)

            got = call(5)
            want = fd.quant_decode_attention_ref(q4, k3, ks3, v3, vs3,
                                                 lengths, 5, s_attn)
            torch.cuda.synchronize()
            rows = [b for b, n in enumerate(lens) if n > 0]
            err = max(float((a[rows] - b[rows]).abs().max()
                            / b[rows].abs().max())
                      for a, b in zip(got, want))
            if check and err > 1e-5:
                raise RuntimeError(f"{name} {label}: error {err:.2e} of "
                                   "max|plain|")
            us = graph_us(call, L)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(L):
                    call(i)
                torch.cuda.synchronize()
            kernels = {_kernel_name(e.key):
                       round(e.self_device_time_total / L, 2)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total}
            out[label] = {"us": round(us, 2), "kernels_us": kernels,
                          "err": err}
            print(f"{name:12s} {label:10s} s_attn {s_attn:4d}: {us:6.2f} us "
                  f"(graph replay); by kernel {kernels}; error {err:.1e} "
                  "of max|plain|", flush=True)
        return out

    result = {"card": card, "root": str(root),
              "kernel": measure("kernel", True)}
    if args.root is None:
        path = build.BUILD_DIR / "fd_probe_bytes_only.cu"
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path.write_text(bytes_only((build.CSRC / "flash_decode.cu")
                                   .read_text()))
        so = path.with_suffix(".so")
        proc = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(so), str(path)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError("bytes_only failed to build:\n"
                               + proc.stdout + proc.stderr)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in fd._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        kernel_lib = build.library("flash_decode", fd._SIGNATURES)
        build._LIBS["flash_decode"] = lib
        try:
            result["bytes_only"] = measure("bytes_only", False)
        finally:
            build._LIBS["flash_decode"] = kernel_lib
        result["kernel_again"] = measure("kernel", True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
