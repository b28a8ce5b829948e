#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``instaslice_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py                    # every phase, one card

Phases, each timed; any failure raises and the script exits non-zero
without a result line:

1. build every kernel from ``instaslice_tpu_torch/csrc`` with ``nvcc``
   for ``sm_90a`` (one compiler per source, started together); the
   registers and spills of each warp-specialised kernel (B5-B7) are
   logged, and none may spill, have its ``setmaxnreg`` ignored or its
   ``wgmma`` serialised by ptxas;
2. kernels: each wrapper on the card at the shapes the 7B int8 serving
   path gives it, held against its plain PyTorch version with a stated
   tolerance; B2 and B3 at M = 1, 8, 100, 128 and 256 rows with bf16 x
   (the tensor-core kernels) and fp32 x (the CUDA-core kernels), by the
   largest difference and by relative L2 error over the output and over
   its worst block tile; per-launch device time (CUDA graph replay, CUDA
   events), the plain version's and one PyTorch library call's time,
   achieved GB/s, and the bound (bytes over 3.35 TB/s or operations over
   989 TFLOP/s, from this run's inputs); B1 (split across the cache)
   at three batch-8 shapes: staggered lengths and full depth at s_attn
   1024, the engine's prompt lengths at s_attn 256, the empty row
   bit-exact and two runs bit-equal at each;
3. engine (the main path): the full-width 7B int8 W+KV engine
   (``vocab 32000, d_model 4096, 32 heads / 8 KV heads, 32 layers,
   d_ff 20480``, seeded random weights) serves 8 prompts through
   ``generate``; launch counters are zeroed just before and read just
   after, and must match what the path implies; then TTFT, decode
   tokens/s and the device-busy time of a decode step and of a 128-token
   prefill chunk;
4. cut: the same weights cut to 2 layers run one prefill and 4 decode
   steps on the CPU (plain versions) and on the card (kernels); logits
   within the stated tolerance, greedy tokens equal;
   serve (the server's main path): the port's HTTP server, built by its
   own CLI wiring (``api_server.build_parser`` + ``build_engine``) at
   the same 7B int8 configuration, in process on port 0, answers 8
   concurrent greedy completions (64-600 prompt tokens, 32 new each,
   some streamed, one with logprobs) with B1-B3 launches counted as the
   path implies; then a prompt repeating one's first 256 tokens is a
   radix hit that launches B2 192 times fewer per skipped chunk than the
   same prompt cold, with the same greedy tokens; no KV block leaks;
   TTFT, tokens/s and the host clock per request are logged;
5. train kernels: the flash-attention forward (B5) and backward (B6 dq,
   B7 dk/dv) against their plain versions in bf16 at (B*H 128, S 1024,
   hd 128) causal, at S 1025 (the training CLI's row width) and
   non-causal, by the largest difference and by relative L2 error over
   each output and over its worst 64-row tile, each also run twice
   bit-equal; timed like phase 2, beside SDPA as the library yardstick
   (its forward, and its backward as forward + backward less forward,
   all by graph replay);
   then the bf16 cut: the 871M configuration cut to 2 layers at its
   training precision, batch 2 x 1024: loss and grads through B5-B7
   against the same with their plain versions in the kernels' place;
6. train (the second main path): the 871M configuration (``vocab 32000,
   d_model 2048, 16 heads, 16 layers, d_ff 8192``, seeded random fp32
   master weights, bf16 compute) through ``make_train_step`` at batch 8 x
   1024 tokens: 1 warm-up and 4 timed steps on one batch, loss finite and
   falling, B5/B6/B7 launches exactly 16 per step; step ms, tokens/s,
   MFU, device busy share and peak memory;
7. CLI: ``instaslice_tpu_torch.cli.train_main`` on a synthetic corpus at
   the 871M defaults, 3 steps at ``--seq-len 1024`` (rows of 1025
   tokens: the ragged path), its JSON line checked;
8. train cut: the 871M configuration cut to 2 layers in fp32 at batch 2 x
   256: loss, grads, and the params and each leaf's update after 3 AdamW
   steps (clip, warmup) on the CPU (plain versions) and on the card
   (kernels), within the stated tolerances.

Then the ``kernels`` JSON line (launches: B1-B4 from the serve phase,
B5-B7 from the train phase; ``engine_launches`` from phase 3), and last
``{"ok": true, "device": {...}}``. Without a card, or without the port
beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

#: CPU-vs-card tolerances of the fp32 train cut (phase 8): relative loss
#: error, the relative L2 error of the grads (each leaf's worst), the
#: largest absolute difference of the params after 3 AdamW steps (which
#: move them by ~1e-3) and the relative L2 error of each leaf's update
#: over the 3 steps (the worst). fp32 on both sides, sums in another
#: order; measured on an H100 at 700 W: 8.5e-8, 2.1e-6, 2.3e-6 and
#: 1.2e-5; each tolerance is about 10x its measurement
CUT_TOL = {"loss": 1e-6, "grads": 2.5e-5, "params": 2.5e-5,
           "update": 1.2e-4}

#: B5-B7 in bf16 against their plain versions (phase 5): relative L2
#: error of each output tensor, and of its worst 64-row tile; measured
#: on an H100 at 700 W: at most 2.7e-3 and 5.0e-3; a kernel dropping one
#: key or query tile reads 0.3-0.9 on its worst tile
FLASH_TOL = {"rel_l2": 1e-2, "tile_rel_l2": 2e-2}
FLASH_TOL_TEXT = ("bf16 outputs: max abs <= 2**-7 x max|plain|, rel L2 <= "
                  f"{FLASH_TOL['rel_l2']:g}, worst 64-row tile rel L2 <= "
                  f"{FLASH_TOL['tile_rel_l2']:g}; lse: 1e-5 x max|plain|")

#: the bf16 2-layer cut on the card (phase 6): loss and grads through the
#: kernels against the same step through the plain versions; relative
#: loss error and each grad leaf's relative L2 error (the worst); the
#: kernels round p and ds to bf16, which bf16 activations carry through
#: both layers. Measured on an H100 at 700 W: 1.9e-6 and 8.5e-3
BF16_CUT_TOL = {"loss": 2e-5, "grads": 5e-2}

#: B2-B4 against their plain versions (phase 2): products of a bf16 or
#: fp32 x and an int8 weight are exact in fp32 on both sides, so only the
#: order of the fp32 sums (up to 20480 terms; tensor-core order for bf16
#: x) differs. Measured on an H100 at 700 W over every shape of phase 2
#: (200 comparisons): largest difference at most 3.0e-6 of max|plain|,
#: relative L2 at most 1.5e-6 over the output and 1.6e-6 over its worst
#: block tile; the bounds are 7-10x that. A kernel that skips one k tile
#: or one ring stage in one block, or one split of one channel tile in
#: the second pass, reads 0.2-0.8 on all three.
QMM_TOL = {"max_rel": 2e-5, "rel_l2": 1.5e-5, "tile_rel_l2": 1.5e-5}
QMM_TOL_TEXT = ("max abs <= 2e-5 x max|plain|, rel L2 <= 1.5e-5, worst "
                "block tile rel L2 <= 1.5e-5")
QMM_MS = (1, 8, 100, 128, 256)

BIG = ("wq", "wk", "wv", "wo", "w_in", "w_out")

#: device-time classes of a profiled step: the first class whose pattern
#: occurs in a kernel's (lower-cased) name takes it
KERNEL_CLASSES = (
    ("flash attention B5-B7", ("fa_fwd", "fa_bwd", "wg::")),
    ("w8a16 and decode kernels B1-B4", ("qmm_", "fd_kernel",
                                         "fd_combine_kernel")),
    ("cuBLAS GEMM", ("nvjet", "gemm", "cutlass", "xmma")),
    ("optimizer", ("adam", "multi_tensor")),
    ("elementwise", ("elementwise",)),
    ("reductions", ("reduce",)),
)
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the bf16 tensor rate."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def gbs(nbytes: float, ms: float) -> float:
    """GB/s of ``nbytes`` moved in ``ms`` milliseconds."""
    return nbytes / ms / 1e6


def graph_ms(torch, fn, n: int, replays: int = 3) -> float:
    """Device time per call of ``fn(i)``, i = 0..n-1: the n calls are
    captured once into a CUDA graph, replayed ``replays`` times between
    CUDA events (so host launch cost is not in the number)."""
    fn(0)                                   # loads modules, warms caches
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
    ms = start.elapsed_time(end) / (n * replays)
    del g
    torch.cuda.empty_cache()
    return ms


# ---------------------------------------------------------------- phases


def ptxas_kernels(text: str) -> list:
    """(kernel, registers, spill-store bytes) of every kernel in a
    ``-Xptxas=-v`` log; the warp-specialised kernels of namespace wg by
    readable name (``wg::fwd_kernel<causal=1>``), the others mangled."""
    out = []
    for block in text.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        wg = re.search(r"2wg\d+(\w+?_kernel)ILb([01])E", name)
        if wg:
            name = f"wg::{wg.group(1)}<causal={wg.group(2)}>"
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        out.append((name, int(regs.group(1)) if regs else 0,
                    int(spill.group(1)) if spill else 0))
    return out


def phase_build(build) -> None:
    t0 = time.perf_counter()
    paths = build.build()
    log(f"build: {[p.name for p in paths]} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in build.BUILD_LOGS.items():
        (build.BUILD_DIR / f"{name}.ptxas.log").write_text(text)
        kernels = ptxas_kernels(text)
        log(f"build: {name}: {len(kernels)} kernels, registers "
            f"{min((k[1] for k in kernels), default=0)}-"
            f"{max((k[1] for k in kernels), default=0)}, max spill stores "
            f"{max((k[2] for k in kernels), default=0)} bytes")
        # the warp-specialised kernels: their consumer warpgroups hold the
        # accumulators in registers raised by setmaxnreg; a spill or an
        # ignored setmaxnreg undoes the design
        for kname, regs, spill in kernels:
            if kname.startswith("wg::"):
                log(f"build: {kname}: {regs} registers at launch "
                    f"(setmaxnreg: producer 40, consumers 232), spill "
                    f"stores {spill} bytes")
                check(spill == 0, f"{kname} spills {spill} bytes")
        for line in text.splitlines():
            if "setmaxnreg" in line or "wgmma" in line:
                log(f"build: {name}: ptxas: {line.strip()}")
        check("setmaxnreg ignored" not in text,
              f"{name}: ptxas ignored setmaxnreg")
        check("are serialized" not in text,
              f"{name}: ptxas serialised wgmma (the tensor-core pipeline "
              "waits on every product)")


def _err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def qmm_errors(torch, got, want, rows: int, cols: int) -> dict:
    """How far a w8a16 output (M, N) lies from its plain version: the
    largest difference over max|plain|, the relative L2 error of the
    output, and the worst relative L2 error of one ``rows x cols`` tile
    (what one block of the kernel writes), so that a dropped k tile,
    ring stage or channel tile shows however small its elements are."""
    diff = (got - want).float()
    want = want.float()
    M, N = want.shape
    pad = (0, -N % cols, 0, -M % rows)

    def tiles(t):
        t = torch.nn.functional.pad(t, pad)
        return (t.reshape(t.shape[0] // rows, rows, t.shape[1] // cols, cols)
                .permute(0, 2, 1, 3).reshape(-1, rows * cols))

    tile = float((tiles(diff).norm(dim=-1)
                  / tiles(want).norm(dim=-1).clamp_min(1e-30)).max())
    return {"max_abs": float(diff.abs().max()),
            "max_rel": float(diff.abs().max() / want.abs().max()),
            "rel_l2": float(diff.norm() / want.norm()),
            "tile_rel_l2": tile}


def check_qmm(torch, qm, got, want, what, x_dtype, M, K, N,
              transposed) -> dict:
    """Hold one B2/B3/B4 output against its plain version within
    QMM_TOL; the tile is the launched kernel's block tile."""
    plan = qm.plan(x_dtype, M, K, N, transposed)
    if plan.tile is not None:
        rows, cols = M, plan.tile.ct
    else:                       # masked kernels: 8 rows x 256 or 32 channels
        rows, cols = 8, 32 if transposed else 256
    r = qmm_errors(torch, got, want, rows, cols)
    for key, tol in QMM_TOL.items():
        check(r[key] <= tol, f"{what}: {key} {r[key]:.3e} > {tol:g} "
              f"({plan.entry}, {plan.splits} x k_len {plan.k_len})")
    r["entry"] = plan.entry
    r["splits"] = plan.splits
    return r


def phase_kernels(torch, cfg, qp, ops) -> list:
    """Each kernel against its plain version at the main path's shapes;
    returns the kernels' entries (launches filled in later)."""
    fd, qm = ops.flash_decode, ops.quant_matmul
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    out = []

    def worse(acc: dict, r: dict) -> None:
        for key in ("max_abs", "rel_l2", "tile_rel_l2"):
            acc[key] = max(acc.get(key, 0.0), r[key])

    # ---- B2 quant_matmul_stacked: the six projections at M = 1 ... 256
    detail = []
    errs = {}
    for M in QMM_MS:
        for name in BIG:
            leaf = qp["blocks"][name]
            K, N = leaf.q.shape[1:]
            x32 = torch.randn((M, K), generator=gen, device=dev)
            x = x32.to(torch.bfloat16)
            worst = {}
            for li in (0, L // 2, L - 1):
                for xin in (x, x32):
                    got = qm.quant_matmul_stacked(xin, leaf.q, leaf.s, li)
                    want = qm.quant_matmul_stacked_ref(xin, leaf.q, leaf.s,
                                                       li)
                    r = check_qmm(torch, qm, got, want, f"B2 {name} M={M} "
                                  f"layer {li} {xin.dtype}", xin.dtype, M, K,
                                  N, False)
                    worse(worst, r)
                    worse(errs, r)
            check(bool(torch.equal(
                qm.quant_matmul_stacked(x, leaf.q, leaf.s, L // 2),
                qm.quant_matmul_stacked(x, leaf.q, leaf.s, L // 2))),
                f"B2 {name} M={M}: two runs bit-equal")
            wb = [leaf.layer(li).dequantize(torch.bfloat16)
                  for li in range(8)]
            ms = graph_ms(torch, lambda i: qm.quant_matmul_stacked(
                x, leaf.q, leaf.s, i % L), L)
            plain = graph_ms(torch, lambda i: qm.quant_matmul_stacked_ref(
                x, leaf.q, leaf.s, i % L), 8, replays=2)
            lib = graph_ms(torch, lambda i: torch.matmul(x, wb[i % 8]), 8)
            del wb
            nbytes = K * N + 2 * N + 2 * M * K + 4 * M * N
            b_ms, b_by = bound(nbytes, 2 * M * K * N)
            plan = qm.plan(x.dtype, M, K, N, False)
            detail.append({"proj": name, "M": M, "K": K, "N": N, "ms": ms,
                           "plain_ms": plain, "library_ms": lib,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "gb_per_s": gbs(nbytes, ms),
                           "splits": plan.splits, "k_len": plan.k_len,
                           **worst})
            log(f"kernels: B2 {name:5s} M={M:3d} K={K} N={N}: "
                f"{ms * 1e3:.1f} us = {gbs(nbytes, ms):.0f} GB/s (bound "
                f"{b_ms * 1e3:.1f} us by {b_by}, plain {plain * 1e3:.1f}, "
                f"library {lib * 1e3:.1f}; {plan.splits} x k_len "
                f"{plan.k_len}; rel L2 {worst['rel_l2']:.1e}, worst tile "
                f"{worst['tile_rel_l2']:.1e}, bf16 and fp32 x)")
    for M in QMM_MS:
        six = [d for d in detail if d["M"] == M]
        log(f"kernels: B2 six projections M={M}: "
            f"{sum(d['ms'] for d in six) * 1e3:.1f} us (bound "
            f"{sum(d['bound_ms'] for d in six) * 1e3:.1f}, plain "
            f"{sum(d['plain_ms'] for d in six) * 1e3:.1f}, library "
            f"{sum(d['library_ms'] for d in six) * 1e3:.1f})")
    dec = [d for d in detail if d["M"] == 8]
    out.append({
        "name": "quant_matmul_stacked", "route": "cuda",
        "source": "instaslice_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "instaslice_tpu/ops/quant_matmul.py:138",
        "work": "the six projections of one layer at decode M=8",
        "max_abs_err": errs["max_abs"], "rel_l2_err": errs["rel_l2"],
        "tile_rel_l2_err": errs["tile_rel_l2"], "tol": QMM_TOL_TEXT,
        "ms": sum(d["ms"] for d in dec),
        "plain_ms": sum(d["plain_ms"] for d in dec),
        "bound_ms": sum(d["bound_ms"] for d in dec), "bound_by": "bytes",
        "library_ms": sum(d["library_ms"] for d in dec),
        "detail": detail,
    })

    # ---- B3 quant_matmul_t: the unembedding at M = 1 ... 256
    emb = qp["embed"]
    eb = emb.dequantize(torch.bfloat16)
    detail = []
    errs = {}
    for M in QMM_MS:
        x32 = torch.randn((M, D), generator=gen, device=dev)
        x = x32.to(torch.bfloat16)
        worst = {}
        for xin in (x, x32):
            got = qm.quant_matmul_t(xin, emb.q, emb.s)
            want = qm.quant_matmul_t_ref(xin, emb.q, emb.s)
            r = check_qmm(torch, qm, got, want, f"B3 M={M} {xin.dtype}",
                          xin.dtype, M, D, V, True)
            worse(worst, r)
            worse(errs, r)
        check(bool(torch.equal(qm.quant_matmul_t(x, emb.q, emb.s),
                               qm.quant_matmul_t(x, emb.q, emb.s))),
              f"B3 M={M}: two runs bit-equal")
        ms = graph_ms(torch, lambda i: qm.quant_matmul_t(x, emb.q, emb.s), 16)
        plain = graph_ms(torch, lambda i: qm.quant_matmul_t_ref(
            x, emb.q, emb.s), 4, replays=2)
        lib = graph_ms(torch, lambda i: torch.matmul(x, eb.t()), 16)
        nbytes = V * D + 2 * V + 2 * M * D + 4 * M * V
        b_ms, b_by = bound(nbytes, 2 * M * D * V)
        detail.append({"M": M, "K": D, "N": V, "ms": ms, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
                       "gb_per_s": gbs(nbytes, ms), **worst})
        log(f"kernels: B3 unembed M={M:3d}: {ms * 1e3:.1f} us = "
            f"{gbs(nbytes, ms):.0f} GB/s (bound {b_ms * 1e3:.1f} us by "
            f"{b_by}, plain {plain * 1e3:.1f}, library {lib * 1e3:.1f}; "
            f"rel L2 {worst['rel_l2']:.1e}, worst tile "
            f"{worst['tile_rel_l2']:.1e}, bf16 and fp32 x)")
    del eb
    dec = next(d for d in detail if d["M"] == 8)
    out.append({
        "name": "quant_matmul_t", "route": "cuda",
        "source": "instaslice_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "instaslice_tpu/ops/quant_matmul.py:89",
        "work": "the unembedding (32000 x 4096 int8) at decode M=8",
        "max_abs_err": errs["max_abs"], "rel_l2_err": errs["rel_l2"],
        "tile_rel_l2_err": errs["tile_rel_l2"], "tol": QMM_TOL_TEXT,
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"], "detail": detail,
    })

    # ---- B4 quant_matmul: the same kernels on an unstacked (K, N) weight
    wq = qp["blocks"]["wq"]
    K, N = wq.q.shape[1:]
    errs = {}
    for M in QMM_MS:
        x32 = torch.randn((M, D), generator=gen, device=dev)
        for xin in (x32.to(torch.bfloat16), x32):
            got = qm.quant_matmul(xin, wq.q[3], wq.s[3])
            want = qm.quant_matmul_ref(xin, wq.q[3], wq.s[3])
            worse(errs, check_qmm(torch, qm, got, want, f"B4 M={M} "
                                  f"{xin.dtype}", xin.dtype, M, K, N, False))
    x = torch.randn((8, D), generator=gen, device=dev).to(torch.bfloat16)
    wb = [wq.layer(li).dequantize(torch.bfloat16) for li in range(8)]
    ms = graph_ms(torch, lambda i: qm.quant_matmul(
        x, wq.q[i % L], wq.s[i % L]), L)
    plain = graph_ms(torch, lambda i: qm.quant_matmul_ref(
        x, wq.q[i % L], wq.s[i % L]), 8, replays=2)
    lib = graph_ms(torch, lambda i: torch.matmul(x, wb[i % 8]), 8)
    del wb
    nbytes = K * N + 2 * N + 2 * 8 * K + 4 * 8 * N
    b_ms, b_by = bound(nbytes, 2 * 8 * K * N)
    log(f"kernels: B4 wq-shaped M=8: {ms * 1e3:.1f} us = "
        f"{gbs(nbytes, ms):.0f} GB/s (bound {b_ms * 1e3:.1f} us, plain "
        f"{plain * 1e3:.1f}, library {lib * 1e3:.1f})")
    out.append({
        "name": "quant_matmul", "route": "cuda",
        "source": "instaslice_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "instaslice_tpu/ops/quant_matmul.py:66",
        "work": "one unstacked 4096 x 4096 int8 weight at M=8 (not on "
                "the main path: the stacked route serves it)",
        "max_abs_err": errs["max_abs"], "rel_l2_err": errs["rel_l2"],
        "tile_rel_l2_err": errs["tile_rel_l2"], "tol": QMM_TOL_TEXT,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib, "gb_per_s": gbs(nbytes, ms),
    })

    out.insert(0, check_b1(torch, cfg, fd, gen, L))
    return out


def check_b1(torch, cfg, fd, gen, L: int) -> dict:
    """B1 against its plain version at batch 8 over a 1024-position cache
    at three shapes (the first, timed since B1 was first ported, stays
    the entry's top level): staggered depths, full depth, and the engine's
    prompt lengths (the longest cut to its bucket) at the engine's
    s_attn 256; timed at each; returns its ``kernels`` entry."""
    from instaslice_tpu_torch.models.lm import init_cache

    dev = torch.device("cuda")
    B, S, Hkv, hd = 8, 1024, cfg.kv_heads, cfg.head_dim
    G = cfg.n_heads // Hkv
    cache = init_cache(cfg, B, S, quant=True, device=dev)
    for key in ("k", "v"):
        cache[key].copy_(torch.randint(-127, 128, cache[key].shape,
                                       generator=gen, device=dev,
                                       dtype=torch.int8))
    for key in ("k_s", "v_s"):
        cache[key].uniform_(0.005, 0.02, generator=gen)
    q4 = torch.randn((B, Hkv, G, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    args = (cache["k"], cache["k_s"], cache["v"], cache["v_s"])
    # library yardstick: SDPA over the bf16-dequantized prefix, K/V
    # repeated to the query heads outside the timing
    qs = q4.reshape(B, Hkv * G, 1, hd)
    kv_deq = []
    for li in range(8):
        k = (cache["k"][li].float() * cache["k_s"][li, ..., None]).to(
            torch.bfloat16).repeat_interleave(G, dim=1)
        v = (cache["v"][li].float() * cache["v_s"][li, ..., None]).to(
            torch.bfloat16).repeat_interleave(G, dim=1)
        kv_deq.append((k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = (("staggered", [0, 1, 17, 128, 300, 511, 777, 1000], S),
              ("full depth", [S] * B, S),
              ("engine", [256, 200, 129, 100, 64, 33, 17, 5], 256))
    detail = []
    e_max = 0.0
    for label, lens_l, s_attn in shapes:
        lengths = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        empty = [b for b, n in enumerate(lens_l) if n == 0]
        rows = [b for b in range(B) if b not in empty]
        worst = 0.0                 # largest error over max|plain|
        for li in (0, L - 1):
            o, m, l_ = fd.quant_decode_attention(q4, *args, lengths, li,
                                                 s_attn)
            ro, rm, rl = fd.quant_decode_attention_ref(q4, *args, lengths,
                                                       li, s_attn)
            # fp32 both: softmax order and splits differ; 1e-5 of the
            # scale on the rows with a prefix, exact conventions on the
            # empty row
            for got, want, what in ((o, ro, "acc"), (m, rm, "m"),
                                    (l_, rl, "l")):
                e = _err(torch, got[rows], want[rows])
                scale = float(want[rows].abs().max())
                worst = max(worst, e / scale)
                tol = 1e-5 * scale + 1e-5
                check(e <= tol, f"B1 {label} layer {li} {what}: err {e} > "
                      f"{tol}")
                for b in empty:
                    check(bool(torch.equal(got[b], want[b])),
                          f"B1 {label} layer {li} {what}: empty-row "
                          "convention")
            k_loc = torch.randn((B, Hkv, hd), generator=gen, device=dev)
            v_loc = torch.randn((B, Hkv, hd), generator=gen, device=dev)
            lg = torch.einsum("bkgd,bkd->bkg", q4.float() * hd ** -0.5,
                              k_loc)
            e = _err(torch, fd.merge_local(o, m, l_, lg, v_loc),
                     fd.merge_local(ro, rm, rl, lg, v_loc))
            check(e <= 1e-5, f"B1 {label} layer {li} merged: err {e} > 1e-5")
            e_max = max(e_max, e)
            # the splits combine in a fixed order: reruns bit-equal
            o2, m2, l2 = fd.quant_decode_attention(q4, *args, lengths, li,
                                                   s_attn)
            check(bool(torch.equal(o, o2) and torch.equal(m, m2)
                       and torch.equal(l_, l2)),
                  f"B1 {label} layer {li}: two runs bit-equal")
        ms = graph_ms(torch, lambda i: fd.quant_decode_attention(
            q4, *args, lengths, i % L, s_attn), L)
        plain = graph_ms(torch, lambda i: fd.quant_decode_attention_ref(
            q4, *args, lengths, i % L, s_attn), 8, replays=2)
        pos = torch.arange(s_attn, device=dev)[None, :]
        mask = ((pos < lengths[:, None]) | (pos == 0))[:, None, None, :]
        lib = graph_ms(torch, lambda i: sdpa(
            qs, kv_deq[i % 8][0][:, :, :s_attn],
            kv_deq[i % 8][1][:, :, :s_attn], attn_mask=mask), 8)
        live = sum(min(n, s_attn) for n in lens_l)
        nbytes = (live * Hkv * (2 * hd + 2 * 4) + B * Hkv * G * hd * 2
                  + 4 * B + B * Hkv * G * (hd + 2) * 4)
        b_ms, b_by = bound(nbytes, live * Hkv * G * 4 * hd)
        P, n_split = fd.split_plan(B, Hkv, s_attn)
        detail.append({"shape": label, "lengths": lens_l, "s_attn": s_attn,
                       "P": P, "n_split": n_split, "ms": ms,
                       "plain_ms": plain, "library_ms": lib,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "gb_per_s": gbs(nbytes, ms)})
        log(f"kernels: B1 decode attention B=8 {label} s_attn={s_attn} "
            f"lengths {lens_l} (P {P}, {n_split} splits): {ms * 1e3:.1f} us"
            f" = {gbs(nbytes, ms):.0f} GB/s (bound {b_ms * 1e3:.1f} us, "
            f"plain {plain * 1e3:.1f}, library {lib * 1e3:.1f}); worst "
            f"error {worst:.2e} of max|plain|, merged {e_max:.2e}")
    del kv_deq, cache
    torch.cuda.empty_cache()
    top = detail[0]
    return {
        "name": "quant_decode_attention", "route": "cuda",
        "source": "instaslice_tpu_torch/csrc/flash_decode.cu",
        "replaces": "instaslice_tpu/ops/flash_decode.py:59",
        "work": f"one layer, B=8 Hkv=8 G=4 hd=128, lengths "
                f"{top['lengths']}, s_attn {top['s_attn']}",
        "max_abs_err": e_max, "tol": "1e-5 (merged output)",
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "detail": detail,
    }


def phase_engine(torch, cfg, qp, ops) -> dict:
    """The main path: generate on the 7B int8 engine, launches counted
    across exactly that call."""
    from instaslice_tpu_torch.models.lm import TpuLM
    from instaslice_tpu_torch.serving import ServingEngine

    eng = ServingEngine(TpuLM(cfg), qp, max_batch=8, max_len=1024,
                        prefill_len=128, kv_quant=True, device="cuda")
    gen = torch.Generator().manual_seed(11)
    plens = [300, 200, 129, 100, 64, 33, 17, 5]
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen)
               .tolist() for n in plens]
    max_new = 32
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    eng.decode_steps = eng.prefill_dispatches = 0
    t0 = time.perf_counter()
    results = eng.generate(prompts, max_new_tokens=max_new, block_size=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps, chunks = eng.decode_steps, eng.prefill_dispatches
    log(f"engine: generate 8 prompts {plens} x {max_new} tokens in "
        f"{wall:.2f} s: {chunks} prefill chunks, {steps} decode steps, "
        f"launches {counts}")
    check(len(results) == 8, "one result per prompt")
    for r in results:
        check(len(r.tokens) == max_new, f"rid {r.request_id}: "
              f"{len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              "tokens in range")
        check(all(lp <= 0.0 for lp in r.logprobs), "logprobs <= 0")
    # every block still held is the radix prefix cache's (the prompts
    # it learned from these completions); none is leaked
    check(eng.kv.used_blocks() == eng.radix.pool_blocks(),
          "no leaked KV blocks")
    L = cfg.n_layers
    forwards = steps + chunks              # every chunk has M=128 <= 256
    check(chunks == sum(-(-n // 128) for n in plens), "prefill chunks")
    check(counts["quant_decode_attention"] == L * steps > 0,
          "B1 launches = layers x decode steps")
    check(counts["quant_matmul_stacked"] == 6 * L * forwards > 0,
          "B2 launches = 6 x layers x forwards")
    check(counts["quant_matmul_t"] == forwards > 0,
          "B3 launches = forwards")
    check(counts["quant_matmul"] == 0, "B4 is not on this path")
    check(all(counts[n] == 0 for n in FLASH), "B5-B7 are not on this path")

    # warm path TTFT: one 128-token prompt through first sampled token
    t0 = time.perf_counter()
    eng.add_request(list(range(2, 130)))
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    tok_s = eng.throughput(n_steps=64)
    step_ms = 8 / tok_s * 1e3
    log(f"engine: TTFT {ttft * 1e3:.1f} ms (128-token prompt), decode "
        f"{tok_s:.1f} tok/s at batch 8 ({step_ms:.2f} ms/step)")
    for _ in range(8 - len(eng.slots)):
        eng.add_request([1, 2, 3])
    eng.decode_block(1)
    busy = device_busy(torch, lambda: eng.decode_block(8), 8)
    if busy is not None:
        log(f"engine: device busy {busy['ms_per_step']:.2f} ms per decode "
            f"step = {busy['ms_per_step'] / step_ms:.1%} of the step; by "
            f"kernel (ms/step): {busy['top']}")
    # one 128-token prefill chunk (M = 128 through B2 and B3) on a freed slot
    eng.evict_slot(max(eng.slots))
    chunk = device_busy(torch, lambda: eng.add_request(list(range(2, 130))),
                        1)
    if chunk is not None:
        log(f"engine: device busy {chunk['ms_per_step']:.2f} ms per "
            f"128-token prefill chunk; by kernel (ms): {chunk['top']}")
    return {"counts": counts, "decode_steps": steps, "prefill_chunks": chunks,
            "generate_s": wall, "ttft_ms": ttft * 1e3, "decode_tok_s": tok_s,
            "step_ms": step_ms, "device_busy": busy, "chunk_busy": chunk}


def device_busy(torch, run, n_steps: int):
    """Device time per step, by kernel, from a torch.profiler window over
    ``run()`` (``n_steps`` steps; None when the profiler reports no
    device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # kernels only: a user annotation (the optimizer's record_function
    # range) spans kernels that are counted on their own
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total
            and not getattr(e, "is_user_annotation", False)]
    if not rows:
        return None
    rows.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in rows) / 1e3 / n_steps
    top = {e.key[:48]: round(e.self_device_time_total / 1e3 / n_steps, 3)
           for e in rows[:8]}
    by_class = {}
    for e in rows:
        name = next((c for c, pats in KERNEL_CLASSES
                     if any(p in e.key.lower() for p in pats)), "other")
        by_class[name] = round(by_class.get(name, 0.0)
                               + e.self_device_time_total / 1e3 / n_steps, 3)
    return {"ms_per_step": total, "top": top, "by_class": by_class}


def phase_cut(torch, cfg, qp) -> dict:
    """2 layers of the same weights: CPU plain versions vs card kernels,
    one prefill and 4 greedy decode steps (the CPU's tokens fed to
    both)."""
    from instaslice_tpu_torch.models.lm import apply_with_cache, init_cache
    from instaslice_tpu_torch.models.quant import QuantizedTensor

    cut = dataclasses.replace(cfg, n_layers=2)

    def take(leaf, dev):
        if isinstance(leaf, QuantizedTensor):
            return QuantizedTensor(leaf.q[:2].to(dev), leaf.s[:2].to(dev))
        return leaf[:2].to(dev)

    trees = {}
    for dev in ("cpu", "cuda"):
        trees[dev] = {
            "embed": qp["embed"].to(dev),
            "ln_f": {"scale": qp["ln_f"]["scale"].to(dev)},
            "blocks": {k: ({"scale": take(v["scale"], dev)}
                           if isinstance(v, dict) else take(v, dev))
                       for k, v in qp["blocks"].items()},
        }
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(1, cfg.vocab_size, (2, 16), generator=gen)
    lens = torch.zeros(2, dtype=torch.int32)
    caches = {d: init_cache(cut, 2, 64, quant=True, device=d)
              for d in trees}
    worst = 0.0
    for step in range(5):
        lg = {}
        for d in trees:
            out, _ = apply_with_cache(cut, trees[d], toks.to(d), caches[d],
                                      lens.to(d))
            lg[d] = out[:, -1].float().cpu()
        ref, got = lg["cpu"], lg["cuda"]
        check(bool(torch.isfinite(got).all()), "finite logits")
        # bf16 activations, fp32 sums in another order on each side: the
        # measured gap is ~5e-4 of max|logit| (H100); 5e-3 leaves 10x
        tol = 5e-3 * float(ref.abs().max())
        err = float((got - ref).abs().max())
        check(err <= tol, f"cut step {step}: logits err {err} > {tol}")
        worst = max(worst, err / float(ref.abs().max()))
        want_tok, got_tok = ref.argmax(-1), got.argmax(-1)
        check(bool((want_tok == got_tok).all()), f"cut step {step}: greedy "
              f"tokens {got_tok.tolist()} != {want_tok.tolist()}")
        lens = lens + toks.shape[1]
        toks = want_tok[:, None]
    log(f"cut: 2 layers, prefill 16 + 4 decode steps: max logit error "
        f"{worst:.2e} of max|logit|, greedy tokens equal")
    return {"max_rel_err": worst}


#: the port server's own flags for the 7B int8 configuration of phase 3
SERVE_FLAGS = ("--quantize --vocab-size 32000 --d-model 4096 --n-heads 32 "
               "--n-kv-heads 8 --n-layers 32 --d-ff 20480 --max-batch 8 "
               "--max-len 1024 --prefill-len 128 --host 127.0.0.1 --port 0")
#: prompt lengths of the 8 concurrent completions; every other one
#: streams, all ask for logprobs
SERVE_PLENS = (600, 512, 400, 300, 257, 200, 129, 64)
SERVE_NEW = 32
#: a served completion against the same prompt generated again on the
#: same engine, one admission at a time and the radix cache emptied:
#: the greedy tokens are equal, and each token's logprob within this
#: (bf16 logits; the server's wide batched prefill dequantizes into
#: torch.matmul, a lone chunk takes B2)
SERVE_LOGPROB_TOL = 5e-2
#: the HTTP radix hit's prefill chunk against the same chunk cold: rel L2
#: of the chunk's logits at its real rows, at most this (its stripes come
#: from the wide batched prefill's torch.matmul, the cold chunks' from
#: B2, so int8 KV rounds apart: 1.3e-2 measured on the H100); the same
#: rows prefilled with no prefix (the control, 0.84 there) must sit at
#: least 5x above it. The engine-level hit reads stripes of the cold run
#: itself and must give the cold chunk's logits bit for bit
SERVE_CHUNK_TOL = 5e-2


def http_json(url: str, body=None, timeout: float = 600.0):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def http_stream(url: str, body: dict, timeout: float = 600.0) -> dict:
    """POST a streamed completion; its tokens, logprobs, finish reason,
    and the host clock of the first and last token chunks."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    toks, lps, reason, t_first, t_last = [], [], None, None, None
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            data = line[len("data: "):]
            if data == "[DONE]":
                break
            ev = json.loads(data)
            check("error" not in ev, f"stream error {ev}")
            ch = ev["choices"][0]
            if ch["token_ids"]:
                now = time.perf_counter()
                t_first = t_first or now
                t_last = now
                toks += ch["token_ids"]
                lps += ch.get("logprobs") or []
            if ch["finish_reason"] is not None:
                reason = ch["finish_reason"]
    return {"token_ids": toks, "logprobs": lps, "finish_reason": reason,
            "t_first": t_first, "t_last": t_last}


def phase_serve(torch, ops) -> dict:
    """The server's main path: the port's own CLI wiring
    (``api_server.build_parser`` + ``build_engine``) at the 7B int8
    configuration, an in-process ``ApiServer`` on port 0 (so the launch
    counters can be read) driven over HTTP: 8 concurrent greedy
    completions, then a prompt repeating one's first 256 tokens (a radix
    hit). With the server stopped, the same engine answers each prompt
    again with the radix cache emptied (cold), then the hit prompt's tail
    alone (the control, which also overwrites the slot's first
    positions), then the hit prompt once more as an engine-level hit:
    tokens, logprobs and the logits of the prefill chunk after the
    matched head are held against the cold run's; the control shows the
    comparison can fail."""
    import threading
    from collections import Counter

    from instaslice_tpu_torch.serving import api_server

    t0 = time.perf_counter()
    args = api_server.build_parser().parse_args(SERVE_FLAGS.split())
    eng = api_server.build_engine(args)
    srv = api_server.ApiServer(eng, host=args.host, port=args.port).start()
    setup_s = time.perf_counter() - t0
    url = srv.url
    V, L = args.vocab_size, args.n_layers
    # the rows of every forward the engine runs: B2 and B3 take the
    # forwards of at most 256 rows (decode steps, single-slot chunks,
    # 2-row batched chunks); wider batched prefills dequantize into
    # torch.matmul, as the reference does at M > 256
    rows = []
    forward = eng._forward
    #: (tokens, lengths, logits) of each prefill forward while set
    chunks_seen = None

    def counted_forward(tokens, cache, lengths, *a, **kw):
        rows.append(tokens.numel())
        out = forward(tokens, cache, lengths, *a, **kw)
        if chunks_seen is not None and tokens.shape[1] > 1:
            chunks_seen.append((tokens.cpu(), lengths.cpu(),
                                out[0].float()))
        return out

    eng._forward = counted_forward
    try:
        for _ in range(100):
            try:
                if http_json(url + "/readyz", timeout=10)["status"] == "ok":
                    break
            except OSError:
                pass
            time.sleep(0.1)
        else:
            raise RuntimeError("server never became ready")
        gen = torch.Generator().manual_seed(17)
        prompts = [torch.randint(1, V, (n,), generator=gen).tolist()
                   for n in SERVE_PLENS]
        results, errors = [None] * len(prompts), []

        def one(i):
            body = {"prompt": prompts[i], "max_tokens": SERVE_NEW,
                    "temperature": 0.0, "logprobs": True}
            t_send = time.perf_counter()
            try:
                if i % 2 == 0:
                    r = http_stream(url + "/v1/completions",
                                    dict(body, stream=True))
                else:
                    ch = http_json(url + "/v1/completions",
                                   body)["choices"][0]
                    r = dict(ch, t_first=None, t_last=None)
                r["t_send"], r["t_done"] = t_send, time.perf_counter()
                results[i] = r
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"request {i}: {e!r}")

        st0 = http_json(url + "/v1/stats")
        steps0, chunks0, rows0 = (eng.decode_steps, eng.prefill_dispatches,
                                  len(rows))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        steps = eng.decode_steps - steps0
        chunks = eng.prefill_dispatches - chunks0
        kernel_fw = sum(r <= 256 for r in rows[rows0:])
        st1 = http_json(url + "/v1/stats")
        check(not errors, f"serve: {errors}")
        for i, r in enumerate(results):
            toks = r["token_ids"]
            check(len(toks) == SERVE_NEW, f"request {i}: {len(toks)} tokens")
            check(all(0 <= t < V for t in toks), "tokens in range")
            check(r["finish_reason"] == "max_new_tokens",
                  f"request {i}: finish {r['finish_reason']}")
            lps = r["logprobs"]
            check(len(lps) == SERVE_NEW and all(lp <= 0.0 for lp in lps),
                  f"request {i}: logprobs 1:1 with tokens, all <= 0")
        log(f"serve: 8 concurrent completions {list(SERVE_PLENS)} x "
            f"{SERVE_NEW} tokens over HTTP in {wall:.2f} s: {chunks} prefill "
            f"forwards (rows: {sorted(Counter(rows[rows0:]).items())}), "
            f"{steps} "
            f"decode steps, launches {counts}")
        check(counts["quant_decode_attention"] == L * steps > 0,
              "B1 launches = layers x decode steps")
        check(counts["quant_matmul_stacked"] == 6 * L * kernel_fw > 0,
              "B2 launches = 6 x layers x forwards of <= 256 rows")
        check(counts["quant_matmul_t"] == kernel_fw > 0,
              "B3 launches = forwards of <= 256 rows")
        check(counts["quant_matmul"] == 0, "B4 is not on this path")
        check(all(counts[n] == 0 for n in FLASH),
              "B5-B7 are not on this path")
        gen_tok = st1["tokens_generated"] - st0["tokens_generated"]
        ttft = sorted((r["t_first"] - r["t_send"]) * 1e3
                      for r in results if r["t_first"] is not None)
        per_req = [round((r["t_done"] - r["t_send"]) * 1e3, 1)
                   for r in results]
        decode_rates = [(SERVE_NEW - 1) / (r["t_last"] - r["t_first"])
                        for r in results if r["t_first"] is not None
                        and r["t_last"] > r["t_first"]]

        # a radix hit: the first two 128-token granules of the longest
        # prompt, then 100 new tokens
        head = 2 * args.prefill_len
        tail = torch.randint(1, V, (100,), generator=gen).tolist()
        hit_prompt = prompts[0][:head] + tail

        def chunk_logits(offset):
            """Logits of the real rows of the prefill chunk that holds
            the tail at ``offset``, from the forwards just seen."""
            for toks, lens, lg in chunks_seen:
                for r in range(toks.shape[0]):
                    if (int(lens[r]) == offset
                            and toks[r, :len(tail)].tolist() == tail):
                        return lg[r, :len(tail)]
            raise RuntimeError("no prefill chunk at the tail's offset")

        def run(send, offset=head):
            nonlocal chunks_seen
            steps0, chunks0 = eng.decode_steps, eng.prefill_dispatches
            chunks_seen = []
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            r = send()
            torch.cuda.synchronize()
            r.update(ms=(time.perf_counter() - t0) * 1e3,
                     b2=ops.launch_counts()["quant_matmul_stacked"],
                     chunks=eng.prefill_dispatches - chunks0,
                     steps=eng.decode_steps - steps0,
                     logits=chunk_logits(offset))
            if r.get("t_first") is not None:
                r["ttft_ms"] = (r["t_first"] - t0) * 1e3
            chunks_seen = None
            return r

        def engine_run(prompt):
            res = eng.generate([prompt], 16)[0]
            return {"token_ids": res.tokens, "logprobs": res.logprobs}

        before = http_json(url + "/v1/stats")["radix"]
        hit = run(lambda: http_stream(url + "/v1/completions", {
            "prompt": hit_prompt, "max_tokens": 16, "temperature": 0.0,
            "logprobs": True, "stream": True}))
        st = http_json(url + "/v1/stats")
        hit.update(hits=st["radix"]["hits"] - before["hits"],
                   saved=st["radix"]["tokens_saved"] - before["tokens_saved"])
        check(st["radix"]["hits"] >= 1
              and st["radix"]["tokens_saved"] >= head,
              "/v1/stats shows the radix hit")
        check(st["live_slots"] == 0 and st["parked"] == 0, "quiesced")
        check(st["kv"]["used"] == st["radix"]["blocks"],
              f"no leaked KV blocks: kv {st['kv']}, radix {st['radix']}")
        route = st["engine"]["attention_route"]
        check(route == "B1", f"decode attention route {route!r}")
    finally:
        srv.stop()

    # the server is stopped: the engine is the main thread's now. Every
    # served prompt again, the radix cache emptied first (the prompts
    # share no head), one admission at a time
    eng.radix.reclaim(eng.kv.total_blocks)
    again = eng.generate(prompts, SERVE_NEW)
    served_lp = 0.0
    for i, (r, g) in enumerate(zip(results, again)):
        check(r["token_ids"] == g.tokens, f"request {i}: served tokens "
              f"{r['token_ids']} != engine {g.tokens}")
        served_lp = max(served_lp, max(abs(a - b) for a, b in
                                       zip(r["logprobs"], g.logprobs)))
    check(served_lp <= SERVE_LOGPROB_TOL, f"served logprobs differ from "
          f"the engine's by {served_lp} > {SERVE_LOGPROB_TOL}")
    eng.radix.reclaim(eng.kv.total_blocks)
    cold = run(lambda: engine_run(hit_prompt))
    control = run(lambda: engine_run(tail), offset=0)["logits"]
    hit_eng = run(lambda: engine_run(hit_prompt))

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    lp_diff = max(abs(a - b) for a, b in zip(hit["logprobs"],
                                              cold["logprobs"]))
    errs = {"hit": rel(hit.pop("logits"), cold["logits"]),
            "engine_hit": rel(hit_eng.pop("logits"), cold["logits"]),
            "control": rel(control, cold.pop("logits"))}
    for r in (hit, cold, hit_eng):
        for key in ("t_first", "t_last", "logprobs"):
            r.pop(key, None)
    log(f"serve: radix hit {hit}; cold {cold}; engine hit {hit_eng}; "
        f"largest logprob difference hit vs cold {lp_diff:.3g}, served vs "
        f"engine {served_lp:.3g}; chunk logits rel L2 vs cold {errs}")
    check(hit["hits"] == 1 and hit["saved"] == head,
          f"the repeated {head}-token head is a radix hit")
    for r in (hit, cold, hit_eng):
        check(r["b2"] == 6 * L * (r["chunks"] + r["steps"]),
              "B2 launches = 192 per forward")
    for r in (hit, hit_eng):
        check(cold["chunks"] - r["chunks"] == 2,
              "a hit skips its two matched chunks")
        check(cold["b2"] - r["b2"]
              == 6 * L * (2 + cold["steps"] - r["steps"]),
              "a hit launches B2 192 fewer times per matched chunk")
        check(r["token_ids"] == cold["token_ids"],
              f"hit tokens {r['token_ids']} != cold {cold['token_ids']}")
    check(lp_diff <= SERVE_LOGPROB_TOL,
          f"hit vs cold logprobs differ by {lp_diff}")
    check(errs["hit"] <= SERVE_CHUNK_TOL and errs["engine_hit"] == 0.0,
          f"a hit's chunk logits differ from cold: {errs}")
    check(errs["control"] >= 5 * SERVE_CHUNK_TOL,
          f"the control chunk (no prefix) is as close as a hit: {errs}")
    out = {
        "setup_s": setup_s, "wall_s": wall, "counts": counts,
        "decode_steps": steps, "prefill_chunks": chunks,
        "tokens": gen_tok, "tok_s": gen_tok / wall,
        "ttft_ms_p50": ttft[len(ttft) // 2], "ttft_ms": ttft,
        "request_ms": per_req,
        "decode_tok_s_per_stream": [round(x, 1) for x in decode_rates],
        "hit_http_ms": hit["ms"], "hit_http_ttft_ms": hit["ttft_ms"],
        "hit_engine_ms": hit_eng["ms"], "cold_engine_ms": cold["ms"],
        "hit_cold_logprob_diff": lp_diff, "served_logprob_diff": served_lp,
        "chunk_rel_l2": errs,
        "radix": st["radix"], "kv": st["kv"], "engine": st["engine"],
    }
    log(f"serve: {gen_tok} tokens in {wall:.2f} s = {out['tok_s']:.1f} "
        f"tok/s over HTTP, one burst of 8 requests; TTFT p50 "
        f"{out['ttft_ms_p50']:.1f} ms of {len(ttft)} streams "
        f"{[round(t, 1) for t in ttft]}; per request {per_req} ms; radix "
        f"hit over HTTP TTFT {hit['ttft_ms']:.1f} ms, whole 16-token "
        f"request {hit['ms']:.1f} ms; on the engine, 16-token request hit "
        f"{hit_eng['ms']:.1f} ms vs cold {cold['ms']:.1f} ms")
    return out


def param_count(cfg) -> int:
    """Matmul parameters of a dense TpuLM (the embedding once, tied
    unembedding; norms left out): ``instaslice_tpu/bench_tpu.py:355``."""
    attn = (2 * cfg.d_model * cfg.n_heads * cfg.head_dim
            + 2 * cfg.d_model * cfg.kv_heads * cfg.head_dim)
    return (cfg.vocab_size * cfg.d_model
            + cfg.n_layers * (attn + 2 * cfg.d_model * cfg.d_ff))


def train_config(torch, n_layers: int = 16, **kw):
    """The repo's headline training configuration, 871M
    (``README.md:323``, ``instaslice_tpu/bench_tpu.py:694-791``)."""
    from instaslice_tpu_torch.models.lm import ModelConfig

    base = dict(vocab_size=32000, d_model=2048, n_heads=16,
                n_layers=n_layers, d_ff=8192, max_seq_len=2048,
                dtype=torch.bfloat16, param_dtype=torch.float32,
                remat=False)
    base.update(kw)
    return ModelConfig(**base)


def flash_errors(torch, got, want) -> dict:
    """How far a flash kernel's output lies from its plain version: the
    largest absolute difference (also over max|plain|), the relative L2
    error of the whole tensor, and the worst relative L2 error of one
    64-row tile of one (batch, head) (the unit a kernel block writes).
    Causal rows fall off roughly as 1/sqrt(position), so only the tile
    reading sees a fault confined to the small late rows."""
    got, want = got.float(), want.float()
    diff = got - want
    e = float(diff.abs().max())
    scale = float(want.abs().max())
    rel = float(diff.norm() / want.norm().clamp_min(1e-30))
    if got.dim() == 3:                   # (BH, S, hd): 64-row tiles
        BH, S, hd = got.shape
        pad = -S % 64
        d_t = torch.nn.functional.pad(diff, (0, 0, 0, pad)).reshape(
            BH, -1, 64 * hd)
        w_t = torch.nn.functional.pad(want, (0, 0, 0, pad)).reshape(
            BH, -1, 64 * hd)
        tile = float((d_t.norm(dim=-1)
                      / w_t.norm(dim=-1).clamp_min(1e-30)).max())
    else:
        tile = rel
    return {"max_abs": e, "max_rel": e / max(scale, 1e-30), "rel_l2": rel,
            "tile_rel_l2": tile}


def check_flash(r: dict, fp32: bool, what: str) -> None:
    """bf16 outputs (o, dq, dk, dv): at most about one bf16 rounding from
    the plain version at the largest element, and within FLASH_TOL in
    relative L2 over the tensor and over every 64-row tile (the kernels
    round p and ds to bf16 before their products, the plain versions
    keep fp32); fp32 lse: 1e-5 of its largest value."""
    if fp32:
        check(r["max_rel"] <= 1e-5, f"{what}: max abs err {r['max_abs']} "
              f"> 1e-5 of max|plain|")
        return
    check(r["max_rel"] <= 2 ** -7, f"{what}: max abs err {r['max_abs']} "
          f"> 2**-7 of max|plain|")
    for key in ("rel_l2", "tile_rel_l2"):
        check(r[key] <= FLASH_TOL[key], f"{what}: {key} err {r[key]} > "
              f"{FLASH_TOL[key]}")


def phase_train_kernels(torch, fa) -> list:
    """B5, B6 and B7 against their plain versions on the card, bf16, at the
    871M train step's per-layer shape (B*H 128, S 1024, hd 128) causal,
    plus S 1025 and non-causal; times at the main shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    BH, hd = 128, 128
    errs = {name: 0.0 for name in FLASH}
    worst = {name: {"rel_l2": 0.0, "tile_rel_l2": 0.0} for name in FLASH}
    main = None
    for S, causal in ((1024, True), (1025, True), (1024, False)):
        q, k, v, do = (torch.randn((BH, S, hd), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_fwd(q, k, v, causal)
        ro, rlse = fa.flash_fwd_ref(q, k, v, causal)
        delta = (do.float() * ro.float()).sum(-1)
        dq = fa.flash_bwd_dq(q, k, v, do, rlse, delta, causal)
        rdq = fa.flash_bwd_dq_ref(q, k, v, do, rlse, delta, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, rlse, delta, causal)
        rdk, rdv = fa.flash_bwd_dkv_ref(q, k, v, do, rlse, delta, causal)
        for name, pairs in (("flash_fwd", (("o", o, ro), ("lse", lse, rlse))),
                            ("flash_bwd_dq", (("dq", dq, rdq),)),
                            ("flash_bwd_dkv", (("dk", dk, rdk),
                                               ("dv", dv, rdv)))):
            for what, got, want in pairs:
                r = flash_errors(torch, got, want)
                log(f"train kernels: {name} {what} S={S} causal={causal}: "
                    f"max abs {r['max_abs']:.3e} = {r['max_rel']:.3e} of "
                    f"max|plain|, rel L2 {r['rel_l2']:.3e}, worst 64-row "
                    f"tile rel L2 {r['tile_rel_l2']:.3e}")
                check_flash(r, got.dtype == torch.float32,
                            f"{name} {what} S={S} causal={causal}")
                errs[name] = max(errs[name], r["max_abs"])
                if got.dtype == torch.bfloat16:
                    for key in worst[name]:
                        worst[name][key] = max(worst[name][key], r[key])
        # B5-B7 sum in a fixed order (no atomics): reruns bit-equal
        o2, lse2 = fa.flash_fwd(q, k, v, causal)
        check(bool(torch.equal(o, o2) and torch.equal(lse, lse2)),
              f"flash_fwd S={S} causal={causal}: two runs bit-equal")
        dq2 = fa.flash_bwd_dq(q, k, v, do, rlse, delta, causal)
        check(bool(torch.equal(dq, dq2)),
              f"flash_bwd_dq S={S} causal={causal}: two runs bit-equal")
        dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, rlse, delta, causal)
        check(bool(torch.equal(dk, dk2) and torch.equal(dv, dv2)),
              f"flash_bwd_dkv S={S} causal={causal}: two runs bit-equal")
        del o2, lse2, dq2, dk2, dv2
        if S == 1024 and causal:
            main = (q, k, v, do, rlse, delta)
        del o, lse, ro, rlse, dq, rdq, dk, dv, rdk, rdv
    q, k, v, do, lse, delta = main
    S = 1024
    pairs = S * (S + 1) // 2                  # causal (query, key) pairs
    row = BH * S * hd * 2                     # one bf16 (BH, S, hd) tensor
    stats = BH * S * 4                        # one fp32 (BH, S) row vector
    # (bytes, flops): inputs read once, outputs written once; 2 flops per
    # multiply-add over the causal pairs, 2 / 3 / 4 products per kernel
    work = {"flash_fwd": (3 * row + row + stats, 4 * pairs * hd * BH),
            "flash_bwd_dq": (4 * row + 2 * stats + row,
                             6 * pairs * hd * BH),
            "flash_bwd_dkv": (4 * row + 2 * stats + 2 * row,
                              8 * pairs * hd * BH)}
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, True),
                      lambda: fa.flash_fwd_ref(q, k, v, True)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
            lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, True)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
            lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, True)),
    }
    # library yardstick: SDPA (B, H, S, hd) with is_causal; timed, never
    # used. Its forward, and its backward as forward + backward (autograd
    # captured whole in the graph) less forward, all by graph replay,
    # twice in turns to show the spread
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shp = (8, 16, S, hd)
    qs, ks, vs = (t.reshape(shp).detach().requires_grad_(True)
                  for t in (q, k, v))
    dos = do.reshape(shp)

    def sdpa_fwd(i):
        return sdpa(qs.detach(), ks.detach(), vs.detach(), is_causal=True)

    def sdpa_fwd_bwd(i):
        return torch.autograd.grad(sdpa(qs, ks, vs, is_causal=True),
                                   (qs, ks, vs), dos)

    lib_fwds, lib_bwds = [], []
    for _ in range(2):
        f_ms = graph_ms(torch, sdpa_fwd, 8)
        fb_ms = graph_ms(torch, sdpa_fwd_bwd, 8)
        lib_fwds.append(f_ms)
        lib_bwds.append(fb_ms - f_ms)
    lib_fwd = sum(lib_fwds) / 2
    lib_bwd = sum(lib_bwds) / 2
    out = []
    line = {"flash_fwd": "73", "flash_bwd_dq": "130", "flash_bwd_dkv": "183"}
    for name, (kern, plain) in calls.items():
        ms = graph_ms(torch, lambda i: kern(), 8)
        plain_ms = graph_ms(torch, lambda i: plain(), 2, replays=2)
        b_ms, b_by = bound(*work[name])
        entry = {
            "name": name, "route": "cuda",
            "source": "instaslice_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"instaslice_tpu/ops/flash_attention.py:{line[name]}",
            "work": "one layer of the 871M train step: B*H 128, S 1024, "
                    "hd 128, bf16, causal",
            "max_abs_err": errs[name],
            "rel_l2_err": worst[name]["rel_l2"],
            "tile_rel_l2_err": worst[name]["tile_rel_l2"],
            "tol": FLASH_TOL_TEXT,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib_fwd if name == "flash_fwd" else None,
        }
        if name != "flash_fwd":
            entry["library_note"] = (
                "no PyTorch call computes this alone; SDPA's backward "
                f"(dq, dk and dv in one call) = {lib_bwd:.4f} ms (graph "
                "replay of forward + backward less the forward; two "
                f"readings {lib_bwds[0]:.4f}, {lib_bwds[1]:.4f})")
        out.append(entry)
        log(f"train kernels: {name} S=1024 causal: {ms * 1e3:.1f} us = "
            f"{work[name][1] / ms / 1e9:.0f} TFLOP/s (bound "
            f"{b_ms * 1e3:.1f} us, {b_by}; plain {plain_ms * 1e3:.1f} us)")
    log(f"train kernels: SDPA is_causal forward {lib_fwd * 1e3:.1f} us "
        f"({lib_fwds[0] * 1e3:.1f}, {lib_fwds[1] * 1e3:.1f}), backward "
        f"{lib_bwd * 1e3:.1f} us ({lib_bwds[0] * 1e3:.1f}, "
        f"{lib_bwds[1] * 1e3:.1f})")
    del main, q, k, v, do, lse, delta, qs, ks, vs, dos
    torch.cuda.empty_cache()
    return out


class plain_flash:
    """Within the block, the flash-attention autograd path takes the
    plain versions of B5-B7 (on the same card tensors) in place of the
    kernels; for the bf16 cut's reference only."""

    def __init__(self, fa):
        self.fa = fa
        self.kernels = {name: getattr(fa, name) for name in FLASH}

    def __enter__(self):
        for name in FLASH:
            setattr(self.fa, name, getattr(self.fa, f"{name}_ref"))

    def __exit__(self, *exc):
        for name, fn in self.kernels.items():
            setattr(self.fa, name, fn)


def phase_bf16_cut(torch, ops) -> dict:
    """The 871M configuration cut to 2 layers at its training precision
    (bf16 compute over fp32 masters) and batch 2 x 1024, on the card:
    loss and grads through B5-B7 against the same loss and grads with
    the plain versions of B5-B7 in their place."""
    from instaslice_tpu_torch.models.lm import TpuLM, init_params
    from instaslice_tpu_torch.models.train import leaves, loss_fn

    fa = ops.flash_attention
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = train_config(torch, n_layers=2)
    model = TpuLM(cfg)
    params = init_params(cfg, 23, device="cuda")
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(29)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1024), generator=gen,
                           device="cuda")

    def loss_grads():
        loss = loss_fn(model, params, tokens)
        return float(loss), torch.autograd.grad(loss, ps)

    before = [getattr(fa, n).launches for n in FLASH]
    l_k, g_k = loss_grads()
    launched = [getattr(fa, n).launches - b for n, b in zip(FLASH, before)]
    check(launched == [cfg.n_layers] * 3, f"bf16 cut: launches {launched}")
    with plain_flash(fa):
        l_p, g_p = loss_grads()
    check(launched == [getattr(fa, n).launches - b
                       for n, b in zip(FLASH, before)],
          "bf16 cut: the plain run launched no kernel")
    check(math.isfinite(l_k), "bf16 cut: finite loss")
    loss_err = abs(l_k - l_p) / abs(l_p)
    grad_errs = [float((a.float() - b.float()).norm()
                       / b.float().norm().clamp_min(1e-30))
                 for a, b in zip(g_k, g_p)]
    grad_err = max(grad_errs)
    log(f"bf16 cut: 2 layers B=2 S=1024, loss kernels {l_k} plain {l_p} "
        f"(rel err {loss_err:.2e}); grads rel L2 err by leaf "
        f"{[f'{e:.2e}' for e in grad_errs]}")
    check(loss_err <= BF16_CUT_TOL["loss"], f"bf16 cut loss err {loss_err}")
    check(grad_err <= BF16_CUT_TOL["grads"], f"bf16 cut grads err {grad_err}")
    del params, ps, g_k, g_p
    torch.cuda.empty_cache()
    return {"loss_rel_err": loss_err, "grad_rel_l2_err": grad_err}


def phase_train(torch, ops) -> dict:
    """The training main path: the 871M train step at batch 8 x 1024,
    launch counters zeroed just before and read just after."""
    from instaslice_tpu_torch.models.lm import TpuLM
    from instaslice_tpu_torch.models.train import make_train_step

    cfg = train_config(torch)
    B, S, n_timed = 8, 1024, 4
    # as the training CLI: the fp32-output unembedding in TF32 (exact on
    # the forward's bf16 operands; its backward rounds dlogits to TF32)
    torch.backends.cuda.matmul.allow_tf32 = True
    init_fn, step_fn = make_train_step(TpuLM(cfg), learning_rate=3e-4,
                                       grad_clip=1.0, device="cuda")
    state = init_fn(0)
    gen = torch.Generator(device="cuda").manual_seed(17)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses = []
    state, loss = step_fn(state, tokens)          # warm-up
    losses.append(float(loss))
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, loss = step_fn(state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    losses = [float(x) for x in losses]
    steps = 1 + n_timed
    log(f"train: 871M B={B} S={S}, {steps} steps, losses {losses}, "
        f"launches {counts}")
    check(all(math.isfinite(x) for x in losses), "finite losses")
    check(losses[-1] < losses[0], "the loss falls over the steps")
    for name in FLASH:
        check(counts[name] == cfg.n_layers * steps,
              f"{name} launches = layers x steps")
    check(all(counts[n] == 0 for n in counts if n not in FLASH),
          "no serving kernel on the train path")
    step_s = wall / n_timed
    n_params = param_count(cfg)
    mfu = 6 * n_params * B * S / step_s / BF16_FLOPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    busy = device_busy(torch, lambda: step_fn(state, tokens), 1)
    log(f"train: {step_s * 1e3:.1f} ms/step, {B * S / step_s:.0f} tokens/s, "
        f"MFU {mfu:.4f} (6 x {n_params / 1e6:.1f}M x {B * S} tokens over "
        f"989 TFLOP/s), peak memory {peak:.2f} GiB")
    if busy is not None:
        log(f"train: device busy {busy['ms_per_step']:.1f} ms per step = "
            f"{busy['ms_per_step'] / (step_s * 1e3):.1%}; by class "
            f"(ms/step): {busy['by_class']}; by kernel: {busy['top']}")
    del state
    torch.cuda.empty_cache()
    return {"counts": counts, "steps": steps, "losses": losses,
            "step_ms": step_s * 1e3, "tokens_per_s": B * S / step_s,
            "mfu": mfu, "params_m": n_params / 1e6, "peak_gib": peak,
            "device_busy": busy}


def phase_cli(torch, ops) -> dict:
    """``train_main`` on the card at the 871M defaults: 3 steps of rows of
    1025 tokens (--seq-len 1024), its JSON line read back."""
    import contextlib
    import io

    from instaslice_tpu_torch.cli import train_main

    buf = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_main.main(["--synthetic", "100000", "--seq-len", "1024",
                              "--global-batch", "8", "--steps", "3",
                              "--log-every", "1", "--seed", "1"])
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"cli: rc {rc} in {wall:.1f} s: {json.dumps(line)}; launches "
        f"{counts}")
    check(rc == 0, "train_main exits 0")
    check(line["steps"] == 3 and line["backend"] == "cuda", "cli JSON line")
    check(line["final_loss"] is not None
          and math.isfinite(line["final_loss"]), "cli final loss finite")
    for name in FLASH:
        check(counts[name] == 16 * 3, f"cli: {name} launches = 16 x 3")
    torch.cuda.empty_cache()
    return {"line": line, "counts": counts}


def phase_train_cut(torch) -> dict:
    """2 layers of the 871M configuration in fp32 at batch 2 x 256: loss
    and grads at the initial weights, then params after 3 AdamW steps
    (clip 1.0, warmup 2, decay 3), CPU plain versions vs card kernels."""
    from instaslice_tpu_torch.models.lm import TpuLM, init_params
    from instaslice_tpu_torch.models.train import (
        leaves,
        loss_fn,
        make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_config(torch, n_layers=2, dtype=torch.float32,
                       param_dtype=None)
    model = TpuLM(cfg)
    params = init_params(cfg, 3, device="cpu")
    gen = torch.Generator().manual_seed(19)
    batches = [torch.randint(0, cfg.vocab_size, (2, 256), generator=gen)
               for _ in range(3)]
    res = {}
    for dev in ("cpu", "cuda"):
        init_fn, step_fn = make_train_step(
            model, learning_rate=1e-3, grad_clip=1.0, warmup_steps=2,
            decay_steps=3, device=dev)
        state = init_fn(params=params)
        ps = leaves(state.params)
        loss0 = loss_fn(model, state.params, batches[0].to(dev))
        grads = [g.cpu() for g in torch.autograd.grad(loss0, ps)]
        losses = []
        for toks in batches:
            state, loss = step_fn(state, toks)
            losses.append(float(loss))
        res[dev] = (float(loss0.detach()), grads, losses,
                    [p.detach().cpu() for p in leaves(state.params)])
    (l_c, g_c, ls_c, p_c), (l_g, g_g, ls_g, p_g) = res["cpu"], res["cuda"]
    p0 = leaves(params)

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip([l_g] + ls_g, [l_c] + ls_c))
    grad_err = max(rel_l2(a, b) for a, b in zip(g_g, g_c))
    upd_err = max(rel_l2(a - w, b - w) for a, b, w in zip(p_g, p_c, p0))
    par_err = max(float((a - b).abs().max()) for a, b in zip(p_g, p_c))
    log(f"train cut: losses cpu {ls_c} card {ls_g}; loss rel err "
        f"{loss_err:.2e}, grads rel L2 err {grad_err:.2e}, param update "
        f"rel L2 err {upd_err:.2e}, param max abs err {par_err:.2e}")
    check(loss_err <= CUT_TOL["loss"], f"train cut loss err {loss_err}")
    check(grad_err <= CUT_TOL["grads"], f"train cut grads err {grad_err}")
    check(upd_err <= CUT_TOL["update"], f"train cut update err {upd_err}")
    check(par_err <= CUT_TOL["params"], f"train cut params err {par_err}")
    return {"loss_rel_err": loss_err, "grad_rel_l2_err": grad_err,
            "update_rel_l2_err": upd_err, "param_max_abs_err": par_err}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import instaslice_tpu_torch
    from instaslice_tpu_torch import ops
    from instaslice_tpu_torch.models.lm import ModelConfig, init_params
    from instaslice_tpu_torch.models.quant import quantize_params
    from instaslice_tpu_torch.ops import build

    pkg = Path(instaslice_tpu_torch.__file__).resolve().parent
    if pkg.parent != HERE:
        raise RuntimeError(f"the port at {pkg} is not beside this script")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; device 0: {torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()
    timings = {}

    t0 = time.perf_counter()
    phase_build(build)
    timings["build"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg = ModelConfig(vocab_size=32000, d_model=4096, n_heads=32,
                      n_kv_heads=8, n_layers=32, d_ff=20480,
                      max_seq_len=2048, dtype=torch.bfloat16, remat=False)
    qp = quantize_params(init_params(cfg, 0))
    torch.cuda.synchronize()
    timings["init"] = time.perf_counter() - t0
    log(f"init: 7B int8 weights in {timings['init']:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")

    t0 = time.perf_counter()
    kernels = phase_kernels(torch, cfg, qp, ops)
    timings["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = phase_engine(torch, cfg, qp, ops)
    timings["engine"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_cut(torch, cfg, qp)
    timings["cut"] = time.perf_counter() - t0
    del qp
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve = phase_serve(torch, ops)
    timings["serve"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    train_kernels = phase_train_kernels(torch, ops.flash_attention)
    timings["train_kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bf16_cut = phase_bf16_cut(torch, ops)
    timings["bf16_cut"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train = phase_train(torch, ops)
    timings["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli = phase_cli(torch, ops)
    timings["cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cut = phase_train_cut(torch)
    timings["train_cut"] = time.perf_counter() - t0
    timings["total"] = time.perf_counter() - t_all

    # launches: each kernel's count from the main path that runs it (the
    # server's completions for B1-B4, the 871M train steps for B5-B7);
    # the engine's generate is the earlier serving path
    for k in kernels:
        k["launches"] = serve["counts"][k["name"]]
        k["engine_launches"] = eng["counts"][k["name"]]
    for k in train_kernels:
        k["launches"] = train["counts"][k["name"]]
    kernels += train_kernels
    for k in kernels:
        lib = k["library_ms"]
        log(f"kernel {k['name']} ({k['work']}): launches {k['launches']}, "
            f"{k['ms'] * 1e3:.1f} us, bound {k['bound_ms'] * 1e3:.1f} us "
            f"({k['bound_by']}), plain {k['plain_ms'] * 1e3:.1f} us, "
            f"library {'-' if lib is None else f'{lib * 1e3:.1f} us'}, "
            f"max abs err {k['max_abs_err']:.2e} (tol {k['tol']})")
    log("phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in timings.items()))
    busy = eng["device_busy"]
    log(json.dumps({"card": card, "decode_tok_s_b8": eng["decode_tok_s"],
                    "step_ms": eng["step_ms"], "ttft_ms": eng["ttft_ms"],
                    "device_ms_per_step": busy and busy["ms_per_step"],
                    "device_ms_per_prefill_chunk":
                        eng["chunk_busy"] and eng["chunk_busy"]["ms_per_step"],
                    "decode_steps": eng["decode_steps"],
                    "prefill_chunks": eng["prefill_chunks"]}))
    log(json.dumps({"card": card, "serve": serve}))
    tbusy = train["device_busy"]
    log(json.dumps({"card": card, "train_step_ms": train["step_ms"],
                    "train_tokens_per_s": train["tokens_per_s"],
                    "train_mfu": train["mfu"],
                    "train_params_m": train["params_m"],
                    "train_peak_gib": train["peak_gib"],
                    "train_device_ms_per_step":
                        tbusy and tbusy["ms_per_step"],
                    "train_device_ms_by_class": tbusy and tbusy["by_class"],
                    "train_losses": train["losses"],
                    "cli": cli["line"], "bf16_cut": bf16_cut,
                    "train_cut": cut}))
    print(json.dumps({"card": card, "kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
