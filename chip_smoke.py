#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``instaslice_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py                    # every phase, one card

Phases, each timed; any failure raises and the script exits non-zero
without a result line:

1. build every kernel from ``instaslice_tpu_torch/csrc`` with ``nvcc``
   for ``sm_90a`` (one compiler per source, started together);
2. kernels: each wrapper on the card at the shapes the 7B int8 serving
   path gives it, held against its plain PyTorch version with a stated
   tolerance; per-launch device time (CUDA graph replay, CUDA events),
   the plain version's and one PyTorch library call's time, and the
   bound (bytes over 3.35 TB/s or operations over 989 TFLOP/s, from this
   run's inputs);
3. engine (the main path): the full-width 7B int8 W+KV engine
   (``vocab 32000, d_model 4096, 32 heads / 8 KV heads, 32 layers,
   d_ff 20480``, seeded random weights) serves 8 prompts through
   ``generate``; launch counters are zeroed just before and read just
   after, and must match what the path implies; then TTFT and decode
   tokens/s;
4. cut: the same weights cut to 2 layers run one prefill and 4 decode
   steps on the CPU (plain versions) and on the card (kernels); logits
   within the stated tolerance, greedy tokens equal.

Then the ``kernels`` JSON line, and last
``{"ok": true, "device": {...}}``. Without a card, or without the port
beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

BIG = ("wq", "wk", "wv", "wo", "w_in", "w_out")


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


def phase_build(build) -> None:
    t0 = time.perf_counter()
    paths = build.build()
    log(f"build: {[p.name for p in paths]} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in build.BUILD_LOGS.items():
        (build.BUILD_DIR / f"{name}.ptxas.log").write_text(text)
        regs = re.findall(r"Used (\d+) registers", text)
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             text)]
        log(f"build: {name}: {len(regs)} kernels, registers "
            f"{min(map(int, regs), default=0)}-"
            f"{max(map(int, regs), default=0)}, max spill stores "
            f"{max(spills, default=0)} bytes")


def _err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def phase_kernels(torch, cfg, qp, ops) -> list:
    """Each kernel against its plain version at the main path's shapes;
    returns the kernels' entries (launches filled in later)."""
    from instaslice_tpu_torch.models.lm import init_cache

    fd, qm = ops.flash_decode, ops.quant_matmul
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    out = []

    # ---- B2 quant_matmul_stacked: six projections, decode M=8, prefill M=128
    detail = []
    err_max = 0.0
    for M in (8, 128):
        for name in BIG:
            leaf = qp["blocks"][name]
            K, N = leaf.q.shape[1:]
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            for li in (0, L // 2, L - 1):
                got = qm.quant_matmul_stacked(x, leaf.q, leaf.s, li)
                want = qm.quant_matmul_stacked_ref(x, leaf.q, leaf.s, li)
                e = _err(torch, got, want)
                # fp32 sums of up to 20480 exact products (bf16 x int8)
                # in another order: 2e-5 of the output scale
                tol = 2e-5 * float(want.abs().max()) + 1e-6
                check(e <= tol, f"B2 {name} M={M} layer {li}: err {e} > {tol}")
                err_max = max(err_max, e)
            wb = [leaf.layer(li).dequantize(torch.bfloat16)
                  for li in range(8)]
            ms = graph_ms(torch, lambda i: qm.quant_matmul_stacked(
                x, leaf.q, leaf.s, i % L), L)
            plain = graph_ms(torch, lambda i: qm.quant_matmul_stacked_ref(
                x, leaf.q, leaf.s, i % L), 8, replays=2)
            lib = graph_ms(torch, lambda i: torch.matmul(x, wb[i % 8]), 8)
            del wb
            b_ms, b_by = bound(K * N + 2 * N + 2 * M * K + 4 * M * N,
                               2 * M * K * N)
            detail.append({"proj": name, "M": M, "K": K, "N": N, "ms": ms,
                           "plain_ms": plain, "library_ms": lib,
                           "bound_ms": b_ms, "bound_by": b_by})
            log(f"kernels: B2 {name:5s} M={M:3d} K={K} N={N}: "
                f"{ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us, plain "
                f"{plain * 1e3:.1f}, library {lib * 1e3:.1f})")
    dec = [d for d in detail if d["M"] == 8]
    out.append({
        "name": "quant_matmul_stacked", "route": "cuda",
        "source": "instaslice_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "instaslice_tpu/ops/quant_matmul.py:138",
        "work": "the six projections of one layer at decode M=8",
        "max_abs_err": err_max, "tol": "2e-5 x max|plain|",
        "ms": sum(d["ms"] for d in dec),
        "plain_ms": sum(d["plain_ms"] for d in dec),
        "bound_ms": sum(d["bound_ms"] for d in dec), "bound_by": "bytes",
        "library_ms": sum(d["library_ms"] for d in dec),
        "detail": detail,
    })

    # ---- B3 quant_matmul_t: the unembedding, decode M=8, prefill M=128
    emb = qp["embed"]
    eb = emb.dequantize(torch.bfloat16)
    detail = []
    err_max = 0.0
    for M in (8, 128):
        x = torch.randn((M, D), generator=gen, device=dev).to(torch.bfloat16)
        got = qm.quant_matmul_t(x, emb.q, emb.s)
        want = qm.quant_matmul_t_ref(x, emb.q, emb.s)
        e = _err(torch, got, want)
        tol = 2e-5 * float(want.abs().max()) + 1e-6
        check(e <= tol, f"B3 M={M}: err {e} > {tol}")
        err_max = max(err_max, e)
        ms = graph_ms(torch, lambda i: qm.quant_matmul_t(x, emb.q, emb.s), 16)
        plain = graph_ms(torch, lambda i: qm.quant_matmul_t_ref(
            x, emb.q, emb.s), 4, replays=2)
        lib = graph_ms(torch, lambda i: torch.matmul(x, eb.t()), 16)
        b_ms, b_by = bound(V * D + 2 * V + 2 * M * D + 4 * M * V,
                           2 * M * D * V)
        detail.append({"M": M, "K": D, "N": V, "ms": ms, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
                       "max_abs_err": e})
        log(f"kernels: B3 unembed M={M:3d}: {ms * 1e3:.1f} us (bound "
            f"{b_ms * 1e3:.1f} us, plain {plain * 1e3:.1f}, library "
            f"{lib * 1e3:.1f})")
    del eb
    dec = detail[0]
    out.append({
        "name": "quant_matmul_t", "route": "cuda",
        "source": "instaslice_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "instaslice_tpu/ops/quant_matmul.py:89",
        "work": "the unembedding (32000 x 4096 int8) at decode M=8",
        "max_abs_err": err_max, "tol": "2e-5 x max|plain|",
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"], "detail": detail,
    })

    # ---- B4 quant_matmul: the same kernel on an unstacked (K, N) weight
    x = torch.randn((8, D), generator=gen, device=dev).to(torch.bfloat16)
    wq = qp["blocks"]["wq"]
    K, N = wq.q.shape[1:]
    got = qm.quant_matmul(x, wq.q[3], wq.s[3])
    want = qm.quant_matmul_ref(x, wq.q[3], wq.s[3])
    e = _err(torch, got, want)
    tol = 2e-5 * float(want.abs().max()) + 1e-6
    check(e <= tol, f"B4: err {e} > {tol}")
    wb = [wq.layer(li).dequantize(torch.bfloat16) for li in range(8)]
    ms = graph_ms(torch, lambda i: qm.quant_matmul(
        x, wq.q[i % L], wq.s[i % L]), L)
    plain = graph_ms(torch, lambda i: qm.quant_matmul_ref(
        x, wq.q[i % L], wq.s[i % L]), 8, replays=2)
    lib = graph_ms(torch, lambda i: torch.matmul(x, wb[i % 8]), 8)
    del wb
    b_ms, b_by = bound(K * N + 2 * N + 2 * 8 * K + 4 * 8 * N, 2 * 8 * K * N)
    log(f"kernels: B4 wq-shaped M=8: {ms * 1e3:.1f} us (bound "
        f"{b_ms * 1e3:.1f} us, plain {plain * 1e3:.1f}, library "
        f"{lib * 1e3:.1f})")
    out.append({
        "name": "quant_matmul", "route": "cuda",
        "source": "instaslice_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "instaslice_tpu/ops/quant_matmul.py:66",
        "work": "one unstacked 4096 x 4096 int8 weight at M=8 (not on "
                "the main path: the stacked route serves it)",
        "max_abs_err": e, "tol": "2e-5 x max|plain|", "ms": ms,
        "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib,
    })

    # ---- B1 quant_decode_attention: batch 8, s_attn 1024, staggered depths
    B, S, Hkv, hd = 8, 1024, cfg.kv_heads, cfg.head_dim
    G = cfg.n_heads // Hkv
    cache = init_cache(cfg, B, S, quant=True, device=dev)
    for key in ("k", "v"):
        cache[key].copy_(torch.randint(-127, 128, cache[key].shape,
                                       generator=gen, device=dev,
                                       dtype=torch.int8))
    for key in ("k_s", "v_s"):
        cache[key].uniform_(0.005, 0.02, generator=gen)
    lens_l = [0, 1, 17, 128, 300, 511, 777, 1000]
    lengths = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    q4 = torch.randn((B, Hkv, G, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    args = (cache["k"], cache["k_s"], cache["v"], cache["v_s"], lengths)
    e_max = 0.0
    for li in (0, L - 1):
        o, m, l_ = fd.quant_decode_attention(q4, *args, li, S)
        ro, rm, rl = fd.quant_decode_attention_ref(q4, *args, li, S)
        # fp32 both: softmax order and tiling differ; 1e-5 of the scale
        # on the rows with a prefix, exact conventions on the empty row
        for got, want, what in ((o, ro, "acc"), (m, rm, "m"), (l_, rl, "l")):
            e = _err(torch, got[1:], want[1:])
            tol = 1e-5 * float(want[1:].abs().max()) + 1e-5
            check(e <= tol, f"B1 layer {li} {what}: err {e} > {tol}")
            check(bool((got[0] == want[0]).all()),
                  f"B1 layer {li} {what}: empty-row convention")
        k_loc = torch.randn((B, Hkv, hd), generator=gen, device=dev)
        v_loc = torch.randn((B, Hkv, hd), generator=gen, device=dev)
        lg = torch.einsum("bkgd,bkd->bkg", q4.float() * hd ** -0.5, k_loc)
        e = _err(torch, fd.merge_local(o, m, l_, lg, v_loc),
                 fd.merge_local(ro, rm, rl, lg, v_loc))
        check(e <= 1e-5, f"B1 layer {li} merged: err {e} > 1e-5")
        e_max = max(e_max, e)
    ms = graph_ms(torch, lambda i: fd.quant_decode_attention(
        q4, *args, i % L, S), L)
    plain = graph_ms(torch, lambda i: fd.quant_decode_attention_ref(
        q4, *args, i % L, S), 8, replays=2)
    # library yardstick: SDPA over the bf16-dequantized prefix, K/V
    # repeated to the query heads outside the timing
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None]) | (
        torch.arange(S, device=dev)[None, :] == 0)
    mask = mask[:, None, None, :]
    qs = q4.reshape(B, Hkv * G, 1, hd)
    kv_deq = []
    for li in range(8):
        k = (cache["k"][li].float() * cache["k_s"][li, ..., None]).to(
            torch.bfloat16).repeat_interleave(G, dim=1)
        v = (cache["v"][li].float() * cache["v_s"][li, ..., None]).to(
            torch.bfloat16).repeat_interleave(G, dim=1)
        kv_deq.append((k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = graph_ms(torch, lambda i: sdpa(qs, *kv_deq[i % 8],
                                         attn_mask=mask), 8)
    del kv_deq, cache
    torch.cuda.empty_cache()
    live = sum(min(n, S) for n in lens_l)
    nbytes = (live * Hkv * (2 * hd + 2 * 4) + B * Hkv * G * hd * 2 + 4 * B
              + B * Hkv * G * (hd + 2) * 4)
    b_ms, b_by = bound(nbytes, live * Hkv * G * 4 * hd)
    log(f"kernels: B1 decode attention B=8 s_attn=1024 lengths {lens_l}: "
        f"{ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us, plain "
        f"{plain * 1e3:.1f}, library {lib * 1e3:.1f})")
    out.insert(0, {
        "name": "quant_decode_attention", "route": "cuda",
        "source": "instaslice_tpu_torch/csrc/flash_decode.cu",
        "replaces": "instaslice_tpu/ops/flash_decode.py:59",
        "work": f"one layer, B=8 Hkv=8 G=4 hd=128, lengths {lens_l}",
        "max_abs_err": e_max, "tol": "1e-5 (merged output)", "ms": ms,
        "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib,
    })
    return out


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
    check(eng.kv.used_blocks() == 0, "no leaked KV blocks")
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

    # warm path TTFT: one 128-token prompt through first sampled token
    t0 = time.perf_counter()
    eng.add_request(list(range(2, 130)))
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    tok_s = eng.throughput(n_steps=64)
    step_ms = 8 / tok_s * 1e3
    log(f"engine: TTFT {ttft * 1e3:.1f} ms (128-token prompt), decode "
        f"{tok_s:.1f} tok/s at batch 8 ({step_ms:.2f} ms/step)")
    busy = device_busy(torch, eng, 8)
    if busy is not None:
        log(f"engine: device busy {busy['ms_per_step']:.2f} ms per decode "
            f"step = {busy['ms_per_step'] / step_ms:.1%} of the step; by "
            f"kernel (ms/step): {busy['top']}")
    return {"counts": counts, "decode_steps": steps, "prefill_chunks": chunks,
            "generate_s": wall, "ttft_ms": ttft * 1e3, "decode_tok_s": tok_s,
            "step_ms": step_ms, "device_busy": busy}


def device_busy(torch, eng, n_steps: int):
    """Device time per decode step, by kernel, from a torch.profiler
    window over one decode block (None when the profiler reports no
    device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(8 - len(eng.slots)):
        eng.add_request([1, 2, 3])
    eng.decode_block(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.decode_block(n_steps)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    if not rows:
        return None
    rows.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in rows) / 1e3 / n_steps
    top = {e.key[:48]: round(e.self_device_time_total / 1e3 / n_steps, 3)
           for e in rows[:6]}
    return {"ms_per_step": total, "top": top}


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
    for k in kernels:
        k["launches"] = eng["counts"][k["name"]]
        log(f"kernel {k['name']} ({k['work']}): launches {k['launches']}, "
            f"{k['ms'] * 1e3:.1f} us, bound {k['bound_ms'] * 1e3:.1f} us "
            f"({k['bound_by']}), plain {k['plain_ms'] * 1e3:.1f} us, "
            f"library {k['library_ms'] * 1e3:.1f} us, max abs err "
            f"{k['max_abs_err']:.2e} (tol {k['tol']})")
    t0 = time.perf_counter()
    phase_cut(torch, cfg, qp)
    timings["cut"] = time.perf_counter() - t0
    timings["total"] = time.perf_counter() - t_all
    log("phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in timings.items()))
    busy = eng["device_busy"]
    log(json.dumps({"card": card, "decode_tok_s_b8": eng["decode_tok_s"],
                    "step_ms": eng["step_ms"], "ttft_ms": eng["ttft_ms"],
                    "device_ms_per_step": busy and busy["ms_per_step"],
                    "decode_steps": eng["decode_steps"],
                    "prefill_chunks": eng["prefill_chunks"]}))
    print(json.dumps({"card": card, "kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
