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
   prefill chunk; on the card every decode block and spec round of this
   and the later serving phases replays captured CUDA graphs, which
   launch their kernels with no wrapper call, so a serving path's
   launches are counted from a torch.profiler trace of the card over
   the counted run (``Traced``), and the wrappers count only what ran
   eagerly (prefill chunks, a capture's warm-up step); the LoRA,
   window, int4, MoE, spec and migrate phases hold their graph runs
   against an eager twin over the same weights (``eager_twin``: tokens
   and logprobs bit-equal), read logits on the twin, and time both;
   graph: the same engine on the graph route against
   ``decode_graphs=False`` (the final norm's scale divided by 64, so that
   logprobs and draws of the seeded weights can differ): greedy tokens
   and logprobs bit-equal over 32 steps that change attend bucket, both
   keys captured with the slots live, a control with every length one
   further on that differs, B1-B3 launches under replay, a sampled block
   equal to the eager route's draws and two replays from one state
   differing, tok/s and device busy of both routes in turns, the graphs
   within ``compile_budget``, capture seconds and the pool's GiB;
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
   spec: speculative decoding on the 871M configuration (``vocab 32000,
   d_model 2048, 16 heads, 16 layers, d_ff 8192``, bf16, seeded random
   weights): B2 and B3 at its int8 shapes (M = 8, 40, 128 and 256: draft
   steps, the server's verify, prefill chunks) against their plain
   versions, timed like phase 2; the engine (bf16 target,
   ``quantize_params`` of the same weights as the draft, batch 8,
   max_len 1024, prefill 128, spec_k 4, adaptive ladder) runs greedy
   rounds from one burst admission, held against plain decode from the
   same admission, one verify forward held against single-row forwards
   over the same tokens (in bf16, and gated in a float32 copy beside an
   off-by-one control) and its accepted counts recomputed on the host,
   B2/B3 launches counted per draft forward; tokens/s and tokens per
   round against plain decode, device ms of the draft and the verify, a
   sampled run's acceptance; one session exported from a spec engine
   and imported into another: the resumed target and draft cache rows,
   the next round's first draft logits, proposals and accepted counts
   equal; the port server from its own CLI wiring (``--quantize``
   target, ``--draft-*`` bf16 draft restored from a port checkpoint of
   the same weights) answers 8 concurrent completions equal to the same
   prompts through its engine without spec rounds, B1-B3 counted per
   target forward; then B1 at the 871M's head layout (Hkv 16, G 1) at
   the server's single-token forwards' lengths and window;
   migrate: two port servers at the 7B int8 configuration: a streamed
   completion starts on A, A drains with ``{"migrate": true}``, the blob
   of its migration terminal goes to B's ``/v1/sessions/import`` and a
   ``{"resume": rid}`` completion finishes it on B, with the tokens and
   logprobs of the same request unmigrated on A; blob size, drain,
   import and resume-to-first-token times against the cold TTFT; then
   the fleet step: the port's router in front of A and B (a routed
   greedy completion equal to the same request direct, the TTFT the
   router adds, prefix affinity to the replica holding a prompt's
   granules, a replica removed with ``migrate`` under a live stream that
   stays one stream, token-identical, with no 503) and the port's
   loadgen through it, its B1-B3 launches from the card's trace against
   the engines' forwards, and the telemetry step: the port's fleet
   aggregator over the router and both servers, its rollup's change over
   the loadgen run equal to the client's report exactly, a routed request
   stitched across router and server, ``/v1/fleet``, ``/metrics`` and
   ``tpuslice-gpu fleet``; the chaos step's gray arm: a second router
   with the gray sweep on over A and B, 0.5 s of latency on its hop to A
   from its first poll: A ejected on its latency EWMA, a loadgen run
   around it all ``ok``, A idle, A re-admitted after the heal, the
   loadgen's nemesis arm with none hung, ``check_nemesis`` clean on the
   phase's event file, B never ejected; at engine level B's first decode
   logits after importing a parked session equal A's continuation bit
   for bit; no KV block leaks;
   kill (the chaos step's kill arm): three 7B int8 replicas, each a
   process of its own with its own trace and event files, behind the
   port's router in this process; the port's loadgen streams through it,
   the victim is SIGKILLed once it holds a live slot, the third replica
   added and the victim removed: outcomes summing to the requests, none
   hung, the rest classified; the survivor and the fresh replica
   quiesced with no KV leak, a routed request's tokens equal direct,
   B1-B3 from each one's own card trace equal to its forwards;
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
   MFU, device busy share and peak memory; then the same step under
   remat "dots" and "full" (B5 32 a step: the recompute runs it again),
   not profiled;
   moe: (a) ``bench_moe``'s dense/MoE forward pair at its defaults (L4
   d2048, dense ff 8192 against 8 experts of ff 4096, top-2, B4 S512,
   vocab 8192, bf16), each model's device time per forward from the
   profiler: ``moe_bench_overhead_pct``; (b) the MoE main path: the 871M
   widths with 8 experts of d_ff 4096, top-2, capacity 1.25 (2.48 B params,
   fp32 masters) through ``make_train_step`` at batch 8 x 1024 under
   remat "dots": 1 warm-up and 3 timed steps, loss finite and falling,
   the load-balance term finite and in (0, 8], B5 32 and B6/B7 16
   launches a step;
   step ms, tokens/s, MFU over the active parameters, peak memory, device
   time by class; then remat "full", and no remat (an out-of-memory is
   recorded as a reading), not profiled; (c) its 1-layer fp32 cut at batch
   2 x 128 (2 layers at 2 x 256 before the chaos step), CPU against card,
   within the train cut's bounds; (d) ``quantize_params`` of its bf16
   weights served by ``ServingEngine`` (batch 8, max_len 1024, prefill
   128) on 8 prompts: B4 4 per layer and B3 once per forward, B1 and B2
   none (gated off for MoE, as in the reference), decode tok/s and device
   ms a step, and a 1-layer int8 cut of its cache forward in fp32, CPU
   against card, with equal greedy tokens; (e) B4 against its plain
   version at (M, 2048) x (2048, 2048), M = 1 ... 256, timed at M = 8;
7. CLI: ``instaslice_tpu_torch.cli.train_main`` on a synthetic corpus at
   the 871M defaults, 3 steps at ``--seq-len 1024`` (rows of 1025
   tokens: the ragged path), its JSON line checked;
8. train cut: the 871M configuration cut to 1 layer in fp32 at batch 2 x
   128 (2 layers at 2 x 256 before the chaos step): loss, grads, and the
   params and each leaf's update after 3 AdamW steps (clip, warmup) on
   the CPU (plain versions) and on the card (kernels), within the stated
   tolerances.

lora (after migrate, serving half): multi-LoRA at the 7B int8
configuration: 4 adapters of rank 8 on (wq, wv) (the reference's
``serving_lora`` recipe, ``b`` nonzero) written as port adapter
checkpoints and loaded by the server's CLI wiring (``--lora`` x 4); 8
concurrent greedy completions over HTTP on adapters i % 5 (the base
included), B1-B3 launches as the path implies (adapters add none); then
each request alone (the single-adapter path) and the 8 as one burst on
this engine and on an engine without adapters over the same weights:
base rows bit-equal, adapter rows' decode logits and served logprobs
within the stated bounds of their lone runs and, the control, 5x the
bound away from the base rows; decode tok/s and device ms per step with
and without adapters (``serving_lora_overhead_pct``);
window (after lora's serving half): the serving configuration's widths
at ``WINDOW_LAYERS`` layers with Mistral 7B's sliding window (``--window
4096 --max-len 8192``) from the server's CLI wiring: six short streamed completions, then, once they
decode, two of 4400 and 4200 prompt tokens decoded past the window; B1
on exactly the decode steps whose 256-position bucket is at most 4095
wide, the band on the others, B2/B3 on every forward of at most 256
rows, no leaked KV blocks; decode tok/s and device ms per step inside the
window (B1) and past it (the band); a long row's decode logits against
the windowed full forward (bf16 at the server's depth, and a float32 2-layer cut
with a float32 and with the int8 KV cache), the control without the
window gated on the float32 cut;
int4: the serving configuration's widths at ``INT4_LAYERS`` layers with
``--quantize-bits 4`` (group-wise int4 weights, int8 KV cache): 8
concurrent completions over HTTP with B1 once a layer each decode step
and no B2/B3, the card's int4 unpacking equal to
the CPU's, a burst's decode logits against the same engine over the
dequantized bf16 weights, the weights' GiB as int4, int8 and bf16, decode
tok/s and device ms per step;
lora (last, training half): QLoRA on the 871M training configuration,
rank 8 on (wq, wv) over the int8 base at batch 8 x 1024: the first loss
the frozen base's, falling, the base bit-unchanged, B5/B6/B7 16 launches
a step; step ms, tokens/s and peak memory beside the full step's; the
training CLI twice (``--lora-rank 8 --quantize-base``) and an 871M
``--quantize`` server answering one completion on each of its adapters;
parallel (after lora's training half): the parallel layer on one card.
World size 1 on NCCL: the 871M training configuration through
``slice_mesh`` and ``make_train_step(mesh=...)``, 3 steps from the train
phase's seed and batch, losses and params bit-equal to the meshless step
on the same weights, B5/B6/B7 16 launches a step, step ms and peak GiB
beside the meshless step's; then two processes on the one card over gloo
on CUDA tensors (spawned after the parent frees its cached memory, the
kernels already built), the 871M widths at 2 layers, batch 8 x 1024:
(dp 1, tp 2), the same with the two ranks' ``wo`` shards swapped (the
control, which must miss the bound), and (dp 2, tp 1) with ZeRO-1, each 3
steps against the one-process step on the same weights within
``PAR_TOL``, B5-B7 2 launches per rank a step, each ZeRO-1 moment holding
numel / 2; the phase logs its seconds and the groups' backend. No run
is a scaling number;
tp_serve (last): tensor-parallel serving with the driver/follower op
stream. A mesh of one rank on NCCL around the 7B int8 engine (graph
route) against the meshless engine over the same weights, the final
norm's scale divided by 64 as in the graph phase: tokens, logprobs and
a logits probe bit-equal, decode tok/s of both in turns; then, that 7B
freed, the 7B int8 server at tp 2 as two spawned processes sharing the
card over gloo on CUDA tensors, full width and depth (each rank 16 query
heads, 4 KV heads, half of d_ff and of the vocabulary), each built by the
server's own CLI wiring (``build_parser`` + ``build_engine`` with
``--from-env`` inside the group the smoke started, then ``split_ranks``):
rank 0 answers the serve phase's 8 completions over HTTP through
``DistributedEngine`` and drives ``run_script``, rank 1 replays the op
stream; the first ``TP_GREEDY`` tokens equal the meshless engine's and
each logprob within ``TP_LOGPROB_TOL`` over the agreeing prefix, a
logits probe within ``TP_LOGITS_TOL`` and the swapped-``wq`` control
outside it, the follower's ``state_digest`` equal to the driver's, B1-B3
launched on both ranks (the same counts, B1 once a layer a decode step);
per rank its decode ms a step and tok/s at batch 8, its peak GiB while
building and serving, and the phase's seconds;
parallel_rest (last): the rest of the parallel layer, two processes
sharing the card over gloo on CUDA tensors each time (no scaling
number): (a) the MoE training configuration at ``REST_LAYERS`` (2)
layers (8 experts, 4 a rank) in float32 at tp 2, 3 steps against the
one-process step within ``REST_MOE_TOL``, the swapped-experts control
outside it, B5 12 and B6/B7 6 per rank; (b) its int8 engine at tp 2 on 8 prompts: greedy tokens
equal on both ranks and their first ``TP_GREEDY`` equal the meshless
engine's, B4 4 a layer and B3 once a forward per rank; (c) the 7B int8
server at tp 2 with 4 stacked adapters (``--from-env --lora`` x 4):
the lora phase's 8 completions over HTTP from rank 0, rank 1 following,
greedy tokens against the lora phase's meshless server, B1-B3 on both
ranks; (d) ``--ring --sp 2`` through the training CLI under
``torch.distributed.run`` (two ranks on one card: gloo) at
the 871M widths, 2 layers, rows of 2048 tokens, against the same flags
in one process (the ring runs no kernel); (e) GPipe at pipe 2, 4
micro-batches, the 871M widths at 2 layers, 3 steps against the
one-process step, B5-B7 5 a step per stage; the phase logs its seconds.
slice: the slice/device layer on the card, from discovery to a
granted device that serves and back (``phase_slice``), its backend and
plugin from the port's rendered device-plugin DaemonSet
(``deploy/manifests.py``: the command through ``[project.scripts]``,
its args through the CLI's parser, its host paths mapped to the
phase's directories): the NVML
backend's ctypes struct layouts against the toolkit's ``nvml.h``
(``device/nvml_layout.c``); ``select_backend("auto")`` is the NVML
backend; its inventory (name, UUID, memory, power limit beside
``nvidia-smi``, MIG mode current and pending, NVML's profile table
against the fixed H100 80GB catalog); first-fit places a 3g.40gb where
MIG is on and creating it is allowed, else the whole GPU (the refusal
printed by its NVML name); the reservation, which a second process lists
and is refused (``ChipsBusy``); the device plugin over that reservation,
driven as the kubelet drives it through the port's hand-written gRPC
wire only (``plugin_exchange``: the slice manager registers with a
kubelet of the port's wire, ListAndWatch lists exactly the slice,
Healthy, a health mark and its clearing each pushed within 1 s,
GetPreferredAllocation, Allocate, the controls ``slice-nope`` NOT_FOUND
and ``gpu-0`` INVALID_ARGUMENT, and the plugin's socket removed: a
second Register within the poll period; Register ms, Allocate's round
trip and the health-update latency printed); ``slice_env`` for one pod,
overlaid with Allocate's envs as the kubelet overlays them (the two
agree on every key they share, and every DeviceSpec's host path
exists), and the 7B int8 server (full depth) in a fresh process whose
environment is this one's without
``CUDA_VISIBLE_DEVICES``/``NVIDIA_VISIBLE_DEVICES`` plus those: torch
sees one device, the granted UUID, the serve phase's 8 completions
answered with B1-B3 on the card's trace; ``parallel/dcn_smoke.py`` in
two processes of a two-worker grant's handoff env on the granted device
(gloo), both printing ``psum_total`` 3.0; then the release, after which
no reservation and no MIG instance of the phase's is left. The registry
is a temporary directory of the phase's own; MIG mode is read, never
changed.

agent: the node agent on the card (``phase_agent``): the port's
``kube/httptest`` serves a ``FakeKube`` on 127.0.0.1 behind a bearer
token and a JSON kubeconfig; the agent in a fresh process
(``agent_child``: ``tpuslice-gpu-agent``'s parser and runner over the
real HTTP client and the NVML backend) publishes the node's CR (the
card's grid, one chip a GPU, its profiles plus ``gpu``) and answers
``/healthz`` and ``/readyz``; the smoke writes, as the controller, a
``creating`` allocation placed first-fit (3g.40gb where MIG is on,
else the whole GPU), and the agent realizes it: the pod's ConfigMap
with the granted UUID alone, ``realized_on`` and ``prepared`` under
the part key, the Node's per-pod resource, the reservation listed by
another process; the 7B int8 server in a fresh process on the
ConfigMap's env serves the serve phase's tokens with B1-B3 on the
card's trace; two health sweeps leave ``unhealthyChips`` empty; the
agent, holding the grant, restarted under ``TPUSLICE_NEMESIS_PLAN`` with
a cut from the apiserver 2.5 s into its run for 4 s (the chaos step's
partition arm): ``DegradedModeEntered`` once, another process lists the
reservation unchanged during the cut, ``DegradedModeExited`` after it,
the CR's prepared equal to the device's, MIG untouched; the allocation
flipped to ``deleted`` is torn down to nothing, and a pod submitted after
the heal is granted and torn down; an agent
armed to crash at ``agent.realize`` dies with its reservation
unrecorded, and a restarted agent reaps that orphan (``OrphanReaped``
on its ``/v1/debug/events``). Boot to CR, realize and teardown
latency and the first burst's tok/s are printed beside the card.

controller: InstaSlice's pod loop by the port's controller and agent
processes over HTTP (``phase_controller``), each started from the port's
rendered Deployment and DaemonSet (their commands through
``[project.scripts]``, their args and env as rendered, the registry
mapped by ``TPUSLICE_REGISTRY_DIR``, the JSON kubeconfig by
``KUBECONFIG``), the seconds from each spawn to its probes answering 200
logged: the port's sample pod (``deploy/samples/test-pod.yaml``) placed,
realized and ungated; while it is granted, ``tpuslice-gpu status
--json`` and ``describe pod --json`` read the live apiserver (one node
of the card's generation, the slice ungated and realized 1/1, the
timeline's Admitted, Placed and Ungated in order); the workload on its
ConfigMap's env; a waiting pod, teardown after the grace, a controller
killed at ``controller.ungate`` and its successor.

ctl (last): the operator CLIs (``phase_ctl``): ``tpuslice-gpu
serve-bench`` in process at the 871M configuration's full widths and
depth, batch 8, max_len 1024, prefill 128, ``--quantize`` (B1, B2, B3)
then ``--spec`` (B2, B3, no B1), each JSON line with the reference's
keys and ``backend`` ``cuda``, the launches on the card's trace equal to
what the engine's counters imply for the steps it ran; the controller
phase's ``status``/``describe`` ms; ``python -m
instaslice_tpu_torch.cli.demo --transport http`` in a fresh process
(rc 0, its last line, the grant seconds on the fake backend).

Then the ``kernels`` JSON line (launches, from the card's trace on the
serving paths and from the wrappers on the training ones: B1-B3 from the
serve phase, B4 from the moe phase's engine (its times at that path's 2048 x 2048,
the 7B-shaped reading in ``detail_7b_wq``), B5-B7 from the train phase;
``moe_launches`` from the moe phase's engine (B1-B4) and MoE train steps
(B5-B7); ``engine_launches`` from phase 3,
``spec_launches`` from the spec phase's engine, ``lora_launches`` from the
lora phase's server (B1-B4) and QLoRA steps (B5-B7), ``window_launches``
and ``int4_launches`` from the window and int4 phases' servers;
``spec_detail`` holds B1-B3 at the 871M shapes; ``parallel_launches``
from the parallel phase's world-size-1 mesh step and
``parallel_rank_launches`` per rank of its two-process runs,
``tp_serve_launches`` per rank of the tp 2 server,
``parallel_rest_launches`` per rank or stage of the parallel_rest
phase's runs, ``slice_launches`` from the slice phase's workload,
``agent_launches`` and ``controller_launches`` from the agent and
controller phases' workloads, ``ctl_launches`` from the ctl phase's
``--quantize`` and ``--spec`` runs, ``fleet_launches`` from the migrate
phase's fleet step, ``kill_launches`` from the kill phase's survivor and
fresh replica), the chaos step's JSON line (each arm's numbers and the
step's seconds), the graph
phase's JSON line, and last
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

#: ``bench_moe``'s defaults (``instaslice_tpu/bench_tpu.py:794-797``): a
#: dense model against the MoE of matched active FLOPs (expert d_ff =
#: dense d_ff / top_k, ``:802-807``), bf16 forward only
MOE_BENCH = dict(d_model=2048, n_heads=16, n_layers=4, dense_ff=8192,
                 n_experts=8, top_k=2, batch=4, seq=512, vocab=8192)
#: forwards in the profiled window of each model
MOE_BENCH_FWDS = 2


def free_memory(torch) -> None:
    """Drop what no name holds any more and return the card's cached
    blocks, so that a later phase starts from what earlier ones keep."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


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


def rel_l2(a, b) -> float:
    """Relative L2 error of ``a`` against ``b`` (in fp32)."""
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


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


def phase_gates() -> dict:
    """The port's two static gates (``instaslice_tpu_torch/analysis/
    slicelint.py`` and ``slicecheck.py``) over this checkout's package, as
    the port's images run them before ``pip install``: each a ``python
    -m`` process from the repository root, the two at once. Each must exit
    0 with no finding."""
    t0 = time.perf_counter()
    procs = {g: subprocess.Popen(
        [sys.executable, "-m", f"instaslice_tpu_torch.analysis.{g}"],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for g in ("slicelint", "slicecheck")}
    out = {}
    try:
        for g, p in procs.items():
            text, _ = p.communicate(timeout=300)
            out[g] = {"rc": p.returncode,
                      "seconds": time.perf_counter() - t0}
            check(p.returncode == 0 and not text.strip(),
                  f"gates: {g} exit {p.returncode}: {text[-3000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out["seconds"] = time.perf_counter() - t0
    log(f"gates: slicelint ({out['slicelint']['seconds']:.2f} s) and "
        f"slicecheck ({out['slicecheck']['seconds']:.2f} s) over "
        f"instaslice_tpu_torch, run at once: 0 findings each; the step "
        f"{out['seconds']:.2f} s")
    return out


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


def worse(acc: dict, r: dict) -> None:
    """Keep in ``acc`` the largest of each error reading of ``r``."""
    for key in ("max_abs", "rel_l2", "tile_rel_l2"):
        acc[key] = max(acc.get(key, 0.0), r[key])


def b2_case(torch, qm, leaf, name: str, M: int, gen, xs, tag: str) -> dict:
    """B2 on one stacked projection at ``M`` rows of x, drawn from
    ``gen``: held against its plain version with each dtype of ``xs``
    (bf16: the tensor-core kernel; fp32: the CUDA-core one) at the first,
    middle and last layer, two runs bit-equal, then timed (bf16 x) with
    its bound, plain version and library call; its detail entry."""
    L, K, N = leaf.q.shape
    x32 = torch.randn((M, K), generator=gen, device=gen.device)
    x = x32.to(torch.bfloat16)
    worst = {}
    for li in (0, L // 2, L - 1):
        for xin in (x32.to(dt) for dt in xs):
            got = qm.quant_matmul_stacked(xin, leaf.q, leaf.s, li)
            want = qm.quant_matmul_stacked_ref(xin, leaf.q, leaf.s, li)
            worse(worst, check_qmm(torch, qm, got, want, f"{tag}B2 {name} "
                                   f"M={M} layer {li} {xin.dtype}",
                                   xin.dtype, M, K, N, False))
    check(bool(torch.equal(qm.quant_matmul_stacked(x, leaf.q, leaf.s, L // 2),
                           qm.quant_matmul_stacked(x, leaf.q, leaf.s,
                                                   L // 2))),
          f"{tag}B2 {name} M={M}: two runs bit-equal")
    wb = [leaf.layer(li).dequantize(torch.bfloat16)
          for li in range(min(8, L))]
    ms = graph_ms(torch, lambda i: qm.quant_matmul_stacked(
        x, leaf.q, leaf.s, i % L), L)
    plain = graph_ms(torch, lambda i: qm.quant_matmul_stacked_ref(
        x, leaf.q, leaf.s, i % L), 8, replays=2)
    lib = graph_ms(torch, lambda i: torch.matmul(x, wb[i % len(wb)]), 8)
    del wb
    nbytes = K * N + 2 * N + 2 * M * K + 4 * M * N
    b_ms, b_by = bound(nbytes, 2 * M * K * N)
    plan = qm.plan(x.dtype, M, K, N, False)
    log(f"{tag}kernels: B2 {name:5s} M={M:3d} K={K} N={N}: "
        f"{ms * 1e3:.1f} us = {gbs(nbytes, ms):.0f} GB/s (bound "
        f"{b_ms * 1e3:.1f} us by {b_by}, plain {plain * 1e3:.1f}, "
        f"library {lib * 1e3:.1f}; {plan.splits} x k_len {plan.k_len}; rel "
        f"L2 {worst['rel_l2']:.1e}, worst tile {worst['tile_rel_l2']:.1e})")
    return {"proj": name, "M": M, "K": K, "N": N, "ms": ms,
            "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
            "bound_by": b_by, "gb_per_s": gbs(nbytes, ms),
            "splits": plan.splits, "k_len": plan.k_len, **worst}


def b3_case(torch, qm, emb, M: int, gen, xs, tag: str) -> dict:
    """B3 on the (V, D) embedding at ``M`` rows, as :func:`b2_case`."""
    V, D = emb.q.shape
    x32 = torch.randn((M, D), generator=gen, device=gen.device)
    x = x32.to(torch.bfloat16)
    worst = {}
    for xin in (x32.to(dt) for dt in xs):
        worse(worst, check_qmm(torch, qm, qm.quant_matmul_t(xin, emb.q, emb.s),
                               qm.quant_matmul_t_ref(xin, emb.q, emb.s),
                               f"{tag}B3 M={M} {xin.dtype}", xin.dtype, M, D,
                               V, True))
    check(bool(torch.equal(qm.quant_matmul_t(x, emb.q, emb.s),
                           qm.quant_matmul_t(x, emb.q, emb.s))),
          f"{tag}B3 M={M}: two runs bit-equal")
    eb = emb.dequantize(torch.bfloat16)
    ms = graph_ms(torch, lambda i: qm.quant_matmul_t(x, emb.q, emb.s), 16)
    plain = graph_ms(torch, lambda i: qm.quant_matmul_t_ref(
        x, emb.q, emb.s), 4, replays=2)
    lib = graph_ms(torch, lambda i: torch.matmul(x, eb.t()), 16)
    del eb
    nbytes = V * D + 2 * V + 2 * M * D + 4 * M * V
    b_ms, b_by = bound(nbytes, 2 * M * D * V)
    log(f"{tag}kernels: B3 unembed M={M:3d} K={D} N={V}: {ms * 1e3:.1f} us "
        f"= {gbs(nbytes, ms):.0f} GB/s (bound {b_ms * 1e3:.1f} us by {b_by}, "
        f"plain {plain * 1e3:.1f}, library {lib * 1e3:.1f}; rel L2 "
        f"{worst['rel_l2']:.1e}, worst tile {worst['tile_rel_l2']:.1e})")
    return {"M": M, "K": D, "N": V, "ms": ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by,
            "gb_per_s": gbs(nbytes, ms), **worst}


def log_six(tag: str, detail: list, ms_rows) -> None:
    """The six projections' sums at each row count."""
    for M in ms_rows:
        six = [d for d in detail if d["M"] == M]
        log(f"{tag}kernels: B2 six projections M={M}: "
            f"{sum(d['ms'] for d in six) * 1e3:.1f} us (bound "
            f"{sum(d['bound_ms'] for d in six) * 1e3:.1f}, plain "
            f"{sum(d['plain_ms'] for d in six) * 1e3:.1f}, library "
            f"{sum(d['library_ms'] for d in six) * 1e3:.1f})")


def phase_kernels(torch, cfg, qp, ops) -> list:
    """Each kernel against its plain version at the main path's shapes;
    returns the kernels' entries (launches filled in later)."""
    fd, qm = ops.flash_decode, ops.quant_matmul
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    L, D = cfg.n_layers, cfg.d_model
    out = []

    xs = (torch.bfloat16, torch.float32)
    # ---- B2 quant_matmul_stacked: the six projections at M = 1 ... 256
    detail = [b2_case(torch, qm, qp["blocks"][name], name, M, gen, xs, "")
              for M in QMM_MS for name in BIG]
    errs = {}
    for d in detail:
        worse(errs, d)
    log_six("", detail, QMM_MS)
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
    detail = [b3_case(torch, qm, qp["embed"], M, gen, xs, "")
              for M in QMM_MS]
    errs = {}
    for d in detail:
        worse(errs, d)
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
        "work": "one unstacked 4096 x 4096 int8 weight (a 7B wq layer) "
                "at M=8",
        "max_abs_err": errs["max_abs"], "rel_l2_err": errs["rel_l2"],
        "tile_rel_l2_err": errs["tile_rel_l2"], "tol": QMM_TOL_TEXT,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib, "gb_per_s": gbs(nbytes, ms),
    })

    out.insert(0, check_b1(torch, cfg, fd, gen))
    return out


#: B1's cases at batch 8 over a 1024-position cache: staggered depths,
#: full depth, and the engine's prompt lengths (the longest cut to its
#: bucket) at the engine's s_attn 256, as (label, lengths, s_attn)
B1_S = 1024
B1_SHAPES = (("staggered", [0, 1, 17, 128, 300, 511, 777, 1000], B1_S),
             ("full depth", [B1_S] * 8, B1_S),
             ("engine", [256, 200, 129, 100, 64, 33, 17, 5], 256))


def check_b1(torch, cfg, fd, gen) -> dict:
    """B1 against its plain version at :data:`B1_SHAPES` (the first,
    timed since B1 was first ported, stays the entry's top level), timed
    at each; returns its ``kernels`` entry."""
    detail, e_max = b1_cases(torch, cfg, fd, gen, B1_S, B1_SHAPES, "")
    top = detail[0]
    return {
        "name": "quant_decode_attention", "route": "cuda",
        "source": "instaslice_tpu_torch/csrc/flash_decode.cu",
        "replaces": "instaslice_tpu/ops/flash_decode.py:59",
        "work": f"one layer, B=8 Hkv={top['Hkv']} G={top['G']} "
                f"hd={top['hd']}, lengths {top['lengths']}, s_attn "
                f"{top['s_attn']}",
        "max_abs_err": e_max, "tol": "1e-5 (merged output)",
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "detail": detail,
    }


def b1_cases(torch, cfg, fd, gen, S: int, shapes, tag: str):
    """B1 at ``cfg``'s head layout over an int8 cache of ``S`` positions
    drawn from ``gen``, at each (label, lengths, s_attn) of ``shapes``:
    acc, m and l within 1e-5 of max|plain| (+ 1e-5) on the rows with a
    prefix at the first and last layer, the empty row's conventions
    exact, the merged output within 1e-5, two runs bit-equal; timed with
    its bound, plain version and SDPA. Returns (detail, worst merged
    error)."""
    from instaslice_tpu_torch.models.lm import init_cache

    dev = torch.device("cuda")
    L, Hkv, hd = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    G = cfg.n_heads // Hkv
    B = len(shapes[0][1])
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
    for li in range(min(8, L)):
        k = (cache["k"][li].float() * cache["k_s"][li, ..., None]).to(
            torch.bfloat16).repeat_interleave(G, dim=1)
        v = (cache["v"][li].float() * cache["v_s"][li, ..., None]).to(
            torch.bfloat16).repeat_interleave(G, dim=1)
        kv_deq.append((k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
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
                check(e <= tol, f"{tag}B1 {label} layer {li} {what}: err "
                      f"{e} > {tol}")
                for b in empty:
                    check(bool(torch.equal(got[b], want[b])),
                          f"{tag}B1 {label} layer {li} {what}: empty-row "
                          "convention")
            k_loc = torch.randn((B, Hkv, hd), generator=gen, device=dev)
            v_loc = torch.randn((B, Hkv, hd), generator=gen, device=dev)
            lg = torch.einsum("bkgd,bkd->bkg", q4.float() * hd ** -0.5,
                              k_loc)
            e = _err(torch, fd.merge_local(o, m, l_, lg, v_loc),
                     fd.merge_local(ro, rm, rl, lg, v_loc))
            check(e <= 1e-5, f"{tag}B1 {label} layer {li} merged: err {e} "
                  "> 1e-5")
            e_max = max(e_max, e)
            # the splits combine in a fixed order: reruns bit-equal
            o2, m2, l2 = fd.quant_decode_attention(q4, *args, lengths, li,
                                                   s_attn)
            check(bool(torch.equal(o, o2) and torch.equal(m, m2)
                       and torch.equal(l_, l2)),
                  f"{tag}B1 {label} layer {li}: two runs bit-equal")
        ms = graph_ms(torch, lambda i: fd.quant_decode_attention(
            q4, *args, lengths, i % L, s_attn), L)
        plain = graph_ms(torch, lambda i: fd.quant_decode_attention_ref(
            q4, *args, lengths, i % L, s_attn), 8, replays=2)
        pos = torch.arange(s_attn, device=dev)[None, :]
        mask = ((pos < lengths[:, None]) | (pos == 0))[:, None, None, :]
        lib = graph_ms(torch, lambda i: sdpa(
            qs, kv_deq[i % len(kv_deq)][0][:, :, :s_attn],
            kv_deq[i % len(kv_deq)][1][:, :, :s_attn], attn_mask=mask), 8)
        live = sum(min(n, s_attn) for n in lens_l)
        nbytes = (live * Hkv * (2 * hd + 2 * 4) + B * Hkv * G * hd * 2
                  + 4 * B + B * Hkv * G * (hd + 2) * 4)
        b_ms, b_by = bound(nbytes, live * Hkv * G * 4 * hd)
        P, n_split = fd.split_plan(B, Hkv, s_attn)
        detail.append({"shape": label, "lengths": lens_l, "s_attn": s_attn,
                       "Hkv": Hkv, "G": G, "hd": hd,
                       "P": P, "n_split": n_split, "ms": ms,
                       "plain_ms": plain, "library_ms": lib,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "gb_per_s": gbs(nbytes, ms), "max_rel_err": worst})
        log(f"{tag}kernels: B1 decode attention B={B} Hkv={Hkv} G={G} "
            f"{label} s_attn={s_attn} lengths {lens_l} (P {P}, {n_split} "
            f"splits): {ms * 1e3:.1f} us = {gbs(nbytes, ms):.0f} GB/s "
            f"(bound {b_ms * 1e3:.1f} us, plain {plain * 1e3:.1f}, library "
            f"{lib * 1e3:.1f}); worst error {worst:.2e} of max|plain|, "
            f"merged {e_max:.2e}")
    del kv_deq, cache
    torch.cuda.empty_cache()
    return detail, e_max


def phase_engine(torch, cfg, qp, ops) -> dict:
    """The main path: generate on the 7B int8 engine, launches counted
    across exactly that call."""
    from instaslice_tpu_torch.models.lm import TpuLM
    from instaslice_tpu_torch.serving import ServingEngine

    eng = ServingEngine(TpuLM(cfg), qp, max_batch=8, max_len=1024,
                        prefill_len=128, kv_quant=True, device="cuda")
    # the server's start-up: every decode graph captured before traffic
    eng.warm_prefill_buckets()
    graphs0 = eng.graph_stats()["graphs"]
    gen = torch.Generator().manual_seed(11)
    plens = [300, 200, 129, 100, 64, 33, 17, 5]
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen)
               .tolist() for n in plens]
    max_new = 32
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    eng.decode_steps = eng.prefill_dispatches = 0
    t0 = time.perf_counter()
    with Traced(torch, ops) as tr:
        results = eng.generate(prompts, max_new_tokens=max_new,
                               block_size=16)
    wall = tr.t_end - t0
    counts, eager_counts = tr.counts, ops.launch_counts()
    steps, chunks = eng.decode_steps, eng.prefill_dispatches
    log(f"engine: generate 8 prompts {plens} x {max_new} tokens in "
        f"{wall:.2f} s (traced): {chunks} prefill chunks, {steps} decode "
        f"steps, launches on the card's trace {counts}, by the wrappers "
        f"(eager) {eager_counts}")
    check(eng.graph_stats()["graphs"] == graphs0, "engine: no capture in "
          "the counted run")
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
    check(eager_counts["quant_decode_attention"] == 0
          and eager_counts["quant_matmul_stacked"] == 6 * L * chunks
          and eager_counts["quant_matmul_t"] == chunks,
          "engine: the wrappers count the prefill chunks' launches only "
          "(every decode step replayed a graph)")

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
    graphs = eng.graph_stats()
    within_budget(graphs, "engine")
    log(f"engine: decode graphs {graphs}")
    return {"counts": counts, "decode_steps": steps, "prefill_chunks": chunks,
            "generate_s": wall, "ttft_ms": ttft * 1e3, "decode_tok_s": tok_s,
            "step_ms": step_ms, "device_busy": busy, "chunk_busy": chunk,
            "graphs": graphs}


#: the graph phase's prompts: the engine phase's, the first cut to 240
#: tokens so that its 32 decode steps cross from the 256-position attend
#: bucket into the 512 one
GRAPH_PLENS = (240, 200, 129, 100, 64, 33, 17, 5)
#: its decode blocks: 8 steps in bucket 256, then 8 and 16 in bucket 512
GRAPH_BLOCKS = (8, 8, 16)
#: decode steps of each timed turn (after a warm block as long) of the
#: routes' tok/s; 64 until the eager turns took 24 s of the phase on a
#: slow host (the eager 7B decodes at 78-150 tok/s), cut to pay for the
#: traced windows' longer settle
GRAPH_TPUT_STEPS = 16


def phase_graph(torch, cfg, qp, ops) -> dict:
    """The decode graphs against the eager route on the 7B int8 engine at
    full width and depth (batch 8, max_len 1024, prefill 128): greedy
    tokens and logprobs bit-equal over 32 steps whose bucket changes
    after the first block, each key captured lazily with the slots live,
    with a control that must differ (the eager engine with every length
    one further on); B1-B3 launches under replay as the path implies; at
    temperature 0.8 two replays of one graph from the same decode state
    draw different tokens and a sampled block equals the eager route's
    draws; decode tok/s and device busy for both routes, the graphs
    against ``compile_budget``, capture seconds and the pool's GiB.

    The seeded weights' logits spread about sqrt(d_model) = 64 wide, so
    every step's top token takes all the mass: its logprob rounds to 0,
    a sampled draw is the argmax, and neither comparison could fail. The
    phase serves the same weights with the final norm's scale divided by
    64 (logits about 1 wide); kernels and launches are the same."""
    from instaslice_tpu_torch.models.lm import TpuLM
    from instaslice_tpu_torch.serving import ServingEngine

    opts = dict(max_batch=8, max_len=1024, prefill_len=128, kv_quant=True,
                device="cuda")
    flat = dict(qp, ln_f={"scale": qp["ln_f"]["scale"]
                          / math.sqrt(cfg.d_model)})
    g_eng = ServingEngine(TpuLM(cfg), flat, **opts)
    e_eng = ServingEngine(TpuLM(cfg), flat, decode_graphs=False, **opts)
    check(g_eng.decode_route() == "cuda graphs" and e_eng.decode_route()
          == "eager (decode_graphs=False)", "graph: the two routes")
    gen = torch.Generator().manual_seed(11)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen)
               .tolist() for n in GRAPH_PLENS]
    L, n = cfg.n_layers, sum(GRAPH_BLOCKS)

    def run(eng, shift: int = 0, traced: bool = True):
        """The prompts admitted (every length ``shift`` further on), then
        GRAPH_BLOCKS: per slot (tokens, logprobs), the launches on the
        card's trace (None where not ``traced``: the runs whose launches
        no check reads) and by the wrappers, the decode steps dispatched
        and the graphs captured meanwhile."""
        for s in list(eng.slots):
            eng.evict_slot(s)
        eng.radix.reclaim(eng.kv.total_blocks)
        for p in prompts:
            eng.add_request(p)
        eng.lengths.add_(shift)
        ops.reset_launch_counts()
        steps0, graphs0 = eng.decode_steps, len(eng._graphs)
        counts = None
        if traced:
            with Traced(torch, ops) as tr:
                t0 = time.perf_counter()
                for b in GRAPH_BLOCKS:
                    eng.decode_block(b)
            run.seconds, counts = tr.t_end - t0, tr.counts
        else:
            for b in GRAPH_BLOCKS:
                eng.decode_block(b)
        return (slot_runs(eng), counts, ops.launch_counts(),
                eng.decode_steps - steps0, len(eng._graphs) - graphs0)

    def implied(steps: int) -> dict:
        return dict.fromkeys(ops.KERNEL_WRAPPERS, 0) | {
            "quant_decode_attention": L * steps,
            "quant_matmul_stacked": 6 * L * steps,
            "quant_matmul_t": steps}

    g_out, g_counts, g_wrap, g_steps, g_new = run(g_eng)
    first_s = run.seconds
    e_out, e_counts, e_wrap, e_steps, _ = run(e_eng)
    keys = sorted(k[1] for k in g_eng._graphs)
    check(keys == [256, 512] and g_new == 2,
          f"graph: keys captured lazily {keys}")
    check(g_out == e_out, "graph: greedy tokens and logprobs bit-equal "
          "to the eager route over 32 steps")
    check(g_steps == e_steps == n, f"graph: decode steps {g_steps}")
    # the eager route: the trace counts what the wrappers count
    check(e_counts == e_wrap == implied(n), f"graph: eager launches, "
          f"traced {e_counts}, by the wrappers {e_wrap}")
    # the graph route: each lazy capture's warm-up step launched for real
    # (the wrappers counted those, and nothing of the captures or the
    # replays); the trace holds every replayed step's kernels besides
    check(g_wrap == implied(g_new), f"graph: the wrappers count the "
          f"{g_new} warm-up steps only: {g_wrap}")
    check(g_counts == implied(n + g_new),
          f"graph: B1 = layers x steps, B2 = 6 x layers x steps, B3 = "
          f"steps on the trace under replay (warm-ups included): "
          f"{g_counts}")
    ctrl = run(e_eng, shift=1, traced=False)[0]
    lp_ctrl = max(abs(a - b) for (_, la), (_, lb) in zip(ctrl, g_out)
                  for a, b in zip(la, lb))
    check(ctrl != g_out and lp_ctrl > 0.0, "graph: the control (lengths "
          "one further on) differs")
    log(f"graph: 8 prompts {list(GRAPH_PLENS)}, blocks {list(GRAPH_BLOCKS)} "
        f"(buckets {keys}, captured lazily in the first run, its blocks "
        f"{first_s:.2f} s, traced): tokens and logprobs bit-equal to the eager route; launches "
        f"on the trace {g_counts} ({n} replayed steps and {g_new} warm-up "
        f"steps), by the wrappers {g_wrap}; control with lengths + 1: "
        f"largest logprob difference {lp_ctrl:.3g}")

    # ---- sampled: fresh draws per replay, and the eager route's draws
    for e in (g_eng, e_eng):
        e.temperature = 0.8
    samp = [run(e, traced=False)[0] for e in (g_eng, e_eng)]
    check(samp[0] == samp[1], "graph: sampled blocks equal the eager "
          "route's draws from the same generator state")
    saved = g_eng._save_state()
    g_eng.decode_block(8)
    first = g_eng._blk_toks[:8].clone()
    for b, c in zip(g_eng._state_buffers(), saved[0]):
        b.copy_(c)
    g_eng.decode_block(8)
    differ = int((first != g_eng._blk_toks[:8]).sum())
    check(differ > 0, "graph: two replays of one sampled graph draw "
          "different tokens")
    log(f"graph: temperature 0.8: a sampled run equals the eager route's "
        f"draws; two replays of one graph from the same state differ in "
        f"{differ} of 64 tokens")
    for e in (g_eng, e_eng):
        e.temperature = 0.0
        for s in list(e.slots):
            e.evict_slot(s)

    # ---- host clock and device time, the routes in turns
    tok_s = {"graphs": [], "eager": []}
    for name, e in (("eager", e_eng), ("graphs", g_eng), ("graphs", g_eng),
                    ("eager", e_eng)):
        tok_s[name].append(e.throughput(n_steps=GRAPH_TPUT_STEPS))
        for s in list(e.slots):
            e.evict_slot(s)
    busy = {}
    for name, e in (("graphs", g_eng), ("eager", e_eng)):
        for _ in range(8):
            e.add_request([1, 2, 3])
        e.decode_block(1)
        busy[name] = device_busy(torch, lambda: e.decode_block(8), 8)
        for s in list(e.slots):
            e.evict_slot(s)
    stats = g_eng.graph_stats()
    within_budget(stats, "graph")
    pool = g_eng.graph_pool_gib()
    rate = {k: sum(v) / len(v) for k, v in tok_s.items()}
    step_ms = {k: 8 / v * 1e3 for k, v in rate.items()}
    dev_ms = {k: v and v["ms_per_step"] for k, v in busy.items()}
    share = {k: dev_ms[k] and dev_ms[k] / step_ms[k] for k in rate}
    log(f"graph: decode at batch 8, tok/s by turn {tok_s}: graphs "
        f"{rate['graphs']:.1f} ({step_ms['graphs']:.2f} ms a step), eager "
        f"{rate['eager']:.1f} ({step_ms['eager']:.2f} ms); device ms a step "
        f"{dev_ms}, busy share {share}; graphs {stats['graphs']} of budget "
        f"{stats['budget']}, captured in {stats['capture_seconds']:.2f} s, "
        f"pool {pool} GiB; device by kernel (graphs) "
        f"{busy['graphs'] and busy['graphs']['top']}")
    out = {"counts": g_counts, "decode_steps": g_steps, "tok_s": tok_s,
           "step_ms": step_ms, "device_ms_per_step": dev_ms,
           "device_busy_share": share, "graphs": stats["graphs"],
           "budget": stats["budget"],
           "capture_seconds": stats["capture_seconds"], "pool_gib": pool,
           "control_logprob_diff": lp_ctrl, "sampled_replay_differ": differ,
           "first_run_s": first_s}
    del g_eng, e_eng
    free_memory(torch)
    return out


def device_busy(torch, run, n_steps: int, kn: str = "quant_matmul_stacked"):
    """Device time per step, by kernel, from a torch.profiler window over
    ``run()`` (``n_steps`` steps; None when the profiler reports no
    device activity), and the window's kernel launches by wrapper
    (``Traced``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from instaslice_tpu_torch import ops

    prof = start_trace(torch, profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
    try:
        run()
    except BaseException:
        prof.__exit__(None, None, None)
        raise
    names = stop_trace(torch, prof)
    # kernels only: a user annotation (the optimizer's record_function
    # range) spans kernels that are counted on their own; the trace's
    # marker is not the window's
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total
            and not getattr(e, "is_user_annotation", False)
            and "spin_kernel" not in e.key]
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
    launches = ops.trace_launch_counts(names.items(), kn)
    return {"ms_per_step": total, "top": top, "by_class": by_class,
            "launches": launches}


def phase_cut(torch, cfg, qp, what: str = "cut", n_layers: int = 2) -> dict:
    """``n_layers`` layers of the same weights: CPU plain versions vs
    card kernels, one prefill and 4 greedy decode steps (the CPU's tokens
    fed to both)."""
    from instaslice_tpu_torch.models.lm import apply_with_cache, init_cache
    from instaslice_tpu_torch.models.quant import QuantizedTensor

    cut = dataclasses.replace(cfg, n_layers=n_layers)

    def take(leaf, dev):
        if isinstance(leaf, QuantizedTensor):
            return QuantizedTensor(leaf.q[:n_layers].to(dev),
                                   leaf.s[:n_layers].to(dev))
        return leaf[:n_layers].to(dev)

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
        check(err <= tol, f"{what} step {step}: logits err {err} > {tol}")
        worst = max(worst, err / float(ref.abs().max()))
        want_tok, got_tok = ref.argmax(-1), got.argmax(-1)
        check(bool((want_tok == got_tok).all()), f"{what} step {step}: "
              f"greedy tokens {got_tok.tolist()} != {want_tok.tolist()}")
        lens = lens + toks.shape[1]
        toks = want_tok[:, None]
    log(f"{what}: {n_layers} layers, prefill 16 + 4 decode steps: max logit error "
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


def undrain(url: str) -> None:
    """``DELETE /v1/drain``: the server takes traffic again."""
    import urllib.request

    req = urllib.request.Request(url + "/v1/drain", method="DELETE")
    urllib.request.urlopen(req, timeout=60).read()


def wait_ready(url: str) -> None:
    for _ in range(100):
        try:
            if http_json(url + "/readyz", timeout=10)["status"] == "ok":
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise RuntimeError("server never became ready")


def http_stream(url: str, body: dict, timeout: float = 600.0,
                progress: dict = None) -> dict:
    """POST a streamed completion; its tokens, logprobs, finish reason,
    the host clock of the first and last token chunks, and a session
    migration terminal's blob with the host clock it arrived at.
    ``progress["n"]``, when given, counts the tokens streamed so far."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    toks, lps, reason, t_first, t_last = [], [], None, None, None
    session, t_session = None, None
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
            if ev.get("object") == "text_completion.migration":
                session, t_session = ev["session"], time.perf_counter()
                continue
            ch = ev["choices"][0]
            if ch["token_ids"]:
                now = time.perf_counter()
                t_first = t_first or now
                t_last = now
                toks += ch["token_ids"]
                lps += ch.get("logprobs") or []
                if progress is not None:
                    progress["n"] = len(toks)
            if ch["finish_reason"] is not None:
                reason = ch["finish_reason"]
    return {"token_ids": toks, "logprobs": lps, "finish_reason": reason,
            "t_first": t_first, "t_last": t_last, "session": session,
            "t_session": t_session}


def http_burst(url: str, prompts: list, max_tokens: int):
    """The serve phase's burst: one greedy completion a prompt with
    logprobs, all sent together from their own threads, the even-indexed
    ones streamed. Returns (results, errors): each result is the
    completion's choice (a streamed one as :func:`http_stream` reads it,
    with its first and last token's host clock) with the request's
    ``t_send`` and ``t_done``."""
    import threading

    results, errors = [None] * len(prompts), []

    def one(i):
        body = {"prompt": prompts[i], "max_tokens": max_tokens,
                "temperature": 0.0, "logprobs": True}
        t_send = time.perf_counter()
        try:
            if i % 2 == 0:
                r = http_stream(url + "/v1/completions",
                                dict(body, stream=True))
            else:
                ch = http_json(url + "/v1/completions", body)["choices"][0]
                r = dict(ch, t_first=None, t_last=None)
            r["t_send"], r["t_done"] = t_send, time.perf_counter()
            results[i] = r
        except Exception as e:  # noqa: BLE001 - reported by the caller
            errors.append(f"request {i}: {e!r}")

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return results, errors


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
    from collections import Counter

    from instaslice_tpu_torch.obs.profiler import Profiler, reset_profiler
    from instaslice_tpu_torch.serving import api_server

    t0 = time.perf_counter()
    args = api_server.build_parser().parse_args(SERVE_FLAGS.split())
    eng = api_server.build_engine(args)
    # a fresh process profiler, disarmed, for the server to pick up: the
    # profile gate's ring counts this server's rounds only
    reset_profiler(Profiler(armed=False))
    srv = api_server.ApiServer(eng, host=args.host, port=args.port).start()
    setup_s = time.perf_counter() - t0
    url = srv.url
    V, L = args.vocab_size, args.n_layers
    check(eng.decode_route() == "cuda graphs", "serve: decode blocks "
          "replay CUDA graphs")
    # the rows of every forward the engine runs (replayed decode steps
    # included): B2 and B3 take the forwards of at most 256 rows (decode
    # steps, single-slot chunks, 2-row batched chunks); wider batched
    # prefills dequantize into torch.matmul, as the reference does at
    # M > 256
    #: (tokens, lengths, logits) of each prefill forward while set
    chunks_seen = None

    def tap(tokens, lengths, logits):
        if chunks_seen is not None and tokens.shape[1] > 1:
            chunks_seen.append((tokens.cpu(), lengths.cpu(),
                                logits.float()))

    fl = ForwardLog(eng, tap=tap)
    fl.start()
    try:
        wait_ready(url)
        gen = torch.Generator().manual_seed(17)
        prompts = [torch.randint(1, V, (n,), generator=gen).tolist()
                   for n in SERVE_PLENS]
        st0 = http_json(url + "/v1/stats")
        steps0, chunks0 = eng.decode_steps, eng.prefill_dispatches
        fl.start()
        t0 = time.perf_counter()
        with Traced(torch, ops) as tr:
            results, errors = http_burst(url, prompts, SERVE_NEW)
        wall = tr.t_end - t0
        fl.stop()
        counts = tr.counts
        steps = eng.decode_steps - steps0
        chunks = eng.prefill_dispatches - chunks0
        rows = [b * t for b, t in fl.target]
        kernel_fw = sum(r <= 256 for r in rows)
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
            f"{SERVE_NEW} tokens over HTTP in {wall:.2f} s (traced): "
            f"{chunks} prefill forwards (rows: "
            f"{sorted(Counter(rows).items())}), {steps} decode steps, "
            f"launches on the card's trace {counts}")
        check(len(fl.attends) == steps and st1["engine"]["decode_graphs"]
              ["graphs"] == st0["engine"]["decode_graphs"]["graphs"],
              "serve: every decode step replayed a graph captured at "
              "start-up")
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
            t0 = time.perf_counter()
            with Traced(torch, ops) as tr:
                r = send()
            r.update(ms=(tr.t_end - t0) * 1e3,
                     b2=tr.counts["quant_matmul_stacked"],
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
        within_budget(st["engine"]["decode_graphs"], "serve")
        profile = profile_gate(srv, eng, V)
    finally:
        srv.stop()
        reset_profiler()

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

    lp_diff = max(abs(a - b) for a, b in zip(hit["logprobs"],
                                              cold["logprobs"]))
    errs = {"hit": rel_l2(hit.pop("logits"), cold["logits"]),
            "engine_hit": rel_l2(hit_eng.pop("logits"), cold["logits"]),
            "control": rel_l2(control, cold.pop("logits"))}
    for r in (hit, cold, hit_eng):
        for key in ("t_first", "t_last", "logprobs", "session",
                    "t_session"):
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
        "profile": profile,
        "served": [{"token_ids": r["token_ids"], "logprobs": r["logprobs"]}
                   for r in results],
    }
    log(f"serve: {gen_tok} tokens in {wall:.2f} s = {out['tok_s']:.1f} "
        f"tok/s over HTTP, one burst of 8 requests; TTFT p50 "
        f"{out['ttft_ms_p50']:.1f} ms of {len(ttft)} streams "
        f"{[round(t, 1) for t in ttft]}; per request {per_req} ms; radix "
        f"hit over HTTP TTFT {hit['ttft_ms']:.1f} ms, whole 16-token "
        f"request {hit['ms']:.1f} ms; on the engine, 16-token request hit "
        f"{hit_eng['ms']:.1f} ms vs cold {cold['ms']:.1f} ms")
    return out


#: the profile gate on the serve phase's server: the port's loadgen
#: (requests, concurrency, prompt length, new tokens; streamed), a warm-up
#: of the same shape, then these arms in this order: four pairs of one
#: arm a side, mirrored (off on, on off, ...). The gate reads each pair's
#: armed over unprofiled tok/s and holds the median of the four: the
#: host's speed moves in steps (arms of one run of the card 13% apart,
#: in two runs of four arms), and a step falls between the two arms of
#: one pair at most as a rule, which the median leaves out
PROFILE_LOADGEN = dict(requests=16, concurrency=8, prompt_len=64,
                       max_tokens=48, stream=True, timeout=300.0)
PROFILE_ARMS = ("off", "on", "on", "off", "off", "on", "on", "off")


def profile_gate(srv, eng, V: int) -> dict:
    """The port's profile gate (``analysis/profile_smoke.py``) at full
    width, on the serve phase's 7B int8 server and engine (graph route):
    a warm-up burst, then the arms of PROFILE_ARMS, the profiler disarmed
    and armed in turns. Each armed arm: the ring's rounds equal the
    scheduler's round counter, no ``CompileObserved`` and
    ``engine.compiled_programs()`` unchanged over it (no graph captured
    past warm-up). Then the exports: the ``profile_rounds`` metric equals
    the ring, no ring growth while idle, the Chrome trace valid with a
    ``dispatch`` segment, a waterfall stitched, the HTTP surface. The
    median over the pairs of arms of armed over unprofiled tok/s (the
    client's tokens per second over each arm's wall) must be at least
    OVERHEAD_FLOOR; the ratio of the two sides' medians is reported."""
    import statistics

    from instaslice_tpu_torch.analysis import profile_smoke as ps
    from instaslice_tpu_torch.serving.engine import GRAPH_FORMS

    t0 = time.perf_counter()
    prof = srv.scheduler.profiler
    check(not prof.armed and prof.rounds_recorded == 0,
          "profile: the server's profiler starts disarmed and empty")
    kw = dict(PROFILE_LOADGEN, vocab=V)
    ps.run_arm(srv.url, 30, kw)
    ps.quiesce(srv.scheduler, timeout=120.0)
    arms = []
    for i, arm in enumerate(PROFILE_ARMS):
        run = ps.profiled_arm if arm == "on" else ps.unprofiled_arm
        r = run(srv, prof, 31 + i, kw)
        arms.append({"arm": arm, "tok_s": r["tok_s"],
                     "rounds": r.get("rounds", 0)})
    ex = ps.exports(srv, prof)
    side = {a: [x["tok_s"] for x in arms if x["arm"] == a]
            for a in ("off", "on")}
    tps = {a: statistics.median(v) for a, v in side.items()}
    # each side's arms, (largest - smallest) / median: the noise the
    # margin over the floor has to hold
    spread = {a: (max(v) - min(v)) / tps[a] for a, v in side.items()}
    pairs = []
    for x, y in zip(arms[::2], arms[1::2]):
        on, off = (x, y) if x["arm"] == "on" else (y, x)
        pairs.append(on["tok_s"] / off["tok_s"])
    ratio = statistics.median(pairs)
    out = {"arms": arms, "median_tok_s": tps, "pair_ratios": pairs,
           "ratio": ratio, "ratio_of_medians": tps["on"] / tps["off"],
           "spread": spread, "floor": ps.OVERHEAD_FLOOR, "exports": ex,
           "graphs": sum(n for k, n in eng.compiled_programs().items()
                         if k in GRAPH_FORMS),
           "seconds": time.perf_counter() - t0}
    log(f"profile: the 7B int8 server, {kw['requests']} requests at "
        f"concurrency {kw['concurrency']}, prompt {kw['prompt_len']}, "
        f"{kw['max_tokens']} tokens an arm: "
        + ", ".join(f"{a['arm']} {a['tok_s']} tok/s" for a in arms)
        + f"; pairs on / off {[round(r, 4) for r in pairs]}, their "
        f"median {ratio:.4f} (floor {ps.OVERHEAD_FLOOR}); medians on "
        f"{tps['on']} / off {tps['off']} = "
        f"{out['ratio_of_medians']:.4f}; spread of the arms off "
        f"{spread['off']:.4f}, on {spread['on']:.4f}; rounds recorded "
        f"{[a['rounds'] for a in arms if a['arm'] == 'on']} = the "
        f"scheduler's, no compile past warm-up, {ex['trace_events']} "
        f"Chrome trace events, waterfall {ex['waterfall_outcome']}; the "
        f"step {out['seconds']:.2f} s")
    check(ratio >= ps.OVERHEAD_FLOOR,
          f"profile: the armed arms kept {ratio:.4f} of the unprofiled "
          f"tok/s (median over the pairs), under {ps.OVERHEAD_FLOOR}")
    return out


# ------------------------------------------------------------- spec phase

#: the draft proposes up to this many tokens a round, as the reference's
#: speculative-decoding bench (``instaslice_tpu/bench_tpu.py:583-614``)
SPEC_K = 4
#: rows of the B2/B3 forwards of the spec path at the 871M configuration's
#: shapes: a draft step (8 slots, one token), the server's int8 verify
#: (8 slots x (k + 1) tokens), and the prefill chunks of 128 tokens of one
#: and of two slots (the draft's on the engine, the int8 target's on the
#: server)
SPEC_MS = (8, 8 * (SPEC_K + 1), 128, 256)
#: new tokens per prompt in the greedy comparison and over HTTP
SPEC_NEW = 32
#: the verify forward's logits (the bf16 target over k+1 rows, its fresh
#: entries attended in one local block) against k+1 single-row decode
#: forwards over the same tokens on a copy of the same cache (each reading
#: the fresh entries back from the bf16 cache): relative L2 over the
#: batch, at most this (bf16 activations round apart in the two orders)
SPEC_VERIFY_TOL = 2e-2
#: the same comparison on a float32 copy of the weights and the cache
#: (summation order alone apart), at most this
SPEC_VERIFY_TOL_FP32 = 1e-4
#: its control (the same forward with every length one further on) must
#: read at least this many times SPEC_VERIFY_TOL_FP32 (in bf16 the
#: control reads under 2x SPEC_VERIFY_TOL: the random weights' logits
#: depend on the context too little to rise above bf16 rounding)
SPEC_VERIFY_CONTROL = 5
#: the port server's own flags for the 871M configuration with the
#: ``--draft-*`` draft (the checkpoint flags are added at run time)
SPEC_SERVE_FLAGS = ("--quantize --vocab-size 32000 --d-model 2048 "
                    "--n-heads 16 --n-layers 16 --d-ff 8192 --max-batch 8 "
                    "--max-len 1024 --prefill-len 128 --host 127.0.0.1 "
                    f"--port 0 --draft-n-layers 16 --spec-k {SPEC_K}")
#: prompt lengths of the spec phase's 8 requests (engine and HTTP)
SPEC_PLENS = (600, 512, 400, 300, 257, 200, 129, 64)


def spec_config(torch):
    """The 871M serving configuration (``instaslice_tpu/bench_tpu.py:
    341-352``): vocab 32000, d_model 2048, 16 heads, 16 layers, d_ff 8192,
    bf16."""
    from instaslice_tpu_torch.models.lm import ModelConfig

    return ModelConfig(vocab_size=32000, d_model=2048, n_heads=16,
                       n_layers=16, d_ff=8192, max_seq_len=2048,
                       dtype=torch.bfloat16, remat=False)


def check_spec_kernels(torch, ops, qp) -> dict:
    """B2 (the six projections) and B3 (the unembedding) at the 871M
    int8 shapes and each row count of SPEC_MS, bf16 x: against their
    plain versions within QMM_TOL, two runs bit-equal, timed like phase
    2. Returns the details by kernel."""
    qm = ops.quant_matmul
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(31)
    xs = (torch.bfloat16,)
    b2 = [b2_case(torch, qm, qp["blocks"][name], name, M, gen, xs, "spec ")
          for M in SPEC_MS for name in BIG]
    b3 = [b3_case(torch, qm, qp["embed"], M, gen, xs, "spec ")
          for M in SPEC_MS]
    log_six("spec ", b2, SPEC_MS)
    return {"quant_matmul_stacked": b2, "quant_matmul_t": b3}


class Traced:
    """The kernel launches the card made inside the ``with`` block, by
    wrapper name (``ops.trace_launch_counts``), counted from a
    torch.profiler (CUPTI) trace of the device: a replayed CUDA graph
    launches its kernels with no wrapper call, so on the graph route only
    the trace sees them. ``kn`` names the wrapper of the (K, N) products
    on this path; ``kernels`` is every kernel the trace saw; ``t_end``
    the host clock when the block's work had finished on the card. The
    trace's raw device events are counted by name (the profiler's own
    event tree, which ``key_averages`` builds, costs ~0.1 ms an event on
    the host)."""

    def __init__(self, torch, ops, kn: str = "quant_matmul_stacked"):
        self.torch, self.ops, self.kn = torch, ops, kn
        self.counts, self.kernels, self.t_end = None, 0, None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = start_trace(self.torch,
                                profile(activities=[ProfilerActivity.CUDA]))
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.t_end = time.perf_counter()
        if exc[0] is not None:
            self.prof.__exit__(*exc)
            return False
        names = stop_trace(self.torch, self.prof)
        self.counts = self.ops.trace_launch_counts(names.items(), self.kn)
        self.kernels = sum(names.values())
        return False


#: seconds the host waits, after the card has run a traced window's work
#: and its end marker, before stopping the trace. The profiler drops, as
#: out of its range, a device record whose time lies past the host's stop,
#: and the device's times stray from the host's clock: by up to 173 ms
#: later within 49 windows of ``ops/trace_probe.py --edges`` on the H100,
#: and past 0.25 s in two windows of this script, which lost the end
#: marker so
TRACE_SETTLE_S = 1.0
#: the end marker's margin in each window stopped in this process: the
#: host's stop less the end of the marker's record, in ms (about
#: TRACE_SETTLE_S where the two clocks agree)
TRACE_END_MARGINS_MS: list = []
#: the lead-in of a traced window: this many short marker kernels
#: (``torch.cuda._sleep`` of TRACE_LEAD_CYCLES clock cycles, launch-bound:
#: ~20 ms of the host's time in all); the end marker spins
#: TRACE_END_CYCLES (~1 ms on the H100), and a spin record longer than
#: TRACE_END_NS is the end marker
TRACE_LEAD = 4096
TRACE_LEAD_CYCLES = 100
TRACE_END_CYCLES = 2_000_000
TRACE_END_NS = 250_000


def start_trace(torch, prof):
    """Start ``prof`` (CUDA activity on) for a window that
    :func:`stop_trace` ends. The profiler drops, as out of its range, a
    window's first device records, however long the host waits before
    them: on the H100 a count that grows with the process's age (~1 a
    record every 13 s of it in ``ops/trace_probe.py``; 1 to 82 over a
    run of this script), with rare spikes of hundreds (385 in the probe,
    527 in this script), whatever the records' spacing; a window's later
    records and other streams' were never dropped. A window whose first records held a
    counted kernel once read its launches wrong. So ``TRACE_LEAD`` short
    marker kernels run and are waited for before the window's work
    begins; :func:`stop_trace` needs one of them in the trace, and then
    no record of the work was dropped at the start. Returns ``prof``."""
    torch.cuda.synchronize()
    prof.__enter__()
    for _ in range(TRACE_LEAD):
        torch.cuda._sleep(TRACE_LEAD_CYCLES)
    torch.cuda.synchronize()
    return prof


def stop_trace(torch, prof):
    """Stop ``prof`` (started by :func:`start_trace`) and count its device
    kernels by name, from the raw trace events (the profiler's own event
    tree, which ``key_averages`` builds, costs ~0.1 ms an event on the
    host), the markers taken out. CUPTI hands a kernel's record over
    after the kernel ends: a trace stopped right after a synchronize lost
    the window's last kernels on the H100 (the last 7 layers of an eager
    7B step). So a long end marker runs after the work, the host waits
    ``TRACE_SETTLE_S`` before stopping (the profiler also drops a record
    whose device time strays past the stop), and the trace must hold
    that marker once and one marker of the lead-in: nothing of the work
    was dropped at either edge. Lead-in markers the profiler dropped are
    logged, and the end marker's margin kept
    (``TRACE_END_MARGINS_MS``)."""
    from collections import Counter

    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    torch.cuda._sleep(TRACE_END_CYCLES)
    torch.cuda.synchronize()
    time.sleep(TRACE_SETTLE_S)
    t_stop = time.time_ns()
    prof.__exit__(None, None, None)
    names, lead, ends = Counter(), 0, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if "spin_kernel" not in e.name():
            names[e.name()] += 1
        elif e.duration_ns() > TRACE_END_NS:
            ends.append((t_stop - e.start_ns() - e.duration_ns()) / 1e6)
        else:
            lead += 1
    check(len(ends) == 1 and lead >= 1,
          f"the trace lost a marker at its window's edges: {lead} of the "
          f"{TRACE_LEAD} lead-in markers, {len(ends)} end markers of 1; "
          f"{sum(names.values())} other records; the end marker's margin "
          f"in the earlier windows {trace_margins()}")
    TRACE_END_MARGINS_MS.append(ends[0])
    if lead < TRACE_LEAD:
        log(f"trace: the profiler dropped {TRACE_LEAD - lead} of the "
            f"{TRACE_LEAD} lead-in markers")
    return names


def trace_margins() -> str:
    """The end marker's margins so far (``TRACE_END_MARGINS_MS``) in
    brief."""
    m = sorted(TRACE_END_MARGINS_MS)
    if not m:
        return "(none yet)"
    return (f"over {len(m)} windows: min {m[0]:.1f} ms, median "
            f"{m[len(m) // 2]:.1f} ms, max {m[-1]:.1f} ms of a "
            f"{TRACE_SETTLE_S * 1e3:.0f} ms settle")


def eager_twin(eng, **kw):
    """An engine over ``eng``'s model and weights (shared, not copied) and
    its configuration, on the eager route (``decode_graphs=False``): the
    steps ``eng``'s graphs capture, run op by op, where instrumentation
    can read them. ``kw`` adds what the configuration holds besides
    (adapters, a draft)."""
    from instaslice_tpu_torch.serving import ServingEngine

    return ServingEngine(
        eng.model, eng.params, max_batch=eng.max_batch, max_len=eng.max_len,
        prefill_len=eng.prefill_len, kv_quant=eng.kv_quant,
        temperature=eng.temperature, device=eng.device, decode_graphs=False,
        **kw)


def lora_twin(eng):
    """:func:`eager_twin` of a multi-LoRA engine, its adapters taken from
    ``eng``'s stack (alpha 16, the recipe's)."""
    return eager_twin(eng, lora_adapters=[{"blocks": {
        t: {k: v[:, i] for k, v in ab.items()}
        for t, ab in eng.lora["blocks"].items()}}
        for i in range(1, eng.n_adapters + 1)],
        lora_alphas=[16.0] * eng.n_adapters)


def slot_runs(eng) -> list:
    """(tokens, logprobs) of every live slot, in slot order."""
    return [(list(r.generated), list(r.logprobs))
            for _, r in sorted(eng.slots.items())]


class ForwardLog:
    """The forwards an engine runs while ``on``: the (rows, T) of each
    target and draft forward, and the attended window of each
    single-token target forward (B1's). An eager forward is seen through
    the engine's ``_forward``/``_draft_forward``; a capture's are not
    counted (a capture records launches and makes none; its warm-up runs
    for real and is). A replayed graph runs no Python: its forwards
    follow, at :meth:`stop`, from its key in the engine's record of the
    replays it dispatched (``graph_replays``): a decode step is one (B,
    1) target forward, a spec round of depth k is k + 1 (B, 1) draft
    forwards and a (B, k + 1) verify, a catch-up of n steps one (B, n)
    draft forward. Once armed, it copies the first multi-row target
    forward's inputs and cache (taken before it writes) with its logits;
    ``tap(tokens, lengths, logits)`` sees every eager target forward."""

    def __init__(self, eng, tap=None):
        import torch

        self.eng, self.on, self.tap = eng, False, tap
        self.target, self.draft, self.attends = [], [], []
        self.capture = None
        self.replays0 = {}
        fwd, dfwd = eng._forward, eng._draft_forward
        capturing = torch.cuda.is_current_stream_capturing

        def target(tokens, cache, lengths, attend_len=0, **kw):
            live = not capturing()
            cap = (live and self.capture is not None and not self.capture
                   and tokens.shape[1] > 1)
            if cap:
                self.capture.update(
                    tokens=tokens.clone(), lengths=lengths.clone(),
                    attend=attend_len,
                    cache={k: c.clone() for k, c in cache.items()})
            out = fwd(tokens, cache, lengths, attend_len, **kw)
            if live and self.tap is not None:
                self.tap(tokens, lengths, out[0])
            if cap:
                self.capture["logits"] = out[0].clone()
            if self.on and live:
                self.target.append(tuple(tokens.shape))
                if tokens.shape[1] == 1:
                    self.attends.append(attend_len or cache["k"].shape[3])
            return out

        def draft(tokens, cache, lengths, attend_len=0):
            if self.on and not capturing():
                self.draft.append(tuple(tokens.shape))
            return dfwd(tokens, cache, lengths, attend_len)

        eng._forward, eng._draft_forward = target, draft

    def start(self):
        self.target, self.draft, self.attends = [], [], []
        self.replays0 = dict(self.eng.graph_replays)
        self.on = True

    def stop(self):
        self.on = False
        B, S = self.eng.max_batch, self.eng.max_len
        for key, n in list(self.eng.graph_replays.items()):
            n -= self.replays0.get(key, 0)
            if key[0] == "decode_block":
                self.target += [(B, 1)] * n
                self.attends += [key[1] or S] * n
            elif key[0] == "spec_round":
                k = key[1]
                self.draft += [(B, 1)] * ((k + 1) * n)
                self.target += [(B, k + 1)] * n
                if k == 0:
                    self.attends += [key[2] or S] * n
            else:
                self.draft += [(B, key[1])] * n

    def close(self):
        for name in ("_forward", "_draft_forward"):
            self.eng.__dict__.pop(name, None)


def within_budget(graphs: dict, what: str) -> None:
    """A ``/v1/stats`` ``decode_graphs`` block: the graph route, with every
    form's captured graphs within ``compile_budget``."""
    over = {f: n for f, n in graphs["graphs"].items()
            if n > graphs["budget"][f]}
    check(graphs["route"] == "cuda graphs" and not over,
          f"{what}: decode graphs {graphs}")


def fp32_tree(tree):
    """A float32 copy of a parameter or cache tree of tensors."""
    if isinstance(tree, dict):
        return {k: fp32_tree(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree.clone()


def verify_readings(torch, model, params, cache, toks, lens, att):
    """The (B, k+1) forward over ``toks`` on a copy of ``cache``; its
    relative L2 distance from k+1 single-row decode forwards over the same
    tokens (each writing its entry, the next reading it back), and from
    the control, the same (B, k+1) forward with every row's length one
    further on (positions and the mask one off: what a verify that wrote
    or read its fresh entries one place away would compute)."""
    def fresh():
        return {n: c.clone() for n, c in cache.items()}

    full, _ = model.apply_with_cache(params, toks, fresh(), lens,
                                     attend_len=att)
    off, _ = model.apply_with_cache(params, toks, fresh(), lens + 1,
                                    attend_len=att)
    c, rows = fresh(), []
    for j in range(toks.shape[1]):
        lg, _ = model.apply_with_cache(params, toks[:, j:j + 1], c,
                                       lens + j, attend_len=att)
        rows.append(lg[:, 0])
    single = torch.stack(rows, dim=1)
    return (full, single, float((single - full).norm() / full.norm()),
            float((off - full).norm() / full.norm()))


def check_verify(torch, model, params, cap: dict, accepted: list) -> dict:
    """The captured verify forward against plain forwards on copies of
    its cache: the same (B, k+1) forward again (a determinism check: the
    engine's verify is this call) and k+1 single-row decode forwards
    (within SPEC_VERIFY_TOL), with the off-by-one control read beside
    them; then the same comparison on a float32 copy of the weights and
    cache, where rounding no longer hides a mask or position fault: within
    SPEC_VERIFY_TOL_FP32, its control at least SPEC_VERIFY_CONTROL times
    that. The engine's accepted count per row against the one computed
    here from the proposals and the plain forward's argmax."""
    from instaslice_tpu_torch.models.lm import TpuLM

    toks, lens, att = cap["tokens"], cap["lengths"], cap["attend"]
    k = toks.shape[1] - 1
    again, single, rel, control = verify_readings(
        torch, model, params, cap["cache"], toks, lens, att)
    check(bool(torch.equal(again, cap["logits"])),
          "spec: determinism: a plain forward over the verify's tokens and "
          "cache equals the engine's verify forward bit for bit")
    check(rel <= SPEC_VERIFY_TOL, f"spec: verify logits vs single-row "
          f"decode forwards rel L2 {rel} > {SPEC_VERIFY_TOL}")
    m32 = TpuLM(dataclasses.replace(model.cfg, dtype=torch.float32))
    _, _, rel32, control32 = verify_readings(
        torch, m32, fp32_tree(params), fp32_tree(cap["cache"]), toks, lens,
        att)
    log(f"spec: verify logits vs k+1 single-row decode forwards rel L2 "
        f"{rel:.3e} (tolerance {SPEC_VERIFY_TOL:g}; control, lengths one "
        f"further on: {control:.3e}); in float32 {rel32:.3e} (tolerance "
        f"{SPEC_VERIFY_TOL_FP32:g}; control {control32:.3e}, must be >= "
        f"{SPEC_VERIFY_CONTROL * SPEC_VERIFY_TOL_FP32:g})")
    check(rel32 <= SPEC_VERIFY_TOL_FP32, f"spec: float32 verify logits vs "
          f"single-row decode forwards rel L2 {rel32} > "
          f"{SPEC_VERIFY_TOL_FP32}")
    check(control32 >= SPEC_VERIFY_CONTROL * SPEC_VERIFY_TOL_FP32,
          f"spec: the float32 off-by-one control reads {control32}, under "
          f"{SPEC_VERIFY_CONTROL} x its tolerance: the check could not see "
          "a wrong mask or position")
    t = again.argmax(dim=-1)
    host = torch.cumprod((toks[:, 1:] == t[:, :k]).long(), dim=1).sum(1)
    check(host.tolist() == accepted, f"spec: accepted per row "
          f"{accepted} != host {host.tolist()} (k {k})")
    argmax_same = float((single.argmax(-1) == t).float().mean())
    return {"k": k, "rel_l2_vs_single_row": rel,
            "control_rel_l2_lengths_plus_one": control,
            "fp32_rel_l2_vs_single_row": rel32,
            "fp32_control_rel_l2_lengths_plus_one": control32,
            "accepted": accepted,
            "argmax_agreement_vs_single_row": argmax_same}


def phase_spec(torch, ops) -> dict:
    """Speculative decoding on the 871M configuration: B2/B3 at its int8
    shapes and the path's row counts; the engine path (bf16 target,
    ``quantize_params`` of the same weights as the draft, batch 8, max_len
    1024, prefill 128, spec_k 4, adaptive ladder) with greedy rounds held
    against plain decode from the same admission and one verify forward
    against plain forwards and an off-by-one control; tokens/s and tokens
    per round against plain decode, device ms of the draft and of the
    verify, a sampled run; one engine export/import between two spec
    engines (resumed target and draft cache rows, the next round's draft
    logits, proposals and accepted counts); the port server from its CLI
    wiring (int8 target verifying, bf16 draft of the same weights restored
    from a port checkpoint) answering 8 concurrent completions; B1 at the
    871M's head layout and the server's single-token forwards' shapes."""
    from instaslice_tpu_torch.models.lm import TpuLM, init_params
    from instaslice_tpu_torch.models.quant import quantize_params
    from instaslice_tpu_torch.serving import AdmissionRequest, ServingEngine

    cfg = spec_config(torch)
    model = TpuLM(cfg)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    draft = quantize_params(params)
    log(f"spec: 871M weights and their int8 copy in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {"kernels": check_spec_kernels(torch, ops, draft)}
    L, V = cfg.n_layers, cfg.vocab_size
    opts = dict(max_batch=8, max_len=1024, prefill_len=128, device="cuda")
    eng = ServingEngine(model, params, draft_model=model, draft_params=draft,
                        spec_k=SPEC_K, **opts)
    fl = ForwardLog(eng)
    eng.warm_prefill_buckets()
    eng.warm_spec_programs()
    warm_graphs = eng.graph_stats()
    log(f"spec: warm-up captured {warm_graphs['graphs']} graphs in "
        f"{warm_graphs['capture_seconds']:.1f} s")
    gen = torch.Generator().manual_seed(41)
    prompts = [torch.randint(1, V, (n,), generator=gen).tolist()
               for n in SPEC_PLENS]

    def admit():
        eng.radix.reclaim(eng.kv.total_blocks)
        eng.add_requests([AdmissionRequest(p) for p in prompts])

    def chains():
        return [eng.slots[s].generated[:SPEC_NEW] for s in range(8)]

    # ---- greedy spec rounds from an admission, launches counted
    fl.start()
    with Traced(torch, ops) as tr:
        admit()
        rounds, ks = 0, []
        t_rounds = time.perf_counter()
        while min(len(r.generated) for r in eng.slots.values()) < SPEC_NEW:
            k = eng.spec_plan_k()
            eng.spec_step(k=k)
            rounds += 1
            ks.append(k)
        torch.cuda.synchronize()
        t_rounds = time.perf_counter() - t_rounds
    fl.stop()
    counts = tr.counts
    spec_chains = chains()
    spec_runs = slot_runs(eng)
    draft_rows = [b * t for b, t in fl.draft]
    check(all(len(c) == SPEC_NEW for c in spec_chains), "spec chains")
    check(counts["quant_matmul_stacked"]
          == 6 * L * sum(r <= 256 for r in draft_rows) > 0,
          "spec: B2 launches = 6 x layers x draft forwards of <= 256 rows")
    check(counts["quant_matmul_t"] == sum(r <= 256 for r in draft_rows),
          "spec: B3 launches = draft forwards of <= 256 rows")
    check(counts["quant_decode_attention"] == 0 and counts["quant_matmul"]
          == 0 and all(counts[n] == 0 for n in FLASH),
          "spec: B1 and B4-B7 are not on the bf16-target path")
    log(f"spec: {rounds} greedy rounds (k {ks}) after one burst admission "
        f"of {list(SPEC_PLENS)}: {len(fl.target)} target forwards, "
        f"{len(fl.draft)} draft forwards (rows "
        f"{sorted(set(draft_rows))}), launches {counts}; accepted "
        f"{eng.spec_accepted} of {eng.spec_proposed}")
    # ---- the same admission through plain decode
    for s in list(eng.slots):
        eng.evict_slot(s)
    admit()
    eng.decode_block(SPEC_NEW - 1)
    plain_chains = chains()
    for i, (a, b) in enumerate(zip(spec_chains, plain_chains)):
        check(a == b, f"spec: prompt {i} spec chain {a} != plain {b}")
    distinct = len({t for c in spec_chains for t in c})
    log(f"spec: greedy spec chains equal plain decode_block's for all 8 "
        f"prompts ({distinct} distinct tokens across them)")
    for s in list(eng.slots):
        eng.evict_slot(s)
    # ---- the same admission and rounds on the eager route (an eager
    # twin over the same weights): tokens and logprobs bit-equal to the
    # replayed rounds'; then one more round there, whose verify forward
    # is held against single-row forwards (its inputs are copied from
    # the eager round's Python: a replay has none) and which the graph
    # engine's round from the same state equals
    twin = eager_twin(eng, draft_model=model, draft_params=draft,
                      spec_k=SPEC_K)
    tfl = ForwardLog(twin)
    for e in (twin, eng):
        e.radix.reclaim(e.kv.total_blocks)
        e.add_requests([AdmissionRequest(p) for p in prompts])
    for k in ks:
        twin.spec_step(k=k)
    check(slot_runs(twin) == spec_runs, "spec: the eager route's rounds "
          "equal the replayed rounds (tokens and logprobs)")
    for k in ks:
        eng.spec_step(k=k)
    rid_slot = {r.request_id: s for s, r in twin.slots.items()}
    tfl.capture = {}
    emitted = twin.spec_step(k=SPEC_K)
    acc = [0] * 8
    for rid, seq in emitted.items():
        acc[rid_slot[rid]] = len(seq) - 1
    out["verify"] = check_verify(torch, model, params, dict(tfl.capture),
                                 acc)
    eng.spec_step(k=SPEC_K)
    check(slot_runs(eng) == slot_runs(twin), "spec: the verified round "
          "replayed equals the eager round")
    log(f"spec: {rounds} rounds and one more of k {SPEC_K} on the eager "
        f"twin equal the replayed ones; verify forward check "
        f"{out['verify']}")
    tfl.close()
    for e in (eng, twin):
        for s in list(e.slots):
            e.evict_slot(s)
    out.update(counts=counts, rounds=rounds, ks=ks,
               accepted=eng.spec_accepted, proposed=eng.spec_proposed,
               rounds_ms=t_rounds / rounds * 1e3)

    # ---- throughput: spec rounds vs plain decode, device ms per round;
    # the same rounds on the eager twin
    d = eng.spec_throughput(rounds=16, detail=True)
    for s in list(eng.slots):
        eng.evict_slot(s)
    d_eager = twin.spec_throughput(rounds=16, detail=True)
    for s in list(twin.slots):
        twin.evict_slot(s)
    # the same engine's plain decode blocks (its draft catching up after
    # each block), and an engine of the same weights with no draft
    same_tok_s = eng.throughput(n_steps=32)
    for s in list(eng.slots):
        eng.evict_slot(s)
    plain_eng = ServingEngine(model, params, **opts)
    plain_tok_s = plain_eng.throughput(n_steps=32)
    del plain_eng
    for _ in range(eng.free_slots()):
        eng.add_request([1, 2, 3])
    k = eng.spec_plan_k()
    attend = eng._spec_attend(k)
    d_all, _ = eng._spec_draft(k + 1, True, 1e-6, attend)
    busy_draft = device_busy(torch, lambda: eng._spec_draft(
        k + 1, True, 1e-6, attend), 1)
    busy_verify = device_busy(torch, lambda: eng._spec_verify(
        d_all[:, :k], None, True, 1e-6, attend), 1)
    # the whole round as the engine replays it: one graph
    busy_round = device_busy(torch, lambda: eng.spec_step(k=k), 1)
    for s in list(eng.slots):
        eng.evict_slot(s)
    round_ms = d["wall_seconds"] / 16 * 1e3
    out["throughput"] = {
        "spec_tok_s": d["tokens_per_sec"],
        "spec_tokens_per_round": d["tokens_per_round"],
        "eager_spec_tok_s": d_eager["tokens_per_sec"],
        "eager_round_ms": d_eager["wall_seconds"] / 16 * 1e3,
        "plain_tok_s": plain_tok_s, "same_engine_plain_tok_s": same_tok_s,
        "round_ms": round_ms, "k": k,
        "device_ms_draft": busy_draft and busy_draft["ms_per_step"],
        "device_ms_verify": busy_verify and busy_verify["ms_per_step"],
        "device_ms_round": busy_round and busy_round["ms_per_step"],
        "graphs": eng.graph_stats(),
        "draft_top": busy_draft and busy_draft["top"],
        "verify_top": busy_verify and busy_verify["top"]}
    log(f"spec: batch 8 greedy, {d['tokens_per_sec']:.1f} tok/s with spec "
        f"({d['tokens_per_round']:.2f} tokens per slot-round, "
        f"{round_ms:.1f} ms a round on the host clock; the eager twin "
        f"{d_eager['tokens_per_sec']:.1f} tok/s, "
        f"{out['throughput']['eager_round_ms']:.1f} ms a round) vs plain "
        f"decode {plain_tok_s:.1f} tok/s without a draft, {same_tok_s:.1f} on the "
        f"spec engine (its draft catching up); device per round at k {k}: "
        f"draft "
        f"{out['throughput']['device_ms_draft']} ms ({k + 1} forwards), "
        f"verify {out['throughput']['device_ms_verify']} ms; the replayed "
        f"round {out['throughput']['device_ms_round']} ms on the card; "
        f"graphs {out['throughput']['graphs']}")
    # ---- sampled rounds
    eng.temperature = 0.8
    a0, p0 = eng.spec_accepted, eng.spec_proposed
    ds = eng.spec_throughput(rounds=8, detail=True)
    for s in list(eng.slots):
        eng.evict_slot(s)
    eng.temperature = 0.0
    rate = (eng.spec_accepted - a0) / max(1, eng.spec_proposed - p0)
    out["sampled"] = {"acceptance": rate,
                      "tokens_per_round": ds["tokens_per_round"],
                      "tok_s": ds["tokens_per_sec"]}
    log(f"spec: sampled (temperature 0.8) acceptance {rate:.3f}, "
        f"{ds['tokens_per_round']:.2f} tokens per slot-round, "
        f"{ds['tokens_per_sec']:.1f} tok/s")

    # ---- one engine-level export/import between two spec engines, on
    # both routes: the graph engine exports to a graph engine, its eager
    # twin (the same steps) to an eager engine; the eager pair's next
    # round is read (draft logits, proposals), and all four next rounds
    # agree
    other = ServingEngine(model, params, draft_model=model,
                          draft_params=draft, spec_k=SPEC_K, **opts)
    twin_b = eager_twin(eng, draft_model=model, draft_params=draft,
                        spec_k=SPEC_K)
    pairs = {"graph": (eng, other), "eager": (twin, twin_b)}
    rids, n = {}, None
    for route, (a, b) in pairs.items():
        rid = a.add_request(prompts[3])
        a.spec_step(k=SPEC_K)
        a.spec_step(k=SPEC_K)
        a.preempt_slot(0)
        blob = json.loads(json.dumps(a.export_session(rid)))
        check(blob["draft_stripe"]["k"]["dtype"] == "bfloat16"
              and blob["stripe"]["k"]["dtype"] == "bfloat16",
              "spec: the blob carries both bf16 stripes")
        rid_b = b.import_session(blob)
        n = blob["length"]
        rids[route] = (rid, rid_b)
        check((a.resume_request(rid), b.resume_request(rid_b)) == (0, 0),
              f"spec migration ({route}): both resume into slot 0")
        # the resumed rows of both caches, the draft's included: an
        # import that dropped or mis-wrote the draft stripe differs here,
        # where the collapsed greedy chain of random weights would not
        # show it
        for cname in ("cache", "draft_cache"):
            for key, c in getattr(a, cname).items():
                check(bool(torch.equal(c[:, 0, :, :n],
                                       getattr(b, cname)[key][:, 0, :, :n])),
                      f"spec migration ({route}): resumed {cname} rows "
                      f"{key}[:{n}] equal")
    seen = {}
    for name, e in (("a", twin), ("b", twin_b)):
        dr, dfwd = e._spec_draft, e._draft_forward

        def rec(*a, _dr=dr, _n=name):
            d_all, q = _dr(*a)
            seen[_n] = d_all.clone()
            return d_all, q

        def grab(tokens, cache, lengths, attend_len=0, _f=dfwd, _n=name):
            out = _f(tokens, cache, lengths, attend_len)
            seen.setdefault(_n + "_draft_logits", out[0][0].clone())
            return out
        e._spec_draft, e._draft_forward = rec, grab
        a0 = e.spec_accepted
        seen[name + "_out"] = (e.spec_step(k=SPEC_K), e.spec_accepted - a0)
        e._spec_draft, e._draft_forward = dr, dfwd
    (out_a, acc_a), (out_b, acc_b) = seen["a_out"], seen["b_out"]
    rid, rid_b = rids["eager"]
    check(bool(torch.equal(seen["a_draft_logits"], seen["b_draft_logits"])),
          "spec migration: the next round's first draft logits are equal "
          "bit for bit")
    check(bool(torch.equal(seen["a"][0], seen["b"][0])),
          "spec migration: the next round's proposals are equal")
    check(acc_a == acc_b and out_a[rid] == out_b[rid_b],
          "spec migration: the next round's accepted counts and tokens "
          "are equal")
    emitted = {"eager_a": out_a[rid], "eager_b": out_b[rid_b]}
    for name, e, r in (("graph_a", eng, rids["graph"][0]),
                       ("graph_b", other, rids["graph"][1])):
        emitted[name] = e.spec_step(k=SPEC_K)[r]
    # each next round's tokens and their logprobs (slot 0's last ones)
    runs = {name: (emitted[name], e.slots[0].logprobs[-len(emitted[name]):])
            for name, e in (("graph_a", eng), ("graph_b", other),
                            ("eager_a", twin), ("eager_b", twin_b))}
    check(all(r == runs["eager_a"] for r in runs.values()),
          f"spec migration: the exporter's and the importer's next rounds "
          f"on the graph route equal the eager route's (tokens and "
          f"logprobs): {runs}")
    log(f"spec: engine export/import between two spec engines on each "
        f"route: resumed target and draft cache rows [0, {n}) equal, next "
        f"round's first draft logits equal bit for bit (eager), proposals "
        f"{seen['a'][0].tolist()}, accepted {acc_a}, the four next rounds' "
        f"tokens and logprobs equal")
    for e in (eng, other, twin, twin_b):
        for s in list(e.slots):
            e.evict_slot(s)
        e.radix.reclaim(e.kv.total_blocks)
        check(e.kv.used_blocks() == 0, "spec: no leaked KV blocks")
    del eng, other, twin, twin_b, fl
    free_memory(torch)

    out["serve"] = spec_serve(torch, ops, params, prompts)
    del params, draft
    free_memory(torch)
    # B1 at the 871M's MHA layout (Hkv 16, G 1) and the server's own
    # single-token forwards' lengths and window
    shapes = [(f"spec server forward {i}", lens, att)
              for i, (lens, att) in enumerate(out["serve"]["b1_shapes"])]
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(37)
    out["kernels"]["quant_decode_attention"], e = b1_cases(
        torch, cfg, ops.flash_decode, gen, out["serve"]["cache_len"], shapes,
        "spec ")
    out["b1_max_abs_err"] = e
    return out


def spec_serve(torch, ops, params, prompts) -> dict:
    """The 871M spec server from its own CLI wiring over a port
    checkpoint of ``params``: 8 concurrent greedy completions, B1-B3
    counted per target forward, then (server stopped) the same prompts
    through its engine without spec rounds."""
    import shutil
    import threading

    from instaslice_tpu_torch.models.checkpoint import TrainCheckpointer
    from instaslice_tpu_torch.models.train import TrainState, leaves
    from instaslice_tpu_torch.serving import api_server

    ck = HERE / "build" / "spec_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    t0 = time.perf_counter()
    TrainCheckpointer(str(ck)).save(TrainState(
        step=1, params=params,
        opt_state=torch.optim.SGD(leaves(params), lr=0.0)))
    args = api_server.build_parser().parse_args(
        SPEC_SERVE_FLAGS.split() + ["--checkpoint", str(ck),
                                    "--draft-checkpoint", str(ck)])
    eng = api_server.build_engine(args)
    shutil.rmtree(ck, ignore_errors=True)
    check(eng.kv_quant and eng.draft_model is not None
          and eng.draft_cache["k"].dtype == torch.bfloat16,
          "spec server: int8 target W+KV, bf16 draft")
    srv = api_server.ApiServer(eng, host=args.host, port=args.port).start()
    setup_s = time.perf_counter() - t0
    L = args.n_layers
    fl = ForwardLog(eng)
    try:
        wait_ready(srv.url)
        results, errors = [None] * len(prompts), []

        def one(i):
            try:
                body = {"prompt": prompts[i], "max_tokens": SPEC_NEW,
                        "temperature": 0.0, "logprobs": True}
                results[i] = http_json(srv.url + "/v1/completions",
                                       body)["choices"][0]
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"request {i}: {e!r}")

        st0 = http_json(srv.url + "/v1/stats")["spec"]
        fl.start()
        t0 = time.perf_counter()
        with Traced(torch, ops) as tr:
            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(len(prompts))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        wall = tr.t_end - t0
        fl.stop()
        counts = tr.counts
        st = http_json(srv.url + "/v1/stats")
    finally:
        srv.stop()
    check(not errors, f"spec server: {errors}")
    spec = st["spec"]
    rows = [b * t for b, t in fl.target]
    decode_fw = sum(t == 1 for _, t in fl.target)
    kern_fw = sum(r <= 256 for r in rows)
    log(f"spec server: 8 concurrent completions in {wall:.2f} s; target "
        f"forwards by (rows, T) {sorted(set(fl.target))}, draft forwards "
        f"{len(fl.draft)}, launches {counts}; /v1/stats spec {spec}")
    check(spec["rounds"] > st0["rounds"]
          and spec["accepted"] > st0["accepted"]
          and spec["proposed"] >= spec["accepted"],
          "spec server: /v1/stats shows rounds and acceptance")
    check(counts["quant_decode_attention"] == L * decode_fw > 0,
          "spec server: B1 launches = layers x single-token forwards")
    check(counts["quant_matmul_stacked"] == 6 * L * kern_fw > 0,
          "spec server: B2 launches = 6 x layers x target forwards of "
          "<= 256 rows")
    check(counts["quant_matmul_t"] == kern_fw, "spec server: B3 launches")
    check(any(t > 1 and b * t <= 256 for b, t in fl.target),
          "spec server: an int8 verify forward ran B2/B3")
    eng.radix.reclaim(eng.kv.total_blocks)
    again = eng.generate(prompts, SPEC_NEW)
    lp = 0.0
    for i, (r, g) in enumerate(zip(results, again)):
        check(r["token_ids"] == g.tokens, f"spec server: request {i} "
              f"tokens {r['token_ids']} != without spec {g.tokens}")
        lp = max(lp, max(abs(a - b) for a, b in zip(r["logprobs"],
                                                     g.logprobs)))
    check(lp <= SERVE_LOGPROB_TOL, f"spec server: logprobs differ from "
          f"plain decode by {lp}")
    st_kv = eng.kv_stats()
    check(st_kv["used"] == eng.radix.pool_blocks(),
          "spec server: no leaked KV blocks")
    tok = sum(len(r["token_ids"]) for r in results)
    log(f"spec server: {tok} tokens in {wall:.2f} s = {tok / wall:.1f} tok/s "
        f"over HTTP (prefill included); tokens equal to plain decode of the "
        f"same engine, logprobs within {lp:.3g}; setup {setup_s:.1f} s")
    forwards = sorted(set(fl.target))
    # B1's shapes on this path: the rows' lengths at their first and at
    # their last decode step, each at the smallest and the largest window
    # the single-token forwards attended
    plens = [len(p) for p in prompts]
    b1 = []
    for lens, att in (([n + 1 for n in plens], min(fl.attends)),
                      ([n + SPEC_NEW - 1 for n in plens], max(fl.attends))):
        shape = (lens, att if max(lens) < att < eng.max_len else 0)
        if shape not in b1:
            b1.append(shape)
    cache_len = eng.cache["k"].shape[3]
    del eng, srv, fl
    free_memory(torch)
    return {"counts": counts, "wall_s": wall, "tok_s": tok / wall,
            "spec": spec, "logprob_diff": lp, "setup_s": setup_s,
            "target_forwards": forwards, "b1_shapes": b1,
            "cache_len": cache_len}


# ---------------------------------------------------------- migrate phase

#: the migrated session: a prompt of this many tokens, this many new
#: tokens, drained after at least MIG_AT of them have streamed
MIG_PLEN = 560
MIG_NEW = 64
MIG_AT = 8
#: the migrated stream's logprobs against the same request unmigrated on
#: the source: the continuation decodes on another engine whose attended
#: window (and so B1's split of the cache) may differ, which moves fp32
#: sums, not tokens
MIG_LOGPROB_TOL = 1e-3


#: the fleet step (in the migrate phase): the router's added TTFT is the
#: median over this many prompts of FLEET_PLEN tokens (one whole granule
#: of the servers' 128-token prefill, which the radix cache keeps, and
#: one more), FLEET_NEW new tokens each (greedy, logprobs, streamed),
#: routed and then direct on the replica the router chose, each with both
#: radix caches emptied
FLEET_TTFT_N = 5
FLEET_PLEN = 129
FLEET_NEW = 4
#: the migration through the router: a prompt of this many tokens and
#: this many new ones (the blob, and so the export, grows with the
#: session's length)
FLEET_MIG_PLEN = 64
FLEET_MIG_NEW = 32
#: the prefix-affinity prompt: the last TTFT prompt's first
#: FLEET_SHARED tokens (its granule), then FLEET_TAIL fresh ones
FLEET_SHARED = 128
FLEET_TAIL = 64
#: the port's loadgen against the router: requests, concurrency, prompt
#: length, max_tokens, seed; streamed
FLEET_LOADGEN = (16, 8, 128, 32, 0)
#: the reference loadgen's report keys for a streamed run with no
#: tenants, adapters, prefix pool, trace or nemesis and no errors
#: (``instaslice_tpu/serving/loadgen.py:523-627``); the port's must match
FLEET_LOADGEN_KEYS = (
    "metric", "value", "unit", "requests", "concurrency", "ok", "errors",
    "outcomes", "status_counts", "p95_latency", "p99_latency",
    "mean_latency", "client_tokens_per_sec", "client_tokens", "stream",
    "trace_id_prefix", "ttft_p50", "ttft_p95", "ttft_p99", "ttft_mean",
    "tpot_p50", "tpot_p95", "tpot_p99")


#: the telemetry step (inside the fleet step): the most seconds it may
#: take, its polls, scrapes, traced request and HTTP plane together, and
#: the seconds the aggregator's pinned clock moves at each poll
TELEMETRY_BUDGET_S = 10.0
TELEMETRY_TICK_S = 5.0


def replica_tokens(urls) -> list:
    """Each replica's own ``tpuslice_serve_tokens_total``, scraped from
    its ``/metrics`` and read by the port's exposition parser."""
    import urllib.request

    from instaslice_tpu_torch.obs.telemetry import metric_sum, parse_exposition

    out = []
    for u in urls:
        with urllib.request.urlopen(u + "/metrics", timeout=60) as r:
            out.append(metric_sum(parse_exposition(r.read().decode()),
                                  "tpuslice_serve_tokens_total"))
    return out


class FleetTelemetry:
    """The port's fleet telemetry (``obs/telemetry.py``) over the fleet
    step's router and its replicas: a ``FleetAggregator`` that discovers
    the replicas from the router's ``/v1/stats``, its clock pinned and
    moved TELEMETRY_TICK_S at each poll, no loop thread (``sample`` calls
    ``poll`` directly), behind a ``TelemetryServer``. ``seconds`` sums the
    host time of the step's own work, ``poll_ms`` each ``poll``'s."""

    def __init__(self, router_url: str, urls: list):
        import importlib.util

        from instaslice_tpu_torch.metrics.metrics import FleetMetrics
        from instaslice_tpu_torch.obs.journal import Journal
        from instaslice_tpu_torch.obs.telemetry import (
            FleetAggregator,
            TelemetryServer,
        )

        t0 = time.perf_counter()
        spec = importlib.util.find_spec("prometheus_client")
        self.prometheus = spec is not None
        log(f"telemetry: importlib.util.find_spec('prometheus_client') = "
            f"{spec}")
        self.urls, self.clock, self.poll_ms = urls, [time.time()], []
        self.agg = FleetAggregator(router_url=router_url,
                                   metrics=FleetMetrics(), journal=Journal(),
                                   clock=lambda: self.clock[0])
        self.server = TelemetryServer(self.agg).start()
        self.seconds = time.perf_counter() - t0

    def sample(self) -> tuple:
        """One ``poll`` (the rollup) and each replica's own token counter
        read right after it."""
        t0 = time.perf_counter()
        self.clock[0] += TELEMETRY_TICK_S
        fleet = self.agg.poll()
        self.poll_ms.append((time.perf_counter() - t0) * 1e3)
        toks = replica_tokens(self.urls)
        self.seconds += time.perf_counter() - t0
        return fleet, toks

    def reconcile(self, before: tuple, after: tuple, rep: dict) -> dict:
        """(a) The rollup's change over the loadgen run against the
        client's report, exactly: tokens and ok requests; each replica's
        own token counter moved and the two add up to the client's
        tokens (so a rollup missing either replica's scrape misses); the
        KV totals those of both servers' ``/v1/stats``; no scrape
        failed."""
        t0 = time.perf_counter()
        (f0, tok0), (f1, tok1) = before, after
        d_tokens = f1["tokens"] - f0["tokens"]
        d_ok = f1["ok_requests"] - f0["ok_requests"]
        own = [b - a for a, b in zip(tok0, tok1)]
        check(d_tokens == rep["client_tokens"],
              f"telemetry (a): the rollup's tokens moved {d_tokens}, the "
              f"client received {rep['client_tokens']}")
        check(d_ok == rep["ok"], f"telemetry (a): the rollup's ok requests "
              f"moved {d_ok}, the client's ok {rep['ok']}")
        check(len(own) == 2 and min(own) > 0
              and sum(own) == rep["client_tokens"],
              f"telemetry (a): each replica's own tokens moved {own}, the "
              f"client received {rep['client_tokens']}")
        stats = [http_json(u + "/v1/stats") for u in self.urls]
        free = sum(int(s["kv"]["free"]) for s in stats)
        total = free + sum(int(s["kv"]["used"]) for s in stats)
        check(f1["kv"]["free"] == free and f1["kv"]["total"] == total,
              f"telemetry (a): the rollup's KV {f1['kv']}, both servers' "
              f"/v1/stats free {free} of {total}")
        check(sorted(f1["replicas"]) == sorted(self.urls)
              and all(r["ok"] for r in f1["replicas"].values()),
              f"telemetry (a): replicas discovered {f1['replicas']}")
        check(f0["scrapes"]["error"] == f1["scrapes"]["error"] == 0,
              f"telemetry (a): scrapes {f0['scrapes']}, {f1['scrapes']}")
        self.seconds += time.perf_counter() - t0
        out = {"tokens": d_tokens, "ok_requests": d_ok,
               "replica_tokens": own, "kv": f1["kv"],
               "scrapes": f1["scrapes"]}
        log(f"telemetry (a): over the loadgen run the rollup moved "
            f"{d_tokens} tokens and {d_ok} ok requests, the client's "
            f"exactly; the replicas' own counters {own}; KV {f1['kv']} "
            f"equals both servers' /v1/stats; scrapes {f1['scrapes']}")
        return out

    def stitch(self, router_url: str, prompt: list, n_new: int) -> dict:
        """(b) One greedy request through the router under a fresh
        ``X-Trace-Id`` (the loadgen's ``_one_request``), then a poll: the
        stitched timeline holds the router's and the server's spans. The
        router records ``router.route`` in the trace without naming a
        parent (as the reference's does) and the server roots its spans at
        ``serve.request``: the router's span opens the timeline, starting
        before every server span, and each server span's parents lead to
        that root within the trace."""
        from instaslice_tpu_torch.obs.telemetry import span_component
        from instaslice_tpu_torch.serving.loadgen import _one_request
        from instaslice_tpu_torch.utils.trace import new_trace_id

        t0 = time.perf_counter()
        tid = new_trace_id()
        _, _, toks, err, code = _one_request(
            router_url, prompt, n_new, stream=False, timeout=120.0,
            trace_id=tid)
        check(err is None and toks > 0,
              f"telemetry (b): the traced request: {err} ({code}), {toks} "
              "tokens")
        self.seconds += time.perf_counter() - t0
        self.sample()
        t0 = time.perf_counter()
        tl = self.agg.stitcher.timeline(tid)
        spans = tl["spans"]
        by_id = {s["spanId"]: s for s in spans}
        serve = [s for s in spans if span_component(s["name"]) == "serve"]
        roots = [s for s in serve if s["name"] == "serve.request"]

        def root_of(s):
            while s.get("parentId") in by_id:
                s = by_id[s["parentId"]]
            return s

        check({"router", "serve"} <= set(tl["components"]),
              f"telemetry (b): components {tl['components']}")
        check(spans[0]["name"] == "router.route" and len(roots) == 1
              and all(spans[0]["start"] <= s["start"] for s in serve)
              and all(root_of(s) is roots[0] for s in serve),
              f"telemetry (b): the router's span does not open the "
              f"timeline of the server's: "
              f"{[(s['name'], s['start'], s.get('parentId')) for s in spans]}")
        self.seconds += time.perf_counter() - t0
        out = {"trace_id": tid, "components": tl["components"],
               "spans": [s["name"] for s in spans]}
        log(f"telemetry (b): trace {tid} stitched: components "
            f"{tl['components']}, spans {out['spans']}")
        return out

    def plane(self) -> dict:
        """(c) The HTTP plane against the aggregator: ``/v1/fleet``'s
        tokens, ``/metrics``' ``tpuslice_fleet_tokens_total``, and
        ``tpuslice-gpu fleet --url`` run in process."""
        import contextlib
        import io
        import urllib.request

        from instaslice_tpu_torch.cli import tpuslicectl
        from instaslice_tpu_torch.obs.telemetry import parse_exposition

        t0 = time.perf_counter()
        url = self.server.url
        tokens = self.agg.fleet()["tokens"]
        served = http_json(url + "/v1/fleet")
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            samples = parse_exposition(r.read().decode())
        exposed = [v for (n, _), v in samples.items()
                   if n == "tpuslice_fleet_tokens_total"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tpuslicectl.main(["fleet", "--url", url])
        ctl = json.loads(buf.getvalue())
        check(served["tokens"] == tokens and exposed == [tokens]
              and rc == 0 and ctl["tokens"] == tokens,
              f"telemetry (c): the aggregator's tokens {tokens}, /v1/fleet "
              f"{served['tokens']}, /metrics {exposed}, tpuslice-gpu fleet "
              f"rc {rc} {ctl.get('tokens')}")
        self.seconds += time.perf_counter() - t0
        log(f"telemetry (c): /v1/fleet, /metrics and tpuslice-gpu fleet "
            f"read the aggregator's {tokens} tokens")
        return {"tokens": tokens}

    def stop(self) -> None:
        self.server.stop()


def served_by(srvs, before: list) -> int:
    """Index of the one server whose ``tokens_generated`` moved since
    ``before`` (each server's reading then)."""
    moved = [i for i, (s, n) in enumerate(zip(srvs, before))
             if s.scheduler.stats()["tokens_generated"] != n]
    check(len(moved) == 1, f"fleet: {len(moved)} servers served one "
          "request")
    return moved[0]


def generated(srvs) -> list:
    return [s.scheduler.stats()["tokens_generated"] for s in srvs]


def radix_cold(srvs, engs) -> None:
    """Empty every server's radix cache, on its scheduler thread."""
    for s, e in zip(srvs, engs):
        s.scheduler.control(lambda e=e: e.radix.reclaim(e.kv.total_blocks))
        check(e.radix.pool_blocks() == 0, "fleet: a radix cache emptied")


def fleet_step(torch, ops, srvs, engs, L: int, V: int) -> dict:
    """The port's fleet router (``serving/router.py``) in front of the
    migrate phase's two 7B int8 servers, and the port's loadgen through
    it. (a) A greedy completion with logprobs routed, then the same
    request direct on the replica the router chose, both radix caches
    emptied before each: tokens equal, logprobs within MIG_LOGPROB_TOL,
    the router's added TTFT the median of FLEET_TTFT_N; (b) a prompt
    sharing the last one's granules goes to the replica that holds them
    (``routed["prefix"]`` up by one, a radix hit there); (c) a streamed
    request through the router, its replica removed with ``migrate`` once
    MIG_AT tokens have streamed: one stream, no 503, its tokens those of
    the same request unmigrated, ``migrations["resumed"]`` up by one;
    (d) ``loadgen.run`` against the router (FLEET_LOADGEN): no errors,
    the reference's report keys, B1-B3 on the card's trace equal to what
    both engines' forwards imply (only this run is traced); (e) the
    telemetry step (``FleetTelemetry``): one poll just before (d) and one
    after its trace has stopped, reconciled exactly with the loadgen's
    report; a traced request stitched across the router and the server;
    the HTTP plane; its seconds within TELEMETRY_BUDGET_S."""
    import statistics
    import threading

    from instaslice_tpu_torch.serving import loadgen
    from instaslice_tpu_torch.serving.router import Router

    t_step = time.perf_counter()
    urls = [s.url for s in srvs]
    gen = torch.Generator().manual_seed(47)
    out = {}
    # eject_factor=0 turns off the gray-failure sweep: the two servers
    # share one card and one host, so one answers its polls slowly while
    # the other prefills, and the sweep would drain it with migrate in
    # the middle of a step that holds every export it makes
    router = Router(urls, poll_interval=0.1, eject_factor=0).start()
    fls, parts, tel = [], {}, None
    try:
        # (a)
        t_part = time.perf_counter()
        added, worst = [], 0.0
        for _ in range(FLEET_TTFT_N):
            prompt = torch.randint(1, V, (FLEET_PLEN,),
                                   generator=gen).tolist()
            body = {"prompt": prompt, "max_tokens": FLEET_NEW,
                    "temperature": 0.0, "logprobs": True, "stream": True}
            radix_cold(srvs, engs)
            before = generated(srvs)
            t_send = time.perf_counter()
            routed = http_stream(router.url + "/v1/completions", body)
            t_routed = routed["t_first"] - t_send
            i = served_by(srvs, before)
            radix_cold(srvs, engs)
            t_send = time.perf_counter()
            direct = http_stream(urls[i] + "/v1/completions", body)
            t_direct = direct["t_first"] - t_send
            check(routed["token_ids"] == direct["token_ids"]
                  and len(routed["token_ids"]) == FLEET_NEW,
                  f"fleet (a): routed tokens {routed['token_ids']} != "
                  f"direct {direct['token_ids']}")
            lp = max(abs(x - y) for x, y in
                     zip(routed["logprobs"], direct["logprobs"]))
            check(lp <= MIG_LOGPROB_TOL, f"fleet (a): logprobs differ by {lp}")
            worst = max(worst, lp)
            added.append((t_routed - t_direct) * 1e3)
        out["ttft_added_ms"] = statistics.median(added)
        out["ttft_added_all_ms"] = added
        out["logprob_diff"] = worst
        log(f"fleet (a): {FLEET_TTFT_N} greedy completions of {FLEET_PLEN} "
            f"tokens routed equal the same request direct (logprobs within "
            f"{worst:.3g}); TTFT added by the router, median "
            f"{out['ttft_added_ms']:.2f} ms of {[round(a, 2) for a in added]}")
        parts["a"] = time.perf_counter() - t_part
        # (b) the direct request left the prompt in replica i's radix
        t_part = time.perf_counter()
        router.poll_now()
        shared = prompt[:FLEET_SHARED] + torch.randint(
            1, V, (FLEET_TAIL,), generator=gen).tolist()
        hits0 = [s.scheduler.stats()["radix"]["hits"] for s in srvs]
        prefix0 = router.routed.get("prefix", 0)
        before = generated(srvs)
        http_stream(router.url + "/v1/completions",
                    dict(body, prompt=shared))
        j = served_by(srvs, before)
        hits = [s.scheduler.stats()["radix"]["hits"] for s in srvs]
        check(j == i and router.routed.get("prefix", 0) == prefix0 + 1
              and hits[j] == hits0[j] + 1,
              f"fleet (b): the shared prompt went to replica {j} (its "
              f"prefix holder {i}), routed {router.routed}, radix hits "
              f"{hits0} -> {hits}")
        out["prefix"] = {"replica": j, "routed": dict(router.routed)}
        log(f"fleet (b): a prompt sharing {FLEET_SHARED} tokens went to "
            f"replica {j}, which holds them: policy prefix, a radix hit")
        parts["b"] = time.perf_counter() - t_part
        # (c)
        t_part = time.perf_counter()
        prompt = torch.randint(1, V, (FLEET_MIG_PLEN,),
                               generator=gen).tolist()
        body = {"prompt": prompt, "max_tokens": FLEET_MIG_NEW,
                "temperature": 0.0, "logprobs": True, "stream": True}
        resumed0 = router.migrations.get("resumed", 0)
        progress, res = {"n": 0}, {}

        def stream():
            try:
                res.update(http_stream(router.url + "/v1/completions",
                                       body, progress=progress))
            except Exception as e:  # noqa: BLE001 - reported below
                res["error"] = repr(e)

        radix_cold(srvs, engs)
        th = threading.Thread(target=stream)
        th.start()
        deadline = time.monotonic() + 120
        while progress["n"] < MIG_AT and time.monotonic() < deadline \
                and th.is_alive():
            time.sleep(0.005)
        (k,) = [n for n, s in enumerate(srvs)
                if s.scheduler.stats()["live_slots"]]
        t0 = time.perf_counter()
        removed = router.remove_replica(urls[k], migrate=True)
        out["remove_ms"] = (time.perf_counter() - t0) * 1e3
        th.join(timeout=120)
        check("error" not in res and res.get("session") is None
              and res.get("finish_reason") == "max_new_tokens",
              f"fleet (c): the client's stream {res.get('error')}, "
              f"finish {res.get('finish_reason')}")
        check(removed["removed"] and removed["migrated"] == 1,
              f"fleet (c): remove_replica {removed}")
        check(router.migrations.get("resumed", 0) == resumed0 + 1,
              f"fleet (c): router migrations {router.migrations}")
        undrain(urls[k])
        radix_cold(srvs, engs)
        ref = http_stream(urls[k] + "/v1/completions", body)
        check(res["token_ids"] == ref["token_ids"]
              and len(ref["token_ids"]) == FLEET_MIG_NEW,
              f"fleet (c): migrated tokens {res['token_ids']} != "
              f"unmigrated {ref['token_ids']}")
        lp = max(abs(x - y) for x, y in
                 zip(res["logprobs"], ref["logprobs"]))
        check(lp <= MIG_LOGPROB_TOL, f"fleet (c): logprobs differ by {lp}")
        out["migration"] = {"replica": k, "removed": removed,
                            "logprob_diff": lp,
                            "migrations": dict(router.migrations)}
        log(f"fleet (c): replica {k} removed with migrate after "
            f"{MIG_AT}+ tokens ({out['remove_ms']:.1f} ms): one stream, no "
            f"503, {FLEET_MIG_NEW} tokens equal the unmigrated run "
            f"(logprobs within {lp:.3g}); router migrations "
            f"{router.migrations}")
        router.add_replica(urls[k])
        parts["c"] = time.perf_counter() - t_part
        # (e) begins: the telemetry step's first poll, outside (d)'s trace
        tel = FleetTelemetry(router.url, urls)
        before = tel.sample()
        # (d) the main path, traced
        t_part = time.perf_counter()
        n_req, conc, plen, new, seed = FLEET_LOADGEN
        fls = [ForwardLog(e) for e in engs]
        steps0 = [e.decode_steps for e in engs]
        for fl in fls:
            fl.start()
        t0 = time.perf_counter()
        with Traced(torch, ops) as tr:
            t_in = time.perf_counter()
            rep = loadgen.run(router.url, n_req, conc, plen, new, V, True,
                              300.0, seed=seed)
            t_out = time.perf_counter()
        wall = tr.t_end - t0
        for fl in fls:
            fl.stop()
        check(rep["errors"] == 0 and rep["ok"] == n_req,
              f"fleet (d): loadgen {rep}")
        check(set(rep) == set(FLEET_LOADGEN_KEYS),
              f"fleet (d): report keys {sorted(rep)} != the reference's")
        steps = sum(e.decode_steps - s0 for e, s0 in zip(engs, steps0))
        rows = [b * t for fl in fls for b, t in fl.target]
        kfw = sum(r <= 256 for r in rows)
        check(sum(len(fl.attends) for fl in fls) == steps > 0,
              "fleet (d): every decode step replayed a graph captured "
              "before the run")
        want = {**dict.fromkeys(ops.KERNEL_WRAPPERS, 0),
                "quant_decode_attention": L * steps,
                "quant_matmul_stacked": 6 * L * kfw,
                "quant_matmul_t": kfw}
        check(tr.counts == want, f"fleet (d): launches {tr.counts}, want "
              f"{want} (B1 = {L} x {steps} decode steps, B2 = {6 * L} x "
              f"{kfw} forwards of <= 256 rows, B3 = {kfw})")
        out["loadgen"] = rep
        out["counts"] = tr.counts
        out["decode_steps"], out["kernel_forwards"] = steps, kfw
        out["loadgen_wall_s"] = wall
        out["loadgen_s"] = t_out - t_in
        log(f"fleet (d): loadgen through the router, {n_req} requests at "
            f"concurrency {conc}, prompt {plen}, {new} tokens, streamed: "
            f"{rep['client_tokens_per_sec']} tok/s, TTFT p50 "
            f"{rep['ttft_p50']} s p99 {rep['ttft_p99']} s, no errors "
            f"({t_out - t_in:.2f} s, {wall:.2f} s with the trace's start); "
            f"routed {router.routed}; launches "
            f"(trace) {tr.counts} = B1 {L} x {steps}, B2 {6 * L} x {kfw}, "
            f"B3 {kfw}")
        parts["d"] = time.perf_counter() - t_part
        # (e) the telemetry step, its second poll after (d)'s trace stopped
        after = tel.sample()
        tele = {"reconcile": tel.reconcile(before, after, rep)}
        prompt = torch.randint(1, V, (FLEET_PLEN,), generator=gen).tolist()
        tele["stitch"] = tel.stitch(router.url, prompt, FLEET_NEW)
        tele["plane"] = tel.plane()
        tele.update(seconds=tel.seconds, poll_ms=tel.poll_ms,
                    poll_ms_median=statistics.median(tel.poll_ms),
                    prometheus_client=tel.prometheus)
        out["telemetry"] = tele
        parts["e"] = tel.seconds
        check(tel.seconds <= TELEMETRY_BUDGET_S,
              f"telemetry: the step took {tel.seconds:.2f} s, over its "
              f"budget of {TELEMETRY_BUDGET_S} s")
        log(f"telemetry: the step {tel.seconds:.2f} s, poll() median "
            f"{tele['poll_ms_median']:.1f} ms of "
            f"{[round(x, 1) for x in tel.poll_ms]}, prometheus_client "
            f"{'present' if tel.prometheus else 'absent'}")
    finally:
        if tel is not None:
            tel.stop()
        for fl in fls:
            fl.close()
        router.stop()
    out["seconds"] = time.perf_counter() - t_step
    out["seconds_by_part"] = parts
    log(f"fleet: {out['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    return out


#: the chaos step's gray arm (in the migrate phase, after the fleet step,
#: on its two servers): the seed of its nemesis plan and of the loadgen's
#: nemesis arm; the router's knobs, the latency on its hop to A and the
#: loadgen runs are the reference smoke's (``analysis/chaos_smoke.py``
#: ``GRAY_ROUTER``, ``GRAY_DELAY_S``, ``GRAY_LOADGEN``)
GRAY_SEED = 1234
#: the longest the gray arm waits for A's ejection (A is seasoned by 6
#: polls of GRAY_DELAY_S first)
GRAY_WAIT_S = 60.0


def gray_arm(srvs, event_file: str) -> dict:
    """A replica that answers every request but slower, on the card: the
    port's gray arm (``analysis/chaos_smoke.py`` ``gray_replica``) over
    the migrate phase's two 7B int8 servers (A, B): a second router with
    the gray sweep on, ``set_nemesis`` putting ``GRAY_DELAY_S`` on its
    hop to A from its first poll. A is ejected on its latency EWMA alone
    (``ReplicaEjected``); a loadgen run around it is all ``ok``, none
    hung, A's engine generating nothing meanwhile; the heal, and A is
    re-admitted (``ReplicaReadmitted``); the loadgen's nemesis arm then
    hangs nothing; ``check_nemesis`` is clean on the phase's event file.
    The two servers share one card and one host: both replicas'
    ``lat_p95`` are logged at each poll the arm waits on, and B ejected
    at any time fails the phase (never retried). No migration and no
    prefill burst runs inside it: each request is 4 tokens of prompt and
    4 new."""
    from types import SimpleNamespace

    from instaslice_tpu_torch import faults
    from instaslice_tpu_torch.analysis import chaos_smoke as cs
    from instaslice_tpu_torch.analysis import validate_events as ve
    from instaslice_tpu_torch.obs import journal
    from instaslice_tpu_torch.serving import loadgen
    from instaslice_tpu_torch.serving.router import Router

    def events():
        got, errors = ve.read_events(event_file)
        check(not errors, f"chaos (a): the phase's event file: {errors[:5]}")
        return got

    serving = SimpleNamespace(faults=faults, journal=journal,
                              loadgen=loadgen, Router=Router)
    r = cs.gray_replica(serving, ve, GRAY_SEED, eject_timeout=GRAY_WAIT_S,
                        servers=srvs, events=events)
    found = cs.findings_of(r)
    for p in r["polls"]:
        log(f"chaos (a) poll: {p[0]} at {p[1]} s: p95 A {p[2]} ms, B "
            f"{p[3]} ms, A ejected {p[4]}")
    check(not found, f"chaos (a): {found}")
    out = {k: r[k] for k in ("eject_s", "readmit_s", "ejections",
                             "around_outcomes", "nemesis_arm", "seconds")}
    out["polls"] = len(r["polls"])
    log(f"chaos (a): A ejected {r['eject_s']:.2f} s after the router's "
        f"first poll ({cs.GRAY_DELAY_S} s on its hop to A), B never; the "
        f"loadgen around it {r['around_outcomes']}, A's engine idle; "
        f"re-admitted {r['readmit_s']:.2f} s after the heal; the loadgen's "
        f"nemesis arm {r['nemesis_arm']}; check_nemesis clean over the "
        f"phase's event file; {out['polls']} polls; "
        f"{r['seconds']:.1f} s")
    return out


def phase_migrate(torch, ops, sinks: Path) -> dict:
    """Session migration between two port servers at the 7B int8
    configuration (``SERVE_FLAGS``), in process on port 0: a streamed
    completion starts on A, A drains with ``{"migrate": true}``, the
    migration terminal's blob goes to B's ``/v1/sessions/import`` and a
    ``{"resume": rid}`` completion finishes it on B; its tokens and
    logprobs against the same request unmigrated on A; then, the servers
    stopped, B's first decode logits after importing a parked session
    against A's own continuation from the same parked state, bit for bit;
    no KV block leaks on either.
    This process's tracer and journal (its two servers', its router's and
    its engines') write ``sinks/fleet.trace.jsonl`` and
    ``sinks/fleet.events.jsonl`` over the phase, listed in ``out["sinks"]``
    for :func:`phase_obs`. The files are one pair for the three: the
    servers and the router run in this process, so that the card's trace
    of it counts their launches, and the tracer and the journal are the
    process's."""
    import threading

    from instaslice_tpu_torch.obs.journal import Journal, reset_journal
    from instaslice_tpu_torch.serving import api_server
    from instaslice_tpu_torch.utils.trace import Tracer, reset_tracer

    files = {"trace": {"fleet": str(sinks / "fleet.trace.jsonl")},
             "event": {"fleet": str(sinks / "fleet.events.jsonl")}}
    reset_tracer(Tracer(trace_file=files["trace"]["fleet"]))
    reset_journal(Journal(event_file=files["event"]["fleet"]))
    try:
        args = api_server.build_parser().parse_args(SERVE_FLAGS.split())
        t0 = time.perf_counter()
        engs = [api_server.build_engine(args) for _ in range(2)]
        srvs = [api_server.ApiServer(e, host=args.host,
                                     port=args.port).start() for e in engs]
        log("migrate: two 7B int8 servers up in "
            f"{time.perf_counter() - t0:.1f} s")
        a_url, b_url = (s.url for s in srvs)
        V = args.vocab_size
        gen = torch.Generator().manual_seed(43)
        prompt = torch.randint(1, V, (MIG_PLEN,), generator=gen).tolist()
        body = {"prompt": prompt, "max_tokens": MIG_NEW, "temperature": 0.0,
                "logprobs": True, "stream": True}
        out = {}
        try:
            for url in (a_url, b_url):
                wait_ready(url)
            # cold TTFT of the prompt (on B; its radix cache then holds the
            # prompt, which a resume never reads)
            t_send = time.perf_counter()
            cold = http_stream(b_url + "/v1/completions",
                               dict(body, max_tokens=2))
            out["cold_ttft_ms"] = (cold["t_first"] - t_send) * 1e3
            # the migrated stream
            progress, res = {"n": 0}, {}

            def stream():
                try:
                    res.update(http_stream(a_url + "/v1/completions", body,
                                           progress=progress))
                except Exception as e:  # noqa: BLE001 - reported below
                    res["error"] = repr(e)

            th = threading.Thread(target=stream)
            th.start()
            deadline = time.monotonic() + 300
            while progress["n"] < MIG_AT and time.monotonic() < deadline \
                    and th.is_alive():
                time.sleep(0.005)
            t_drain = time.perf_counter()
            drained = http_json(a_url + "/v1/drain",
                                {"budget": 30, "migrate": True})
            t_drained = time.perf_counter()
            th.join(timeout=300)
            check("error" not in res, f"migrate: stream {res.get('error')}")
            check(drained["migrated"] == 1, f"migrate: drain {drained}")
            blob = res["session"]
            check(blob is not None, "migrate: the stream ended in a migration "
                  "terminal")
            wire = json.dumps({"session": blob})
            out["blob_mb"] = len(wire) / 1e6
            out["drain_ms"] = (t_drained - t_drain) * 1e3
            out["drain_to_terminal_ms"] = (res["t_session"] - t_drain) * 1e3
            t0 = time.perf_counter()
            imp = http_json(b_url + "/v1/sessions/import", {"session": blob})
            out["import_ms"] = (time.perf_counter() - t0) * 1e3
            t_send = time.perf_counter()
            resumed = http_stream(b_url + "/v1/completions",
                                  {"resume": imp["rid"], "stream": True})
            out["resume_first_token_ms"] = (resumed["t_first"] - t_send) * 1e3
            toks = res["token_ids"] + resumed["token_ids"]
            lps = res["logprobs"] + resumed["logprobs"]
            # the same request unmigrated on A
            undrain(a_url)
            ref = http_stream(a_url + "/v1/completions", body)
            out["split"] = [len(res["token_ids"]), len(resumed["token_ids"])]
            check(toks == ref["token_ids"] and len(toks) == MIG_NEW,
                  f"migrate: stitched tokens {toks} != unmigrated "
                  f"{ref['token_ids']}")
            lp = max(abs(x - y) for x, y in zip(lps, ref["logprobs"]))
            out["logprob_diff"] = lp
            check(lp <= MIG_LOGPROB_TOL, f"migrate: logprobs differ by {lp}")
            stats = [http_json(u + "/v1/stats") for u in (a_url, b_url)]
            for name, st in zip("AB", stats):
                check(st["live_slots"] == 0 and st["parked"] == 0
                      and st["sessions"]["imports_pending"] == 0,
                      f"migrate: server {name} quiesced")
                check(st["kv"]["used"] == st["radix"]["blocks"],
                      f"migrate: server {name} leaked KV blocks: {st['kv']}")
            check(stats[0]["sessions"]["exported"] == 1
                  and stats[1]["sessions"]["imported"] == 1
                  and stats[1]["sessions"]["migrated_in"] == 1,
                  "migrate: the session ledgers")
            out["sessions"] = [st["sessions"] for st in stats]
            out["fleet"] = fleet_step(torch, ops, srvs, engs, args.n_layers,
                                      V)
            out["gray"] = gray_arm(srvs, files["event"]["fleet"])
        finally:
            for s in srvs:
                s.stop()
        log(f"migrate: over HTTP, {out['split'][0]} tokens on A then "
            f"{out['split'][1]} on B equal the unmigrated run (logprobs "
            f"within {out['logprob_diff']:.3g}); blob {out['blob_mb']:.1f} MB "
            f"of JSON; drain POST {out['drain_ms']:.1f} ms, drain to "
            "migration terminal at the client "
            f"{out['drain_to_terminal_ms']:.1f} ms, import POST "
            f"{out['import_ms']:.1f} ms, resume to first token "
            f"{out['resume_first_token_ms']:.1f} ms vs cold TTFT "
            f"{out['cold_ttft_ms']:.1f} ms")

        # ---- engine level, the servers stopped: A's continuation from a
        # parked state against B's after importing it, on both routes (A and
        # B replay graphs; their eager twins over the same weights run the
        # same steps, and their first decode logits are read)
        eng_a, eng_b = engs
        twins = [eager_twin(e) for e in engs]
        for e in engs:
            e.radix.reclaim(e.kv.total_blocks)
        prompt2 = torch.randint(1, V, (600,), generator=gen).tolist()
        logits, conts = {}, {}
        for route, (a, b) in (("graph", engs), ("eager", twins)):
            rid = a.add_request(prompt2)
            a.decode_block(7)
            a.preempt_slot(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blob = a.export_session(rid)
            t1 = time.perf_counter()
            wire = json.dumps(blob)
            t2 = time.perf_counter()
            blob2 = json.loads(wire)
            t3 = time.perf_counter()
            rid_b = b.import_session(blob2)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            if route == "graph":
                stripe = blob["stripe"]
                length = blob["length"]
                out["engine"] = {
                    "length": length, "stripe_shape": stripe["k"]["shape"],
                    "wire_mb": len(wire) / 1e6, "export_ms": (t1 - t0) * 1e3,
                    "json_encode_ms": (t2 - t1) * 1e3,
                    "json_decode_ms": (t3 - t2) * 1e3,
                    "import_ms": (t4 - t3) * 1e3}
            for name, e, r in (("a", a, rid), ("b", b, rid_b)):
                rec = StepLogits(e) if route == "eager" else None
                slot = e.resume_request(r)
                check(slot == 0, "migrate: the session resumes into slot 0")
                e.decode_block(4)
                if rec is not None:
                    rec.close()
                    logits[name] = rec.steps[0][0]
                conts[route + "_" + name] = (
                    e.slots[0].generated[-4:], e.slots[0].logprobs[-4:])
        check(bool(torch.equal(logits["a"], logits["b"])),
              "migrate: B's first decode logits after import equal A's "
              "continuation bit for bit")
        check(all(c == conts["eager_a"] for c in conts.values()),
              "migrate: the next 4 tokens and logprobs after the import "
              "equal A's continuation, on the graph route as on the eager: "
              f"{conts}")
        for name, e in zip(("A", "B", "A's twin", "B's twin"), engs + twins):
            for s in list(e.slots):
                e.evict_slot(s)
            e.radix.reclaim(e.kv.total_blocks)
            check(e.kv.used_blocks() == 0 and not e.parked,
                  f"migrate: engine {name} leaked KV blocks")
        log(f"migrate: engine level, a {length}-token session (stripe "
            f"{stripe['k']['shape']} int8 + fp32 scales): {out['engine']}; "
            "B's first decode logits equal A's continuation bit for bit "
            "(eager), the next 4 tokens and logprobs equal on both routes")
        del engs, eng_a, eng_b, srvs, twins
        free_memory(torch)
    finally:
        # closes both files; the next phase's tracer and journal are
        # made afresh from the environment
        reset_tracer()
        reset_journal()
    out["sinks"] = files
    return out


# ------------------------------------------------------------- kill phase

#: the chaos step's kill arm: the port's loadgen through the port's router
#: over two 7B int8 replicas (``SERVE_FLAGS``), each a process of its own:
#: requests, concurrency, prompt length, new tokens, seed (greedy,
#: streamed). The victim is SIGKILLed once its ``/v1/stats`` shows a live
#: slot; a third replica, started with the others, joins after the kill
KILL_LOADGEN = (24, 4, 64, 24, 0)
#: the longest a replica process may take to build, warm and listen
REPLICA_START_S = 400.0
REPLICAS = ("victim", "survivor", "fresh")


def replica_child(out: str, flags: str, after: tuple = ()) -> int:
    """One replica of the kill arm in a process of its own: the server
    from its CLI wiring (``flags``), its spans and events in the files
    ``TPUSLICE_TRACE_FILE`` and ``TPUSLICE_EVENT_FILE`` name. The three
    start together, but each builds its weights only once the files
    ``after`` (earlier replicas' ``out/built``) exist, and frees the bf16
    weights' cached memory before writing its own: three 7B bf16 inits
    at once (~15 GiB each before quantizing) did not fit beside one
    another on the card, two do. It warms
    the decode graphs the arm's traffic takes with one request of its
    shape, then opens a traced window (``Traced``, a ``ForwardLog``) and
    writes ``out/ready.json`` (URL, pid, build and warm seconds); it
    serves until SIGTERM, closes the window and writes
    ``out/result.json``: B1-B3 from the card's trace of this process,
    what its forwards imply (as the fleet step counts them), and its
    ledger at the stop (live and parked slots, KV blocks used against
    the radix cache's). A SIGKILL writes nothing past ``ready.json``."""
    import os
    import signal
    import threading

    import torch

    from instaslice_tpu_torch import ops
    from instaslice_tpu_torch.serving import api_server

    out_dir = Path(out)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    t_turn = time.perf_counter()
    while not all(Path(a).exists() for a in after):
        check(time.perf_counter() - t_turn < REPLICA_START_S,
              f"replica: {after} never appeared")
        time.sleep(0.05)
    t0 = time.perf_counter()
    args = api_server.build_parser().parse_args(flags.split())
    eng = api_server.build_engine(args)
    torch.cuda.empty_cache()
    (out_dir / "built").write_text("")
    srv = api_server.ApiServer(eng, host=args.host, port=args.port).start()
    res = {"pid": os.getpid(), "url": srv.url, "turn_s": t0 - t_turn,
           "build_s": time.perf_counter() - t0}
    fl = None
    try:
        wait_ready(srv.url)
        _, _, plen, new, _ = KILL_LOADGEN
        t1 = time.perf_counter()
        warm = http_stream(srv.url + "/v1/completions", {
            "prompt": list(range(1, plen + 1)), "max_tokens": new,
            "temperature": 0.0, "stream": True})
        check(len(warm["token_ids"]) == new, "replica: the warm request")
        res["warm_s"] = time.perf_counter() - t1
        fl = ForwardLog(eng)
        steps0 = eng.decode_steps
        fl.start()
        with Traced(torch, ops) as tr:
            (out_dir / "ready.json").write_text(json.dumps(res))
            while not stop.wait(0.2):
                pass
        fl.stop()
        steps = eng.decode_steps - steps0
        kfw = sum(b * t <= 256 for b, t in fl.target)
        L = args.n_layers
        st = srv.scheduler.stats()
        res.update(
            counts=tr.counts, decode_steps=steps, kernel_forwards=kfw,
            graph_steps=len(fl.attends),
            want={**dict.fromkeys(ops.KERNEL_WRAPPERS, 0),
                  "quant_decode_attention": L * steps,
                  "quant_matmul_stacked": 6 * L * kfw,
                  "quant_matmul_t": kfw},
            ledger={"live_slots": st["live_slots"], "parked": st["parked"],
                    "kv_used": st["kv"]["used"],
                    "radix_blocks": st["radix"]["blocks"],
                    "tokens_generated": st["tokens_generated"]})
    finally:
        if fl is not None:
            fl.close()
        srv.stop()
        (out_dir / "result.json").write_text(json.dumps(res))
    return 0


def torn_lines(path: str) -> tuple:
    """(lines, the numbers of those that do not parse) of a JSONL file."""
    bad, n = [], 0
    with open(path) as f:
        for n, line in enumerate(f, 1):
            if line.strip():
                try:
                    json.loads(line)
                except ValueError:
                    bad.append(n)
    return n, bad


def phase_kill(torch, sinks: Path) -> dict:
    """The chaos step's kill arm on the card: a 7B int8 replica SIGKILLed
    mid-stream under the port's router. Three replicas
    (:func:`replica_child`), each a process with its own trace and event
    files, start together (the victim's and the survivor's weights built
    at once, the fresh replica's after them); the router (in this process, its own file
    pair) fronts the victim and the survivor, and the port's loadgen
    streams ``KILL_LOADGEN`` through it. Once the victim holds a live
    slot it is SIGKILLed (a power cut: no drain, no terminal), the third
    replica is added (``add_replica``) and the victim removed
    (``remove_replica``). The outcomes sum to the requests, none hung, at
    least one ``ok``, every other one a classified crash signature; the
    victim exits -9; the survivor and the fresh replica end quiesced with
    no KV leak, a greedy request through the router has the tokens of the
    same request sent direct to each, and each counts B1-B3 on the
    card's trace of its own process equal to its forwards at a clean
    stop (SIGTERM, exit 0). The victim's cut-off files must parse but
    for a torn last line. Returns the files for :func:`phase_obs` (the
    router's, the survivor's and the fresh replica's: the C11 check)."""
    import os
    import shutil
    import signal
    import tempfile
    import threading

    from instaslice_tpu_torch.analysis.chaos_smoke import kill_ledger
    from instaslice_tpu_torch.obs.journal import Journal, reset_journal
    from instaslice_tpu_torch.serving import api_server, loadgen
    from instaslice_tpu_torch.serving.router import Router
    from instaslice_tpu_torch.utils.trace import Tracer, reset_tracer

    t_phase = time.perf_counter()
    free_memory(torch)
    V = api_server.build_parser().parse_args(SERVE_FLAGS.split()).vocab_size
    names = ("router",) + REPLICAS
    files = {kind: {f"chaos_{n}": str(sinks / f"chaos_{n}.{kind}.jsonl")
                    for n in names} for kind in ("trace", "event")}
    reset_tracer(Tracer(trace_file=files["trace"]["chaos_router"]))
    reset_journal(Journal(event_file=files["event"]["chaos_router"]))
    work = Path(tempfile.mkdtemp(prefix="kill-"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPUSLICE_")}
    procs, logs, router, out = {}, {}, None, {}
    try:
        for n in REPLICAS:
            # the fresh replica builds once the other two have
            after = tuple(str(work / m / "built") for m in REPLICAS[:2]) \
                if n == "fresh" else ()
            (work / n).mkdir()
            logs[n] = open(work / f"{n}.log", "w")
            procs[n] = subprocess.Popen(
                [sys.executable, "-c", "import sys; sys.path.insert(0, "
                 f"{str(HERE)!r}); import chip_smoke; sys.exit(chip_smoke."
                 f"replica_child({str(work / n)!r}, {SERVE_FLAGS!r}, "
                 f"{after!r}))"],
                env=dict(env,
                         TPUSLICE_TRACE_FILE=files["trace"][f"chaos_{n}"],
                         TPUSLICE_EVENT_FILE=files["event"][f"chaos_{n}"]),
                cwd=HERE, stdout=logs[n], stderr=subprocess.STDOUT)

        def tail(n: str) -> str:
            return (work / f"{n}.log").read_text()[-3000:]

        def all_ready():
            for n, p in procs.items():
                check(p.poll() is None, f"chaos (b): replica {n} exited "
                      f"({p.returncode}) before it listened: {tail(n)}")
            return all((work / n / "ready.json").exists() for n in REPLICAS)

        wait_until(all_ready, "three replicas listening",
                   timeout=REPLICA_START_S, poll=0.2, phase="chaos (b)")
        ready = {n: json.loads((work / n / "ready.json").read_text())
                 for n in REPLICAS}
        out["start_s"] = time.perf_counter() - t_phase
        out["build_s"] = {n: r["build_s"] for n, r in ready.items()}
        out["turn_s"] = {n: r["turn_s"] for n, r in ready.items()}
        out["warm_s"] = {n: r["warm_s"] for n, r in ready.items()}
        urls = {n: r["url"].rstrip("/") for n, r in ready.items()}
        # eject_factor=0: the kill is this arm's fault, not a gray one
        router = Router([urls["victim"], urls["survivor"]],
                        poll_interval=0.1, stale_after=1.0,
                        migrate_timeout=3.0, eject_factor=0).start()
        wait_until(lambda: all(r.stats for r in router.replicas()),
                   "the router's first polls", poll=0.05, phase="chaos (b)")
        n_req, conc, plen, new, seed = KILL_LOADGEN
        report, fresh_first = {}, {}
        th = threading.Thread(target=lambda: report.update(loadgen.run(
            router.url, n_req, conc, plen, new, V, True, 300.0,
            seed=seed)))
        th.start()
        wait_until(lambda: http_json(urls["victim"] + "/v1/stats",
                                     timeout=10)["live_slots"] > 0,
                   "a live slot on the victim", poll=0.01,
                   phase="chaos (b)")
        t_kill = time.perf_counter()
        procs["victim"].send_signal(signal.SIGKILL)
        out["victim_exit"] = procs["victim"].wait(timeout=60)
        gen0 = http_json(urls["fresh"] + "/v1/stats")["tokens_generated"]
        router.add_replica(urls["fresh"])
        t_add = time.perf_counter()

        def first_token():
            while th.is_alive() and "s" not in fresh_first:
                if http_json(urls["fresh"] + "/v1/stats")[
                        "tokens_generated"] > gen0:
                    fresh_first["s"] = time.perf_counter() - t_add
                time.sleep(0.01)

        watcher = threading.Thread(target=first_token)
        watcher.start()
        router.remove_replica(urls["victim"])
        out["kill_to_removed_ms"] = (time.perf_counter() - t_kill) * 1e3
        th.join(timeout=300)
        watcher.join(timeout=10)
        check(report and not th.is_alive(), "chaos (b): the loadgen never "
              "finished")
        oc = report["outcomes"]
        out["outcomes"] = {k: v for k, v in oc.items() if v}
        out["fresh_first_token_s"] = fresh_first.get("s")
        check(out["victim_exit"] == -signal.SIGKILL,
              f"chaos (b): the victim exited {out['victim_exit']}")
        found = kill_ledger(oc, n_req)
        check(not found, f"chaos (b): outcomes {oc}: {found}")
        # a greedy request through the router, and direct to each replica
        gen = torch.Generator().manual_seed(53)
        body = {"prompt": torch.randint(1, V, (plen,),
                                        generator=gen).tolist(),
                "max_tokens": 8, "temperature": 0.0, "stream": True}
        routed = http_stream(router.url + "/v1/completions", body)
        direct = {n: http_stream(urls[n] + "/v1/completions", body)
                  for n in ("survivor", "fresh")}
        check(len(routed["token_ids"]) == 8 and all(
            d["token_ids"] == routed["token_ids"] for d in direct.values()),
            f"chaos (b): routed tokens {routed['token_ids']}, direct "
            f"{ {n: d['token_ids'] for n, d in direct.items()} }")
        router.stop()
        router = None
        for n in ("survivor", "fresh"):
            wait_until(lambda n=n: (lambda st: st["live_slots"] == 0
                                    and st["parked"] == 0)(
                http_json(urls[n] + "/v1/stats")),
                f"{n} quiesced", poll=0.05, phase="chaos (b)")
            procs[n].send_signal(signal.SIGTERM)
        results = {}
        for n in ("survivor", "fresh"):
            code = procs[n].wait(timeout=120)
            check(code == 0 and (work / n / "result.json").exists(),
                  f"chaos (b): replica {n} stopped with {code}: {tail(n)}")
            r = json.loads((work / n / "result.json").read_text())
            led = r["ledger"]
            check(led["live_slots"] == 0 and led["parked"] == 0
                  and led["kv_used"] == led["radix_blocks"],
                  f"chaos (b): {n}'s ledger at the stop: {led}")
            check(r["counts"] == r["want"] and r["graph_steps"]
                  == r["decode_steps"] > 0 and all(
                      r["counts"][k] > 0 for k in (
                          "quant_decode_attention", "quant_matmul_stacked",
                          "quant_matmul_t")),
                  f"chaos (b): {n}'s launches on its card trace "
                  f"{r['counts']}, its forwards imply {r['want']} "
                  f"({r['decode_steps']} decode steps, "
                  f"{r['graph_steps']} replayed)")
            results[n] = r
        out["counts"] = {n: r["counts"] for n, r in results.items()}
        out["ledger"] = {n: r["ledger"] for n, r in results.items()}
        out["torn"] = {}
        for kind in ("trace", "event"):
            path = files[kind]["chaos_victim"]
            n_lines, bad = torn_lines(path) if os.path.exists(path) \
                else (0, [])
            check(all(b == n_lines for b in bad),
                  f"chaos (b): the victim's {kind} file has unparseable "
                  f"lines {bad} of {n_lines} (only its last may be torn)")
            out["torn"][kind] = {"lines": n_lines, "torn": len(bad)}
    finally:
        if router is not None:
            router.stop()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
        reset_tracer()
        reset_journal()
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"chaos (b): three 7B int8 replicas up in {out['start_s']:.1f} s "
        f"(build s {out['build_s']}, warm s {out['warm_s']}); the victim "
        f"SIGKILLed with a live slot mid-stream, exit "
        f"{out['victim_exit']}; kill to remove_replica "
        f"{out['kill_to_removed_ms']:.1f} ms; the fresh replica's first "
        f"token {out['fresh_first_token_s']} s after joining; outcomes "
        f"{out['outcomes']}; routed tokens equal direct; survivor and "
        f"fresh quiesced, no KV leak, launches on their own card traces "
        f"{out['counts']} equal their forwards; the victim's files "
        f"{out['torn']}; {out['seconds']:.1f} s")
    # the victim's files are cut off (parsed above); a replica that
    # journaled nothing writes no event file
    out["sinks"] = {kind: {k: v for k, v in fs.items()
                           if k != "chaos_victim" and os.path.exists(v)
                           and os.path.getsize(v)}
                    for kind, fs in files.items()}
    return out


# -------------------------------------------------------------- lora phase

#: multi-LoRA serving, the reference's recipe (``instaslice_tpu/
#: bench_tpu.py:868-906``): 4 adapters of rank 8 on (wq, wv), seeded
#: ``init_lora`` (seed 100 + i) with ``b`` drawn N(0, 1) * 0.01 (seed
#: 200 + i), so that no delta is zero; request i takes adapter i % 5 (0 =
#: the base model)
LORA_N, LORA_RANK, LORA_TARGETS = 4, 8, ("wq", "wv")
#: prompt lengths of the lora phase's 8 requests; every other one
#: streams over HTTP, all ask for logprobs
LORA_PLENS = (300, 257, 200, 129, 100, 64, 33, 17)
LORA_NEW = 8
#: a row of the batched run against the same request served alone (one
#: live slot: the single-adapter path): relative L2 of its decode steps'
#: logits, and (over HTTP) the largest logprob difference. The two
#: prefill the prompt apart (the burst's wide batched prefill
#: dequantizes into torch.matmul, a lone chunk takes B2), so in bf16 their
#: activations and int8 KV round apart, as in the serve phase: 1.5e-2 to
#: 1.7e-2 measured on the H100, and an adapter moves a row by only 0.08
#: to 0.10 there, under 5x any bound above that noise. So, as the spec
#: phase's verify check, the control is gated on a float32 copy (the same
#: int8 weights and KV cache, fp32 compute: B2/B3 on their CUDA-core
#: kernels, B1 with fp32 q), where the two paths differ by fp32 rounding
#: only; the bf16 control is logged
LORA_LOGPROB_TOL = 5e-2
LORA_TOL = {"bf16": 5e-2, "fp32": 1e-3}
#: the control: an adapter row against the base row of the same prompt
#: must differ by at least this many times the fp32 bound
LORA_CONTROL = 5


class StepLogits:
    """Records the (B, vocab) logits of each decode step an eager engine
    runs while installed (``ServingEngine._decode_logits``): a replayed
    graph runs no Python to copy them from."""

    def __init__(self, eng):
        check(not eng.decode_graphs, "StepLogits reads an eager engine")
        self.eng, self.real, self.steps = eng, eng._decode_logits, []
        eng._decode_logits = self

    def __call__(self, *a, **kw):
        out = self.real(*a, **kw)
        self.steps.append(out.float().clone())
        return out

    def close(self):
        self.eng._decode_logits = self.real


def lora_adapter_dirs(torch, cfg, root) -> list:
    """The recipe's adapters, each written as a port adapter checkpoint
    (its leaf paths included) under ``root``; their directories."""
    import shutil

    from instaslice_tpu_torch.models.checkpoint import TrainCheckpointer
    from instaslice_tpu_torch.models.lora import LoraConfig, init_lora
    from instaslice_tpu_torch.models.train import TrainState, leaves

    shutil.rmtree(root, ignore_errors=True)
    lcfg = LoraConfig(rank=LORA_RANK, targets=LORA_TARGETS)
    dirs = []
    for i in range(1, LORA_N + 1):
        ad = init_lora(100 + i, cfg, lcfg, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        for ab in ad["blocks"].values():
            ab["b"] = torch.randn(ab["b"].shape, generator=gen,
                                  device="cuda") * 0.01
        d = root / f"adapter{i}"
        TrainCheckpointer(str(d)).save(TrainState(
            step=0, params=ad,
            opt_state=torch.optim.SGD(leaves(ad), lr=0.0)))
        dirs.append(d)
    return dirs


def lora_burst(eng, prompts, adapters):
    """One burst admission of ``prompts`` (request i on ``adapters[i]``)
    decoded to LORA_NEW tokens: per row (tokens, logprobs) and, on an
    eager engine, the (steps, rows, vocab) decode logits (None on a graph
    engine); the slots are finished after."""
    import torch

    from instaslice_tpu_torch.serving import AdmissionRequest

    rec = None if eng.decode_graphs else StepLogits(eng)
    try:
        rids = [r[0] for r in eng.add_requests(
            [AdmissionRequest(p, adapter=a)
             for p, a in zip(prompts, adapters)])]
        eng.decode_block(LORA_NEW - 1)
    finally:
        if rec is not None:
            rec.close()
    slot_of = {r.request_id: s for s, r in eng.slots.items()}
    rows = [slot_of[rid] for rid in rids]
    out = [(list(eng.slots[s].generated), list(eng.slots[s].logprobs))
           for s in rows]
    for s in rows:
        eng.finish_slot(s)
    return out, rec and torch.stack(rec.steps)[:, rows]


def lora_alone(eng, prompt, adapter):
    """The same request served alone (one live slot)."""
    import torch

    rec = None if eng.decode_graphs else StepLogits(eng)
    try:
        rid = eng.add_request(prompt, adapter=adapter)
        eng.decode_block(LORA_NEW - 1)
    finally:
        if rec is not None:
            rec.close()
    slot = next(s for s, r in eng.slots.items() if r.request_id == rid)
    req = eng.slots[slot]
    out = (list(req.generated), list(req.logprobs))
    eng.finish_slot(slot)
    return out, rec and torch.stack(rec.steps)[:, slot]


def lora_rows(torch, eng, prompts, adapters) -> dict:
    """Each request alone on the eager engine ``eng``, then all as one
    burst on ``eng`` and on an eager engine without adapters over the
    same weights and config: the base rows' equality with the latter
    (tokens, logprobs, logits), every row's decode logits against its
    lone run (rel L2) and, the control, each adapter row against the base
    row of its prompt."""
    alone = [lora_alone(eng, p, a) for p, a in zip(prompts, adapters)]
    eng.radix.reclaim(eng.kv.total_blocks)
    burst, burst_lg = lora_burst(eng, prompts, adapters)
    base_eng = eager_twin(eng)
    base, base_lg = lora_burst(base_eng, prompts, [0] * len(prompts))
    del base_eng
    l2 = [rel_l2(burst_lg[:, i], alone[i][1]) for i in range(len(prompts))]
    base_equal = [burst[i] == base[i]
                  and torch.equal(burst_lg[:, i], base_lg[:, i])
                  for i, a in enumerate(adapters) if a == 0]
    control = [min(rel_l2(burst_lg[:, i], base_lg[:, i]),
                   rel_l2(alone[i][1], base_lg[:, i]))
               for i, a in enumerate(adapters) if a]
    lp_ctrl = [max(abs(x - y) for x, y in zip(burst[i][1], base[i][1]))
               for i, a in enumerate(adapters) if a]
    text = (f"rows vs alone decode logits rel L2 "
            f"{[f'{x:.3g}' for x in l2]}, adapter rows vs base rows rel L2 "
            f"{[f'{x:.3g}' for x in control]} (logprobs "
            f"{[f'{x:.3g}' for x in lp_ctrl]}), base rows bit-equal "
            f"{base_equal}")
    return {"alone_runs": [r for r, _ in alone], "burst_runs": burst,
            "alone_l2": l2, "base_equal": base_equal, "control": control,
            "control_logprob": lp_ctrl, "text": text}


def lora_tput(torch, eng, adapters: bool, profile: bool,
              n: int = 16) -> dict:
    """Decode tok/s at batch 8 over one timed block after a warm one (as
    ``bench_serving_lora``), requests round-robin over adapters i % 5 or
    all on the base; with ``profile`` also the device ms of a decode
    step (``device_busy``)."""
    for i in range(8):
        eng.add_request([1, 2, 3], adapter=(i % (LORA_N + 1)) if adapters
                        else 0)
    eng.decode_block(4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.decode_block(n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = device_busy(torch, lambda: eng.decode_block(8), 8) \
        if profile else None
    for s in list(eng.slots):
        eng.evict_slot(s)
    return {"tok_s": 8 * n / wall, "step_ms": wall / n * 1e3,
            "device_ms_per_step": busy and busy["ms_per_step"],
            "device_top": busy and busy["top"]}


def phase_lora_serve(torch, ops) -> dict:
    """Multi-LoRA serving at the 7B int8 configuration: the recipe's
    adapters written as port checkpoints and loaded by the server's own
    CLI wiring (``SERVE_FLAGS`` + ``--lora`` x 4), 8 concurrent greedy
    completions over HTTP on adapters i % 5, launches counted as the path
    implies; then, the server stopped, each request served alone (its
    logprobs against the served stream's) and the 8 as one burst
    admission on this engine and on an engine without adapters over the
    same weights (:func:`lora_rows`), in bf16 and on a float32 copy, where
    the control is gated (``LORA_TOL``); decode tok/s and device ms per
    step with and without adapters."""
    import shutil
    import threading
    from collections import Counter

    from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM
    from instaslice_tpu_torch.serving import ServingEngine, api_server

    t0 = time.perf_counter()
    args0 = api_server.build_parser().parse_args(SERVE_FLAGS.split())
    cfg = ModelConfig(vocab_size=args0.vocab_size, d_model=args0.d_model,
                      n_heads=args0.n_heads, n_kv_heads=args0.n_kv_heads,
                      n_layers=args0.n_layers, d_ff=args0.d_ff,
                      max_seq_len=args0.max_len, dtype=torch.bfloat16,
                      remat=False)
    root = HERE / "build" / "lora_adapters"
    dirs = lora_adapter_dirs(torch, cfg, root)
    flags = SERVE_FLAGS.split()
    for d in dirs:
        flags += ["--lora", str(d)]
    args = api_server.build_parser().parse_args(flags)
    eng = api_server.build_engine(args)
    shutil.rmtree(root, ignore_errors=True)
    names = [d.name for d in dirs]
    check(eng.n_adapters == LORA_N and eng.adapter_names
          == {n: i + 1 for i, n in enumerate(names)},
          f"lora: adapters {eng.adapter_names}")
    check(eng.kv_quant and eng.attention_route() == "B1",
          "lora: int8 W+KV, B1 decode attention")
    srv = api_server.ApiServer(eng, host=args.host, port=args.port).start()
    setup_s = time.perf_counter() - t0
    V, L = args.vocab_size, args.n_layers
    fl = ForwardLog(eng)
    gen = torch.Generator().manual_seed(31)
    prompts = [torch.randint(1, V, (n,), generator=gen).tolist()
               for n in LORA_PLENS]
    adapters = [i % (LORA_N + 1) for i in range(len(prompts))]
    try:
        wait_ready(srv.url)
        code_models = http_json(srv.url + "/v1/models")
        check([m["id"] for m in code_models["data"][1:]] == sorted(names),
              "lora: /v1/models lists the adapters")
        results, errors = [None] * len(prompts), []

        def one(i):
            body = {"prompt": prompts[i], "max_tokens": LORA_NEW,
                    "temperature": 0.0, "logprobs": True}
            if adapters[i]:
                body["adapter"] = names[adapters[i] - 1]
            try:
                if i % 2 == 0:
                    results[i] = http_stream(srv.url + "/v1/completions",
                                             dict(body, stream=True))
                else:
                    results[i] = http_json(srv.url + "/v1/completions",
                                           body)["choices"][0]
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"request {i}: {e!r}")

        steps0 = eng.decode_steps
        g0, f0 = eng.gathered_rounds, eng.fastpath_rounds
        graphs0 = eng.graph_stats()["graphs"]
        fl.start()
        t0 = time.perf_counter()
        with Traced(torch, ops) as tr:
            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(len(prompts))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        wall = tr.t_end - t0
        fl.stop()
        counts = tr.counts
        steps = eng.decode_steps - steps0
        rows = [b * t for b, t in fl.target]
        kernel_fw = sum(r <= 256 for r in rows)
        st = http_json(srv.url + "/v1/stats")
        check(not errors, f"lora: {errors}")
        gathered = eng.gathered_rounds - g0
        fast_http = eng.fastpath_rounds - f0
        log(f"lora: server from 4 adapter checkpoints in {setup_s:.1f} s; 8 "
            f"concurrent completions {list(LORA_PLENS)} x "
            f"{LORA_NEW} tokens on adapters {adapters} over HTTP in "
            f"{wall:.2f} s (traced): rows {sorted(Counter(rows).items())}, "
            f"{steps} decode steps, {gathered} gathered and {fast_http} "
            f"single-adapter rounds, launches on the card's trace {counts}")
        check(len(fl.attends) == steps
              and eng.graph_stats()["graphs"] == graphs0,
              "lora: every decode step replayed a graph captured at "
              "start-up")
        for i, r in enumerate(results):
            check(len(r["token_ids"]) == LORA_NEW and len(r["logprobs"])
                  == LORA_NEW and all(lp <= 0.0 for lp in r["logprobs"]),
                  f"lora: request {i}: {LORA_NEW} tokens and logprobs")
        check(counts["quant_decode_attention"] == L * steps > 0,
              "lora: B1 launches = layers x decode steps")
        check(counts["quant_matmul_stacked"] == 6 * L * kernel_fw > 0,
              "lora: B2 launches = 6 x layers x forwards of <= 256 rows")
        check(counts["quant_matmul_t"] == kernel_fw > 0,
              "lora: B3 launches = forwards of <= 256 rows")
        check(counts["quant_matmul"] == 0
              and all(counts[n] == 0 for n in FLASH),
              "lora: B4-B7 are not on this path")
        check(gathered > 0, "lora: mixed adapters take the gathered path")
        eng_st = st["engine"]
        check(st["live_slots"] == 0 and st["parked"] == 0, "lora: quiesced")
        check(st["kv"]["used"] == st["radix"]["blocks"],
              f"lora: no leaked KV blocks: kv {st['kv']}")
        within_budget(eng_st["decode_graphs"], "lora")
        check(eng_st["decode_graphs"]["graphs"]["decode_block"] >= 2,
              "lora: the single and the gathered step are captured")
    finally:
        srv.stop()
        fl.close()

    # the server is stopped: the engine is this thread's. Each request
    # alone (the radix cache emptied: every run prefills whole: the
    # single-adapter graph), then all as one burst (the gathered graph);
    # the same on an eager twin, whose logits give the bf16 readings of
    # the rows; then the float32 readings
    eng.radix.reclaim(eng.kv.total_blocks)
    f1, g1 = eng.fastpath_rounds, eng.gathered_rounds
    g_alone = [lora_alone(eng, p, a)[0] for p, a in zip(prompts, adapters)]
    fast_alone = eng.fastpath_rounds - f1
    eng.radix.reclaim(eng.kv.total_blocks)
    g_burst = lora_burst(eng, prompts, adapters)[0]
    check(fast_alone == len(prompts) and eng.gathered_rounds > g1,
          "lora: a lone request takes the single-adapter path, the burst "
          "the gathered one")
    twin = lora_twin(eng)
    t0 = time.perf_counter()
    rows16 = lora_rows(torch, twin, prompts, adapters)
    rows16_s = time.perf_counter() - t0
    check(g_alone == rows16["alone_runs"],
          "lora: the single-adapter graph's replays equal the eager route "
          "(tokens and logprobs of every request alone)")
    check(g_burst == rows16["burst_runs"],
          "lora: the gathered graph's replays equal the eager route "
          "(tokens and logprobs of the burst)")
    served_lp = [max(abs(x - y) for x, y in zip(results[i]["logprobs"],
                                                 rows16["alone_runs"][i][1]))
                 for i in range(len(prompts))]
    tok_same = sum(results[i]["token_ids"] == rows16["alone_runs"][i][0]
                   for i in range(len(prompts)))
    cfg32 = dataclasses.replace(eng.model.cfg, dtype=torch.float32)
    eng32 = ServingEngine(TpuLM(cfg32), eng.params, max_batch=8,
                          max_len=1024, prefill_len=128, kv_quant=True,
                          device="cuda",
                          lora_adapters=[{"blocks": {
                              t: {k: v[:, i] for k, v in ab.items()}
                              for t, ab in eng.lora["blocks"].items()}}
                              for i in range(1, LORA_N + 1)],
                          lora_alphas=[16.0] * LORA_N,
                          decode_graphs=False)
    t0 = time.perf_counter()
    rows32 = lora_rows(torch, eng32, prompts, adapters)
    rows32_s = time.perf_counter() - t0
    del eng32
    log(f"lora: alone and burst runs replayed (single and gathered "
        f"graphs) equal the eager twin's bit for bit; served vs alone "
        f"logprobs (largest difference by request) "
        f"{[f'{x:.3g}' for x in served_lp]}, tokens equal in {tok_same} of "
        f"{len(prompts)}; bf16 ({rows16_s:.1f} s): {rows16['text']}; "
        f"float32 ({rows32_s:.1f} s): {rows32['text']}")
    check(max(served_lp) <= LORA_LOGPROB_TOL,
          f"lora: served logprobs vs alone {served_lp}")
    for prec, r in (("bf16", rows16), ("fp32", rows32)):
        check(all(r["base_equal"]), f"lora: {prec} base rows equal the "
              "engine without adapters bit for bit")
        check(max(r["alone_l2"]) <= LORA_TOL[prec],
              f"lora: {prec} rows vs alone {r['alone_l2']}")
    check(min(rows32["control"]) >= LORA_CONTROL * LORA_TOL["fp32"],
          f"lora: float32 adapter rows as close to the base rows as the "
          f"bound: {rows32['control']}")
    check(eng.kv.used_blocks() == eng.radix.pool_blocks(),
          "lora: no leaked KV blocks")
    base_eng = ServingEngine(eng.model, eng.params, max_batch=8,
                             max_len=1024, prefill_len=128, kv_quant=True,
                             device="cuda")

    # decode throughput and device time per step at batch 8: host clocks
    # spread between runs, so the engines take turns (plain, adapters,
    # the adapters' eager twin, twice over in reverse)
    t0 = time.perf_counter()
    runs = {"plain": [], "adapters": [], "adapters_eager": []}
    turns = (("plain", base_eng, False), ("adapters", eng, True),
             ("adapters_eager", twin, True))
    for name, e, ad in turns + turns[::-1]:
        runs[name].append(lora_tput(torch, e, ad, profile=not runs[name]))
    tok_s = {k: sum(r["tok_s"] for r in v) / len(v) for k, v in runs.items()}
    dev_ms = {k: v[0]["device_ms_per_step"] for k, v in runs.items()}
    overhead = 100.0 * (tok_s["plain"] - tok_s["adapters"]) / tok_s["plain"]
    log(f"lora: decode at batch 8 ({time.perf_counter() - t0:.1f} s; tok/s "
        f"by turn): 4 adapters round-robin "
        f"{[round(r['tok_s'], 1) for r in runs['adapters']]} (eager twin "
        f"{[round(r['tok_s'], 1) for r in runs['adapters_eager']]}), no "
        f"adapters "
        f"{[round(r['tok_s'], 1) for r in runs['plain']]}: "
        f"serving_lora_overhead_pct {overhead:.1f}; device ms per step "
        f"{dev_ms}; device by kernel with adapters "
        f"{runs['adapters'][0]['device_top']}")
    check(eng.fastpath_rounds > 0 and eng.gathered_rounds > 0,
          "lora: both adapter paths ran")
    out = {"setup_s": setup_s, "wall_s": wall, "counts": counts,
           "decode_steps": steps, "gathered_rounds": gathered,
           "fastpath_rounds_alone": fast_alone,
           "served_logprob_diff": served_lp,
           "bf16": {k: v for k, v in rows16.items()
                    if k not in ("text", "alone_runs")},
           "fp32": {k: v for k, v in rows32.items()
                    if k not in ("text", "alone_runs")},
           "tok_s": tok_s, "device_ms_per_step": dev_ms,
           "serving_lora_overhead_pct": overhead,
           "engine": eng_st,
           # the served completions: the parallel_rest phase's tp 2
           # adapter server is held against them
           "served": [{k: r[k] for k in ("token_ids", "logprobs")}
                      for r in results]}
    del eng, base_eng, srv, twin
    free_memory(torch)
    return out


#: the 871M server's own flags (the spec phase's configuration, no draft)
LORA_SERVE_871M_FLAGS = ("--quantize --vocab-size 32000 --d-model 2048 "
                         "--n-heads 16 --n-layers 16 --d-ff 8192 "
                         "--max-batch 8 --max-len 1024 --prefill-len 128 "
                         "--host 127.0.0.1 --port 0")


def phase_lora_train(torch, ops, train: dict) -> dict:
    """QLoRA on the 871M training configuration: ``make_lora_train_step``
    at rank 8 on (wq, wv) over the int8 base at batch 8 x 1024, 1 warm-up
    and 4 timed steps: the first loss is the frozen base's, the loss
    falls, the base stays bit-unchanged, B5/B6/B7 launch 16 times a step;
    step ms, tokens/s and peak memory beside the full train step's. Then
    the training CLI twice (``--lora-rank 8 --quantize-base --steps 3``,
    two seeds, two checkpoint dirs) and an 871M ``--quantize`` server on
    the two adapters, answering one completion each."""
    import contextlib
    import io
    import shutil

    from instaslice_tpu_torch.cli import train_main
    from instaslice_tpu_torch.models.lm import TpuLM, init_params
    from instaslice_tpu_torch.models.lora import (
        LoraConfig,
        make_lora_train_step,
    )
    from instaslice_tpu_torch.models.quant import quantize_params
    from instaslice_tpu_torch.models.train import leaves, loss_fn
    from instaslice_tpu_torch.serving import api_server

    cfg = train_config(torch)
    B, S, n_timed = 8, 1024, 4
    torch.backends.cuda.matmul.allow_tf32 = True
    model = TpuLM(cfg)
    base = quantize_params(init_params(cfg, 0))
    frozen = [t for leaf in leaves(base)
              for t in ((leaf.q, leaf.s) if hasattr(leaf, "q") else (leaf,))]
    snapshot = [t.clone() for t in frozen]
    gen = torch.Generator(device="cuda").manual_seed(17)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    with torch.no_grad():
        base_loss = float(loss_fn(model, base, tokens))
    init_fn, step_fn = make_lora_train_step(
        model, base, LoraConfig(rank=LORA_RANK, targets=LORA_TARGETS),
        learning_rate=1e-3, grad_clip=1.0, device="cuda")
    state = init_fn(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, loss = step_fn(state, tokens)          # warm-up, b = 0
    losses = [float(loss)]
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, loss = step_fn(state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = 1 + n_timed
    step_s = wall / n_timed
    first_err = abs(losses[0] - base_loss) / abs(base_loss)
    unchanged = all(torch.equal(a, b) for a, b in zip(frozen, snapshot))
    n_adapter = sum(p.numel() for p in leaves(state.params))
    log(f"lora train: QLoRA 871M int8 base, rank {LORA_RANK} on "
        f"{LORA_TARGETS} ({n_adapter / 1e6:.2f}M adapter params), B={B} "
        f"S={S}: losses {losses}, frozen-base loss {base_loss} (first step "
        f"rel err {first_err:.2e}); {step_s * 1e3:.1f} ms/step, "
        f"{B * S / step_s:.0f} tokens/s, peak {peak:.2f} GiB (full step "
        f"{train['step_ms']:.1f} ms, {train['tokens_per_s']:.0f} tokens/s, "
        f"peak {train['peak_gib']:.2f} GiB); launches {counts}; base "
        f"unchanged {unchanged}")
    check(all(math.isfinite(x) for x in losses), "lora train: finite")
    check(first_err <= BF16_CUT_TOL["loss"],
          "lora train: the first loss is the frozen base's")
    check(losses[-1] < losses[0], "lora train: the loss falls")
    check(unchanged, "lora train: the int8 base is bit-unchanged")
    for name in FLASH:
        check(counts[name] == cfg.n_layers * steps,
              f"lora train: {name} launches = 16 x steps")
    check(all(counts[n] == 0 for n in counts if n not in FLASH),
          "lora train: no serving kernel on the train path")
    busy = device_busy(torch, lambda: step_fn(state, tokens), 1)
    if busy is not None:
        log(f"lora train: device busy {busy['ms_per_step']:.1f} ms per step; "
            f"by class (ms/step): {busy['by_class']}")
    del state, base, frozen, snapshot, init_fn, step_fn
    free_memory(torch)

    # the CLI twice, then an 871M server on its two adapter checkpoints
    root = HERE / "build" / "lora_cli"
    shutil.rmtree(root, ignore_errors=True)
    dirs, lines = [], []
    t0 = time.perf_counter()
    for seed in (0, 1):
        d = root / f"seed{seed}"
        buf = io.StringIO()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            rc = train_main.main([
                "--synthetic", "100000", "--seq-len", "256",
                "--global-batch", "8", "--steps", "3", "--seed", str(seed),
                "--lora-rank", str(LORA_RANK), "--quantize-base",
                "--checkpoint", str(d), "--log-every", "1"])
        cli_counts = ops.launch_counts()
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(rc == 0 and line["steps"] == 3 and line["backend"] == "cuda"
              and math.isfinite(line["final_loss"]),
              f"lora cli: seed {seed}: rc {rc}, {line}")
        for name in FLASH:
            check(cli_counts[name] == cfg.n_layers * 3,
                  f"lora cli: {name} launches = 16 x 3")
        dirs.append(d)
        lines.append(line)
    cli_s = time.perf_counter() - t0
    flags = LORA_SERVE_871M_FLAGS.split()
    for d in dirs:
        flags += ["--lora", str(d)]
    args = api_server.build_parser().parse_args(flags)
    eng = api_server.build_engine(args)
    check(eng.adapter_names == {"seed0": 1, "seed1": 2},
          f"lora cli: served adapters {eng.adapter_names}")
    srv = api_server.ApiServer(eng, host=args.host, port=args.port).start()
    answers = {}
    try:
        wait_ready(srv.url)
        for name in ("seed0", "seed1"):
            ch = http_json(srv.url + "/v1/completions", {
                "prompt": list(range(5, 45)), "max_tokens": 8,
                "adapter": name, "logprobs": True})["choices"][0]
            check(len(ch["token_ids"]) == 8,
                  f"lora cli: adapter {name} answered")
            answers[name] = ch["token_ids"]
    finally:
        srv.stop()
    log(f"lora cli: 2 QLoRA runs in {cli_s:.1f} s: "
        f"{[json.dumps(x) for x in lines]}; the 871M --quantize server on "
        f"both answered {answers}")
    shutil.rmtree(root, ignore_errors=True)
    del eng, srv
    free_memory(torch)
    return {"counts": counts, "losses": losses, "base_loss": base_loss,
            "first_loss_rel_err": first_err, "step_ms": step_s * 1e3,
            "tokens_per_s": B * S / step_s, "peak_gib": peak,
            "adapter_params_m": n_adapter / 1e6,
            "device_ms_per_step": busy and busy["ms_per_step"],
            "device_ms_by_class": busy and busy["by_class"],
            "cli": lines, "cli_answers": answers}


# ------------------------------------------------- window and int4 phases

#: the windowed server: the serve phase's 7B int8 configuration with
#: Mistral 7B's sliding window and context (Jiang et al. 2023, Table 1:
#: window_size 4096, context_len 8192; ``sliding_window: 4096`` in
#: Mistral-7B-v0.1's published config)
WINDOW = 4096
WINDOW_SERVE_FLAGS = (SERVE_FLAGS.replace("--max-len 1024", "--max-len 8192")
                      + f" --window {WINDOW}")
#: the window server's depth: the 7B's widths at this many of its 32
#: layers. The phase was the smoke's longest traced, host-bound one (79.9
#: s at 32 layers on the H100); its work (the prefill of two long
#: prompts, four times over, the full forwards, the eager decode) scales
#: with the depth, its checks and controls hold at any depth, and its
#: launch expectations follow it
WINDOW_LAYERS = 2
#: prompt lengths: two whose decode runs past the window, six short ones
#: (sent first, so that decode steps inside the window run before the
#: long rows are admitted)
WINDOW_LONG = (4400, 4200)
WINDOW_SHORT = (600, 400, 300, 200, 129, 64)
WINDOW_NEW = 16
#: a long row's decode logits against ``TpuLM.apply`` over the same tokens
#: and weights with the same window: relative L2 at most this. bf16 at
#: the 7B's widths: the engine reads an int8 KV cache and projects through B2,
#: the full forward keeps K/V exact and projects through bf16 matmuls
#: (1.5e-2 measured on a d1024 32-layer cut on the CPU); a float32 2-layer
#: cut with a float32 KV cache: sums in another order only (6e-7 there);
#: the same cut with the int8 KV cache: int8 K/V rounding (9e-4 there)
WINDOW_TOL = {"bf16": 5e-2, "fp32": 1e-4, "fp32_int8_kv": 5e-3}
#: the control: the same decode steps against the full forward WITHOUT the
#: window must read at least this many times the bound. Gated on the
#: float32 cut with the float32 KV cache: at full depth in bf16 the window
#: moves the random model's logits by under 5x the rounding noise (4.8x
#: at the d1024 cut, at a larger share of positions outside the window),
#: so the bf16 and int8-KV controls are logged
WINDOW_CONTROL = 5
#: the int4 server: the serve phase's configuration with group-wise int4
#: weights over the int8 KV cache, the repo's capacity recipe
#: (``docs/SERVING.md:821``: ``--quantize --quantize-bits 4``)
INT4_SERVE_FLAGS = SERVE_FLAGS + " --quantize-bits 4"
#: the int4 server's depth: the 7B's widths at this many of its 32 layers
#: (as WINDOW_LAYERS). Its decode is device-bound on the plain int4
#: dequantization (134 ms a step at 32 layers), its work scales with the
#: depth, its checks hold at any depth and its launch expectations follow
#: it; cut to pay for the traced windows' longer settle
INT4_LAYERS = 2
INT4_NEW = 16
#: the int4 engine's decode logits against the same engine over the
#: ``weight()``-dequantized bf16 weights: both run the same bf16 weights
#: through the same ``torch.matmul`` calls (only the int8 KV cache and B1
#: besides), so they should agree bit for bit; relative L2 at most this
INT4_TOL = 1e-3


def tree_gib(tree) -> float:
    """GiB of a params tree's tensors (packed bytes and scales of its
    quantized leaves)."""
    from instaslice_tpu_torch.models.quant import Int4Tensor, QuantizedTensor

    if isinstance(tree, dict):
        return sum(tree_gib(v) for v in tree.values())
    if isinstance(tree, QuantizedTensor):
        return tree_gib(tree.q) + tree_gib(tree.s)
    if isinstance(tree, Int4Tensor):
        return tree_gib(tree.p) + tree_gib(tree.s)
    return tree.numel() * tree.element_size() / 2 ** 30


def decode_tput(torch, eng, prompts, n: int = 16) -> dict:
    """Decode tok/s at the batch of ``prompts`` (admitted one by one, so a
    radix hit serves a repeated head) over one timed block of ``n`` steps
    after a warm one; then the device ms of a decode step over a profiled
    block of 4 (``device_busy``), its launches on the card's trace and
    its sliding-window band steps; the slots are evicted after."""
    for p in prompts:
        eng.add_request(p)
    eng.decode_block(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.decode_block(n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    band0 = eng.band_steps
    busy = device_busy(torch, lambda: eng.decode_block(4), 4)
    band = eng.band_steps - band0
    for s in list(eng.slots):
        eng.evict_slot(s)
    return {"tok_s": len(prompts) * n / wall, "step_ms": wall / n * 1e3,
            "device_ms_per_step": busy and busy["ms_per_step"],
            "device_top": busy and busy["top"],
            "counts": busy and busy["launches"], "band_steps": band,
            "steps": 4}


def decode_logits(torch, eng, prompt, n: int):
    """``prompt`` alone through ``eng.generate`` (an empty engine: slot 0)
    for ``n`` tokens: the tokens and the (n - 1, vocab) logits of its
    decode steps (None on a graph engine), and its logprobs."""
    check(not eng.slots, "an empty engine")
    rec = None if eng.decode_graphs else StepLogits(eng)
    try:
        res = eng.generate([prompt], n)[0]
    finally:
        if rec is not None:
            rec.close()
    return (res.tokens, rec and torch.stack(rec.steps)[:, 0],
            res.logprobs)


def window_rows(torch, model, params, prompt, toks, dec) -> dict:
    """Relative L2 of decode logits ``dec`` against ``TpuLM.apply`` over
    the same tokens with the model's window and without it (the
    control)."""
    from instaslice_tpu_torch.models.lm import TpuLM

    seq = torch.tensor([prompt + toks[:-1]], device="cuda")
    P, out = len(prompt), {}
    for name, cfg in (("window", model.cfg),
                      ("no_window", dataclasses.replace(model.cfg,
                                                        window=0))):
        with torch.no_grad():
            full = TpuLM(cfg).apply(params, seq)[0, P:P + dec.shape[0]]
        out[name] = rel_l2(dec, full)
        del full
        free_memory(torch)
    return out


def window_cut(torch, eng, prompt) -> dict:
    """The served weights cut to 2 layers in float32 on engines with a
    float32 and with the int8 KV cache (batch 1, the server's max_len and
    chunk): a long prompt's decode logits against the windowed full
    forward and without the window."""
    from instaslice_tpu_torch.models.lm import TpuLM
    from instaslice_tpu_torch.models.quant import QuantizedTensor
    from instaslice_tpu_torch.serving import ServingEngine

    cfg = dataclasses.replace(eng.model.cfg, n_layers=2, dtype=torch.float32)

    def take(leaf):
        if isinstance(leaf, QuantizedTensor):
            return QuantizedTensor(leaf.q[:2], leaf.s[:2])
        return leaf[:2]

    params = dict(eng.params, blocks={
        k: ({"scale": take(v["scale"])} if isinstance(v, dict) else take(v))
        for k, v in eng.params["blocks"].items()})
    model, out = TpuLM(cfg), {}
    for name, kvq in (("fp32", False), ("fp32_int8_kv", True)):
        cut = ServingEngine(model, params, max_batch=1, max_len=eng.max_len,
                            prefill_len=eng.prefill_len, kv_quant=kvq,
                            device="cuda", decode_graphs=False)
        toks, dec, _ = decode_logits(torch, cut, prompt, 8)
        check(cut.band_steps == 7, f"window cut {name}: every decode step "
              f"reads the band ({cut.band_steps} of 7)")
        del cut
        out[name] = window_rows(torch, model, params, prompt, toks, dec)
    return out


def staggered_burst(url, short, long_):
    """The short prompts' streamed completions first, the long prompts'
    once every short stream has two tokens (a decode block has run); each
    result with its host clock of sending."""
    import threading

    progress = [{"n": 0} for _ in short + long_]
    results, errors = [None] * len(progress), []

    def one(i, prompt):
        body = {"prompt": prompt, "max_tokens": WINDOW_NEW,
                "temperature": 0.0, "stream": True}
        t_send = time.perf_counter()
        try:
            r = http_stream(url + "/v1/completions", body,
                            progress=progress[i])
            r["t_send"] = t_send
            results[i] = r
        except Exception as e:  # noqa: BLE001 - reported by the caller
            errors.append(f"request {i}: {e!r}")

    threads = [threading.Thread(target=one, args=(i, p))
               for i, p in enumerate(short)]
    for th in threads:
        th.start()
    t0 = time.perf_counter()
    while (not errors and any(progress[i]["n"] < 2 for i in range(len(short)))
           and time.perf_counter() - t0 < 600.0):
        time.sleep(0.01)
    late = [threading.Thread(target=one, args=(len(short) + j, p))
            for j, p in enumerate(long_)]
    for th in late:
        th.start()
    for th in threads + late:
        th.join()
    return results, errors


def phase_window(torch, ops, n_layers: int = WINDOW_LAYERS) -> dict:
    """The windowed 7B int8 server (``WINDOW_SERVE_FLAGS`` at ``n_layers``
    layers), built by the port's own CLI wiring and driven over HTTP: six
    short streamed completions, then, once they decode, two past the
    window. B1 runs on
    the decode steps whose 256-position bucket is at most ``window - 1``
    wide, the band on the others; B2/B3 on every forward of at most 256
    rows. Then, the server stopped: decode tok/s and device ms per step
    inside the window (B1) and past it (the band); a long row's decode
    logits against the windowed full forward in bf16 and on a float32
    2-layer cut, each beside the control without the window."""
    from collections import Counter

    from instaslice_tpu_torch.models.lm import window_band
    from instaslice_tpu_torch.serving import api_server

    t0 = time.perf_counter()
    args = api_server.build_parser().parse_args(
        WINDOW_SERVE_FLAGS.split() + ["--n-layers", str(n_layers)])
    eng = api_server.build_engine(args)
    srv = api_server.ApiServer(eng, host=args.host, port=args.port).start()
    setup_s = time.perf_counter() - t0
    cfg, L, V = eng.model.cfg, args.n_layers, args.vocab_size
    check(cfg.window == WINDOW and eng.max_len == 8192 and eng.kv_quant,
          "window: int8 W+KV, window 4096, context 8192")
    route = eng.attention_route()
    check(route.startswith("B1 to 4095"), f"window: route {route!r}")
    gen = torch.Generator().manual_seed(41)
    short = [torch.randint(1, V, (n,), generator=gen).tolist()
             for n in WINDOW_SHORT]
    long_ = [torch.randint(1, V, (n,), generator=gen).tolist()
             for n in WINDOW_LONG]
    fl = ForwardLog(eng)
    try:
        wait_ready(srv.url)
        band0 = eng.band_steps
        fl.start()
        t0 = time.perf_counter()
        with Traced(torch, ops) as tr:
            results, errors = staggered_burst(srv.url, short, long_)
        wall = tr.t_end - t0
        fl.stop()
        counts = tr.counts
        band = eng.band_steps - band0
        st = http_json(srv.url + "/v1/stats")
        within_budget(st["engine"]["decode_graphs"], "window")
    finally:
        srv.stop()
        fl.close()
    rows = [b * t for b, t in fl.target]
    attends = fl.attends
    check(not errors, f"window: {errors}")
    for i, r in enumerate(results):
        check(len(r["token_ids"]) == WINDOW_NEW
              and all(0 <= t < V for t in r["token_ids"])
              and r["finish_reason"] == "max_new_tokens",
              f"window: request {i}: {r['token_ids']} {r['finish_reason']}")
    b1_steps = sum(not window_band(cfg, eng.max_len, a or eng.max_len)
                   for a in attends)
    kernel_fw = sum(r <= 256 for r in rows)
    ttft = [round((r["t_first"] - r["t_send"]) * 1e3, 1) for r in results]
    log(f"window: server in {setup_s:.1f} s; 8 streamed completions "
        f"{list(WINDOW_SHORT)} then {list(WINDOW_LONG)} x {WINDOW_NEW} "
        f"tokens in {wall:.2f} s: rows {sorted(Counter(rows).items())}, "
        f"{len(attends)} decode steps at buckets "
        f"{sorted(Counter(attends).items())} ({b1_steps} through B1, {band} "
        f"through the band), launches on the card's trace {counts}; TTFT "
        f"ms {ttft} (long prompts last)")
    check(b1_steps > 0 and band > 0 and b1_steps + band == len(attends),
          "window: decode steps inside the window (B1) and past it (band)")
    check(counts["quant_decode_attention"] == L * b1_steps,
          "window: B1 launches = layers x decode steps of buckets <= 4095")
    check(counts["quant_matmul_stacked"] == 6 * L * kernel_fw > 0,
          "window: B2 launches = 6 x layers x forwards of <= 256 rows")
    check(counts["quant_matmul_t"] == kernel_fw > 0,
          "window: B3 launches = forwards of <= 256 rows")
    check(counts["quant_matmul"] == 0 and all(counts[n] == 0 for n in FLASH),
          "window: B4-B7 are not on this path")
    check(st["live_slots"] == 0 and st["parked"] == 0, "window: quiesced")
    check(st["kv"]["used"] == st["radix"]["blocks"],
          f"window: no leaked KV blocks: kv {st['kv']}")

    # decode inside the window (8 short rows: bucket 256, B1) and past it
    # (a long row's radix-cached prompt beside 7 short rows: the band)
    inside = decode_tput(torch, eng, [[1, 2, 3]] * 8)
    past = decode_tput(torch, eng, [long_[0]] + [[1, 2, 3]] * 7)
    # the same on the eager route (a twin over the same weights)
    twin = eager_twin(eng)
    eager = {"inside": decode_tput(torch, twin, [[1, 2, 3]] * 8),
             "past": decode_tput(torch, twin,
                                 [long_[0]] + [[1, 2, 3]] * 7)}
    check(inside["counts"]["quant_decode_attention"] == L * inside["steps"]
          and inside["band_steps"] == 0, "window: short rows decode by B1")
    check(past["counts"]["quant_decode_attention"] == 0
          and past["band_steps"] == past["steps"],
          "window: a row past the window sends every decode step to the band")
    log(f"window: decode at batch 8 inside the window (B1) "
        f"{inside['tok_s']:.1f} tok/s, {inside['device_ms_per_step']} device "
        f"ms per step; past it (band) {past['tok_s']:.1f} tok/s, "
        f"{past['device_ms_per_step']} device ms per step; band step by "
        f"kernel (ms): {past['device_top']}; the eager twin inside "
        f"{eager['inside']['tok_s']:.1f} tok/s, past "
        f"{eager['past']['tok_s']:.1f} tok/s")

    # a long row's decode logits (the eager twin's): bf16 at full depth,
    # then the float32 cut; the graph route's tokens and logprobs of the
    # same row equal the eager twin's
    eng.radix.reclaim(eng.kv.total_blocks)
    twin.radix.reclaim(twin.kv.total_blocks)
    toks, dec, lps = decode_logits(torch, twin, long_[0], 8)
    g_toks, _, g_lps = decode_logits(torch, eng, long_[0], 8)
    check((g_toks, g_lps) == (toks, lps), "window: a long row past the "
          "window replayed (the band's graph) equals the eager route "
          "(tokens and logprobs)")
    del twin
    bf16 = window_rows(torch, eng.model, eng.params, long_[0], toks, dec)
    cut = window_cut(torch, eng, long_[0])
    log(f"window: a {WINDOW_LONG[0]}-token row's 7 decode steps against the "
        f"full forward, rel L2 with the window and without it (control): "
        f"bf16 {bf16}, float32 2-layer cut {cut}; bounds {WINDOW_TOL}, "
        f"control gated on the float32 KV cut at {WINDOW_CONTROL}x")
    check(bf16["window"] <= WINDOW_TOL["bf16"], f"window: bf16 {bf16}")
    for name in ("fp32", "fp32_int8_kv"):
        check(cut[name]["window"] <= WINDOW_TOL[name],
              f"window: {name} cut {cut[name]}")
    check(cut["fp32"]["no_window"] >= WINDOW_CONTROL * WINDOW_TOL["fp32"],
          f"window: the float32 control (no window) reads "
          f"{cut['fp32']['no_window']}, under {WINDOW_CONTROL} x the bound")
    check(eng.kv.used_blocks() == eng.radix.pool_blocks(),
          "window: no leaked KV blocks")
    out = {"setup_s": setup_s, "wall_s": wall, "counts": counts,
           "decode_steps": len(attends), "b1_steps": b1_steps,
           "band_steps": band, "ttft_ms": ttft,
           "ttft_ms_long": ttft[len(short):],
           "inside": {k: v for k, v in inside.items() if k != "counts"},
           "past": {k: v for k, v in past.items() if k != "counts"},
           "eager": {k: {key: v[key] for key in ("tok_s", "step_ms",
                                                 "device_ms_per_step")}
                     for k, v in eager.items()},
           "rows_bf16": bf16, "rows_cut": cut, "route": route}
    del eng, srv
    free_memory(torch)
    return out


def phase_int4(torch, ops, n_layers: int = INT4_LAYERS) -> dict:
    """The int4 7B server (``INT4_SERVE_FLAGS`` at ``n_layers`` layers:
    group-wise int4 weights, int8 KV cache) from seeded weights, by the
    port's own CLI wiring: 8 concurrent greedy completions over HTTP, B1
    once a layer each decode step and no B2/B3 (int4 weights dequantize into ``torch.matmul``); the
    card's unpacking against the CPU's on the same bytes; the decode
    logits of a burst against the same engine over the ``weight()``-
    dequantized bf16 weights; the weights' GiB as int4, int8 and bf16;
    decode tok/s and device ms per step."""
    import threading

    from instaslice_tpu_torch.models.quant import (
        Int4Tensor,
        quantize_params,
        weight,
    )
    from instaslice_tpu_torch.serving import ServingEngine, api_server

    t0 = time.perf_counter()
    args = api_server.build_parser().parse_args(
        INT4_SERVE_FLAGS.split() + ["--n-layers", str(n_layers)])
    eng = api_server.build_engine(args)
    srv = api_server.ApiServer(eng, host=args.host, port=args.port).start()
    setup_s = time.perf_counter() - t0
    L, V = args.n_layers, args.vocab_size
    check(isinstance(eng.params["blocks"]["w_in"], Int4Tensor)
          and isinstance(eng.params["embed"], Int4Tensor) and eng.kv_quant,
          "int4: int4 weights, int8 KV cache")
    check(eng.attention_route() == "B1", "int4: B1 decode attention")
    gen = torch.Generator().manual_seed(43)
    prompts = [torch.randint(1, V, (n,), generator=gen).tolist()
               for n in SERVE_PLENS]
    results, errors = [None] * len(prompts), []

    def one(i):
        body = {"prompt": prompts[i], "max_tokens": INT4_NEW,
                "temperature": 0.0}
        try:
            results[i] = http_json(srv.url + "/v1/completions",
                                   body)["choices"][0]
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"request {i}: {e!r}")

    try:
        wait_ready(srv.url)
        steps0 = eng.decode_steps
        graphs0 = eng.graph_stats()["graphs"]
        t0 = time.perf_counter()
        with Traced(torch, ops) as tr:
            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(len(prompts))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        wall = tr.t_end - t0
        counts = tr.counts
        steps = eng.decode_steps - steps0
        st = http_json(srv.url + "/v1/stats")
        within_budget(st["engine"]["decode_graphs"], "int4")
        check(eng.graph_stats()["graphs"] == graphs0, "int4: no capture "
              "in the counted run")
    finally:
        srv.stop()
    check(not errors, f"int4: {errors}")
    log(f"int4: decode graphs {st['engine']['decode_graphs']}, pool "
        f"{eng.graph_pool_gib()} GiB")
    for i, r in enumerate(results):
        check(len(r["token_ids"]) == INT4_NEW
              and all(0 <= t < V for t in r["token_ids"]),
              f"int4: request {i}: {r['token_ids']}")
    log(f"int4: server in {setup_s:.1f} s; 8 concurrent completions "
        f"{list(SERVE_PLENS)} x {INT4_NEW} tokens over HTTP in {wall:.2f} s "
        f"(traced): {steps} decode steps, launches on the card's trace "
        f"{counts}")
    check(counts["quant_decode_attention"] == L * steps > 0,
          "int4: B1 launches = layers x decode steps")
    check(all(counts[n] == 0 for n in ("quant_matmul_stacked",
                                       "quant_matmul_t", "quant_matmul")),
          "int4: no B2-B4 (int4 weights dequantize into torch.matmul)")
    check(all(counts[n] == 0 for n in FLASH), "int4: B5-B7 are not on "
          "this path")
    check(st["live_slots"] == 0 and st["parked"] == 0, "int4: quiesced")
    check(st["kv"]["used"] == st["radix"]["blocks"],
          f"int4: no leaked KV blocks: kv {st['kv']}")

    # the card's unpacking and dequantization against the CPU's
    for name, leaf in (("w_in", eng.params["blocks"]["w_in"].layer(0)),
                       ("embed", eng.params["embed"])):
        host = Int4Tensor(leaf.p.cpu(), leaf.s.cpu(), leaf.group,
                          leaf.pack_axis)
        check(torch.equal(leaf._unpack().cpu(), host._unpack())
              and torch.equal(leaf.dequantize(torch.bfloat16).cpu(),
                              host.dequantize(torch.bfloat16)),
              f"int4: {name} unpacked on the card equals the CPU's")

    def dequantized(tree):
        if isinstance(tree, dict):
            return {k: dequantized(v) for k, v in tree.items()}
        return weight(tree, torch.bfloat16) if isinstance(tree, Int4Tensor) \
            else tree

    deq = dequantized(eng.params)
    gib = {"int4": tree_gib(eng.params), "bf16": tree_gib(deq)}
    q8 = quantize_params(deq)
    gib["int8"] = tree_gib(q8)
    del q8
    free_memory(torch)
    # the burst on the graph route and on an eager twin over the same
    # int4 weights (whose logits are read): tokens and logprobs equal;
    # the twin's logits against the dequantized bf16 engine's (eager)
    eng.radix.reclaim(eng.kv.total_blocks)
    g_got = lora_burst(eng, prompts, [0] * len(prompts))[0]
    twin = eager_twin(eng)
    got, got_lg = lora_burst(twin, prompts, [0] * len(prompts))
    check(g_got == got, "int4: the burst replayed equals the eager route "
          "(tokens and logprobs)")
    ref = ServingEngine(eng.model, deq, max_batch=8, max_len=eng.max_len,
                        prefill_len=eng.prefill_len, kv_quant=True,
                        device="cuda", decode_graphs=False)
    want, want_lg = lora_burst(ref, prompts, [0] * len(prompts))
    del ref, deq
    free_memory(torch)
    l2 = [rel_l2(got_lg[:, i], want_lg[:, i]) for i in range(len(prompts))]
    bit_equal = bool(torch.equal(got_lg, want_lg))
    log(f"int4: weights {gib} GiB; burst decode logits against the "
        f"dequantized bf16 engine rel L2 {[f'{x:.3g}' for x in l2]} (bound "
        f"{INT4_TOL:g}), bit-equal {bit_equal}")
    check(max(l2) <= INT4_TOL and [t for t, _ in got] == [t for t, _ in want],
          f"int4: decode logits against the dequantized forward {l2}")
    check(eng.kv.used_blocks() == eng.radix.pool_blocks(),
          "int4: no leaked KV blocks")
    tput = decode_tput(torch, eng, [[1, 2, 3]] * 8, n=8)
    check(tput["counts"]["quant_decode_attention"] == L * tput["steps"]
          and tput["counts"]["quant_matmul_stacked"] == 0,
          f"int4: decode block launches B1 {L} times a step, no B2")
    eager = decode_tput(torch, twin, [[1, 2, 3]] * 8, n=8)
    del twin
    log(f"int4: decode at batch 8 {tput['tok_s']:.1f} tok/s, "
        f"{tput['step_ms']:.1f} ms per step on the host clock, "
        f"{tput['device_ms_per_step']} device ms per step (the eager twin "
        f"{eager['tok_s']:.1f} tok/s, {eager['step_ms']:.1f} ms, "
        f"{eager['device_ms_per_step']} device ms); by kernel (ms): "
        f"{tput['device_top']}")
    out = {"setup_s": setup_s, "wall_s": wall, "counts": counts,
           "decode_steps": steps, "weights_gib": gib, "rel_l2": l2,
           "bit_equal": bit_equal,
           "decode": {k: v for k, v in tput.items() if k != "counts"},
           "eager_decode": {k: eager[k] for k in (
               "tok_s", "step_ms", "device_ms_per_step")}}
    del eng, srv
    free_memory(torch)
    return out


def param_count(cfg) -> int:
    """Matmul parameters a token runs through (the embedding once, tied
    unembedding; norms left out): ``instaslice_tpu/bench_tpu.py:355``
    for a dense TpuLM; an MoE layer counts its top-k experts and its
    router (the active parameters)."""
    attn = (2 * cfg.d_model * cfg.n_heads * cfg.head_dim
            + 2 * cfg.d_model * cfg.kv_heads * cfg.head_dim)
    mlp = 2 * cfg.d_model * cfg.d_ff
    if cfg.n_experts:
        mlp = mlp * min(cfg.expert_top_k, cfg.n_experts) \
            + cfg.d_model * cfg.n_experts
    return cfg.vocab_size * cfg.d_model + cfg.n_layers * (attn + mlp)


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


def train_run(torch, ops, cfg, n_timed: int, what: str,
              profile: bool) -> dict:
    """``make_train_step`` on ``cfg`` at batch 8 x 1024: launch counters
    zeroed just before a warm-up step and ``n_timed`` timed steps and
    read just after; the loss finite and falling, B5 once per layer per
    step (twice under remat: the recompute runs it again), B6 and B7 once,
    no serving kernel; step ms, tokens/s, MFU over the active parameters,
    peak memory, and with ``profile`` (the main path's run, not the
    remat sweeps) the device time by kernel class. An MoE model also
    reads its load-balance term before and after."""
    from instaslice_tpu_torch.models.lm import TpuLM
    from instaslice_tpu_torch.models.train import make_train_step

    B, S = 8, 1024
    # as the training CLI: the fp32-output unembedding in TF32 (exact on
    # the forward's bf16 operands; its backward rounds dlogits to TF32)
    torch.backends.cuda.matmul.allow_tf32 = True
    model = TpuLM(cfg)
    init_fn, step_fn = make_train_step(model, learning_rate=3e-4,
                                       grad_clip=1.0, device="cuda")
    state = init_fn(0)
    gen = torch.Generator(device="cuda").manual_seed(17)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")

    def aux_now() -> float:
        with torch.no_grad():
            return float(model.apply(state.params, tokens, unembed=False,
                                     return_aux=True)[1])

    auxes = [aux_now()] if cfg.n_experts else []
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
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    steps = 1 + n_timed
    remat = cfg.remat_policy if cfg.remat else "none"
    log(f"{what}: B={B} S={S} remat {remat}, {steps} steps, losses "
        f"{losses}, launches {counts}")
    check(all(math.isfinite(x) for x in losses), f"{what}: finite losses")
    check(losses[-1] < losses[0], f"{what}: the loss falls over the steps")
    per_step = {"flash_fwd": cfg.n_layers * (2 if cfg.remat else 1),
                "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers}
    for name, n in per_step.items():
        check(counts[name] == n * steps,
              f"{what}: {name} launches {counts[name]} = {n} x {steps}")
    check(all(counts[n] == 0 for n in counts if n not in FLASH),
          f"{what}: no serving kernel on the train path")
    if cfg.n_experts:
        auxes.append(aux_now())
        # E * sum_e f_e P_e: 1 at perfect balance, E at collapse; a
        # product of two means, it can fall below 1
        check(all(math.isfinite(a) and 0.0 < a <= cfg.n_experts
                  for a in auxes), f"{what}: aux {auxes} within (0, E]")
    step_s = wall / n_timed
    n_params = param_count(cfg)
    mfu = 6 * n_params * B * S / step_s / BF16_FLOPS
    busy = (device_busy(torch, lambda: step_fn(state, tokens), 1)
            if profile else None)
    log(f"{what}: {step_s * 1e3:.1f} ms/step, {B * S / step_s:.0f} "
        f"tokens/s, MFU {mfu:.4f} (6 x {n_params / 1e6:.1f}M active x "
        f"{B * S} tokens over 989 TFLOP/s), peak memory {peak:.2f} GiB"
        + (f", aux {auxes}" if auxes else ""))
    if busy is not None:
        log(f"{what}: device busy {busy['ms_per_step']:.1f} ms per step = "
            f"{busy['ms_per_step'] / (step_s * 1e3):.1%}; by class "
            f"(ms/step): {busy['by_class']}; by kernel: {busy['top']}")
    del state, init_fn, step_fn
    free_memory(torch)
    return {"counts": counts, "steps": steps, "losses": losses,
            "step_ms": step_s * 1e3, "tokens_per_s": B * S / step_s,
            "mfu": mfu, "params_m": n_params / 1e6, "peak_gib": peak,
            "device_busy": busy, "remat": remat, "aux": auxes}


def phase_train(torch, ops) -> dict:
    """The training main path: the 871M train step at batch 8 x 1024, no
    remat, launch counters zeroed just before and read just after; then
    the same step under remat "dots" and "full" (the remat sweep of
    ``bench_train_mfu``, ``instaslice_tpu/bench_tpu.py:646-655``), not
    profiled."""
    out = train_run(torch, ops, train_config(torch), 4, "train",
                    profile=True)
    out["remat_sweep"] = {}
    for policy in ("dots", "full"):
        r = train_run(torch, ops, train_config(torch, remat=True,
                                               remat_policy=policy), 3,
                      f"train remat {policy}", profile=False)
        out["remat_sweep"][policy] = {k: r[k] for k in (
            "step_ms", "tokens_per_s", "mfu", "peak_gib", "losses")}
    return out


# ---------------------------------------------------------------- moe phase


def moe_config(torch, n_layers: int = 16, **kw):
    """The MoE training configuration at the 871M's widths: 8 experts,
    top-2, capacity factor 1.25, expert d_ff 4096 = the dense 8192 over
    top_k, so a token's active FLOPs equal the dense model's
    (``bench_moe``'s rule, ``instaslice_tpu/bench_tpu.py:802-807``);
    fp32 masters, bf16 compute, remat "dots"."""
    base = dict(n_experts=8, expert_top_k=2, expert_capacity_factor=1.25,
                d_ff=4096, remat=True, remat_policy="dots")
    base.update(kw)
    return train_config(torch, n_layers=n_layers, **base)


def moe_bench(torch) -> dict:
    """``bench_moe`` at its defaults (``MOE_BENCH``): each model's device
    time per forward from a profiler window of ``MOE_BENCH_FWDS`` forwards
    after one warm-up, and ``moe_bench_overhead_pct`` = the MoE's over the
    dense's. Device time, not the host's clock: eager PyTorch at this size
    is partly host-bound, and a host reading measures the launch overhead
    rather than the MoE's cost."""
    from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM, init_params

    m = MOE_BENCH
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, m["vocab"], (m["batch"], m["seq"]),
                           generator=gen, device="cuda")
    out = {}
    for kind in ("dense", "moe"):
        moe = kind == "moe"
        cfg = ModelConfig(vocab_size=m["vocab"], d_model=m["d_model"],
                          n_heads=m["n_heads"], n_layers=m["n_layers"],
                          d_ff=m["dense_ff"] // m["top_k"] if moe
                          else m["dense_ff"],
                          max_seq_len=m["seq"], dtype=torch.bfloat16,
                          remat=False, n_experts=m["n_experts"] if moe
                          else 0, expert_top_k=m["top_k"])
        model, params = TpuLM(cfg), init_params(cfg, 12, device="cuda")

        def fwds():
            for _ in range(MOE_BENCH_FWDS):
                model.apply(params, tokens)

        with torch.no_grad():
            fwds()                                  # warm-up
            busy = device_busy(torch, fwds, MOE_BENCH_FWDS)
        check(busy is not None, f"moe bench: {kind} device time read")
        out[f"{kind}_fwd_device_ms"] = busy["ms_per_step"]
        out[f"{kind}_fwd_device_by_class"] = busy["by_class"]
        del model, params
        free_memory(torch)
    out["moe_bench_overhead_pct"] = (
        100.0 * (out["moe_fwd_device_ms"] - out["dense_fwd_device_ms"])
        / out["dense_fwd_device_ms"])
    log(f"moe bench: L{m['n_layers']} d{m['d_model']} ff{m['dense_ff']} "
        f"B{m['batch']} S{m['seq']} vs E{m['n_experts']} top{m['top_k']} "
        f"expert_ff{m['dense_ff'] // m['top_k']} (matched active FLOPs), "
        f"bf16 forward, device ms per forward: dense "
        f"{out['dense_fwd_device_ms']:.3f}, moe {out['moe_fwd_device_ms']:.3f}"
        f"; moe_bench_overhead_pct {out['moe_bench_overhead_pct']:.1f}; by "
        f"class: dense {out['dense_fwd_device_by_class']}, moe "
        f"{out['moe_fwd_device_by_class']}")
    return out


def moe_engine(torch, ops, cfg, qp) -> dict:
    """The MoE int8 cache forward, the first path that launches B4: the
    int8 weights ``qp`` of the MoE configuration ``cfg`` served by
    ``ServingEngine`` (batch 8, max_len 1024, prefill 128, int8 KV) on 8
    prompts through ``generate``; launch counters zeroed just before and
    read just after: B4 4 per layer (q, k, v, o) and B3 once per forward
    (every forward has at most 256 rows), B1 and B2 none (gated off for
    MoE, as in the reference); then decode tok/s and device ms a step."""
    from instaslice_tpu_torch.models.lm import TpuLM
    from instaslice_tpu_torch.serving import ServingEngine

    eng = ServingEngine(TpuLM(cfg), qp, max_batch=8, max_len=1024,
                        prefill_len=128, kv_quant=True, device="cuda")
    check(eng.attention_route().startswith("plain (mixture-of-experts"),
          f"moe engine route {eng.attention_route()!r}")
    eng.warm_prefill_buckets()
    graphs0 = eng.graph_stats()["graphs"]
    gen = torch.Generator().manual_seed(11)
    plens = [300, 200, 129, 100, 64, 33, 17, 5]
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen)
               .tolist() for n in plens]
    max_new = 32
    eng.decode_steps = eng.prefill_dispatches = 0
    t0 = time.perf_counter()
    with Traced(torch, ops, kn="quant_matmul") as tr:
        results = eng.generate(prompts, max_new_tokens=max_new,
                               block_size=16)
    wall = tr.t_end - t0
    counts = tr.counts
    steps, chunks = eng.decode_steps, eng.prefill_dispatches
    log(f"moe engine: generate 8 prompts {plens} x {max_new} tokens in "
        f"{wall:.2f} s (traced): {chunks} prefill chunks, {steps} decode "
        f"steps, launches on the card's trace {counts}")
    check(eng.graph_stats()["graphs"] == graphs0, "moe engine: no capture "
          "in the counted run")
    # the same prompts on the eager route (a twin over the same weights)
    twin = eager_twin(eng)
    ops.reset_launch_counts()
    want = twin.generate(prompts, max_new_tokens=max_new, block_size=16)
    check([(r.tokens, r.logprobs) for r in results]
          == [(r.tokens, r.logprobs) for r in want],
          "moe engine: the replayed blocks equal the eager route (tokens "
          "and logprobs)")
    check(ops.launch_counts() == counts, f"moe engine: the eager route's "
          f"wrappers count what the graph route's trace holds: "
          f"{ops.launch_counts()} against {counts}")
    check(len(results) == 8 and all(len(r.tokens) == max_new
                                     for r in results), "moe engine tokens")
    check(all(0 <= t < cfg.vocab_size for r in results for t in r.tokens),
          "moe engine tokens in range")
    check(eng.kv.used_blocks() == eng.radix.pool_blocks(),
          "moe engine: no leaked KV blocks")
    L = cfg.n_layers
    forwards = steps + chunks              # every chunk has M=128 <= 256
    check(chunks == sum(-(-n // 128) for n in plens), "prefill chunks")
    check(counts["quant_matmul"] == 4 * L * forwards > 0,
          "B4 launches = 4 x layers x forwards")
    check(counts["quant_matmul_t"] == forwards, "B3 launches = forwards")
    check(counts["quant_matmul_stacked"] == 0
          and counts["quant_decode_attention"] == 0,
          "B1 and B2 are gated off for MoE")
    check(all(counts[n] == 0 for n in FLASH), "B5-B7 are not on this path")
    tok_s = eng.throughput(n_steps=16)
    eager_tok_s = twin.throughput(n_steps=16)
    del twin
    for _ in range(8 - len(eng.slots)):
        eng.add_request([1, 2, 3])
    eng.decode_block(1)
    busy = device_busy(torch, lambda: eng.decode_block(2), 2,
                       kn="quant_matmul")
    log(f"moe engine: decode {tok_s:.1f} tok/s at batch 8 "
        f"({8 / tok_s * 1e3:.2f} ms/step on the host clock; the eager twin "
        f"{eager_tok_s:.1f} tok/s, {8 / eager_tok_s * 1e3:.2f} ms/step)"
        + (f", device busy {busy['ms_per_step']:.2f} ms per decode step; "
           f"by kernel (ms/step): {busy['top']}" if busy else ""))
    graphs = eng.graph_stats()
    within_budget(graphs, "moe engine")
    out = {"counts": counts, "decode_steps": steps, "prefill_chunks": chunks,
           "generate_s": wall, "decode_tok_s": tok_s,
           "eager_decode_tok_s": eager_tok_s,
           "device_busy": busy, "weights_gib": tree_gib(qp),
           "graphs": graphs, "graph_pool_gib": eng.graph_pool_gib()}
    del eng
    return out


def moe_b4(torch, qm, wq, L: int) -> dict:
    """B4 against its plain version at the MoE path's shape, (M, 2048) x
    (2048, 2048) int8 (one layer's wq), M = 1 ... 256 in bf16 and fp32;
    two runs bit-equal; timed at M = 8 like phase 2 (graph replay over
    the L layers' weights, so the weight is not in L2), beside its plain
    version and ``torch.matmul`` on the bf16 weight."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    K, N = wq.q.shape[1:]
    errs = {}
    for M in QMM_MS:
        x32 = torch.randn((M, K), generator=gen, device=dev)
        for xin in (x32.to(torch.bfloat16), x32):
            got = qm.quant_matmul(xin, wq.q[L - 1], wq.s[L - 1])
            want = qm.quant_matmul_ref(xin, wq.q[L - 1], wq.s[L - 1])
            worse(errs, check_qmm(torch, qm, got, want, f"B4 {K}x{N} M={M} "
                                  f"{xin.dtype}", xin.dtype, M, K, N, False))
            again = qm.quant_matmul(xin, wq.q[L - 1], wq.s[L - 1])
            check(bool(torch.equal(got, again)),
                  f"B4 {K}x{N} M={M}: two runs bit-equal")
    x = torch.randn((8, K), generator=gen, device=dev).to(torch.bfloat16)
    wb = [wq.layer(li).dequantize(torch.bfloat16) for li in range(L)]
    ms = graph_ms(torch, lambda i: qm.quant_matmul(
        x, wq.q[i % L], wq.s[i % L]), L)
    plain = graph_ms(torch, lambda i: qm.quant_matmul_ref(
        x, wq.q[i % L], wq.s[i % L]), 8, replays=2)
    lib = graph_ms(torch, lambda i: torch.matmul(x, wb[i % L]), L)
    del wb
    nbytes = K * N + 2 * N + 2 * 8 * K + 4 * 8 * N
    b_ms, b_by = bound(nbytes, 2 * 8 * K * N)
    log(f"moe: B4 {K}x{N} M=8: {ms * 1e3:.1f} us = {gbs(nbytes, ms):.0f} "
        f"GB/s (bound {b_ms * 1e3:.1f} us, {b_by}; plain "
        f"{plain * 1e3:.1f}, library {lib * 1e3:.1f}); errors {errs}")
    return {"errs": errs, "ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": b_ms, "bound_by": b_by, "gb_per_s": gbs(nbytes, ms)}


#: the moe phase's CPU-against-card training cut: layers and row length;
#: the layers of its int8 cache-forward cut
MOE_CUT_LAYERS, MOE_CUT_ROWS = 1, 128
MOE_INT8_CUT_LAYERS = 1


def phase_moe(torch, ops) -> dict:
    """(a) ``bench_moe``'s dense/MoE forward pair; (b) the MoE main path:
    the MoE configuration through ``make_train_step`` at batch 8 x 1024
    under remat "dots", then "full", then no remat (an OOM is recorded,
    not fatal); (c) a 1-layer fp32 cut of it, CPU against card; (d) the
    MoE int8 engine and a 1-layer int8 cut of its cache forward (fp32
    compute, so that no top-2 choice is decided by bf16 rounding), CPU
    against card; (e) B4 at the path's shape."""
    from instaslice_tpu_torch.models.lm import init_params
    from instaslice_tpu_torch.models.quant import quantize_params

    secs, t0 = {}, time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        secs[name] = round(time.perf_counter() - t0, 1)
        free_memory(torch)
        t0 = time.perf_counter()

    out = {"bench": moe_bench(torch)}
    lap("bench")
    out["train"] = train_run(torch, ops, moe_config(torch), 3, "moe train",
                             profile=True)
    lap("train")
    out["train_sweep"] = {}
    r = train_run(torch, ops, moe_config(torch, remat_policy="full"), 3,
                  "moe train remat full", profile=False)
    out["train_sweep"]["full"] = {k: r[k] for k in (
        "step_ms", "tokens_per_s", "mfu", "peak_gib", "losses", "aux")}
    lap("train_full")
    try:
        r = train_run(torch, ops, moe_config(torch, remat=False), 3,
                      "moe train remat none", profile=False)
        out["train_sweep"]["none"] = {k: r[k] for k in (
            "step_ms", "tokens_per_s", "mfu", "peak_gib", "losses", "aux")}
    except torch.cuda.OutOfMemoryError as e:
        msg = str(e).splitlines()[0]
        log(f"moe train remat none: out of memory (measured): {msg}")
        out["train_sweep"]["none"] = {"oom": msg}
    lap("train_none")
    # 1 layer at rows of 128 (2 at 256 until the chaos step came, cut to
    # pay for it): the CPU's fp32 experts are most of the part's seconds
    out["train_cut"] = phase_train_cut(
        torch, moe_config(torch, n_layers=MOE_CUT_LAYERS,
                          dtype=torch.float32, param_dtype=None),
        "moe train cut", rows=MOE_CUT_ROWS)
    lap("train_cut")
    cfg = moe_config(torch, param_dtype=None, remat=False)
    qp = quantize_params(init_params(cfg, 0, device="cuda"))
    lap("engine_weights")
    out["engine"] = moe_engine(torch, ops, cfg, qp)
    lap("engine")
    out["b4"] = moe_b4(torch, ops.quant_matmul, qp["blocks"]["wq"],
                       cfg.n_layers)
    del qp
    lap("b4")
    # 1 layer (2 until the chaos step came, cut to pay for it)
    cut = dataclasses.replace(cfg, n_layers=MOE_INT8_CUT_LAYERS,
                              dtype=torch.float32)
    out["cut"] = phase_cut(torch, cut, quantize_params(
        init_params(cut, 0, device="cpu")), "moe int8 cut",
        n_layers=MOE_INT8_CUT_LAYERS)
    lap("int8_cut")
    log(f"moe: seconds by part {secs}")
    out["seconds"] = secs
    return out


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


#: the CPU-against-card training cut of the 871M (the ``train_cut``
#: phase): layers and row length (2 at rows of 256 until the chaos step
#: came, cut to pay for it: the CPU's fp32 step is most of its seconds)
TRAIN_CUT_LAYERS, TRAIN_CUT_ROWS = 1, 128


def phase_train_cut(torch, cfg=None, what: str = "train cut",
                    rows: int = 256) -> dict:
    """2 layers of the 871M configuration (or ``cfg``) in fp32 at batch
    2 x ``rows``: loss and grads at the initial weights, then params
    after 3 AdamW steps (clip 1.0, warmup 2, decay 3), CPU plain versions
    vs card kernels."""
    from instaslice_tpu_torch.models.lm import TpuLM, init_params
    from instaslice_tpu_torch.models.train import (
        leaves,
        loss_fn,
        make_train_step,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    if cfg is None:
        cfg = train_config(torch, n_layers=2, dtype=torch.float32,
                           param_dtype=None)
    model = TpuLM(cfg)
    params = init_params(cfg, 3, device="cpu")
    gen = torch.Generator().manual_seed(19)
    batches = [torch.randint(0, cfg.vocab_size, (2, rows), generator=gen)
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

    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip([l_g] + ls_g, [l_c] + ls_c))
    grad_err = max(rel_l2(a, b) for a, b in zip(g_g, g_c))
    upd_err = max(rel_l2(a - w, b - w) for a, b, w in zip(p_g, p_c, p0))
    par_err = max(float((a - b).abs().max()) for a, b in zip(p_g, p_c))
    log(f"{what}: losses cpu {ls_c} card {ls_g}; loss rel err "
        f"{loss_err:.2e}, grads rel L2 err {grad_err:.2e}, param update "
        f"rel L2 err {upd_err:.2e}, param max abs err {par_err:.2e}")
    check(loss_err <= CUT_TOL["loss"], f"{what} loss err {loss_err}")
    check(grad_err <= CUT_TOL["grads"], f"{what} grads err {grad_err}")
    check(upd_err <= CUT_TOL["update"], f"{what} update err {upd_err}")
    check(par_err <= CUT_TOL["params"], f"{what} params err {par_err}")
    return {"loss_rel_err": loss_err, "grad_rel_l2_err": grad_err,
            "update_rel_l2_err": upd_err, "param_max_abs_err": par_err}


# ------------------------------------------------------------ parallel phase

#: the two-process runs: name, model-axis size, ZeRO-1, the control that
#: swaps the two ranks' wo shards
PAR_RUNS = (("tp2", 2, False, False), ("tp2_swapped_wo", 2, False, True),
            ("dp2_zero1", 1, True, False))
#: their depth: gloo moves every collective through host memory, so this
#: run puts B5-B7 and the tensor-parallel code on the card at the per-rank
#: shapes; it times nothing (4 until the ctl phase came, cut to 2 to pay
#: for it: the depth of the CPU cut that set PAR_TOL)
PAR_LAYERS = 2
#: the two-process runs against the one-process step on the same weights
#: (bf16 compute over fp32 masters, 3 AdamW steps at lr 3e-4, clip 1.0):
#: the largest relative loss error over the steps and the worst leaf's
#: relative L2 error of the final params. Set from the CPU cut of the same
#: configuration before the first card run (871M widths, 2 layers, batch
#: 2 x 128, two gloo processes on the CPU): tp 2 read 5.0e-5 and 1.9e-3,
#: dp 2 with ZeRO-1 4.0e-5 and 1.5e-3, the swapped-wo control 3.4e-2 and
#: 1.41; each bound is about 10x the larger in-bound reading
PAR_TOL = {"loss": 5e-4, "params": 2e-2}


def _swap_model_shards(torch, state, path: str) -> None:
    """The control: this rank takes the other model rank's block of leaf
    ``path`` (two model ranks)."""
    from instaslice_tpu_torch.parallel import collectives as coll

    lay = state.layout
    i = lay.paths.index(path)
    leaf = state.params
    for k in path.split("/"):
        leaf = leaf[k]
    full = lay.gather(i, leaf)
    other = dataclasses.replace(lay.axes.model, rank=1 - lay.axes.model.rank)
    with torch.no_grad():
        leaf.copy_(coll.shard_leaf(full, lay.specs[i],
                                   dataclasses.replace(lay.axes,
                                                       model=other)))


def parallel_child(rank: int, world: int, init_method: str, out: str,
                   dev_type: str, n_layers: int, B: int, S: int) -> None:
    """One rank of the two-process runs (spawned): gloo on ``dev_type``
    tensors, each of :data:`PAR_RUNS` over a (dp, 1, tp) mesh for 3 steps
    of the step :func:`parallel_reference` ran; rank 0 holds the gathered
    params against the reference's. Writes ``rank<r>.json``."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(HERE))
    from instaslice_tpu_torch import ops
    from instaslice_tpu_torch.models.lm import TpuLM
    from instaslice_tpu_torch.models.train import (
        full_params,
        leaf_paths,
        leaves,
        make_train_step,
    )
    from instaslice_tpu_torch.parallel import (
        initialize_distributed,
        slice_mesh,
    )
    from instaslice_tpu_torch.parallel.collectives import mesh_axes

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    out = Path(out)
    dev = f"{dev_type}:0" if dev_type == "cuda" else "cpu"
    if dev_type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = True
    initialize_distributed(backend="gloo", init_method=init_method,
                           device=dev)
    res = {}
    try:
        cfg = train_config(torch, n_layers=n_layers)
        ref = (torch.load(out / "reference.pt", mmap=True, weights_only=True)
               if rank == 0 else None)
        for name, tp, zero1, swap in PAR_RUNS:
            t0 = time.perf_counter()
            mesh = slice_mesh(axis_sizes=(-1, 1, tp), device=dev_type)
            axes = mesh_axes(mesh)
            init_fn, step_fn = make_train_step(
                TpuLM(cfg), mesh=mesh, zero1=zero1, learning_rate=3e-4,
                grad_clip=1.0, device=dev)
            state = init_fn(0)
            if swap:
                _swap_model_shards(torch, state, "blocks/wo")
            gen = torch.Generator(device=dev).manual_seed(17)
            tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                   device=dev)
            ops.reset_launch_counts()
            losses = []
            for _ in range(3):
                state, loss = step_fn(state, tokens)
                losses.append(float(loss))
            counts = ops.launch_counts()
            moments = [(z, p.numel(), st["exp_avg"].numel())
                       for z, p, st in zip(
                           state.layout.zero_dims, leaves(state.params),
                           state.opt_state.adamw.state_dict()[
                               "state"].values())]
            full = full_params(state)
            r = {"losses": losses, "counts": counts, "moments": moments,
                 "backend": axes.model.backend or axes.data.backend,
                 "seconds": time.perf_counter() - t0}
            if rank == 0:
                r["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in
                                        zip(losses, ref["losses"]))
                r["params_rel_l2"] = {
                    p: rel_l2(t.detach().float().cpu(),
                              ref["params"][p].float())
                    for p, t in zip(leaf_paths(full), leaves(full))}
            res[name] = r
            del state, full, init_fn, step_fn
            if dev_type == "cuda":
                free_memory(torch)
    finally:
        (out / f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def parallel_reference(torch, dev: str, n_layers: int, B: int, S: int,
                       out: Path) -> dict:
    """The one-process step the two-process runs are held against: the
    871M widths at ``n_layers``, seed 0, 3 steps on the train phase's
    batch; its losses and final params saved to ``out``."""
    from instaslice_tpu_torch.models.lm import TpuLM
    from instaslice_tpu_torch.models.train import (
        leaf_paths,
        leaves,
        make_train_step,
    )

    cfg = train_config(torch, n_layers=n_layers)
    init_fn, step_fn = make_train_step(TpuLM(cfg), learning_rate=3e-4,
                                       grad_clip=1.0, device=dev)
    state = init_fn(0)
    gen = torch.Generator(device=dev).manual_seed(17)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    losses = []
    for _ in range(3):
        state, loss = step_fn(state, tokens)
        losses.append(float(loss))
    params = {p: t.detach().cpu() for p, t in
              zip(leaf_paths(state.params), leaves(state.params))}
    torch.save({"losses": losses, "params": params}, out / "reference.pt")
    return {"losses": losses}


def parallel_two_process(torch, dev_type: str = "cuda",
                         n_layers: int = PAR_LAYERS, B: int = 8,
                         S: int = 1024) -> dict:
    """Two processes on one card over gloo on CUDA tensors (spawned, not
    forked; the kernels are built and the parent's cached memory freed
    before): (dp 1, tp 2), the same with the two ranks' wo shards swapped
    (the control), and (dp 2, tp 1) with ZeRO-1, each 3 steps against the
    one-process step on the same weights, within :data:`PAR_TOL`; B5-B7
    one launch per rank per layer-step; each ZeRO-1 moment numel / 2."""
    import multiprocessing as mp
    import shutil
    import socket

    out = HERE / "build" / "parallel"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    dev = "cuda" if dev_type == "cuda" else "cpu"
    t0 = time.perf_counter()
    ref = parallel_reference(torch, dev, n_layers, B, S, out)
    t_ref = time.perf_counter() - t0
    if dev_type == "cuda":
        free_memory(torch)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=parallel_child, args=(
        r, 2, f"tcp://127.0.0.1:{port}", str(out), dev_type, n_layers, B,
        S)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    check(codes == [0, 0], f"parallel children exit codes {codes}")
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    shutil.rmtree(out)          # the reference's params: ~0.7 GiB at 2 layers
    runs = {}
    for name, tp, zero1, swap in PAR_RUNS:
        r0, r1 = ranks[0][name], ranks[1][name]
        worst = max(r0["params_rel_l2"].values())
        runs[name] = {
            "losses": r0["losses"], "loss_rel_err": r0["loss_rel_err"],
            "params_rel_l2_worst": worst,
            "worst_leaf": max(r0["params_rel_l2"],
                              key=r0["params_rel_l2"].get),
            "counts": [r0["counts"], r1["counts"]],
            "backend": r0["backend"], "seconds": r0["seconds"]}
        log(f"parallel {name}: losses {r0['losses']} (one process "
            f"{ref['losses']}), loss rel err {r0['loss_rel_err']:.2e}, "
            f"params rel L2 worst {worst:.2e} ({runs[name]['worst_leaf']}); "
            f"backend {r0['backend']} on {dev_type} tensors; per-rank "
            f"launches {[{k: c[k] for k in FLASH} for c in runs[name]['counts']]}; "
            f"{r0['seconds']:.1f} s")
        within = (r0["loss_rel_err"] <= PAR_TOL["loss"]
                  and worst <= PAR_TOL["params"])
        if swap:
            check(not within, f"parallel {name}: the control misses the "
                  f"bound {PAR_TOL}")
        else:
            check(within, f"parallel {name}: within {PAR_TOL}")
        for c in runs[name]["counts"]:
            for k in FLASH:
                check(c[k] == n_layers * 3,
                      f"parallel {name}: {k} {c[k]} = {n_layers} x 3 "
                      "per rank")
        if zero1:
            for rk in ranks:
                for zdim, numel, mu in rk[name]["moments"]:
                    check(mu == (numel // 2 if zdim is not None else numel),
                          f"parallel {name}: ZeRO-1 moment {mu} of {numel}")
    return {"runs": runs, "reference_losses": ref["losses"],
            "reference_s": t_ref, "tol": PAR_TOL,
            "n_layers": n_layers, "B": B, "S": S}


def parallel_ws1(torch, ops) -> dict:
    """World size 1 on NCCL at the full 871M: ``slice_mesh`` ->
    ``make_train_step(mesh=...)``, 3 steps from the train phase's seed and
    batch, bit-equal in losses and params to the meshless step on the
    same weights; B5-B7 16 launches a step; step ms (steps 2-3) and peak
    GiB of both."""
    import socket

    import torch.distributed as dist

    from instaslice_tpu_torch.models.lm import TpuLM
    from instaslice_tpu_torch.models.train import leaves, make_train_step
    from instaslice_tpu_torch.parallel import (
        initialize_distributed,
        slice_mesh,
    )

    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = train_config(torch)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_distributed(backend="nccl",
                           init_method=f"tcp://127.0.0.1:{port}",
                           device="cuda")
    try:
        mesh = slice_mesh(device="cuda")
        out = {"backend": dist.get_backend(), "mesh": list(mesh.shape)}
        for what, m in (("meshless", None), ("mesh", mesh)):
            init_fn, step_fn = make_train_step(
                TpuLM(cfg), learning_rate=3e-4, grad_clip=1.0,
                device="cuda", mesh=m)
            state = init_fn(0)
            gen = torch.Generator(device="cuda").manual_seed(17)
            tokens = torch.randint(0, cfg.vocab_size, (8, 1024),
                                   generator=gen, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            losses = []
            state, loss = step_fn(state, tokens)
            losses.append(loss)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                state, loss = step_fn(state, tokens)
                losses.append(loss)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / 2 * 1e3
            out[what] = {"losses": [float(x) for x in losses],
                         "step_ms": step_ms,
                         "peak_gib": torch.cuda.max_memory_allocated()
                         / 2 ** 30,
                         "counts": ops.launch_counts()}
            # on the host: a copy on the card would raise the next run's
            # peak by the params' 3.2 GiB
            out[what + "_params"] = [p.detach().cpu()
                                     for p in leaves(state.params)]
            del state, init_fn, step_fn
            free_memory(torch)
        same = all(torch.equal(a, b) for a, b in
                   zip(out.pop("meshless_params"), out.pop("mesh_params")))
        free_memory(torch)
    finally:
        dist.destroy_process_group()
    a, b = out["meshless"], out["mesh"]
    log(f"parallel ws1 (NCCL, mesh {out['mesh']}): losses {b['losses']} "
        f"vs meshless {a['losses']}, params bit-equal {same}; step "
        f"{b['step_ms']:.1f} ms vs {a['step_ms']:.1f} ms, peak "
        f"{b['peak_gib']:.2f} vs {a['peak_gib']:.2f} GiB; launches "
        f"{ {k: b['counts'][k] for k in FLASH} }")
    check(b["losses"] == a["losses"], "parallel ws1: losses bit-equal")
    check(same, "parallel ws1: params bit-equal")
    for k in FLASH:
        check(b["counts"][k] == 16 * 3, f"parallel ws1: {k} = 16 x 3")
    out["params_bit_equal"] = same
    return out


def phase_parallel(torch, ops) -> dict:
    """The parallel layer on one card: world size 1 on NCCL at the full
    871M (:func:`parallel_ws1`), then two processes over gloo on CUDA
    tensors at 2 layers (:func:`parallel_two_process`). No scaling
    number: one card."""
    t0 = time.perf_counter()
    out = {"ws1": parallel_ws1(torch, ops)}
    t1 = time.perf_counter()
    free_memory(torch)
    out["two_process"] = parallel_two_process(torch)
    out["seconds"] = {"ws1": t1 - t0, "two_process": time.perf_counter() - t1}
    log(f"parallel: seconds by part {out['seconds']}")
    return out


#: tensor-parallel serving (the tp_serve phase): the 7B int8 server at tp
#: 2 as two processes on the one card over gloo. Greedy tokens are held
#: equal to the meshless engine's for the first TP_GREEDY of each
#: completion (bf16 configs: short runs only), and each token's logprob
#: within TP_LOGPROB_TOL over the prefix where the tokens agree; both
#: engines serve the final norm's scale divided by 64, as the graph phase
#: does, so that logprobs of the seeded weights read something. The
#: meshless reference admits one prompt at a time (B2 on every 128-row
#: chunk) and the server bursts (wide chunks through torch.matmul), as in
#: the serve phase; the ranks sum their fp32 partial products in another
#: order than one card's kernels
TP_GREEDY = 4
TP_LOGPROB_TOL = 5e-2
#: the served decode steps' logits (:class:`DecodeRows`) and the logits
#: probe (:func:`tp_logits_probe`) of the tp 2 engine against the
#: meshless one: relative L2 over the vocabulary at each row, at most
#: this; the swapped-shard control must miss it on both. The seeded
#: weights' last token dominates its own logit, so a served logprob
#: moves little even when half the heads are wrong (the control's stays
#: within TP_LOGPROB_TOL): the logits say more
TP_LOGITS_TOL = 3e-2
#: the probe: the first prompt's first chunk, then greedy decode steps
TP_PROBE_STEPS = 3
#: the control (each rank serving the other's wq shard) decodes this many
#: tokens of the first two prompts
TP_CONTROL_NEW = 4
#: the timed decode block of each rank: batch 8 of 64-token prompts
TP_TPUT_STEPS = 16


def tp_prompts(torch, V: int) -> list:
    """The serve phase's 8 prompts (:data:`SERVE_PLENS`, seed 17)."""
    gen = torch.Generator().manual_seed(17)
    return [torch.randint(1, V, (n,), generator=gen).tolist()
            for n in SERVE_PLENS]


def tp_logits_probe(torch, eng, prompt):
    """(1 + TP_PROBE_STEPS, vocab) fp32 logits on the host: one
    prefill chunk of ``prompt`` (its first ``prefill_len`` tokens) into a
    fresh one-row int8 cache through the engine's own model, weights and
    mesh, the chunk's last row, then greedy decode steps."""
    model, dev = eng.model, eng.device
    cache = model.init_cache(1, 256, quant=True, device=dev, mesh=eng.mesh)
    toks = torch.tensor([prompt[:eng.prefill_len]], device=dev)
    lens = torch.zeros(1, dtype=torch.int32, device=dev)
    out = []
    with torch.no_grad():
        for _ in range(1 + TP_PROBE_STEPS):
            logits, cache = model.apply_with_cache(eng.params, toks, cache,
                                                   lens, mesh=eng.mesh)
            out.append(logits[0, -1].float().cpu())
            lens = lens + toks.shape[1]
            toks = logits[:, -1].argmax(-1, keepdim=True)
    return torch.stack(out)


class DecodeRows:
    """The logits of every eager decode step (a (B, 1) target forward)
    an engine runs while it is open, on the host: each live slot's row,
    keyed by (its prompt's index in ``prompts``, its position), through a
    :class:`ForwardLog` tap. Rows of a slot whose prompt is not among
    ``prompts`` are not kept. :meth:`close` unwraps the engine."""

    def __init__(self, eng, prompts):
        index = {tuple(p): i for i, p in enumerate(prompts)}
        self.rows = {}

        def tap(tokens, lengths, logits):
            if tokens.shape[1] != 1:
                return
            lens = lengths.tolist()
            for s, req in eng.slots.items():
                i = index.get(tuple(req.prompt))
                if i is not None:
                    self.rows[(i, lens[s])] = logits[s, 0].float().cpu()

        self.log = ForwardLog(eng, tap=tap)

    def close(self) -> dict:
        """Unwrap the engine; the rows as ``{"keys": [[i, position],
        ...], "logits": (n, vocab)}``, which ``torch.save`` takes."""
        import torch

        self.log.close()
        keys = sorted(self.rows)
        return {"keys": [list(k) for k in keys],
                "logits": torch.stack([self.rows[k] for k in keys])}


def decode_err(torch, got: dict, want: dict, i: int, plen: int,
               agree: int) -> float:
    """The largest relative L2 error over the vocabulary of request
    ``i``'s decode-step logits in ``got`` against ``want`` (each as
    :meth:`DecodeRows.close` returns them) at the positions whose inputs
    agree: a decode step at position n reads the prompt (``plen``
    tokens) and the first n - plen + 1 generated tokens, so n < plen +
    ``agree``. inf where no such step is in both."""
    at = [{tuple(k): r for k, r in zip(d["keys"], d["logits"])}
          for d in (got, want)]
    errs = [rel_l2(at[0][(i, n)], at[1][(i, n)])
            for n in range(plen, plen + agree)
            if (i, n) in at[0] and (i, n) in at[1]]
    return max(errs) if errs else math.inf


def _tp_serve_http(torch, deng, args, prompts) -> dict:
    """Rank 0: the port server over the driver's engine on port 0, the
    serve phase's burst (:func:`http_burst`) with every decode step's
    logits kept (:class:`DecodeRows`); each completion's tokens and
    logprobs, the wall time, ``/v1/stats`` and the decode rows."""
    from instaslice_tpu_torch.serving import api_server

    rows = DecodeRows(deng.engine, prompts)
    srv = api_server.ApiServer(deng, host=args.host, port=args.port).start()
    try:
        wait_ready(srv.url)
        t0 = time.perf_counter()
        results, errors = http_burst(srv.url, prompts, SERVE_NEW)
        wall = time.perf_counter() - t0
        stats = http_json(srv.url + "/v1/stats")
    finally:
        srv.stop()
        decode = rows.close()
    check(not errors, f"tp_serve: {errors}")
    return {"results": [{k: r[k] for k in ("token_ids", "logprobs",
                                           "finish_reason")}
                        for r in results],
            "wall_s": wall, "mesh": stats["mesh"],
            "route": stats["engine"]["decode_graphs"]["route"],
            "tokens_generated": stats["tokens_generated"]}, decode


def _swap_wq_shards(torch, eng) -> None:
    """The control: each rank serves the other rank's block of ``wq``'s
    columns (both ranks gather the whole leaf over ``model``)."""
    from instaslice_tpu_torch.models.quant import QuantizedTensor
    from instaslice_tpu_torch.parallel import collectives as coll

    ax = eng._axes
    other = dataclasses.replace(ax, model=dataclasses.replace(
        ax.model, rank=1 - ax.model.rank))
    wq = eng.params["blocks"]["wq"]
    spec = (None, None, "model")
    eng.params["blocks"]["wq"] = QuantizedTensor(
        coll.shard_leaf(coll.all_gather(wq.q, ax.model, 2), spec, other),
        coll.shard_leaf(coll.all_gather(wq.s, ax.model, 2), spec, other))


def tp_serve_child(rank: int, world: int, init_method: str, out: str,
                   oplog_port: int) -> None:
    """One rank of the tp 2 server (spawned): the smoke starts gloo, then
    the port's own CLI wiring builds the engine (``build_parser`` +
    ``build_engine`` with ``--from-env``, which finds the group started
    and keeps it) and splits the ranks (``split_ranks``): rank 0 answers
    the 8 completions over HTTP through ``DistributedEngine`` and then
    drives ``run_script``; rank 1 replays the op stream. Launch counters
    are zeroed after the warm-ups and read when the op stream closes.
    Then, the same calls on both ranks: a timed decode block, and the
    control with the two ranks' ``wq`` shards swapped. Writes
    ``rank<r>.json``; rank 0 also ``probe.pt``: the logits probe's, the
    served decode steps' and the control's (:class:`DecodeRows`)."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(HERE))
    from instaslice_tpu_torch import ops
    from instaslice_tpu_torch.parallel import initialize_distributed
    from instaslice_tpu_torch.serving import api_server
    from instaslice_tpu_torch.serving.dcn_serve_smoke import (
        run_script,
        state_digest,
    )

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    out = Path(out)
    initialize_distributed(backend="gloo", init_method=init_method,
                           device="cuda:0")
    res = {"rank": rank}
    try:
        t0 = time.perf_counter()
        args = api_server.build_parser().parse_args(
            SERVE_FLAGS.split() + ["--from-env", "--oplog-port",
                                   str(oplog_port)])
        eng = api_server.build_engine(args)
        torch.cuda.synchronize()
        res["build_s"] = time.perf_counter() - t0
        res["build_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        res["weights_gib"] = tree_gib(eng.params)
        res["route"] = eng.decode_route()
        res["cache_heads"] = eng.cache["k"].shape[2]
        res["kv_heads"], res["n_layers"] = args.n_kv_heads, args.n_layers
        check(eng.mesh is not None and eng._axes.model.size == 2,
              f"tp_serve rank {rank}: a model axis of 2")
        with torch.no_grad():
            # replicated on every rank (see TP_LOGPROB_TOL)
            eng.params["ln_f"]["scale"].div_(math.sqrt(args.d_model))
        prompts = tp_prompts(torch, args.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        deng = api_server.split_ranks(eng, args)
        if deng is not None:
            check(rank == 0, "the driver is rank 0")
            try:
                res["http"], served_rows = _tp_serve_http(
                    torch, deng, args, prompts)
                run_script(deng)
            finally:
                deng.shutdown()
        torch.cuda.synchronize()
        res["counts"] = ops.launch_counts()
        res["serve_s"] = time.perf_counter() - t0
        res["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        res["digest"] = state_digest(eng)
        res["decode_steps"] = eng.decode_steps
        # the same calls on both ranks from here
        for s in list(eng.slots):
            eng.evict_slot(s)
        eng.finished.clear()
        short = [p[:64] for p in prompts]
        for p in short:
            eng.add_request(p)
        eng.decode_block(2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.decode_block(TP_TPUT_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        res["decode_ms_per_step"] = wall / TP_TPUT_STEPS * 1e3
        res["decode_tok_s"] = len(short) * TP_TPUT_STEPS / wall
        for s in list(eng.slots):
            eng.evict_slot(s)
        eng.finished.clear()
        probe = tp_logits_probe(torch, eng, prompts[0])
        _swap_wq_shards(torch, eng)
        rows = DecodeRows(eng, prompts)
        ctl = eng.generate(prompts[:2], TP_CONTROL_NEW)
        ctl_rows = rows.close()
        res["control"] = [{"token_ids": r.tokens} for r in ctl]
        ctl_probe = tp_logits_probe(torch, eng, prompts[0])
        if rank == 0:
            torch.save({"probe": probe, "control": ctl_probe,
                        "served_rows": served_rows,
                        "control_rows": ctl_rows}, out / "probe.pt")
    finally:
        (out / f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def agreeing_prefix(got: list, want: list) -> int:
    n = 0
    while n < min(len(got), len(want)) and got[n] == want[n]:
        n += 1
    return n


def logprob_err(got: dict, want) -> float:
    """The largest logprob difference over the tokens where ``got`` and
    ``want`` (a ``GenerationResult``) agree; inf where the first token
    already differs."""
    n = agreeing_prefix(got["token_ids"], want.tokens)
    if n == 0:
        return math.inf
    return max(abs(a - b) for a, b in zip(got["logprobs"][:n],
                                          want.logprobs[:n]))


def tp_shard_kernels(torch, ops, cfg, qp) -> dict:
    """B1-B3 against their plain versions at the shapes the tp 2 server
    gives them, as :func:`phase_kernels` holds the meshless shapes: rank
    0's leaves of the 7B int8 weights (``shard_params`` at a model axis of
    2; rank 1's have the same shapes), B2 on the six projections and B3
    on the 16000-row embedding at M = 1 ... 256 within QMM_TOL, B1 at
    the rank's 16 query and 4 KV heads at :data:`B1_SHAPES` within its
    1e-5 bounds, each timed. Returns each kernel's worst errors and
    detail."""
    from instaslice_tpu_torch.models.lm import param_specs
    from instaslice_tpu_torch.models.quant import shard_params
    from instaslice_tpu_torch.parallel.collectives import Axis, MeshAxes

    fd, qm = ops.flash_decode, ops.quant_matmul
    shards = shard_params(qp, param_specs(cfg),
                          MeshAxes(model=Axis(None, 2, 0)))
    gen = torch.Generator(device="cuda").manual_seed(13)
    xs = (torch.bfloat16, torch.float32)
    tag = "tp_serve rank 0 shards: "
    out = {}
    for name, detail in (
            ("quant_matmul_stacked",
             [b2_case(torch, qm, shards["blocks"][p], p, M, gen, xs, tag)
              for M in QMM_MS for p in BIG]),
            ("quant_matmul_t",
             [b3_case(torch, qm, shards["embed"], M, gen, xs, tag)
              for M in QMM_MS])):
        errs = {}
        for d in detail:
            worse(errs, d)
        out[name] = {"max_abs_err": errs["max_abs"],
                     "rel_l2_err": errs["rel_l2"],
                     "tile_rel_l2_err": errs["tile_rel_l2"],
                     "detail": detail}
    log_six(tag, out["quant_matmul_stacked"]["detail"], QMM_MS)
    del shards
    rank_cfg = dataclasses.replace(
        cfg, d_model=cfg.d_model // 2, n_heads=cfg.n_heads // 2,
        n_kv_heads=cfg.kv_heads // 2)
    detail, e_max = b1_cases(torch, rank_cfg, fd, gen, B1_S, B1_SHAPES, tag)
    out["quant_decode_attention"] = {"max_abs_err": e_max, "detail": detail}
    return out


def tp_one_rank(torch, ops, cfg, prompts) -> dict:
    """(1) A mesh of one rank on NCCL around the 7B int8 engine against the
    meshless engine over the same weights (the final norm's scale divided
    by 64): greedy tokens and logprobs bit-equal on the graph route, and
    each one's decode tok/s (batch 8 of 64-token prompts, in turns). The
    meshless results, and its eager twin's decode-step logits on the same
    prompts (:class:`DecodeRows`), are the reference of the two-process
    run. First, B1-B3 at the tp 2 ranks' shapes
    (:func:`tp_shard_kernels`)."""
    import socket

    import torch.distributed as dist

    from instaslice_tpu_torch.models.lm import TpuLM, init_params
    from instaslice_tpu_torch.models.quant import quantize_params
    from instaslice_tpu_torch.parallel import (
        initialize_distributed,
        slice_mesh,
    )
    from instaslice_tpu_torch.serving import ServingEngine

    qp = quantize_params(init_params(cfg, 0, device="cuda"))
    shard_kernels = tp_shard_kernels(torch, ops, cfg, qp)
    qp["ln_f"]["scale"] = qp["ln_f"]["scale"] / math.sqrt(cfg.d_model)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_distributed(backend="nccl",
                           init_method=f"tcp://127.0.0.1:{port}",
                           device="cuda")
    try:
        mesh = slice_mesh(axes=("data", "seq", "model"),
                          axis_sizes=(1, 1, -1), device="cuda")
        opts = dict(max_batch=8, max_len=1024, prefill_len=128,
                    kv_quant=True, device="cuda")
        engs = {"meshless": ServingEngine(TpuLM(cfg), qp, **opts),
                "mesh": ServingEngine(TpuLM(cfg), qp, mesh=mesh, **opts)}
        out = {"backend": dist.get_backend(),
               "mesh_shape": list(mesh.shape)}
        for name, eng in engs.items():
            check(eng.decode_route() == "cuda graphs",
                  f"tp_serve {name}: the graph route")
            eng.warm_prefill_buckets()
            out[name] = {"results": eng.generate(prompts, SERVE_NEW),
                         "probe": tp_logits_probe(torch, eng, prompts[0])}
        twin = eager_twin(engs["meshless"])
        rows = DecodeRows(twin, prompts)
        out["decode_tokens"] = [r.tokens for r in
                                twin.generate(prompts, SERVE_NEW)]
        out["decode_rows"] = rows.close()
        del twin
        a, b = out["meshless"]["results"], out["mesh"]["results"]
        same = ([r.tokens for r in a] == [r.tokens for r in b]
                and [r.logprobs for r in a] == [r.logprobs for r in b]
                and torch.equal(out["meshless"]["probe"],
                                out["mesh"]["probe"]))
        short = [p[:64] for p in prompts]
        for name in ("meshless", "mesh", "mesh", "meshless"):
            eng = engs[name]
            for p in short:
                eng.add_request(p)
            eng.decode_block(2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.decode_block(TP_TPUT_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out[name].setdefault("tok_s", []).append(
                len(short) * TP_TPUT_STEPS / wall)
            for s in list(eng.slots):
                eng.evict_slot(s)
            eng.finished.clear()
        del engs, eng, qp
        free_memory(torch)
    finally:
        dist.destroy_process_group()
    log(f"tp_serve one rank (NCCL, mesh {out['mesh_shape']}): tokens, "
        f"logprobs and probe logits bit-equal to meshless {same}; decode "
        f"tok/s mesh "
        f"{out['mesh']['tok_s']} vs meshless {out['meshless']['tok_s']}")
    check(same, "tp_serve: a mesh of one rank is bit-equal to meshless")
    out["bit_equal"] = same
    out["shard_kernels"] = shard_kernels
    return out


def tp_two_process(torch, one: dict, prompts) -> dict:
    """(2) Two spawned processes on the one card over gloo on CUDA tensors,
    each a rank of the 7B int8 server at tp 2 (:func:`tp_serve_child`):
    the completions and the logits of every served decode step (batch 8)
    against the meshless engine's (``one``, from :func:`tp_one_rank`),
    the follower's digest against the driver's, B1-B3 launched on both
    ranks, the swapped-shard control missing the logits bounds."""
    import multiprocessing as mp
    import shutil
    import socket

    out = HERE / "build" / "tp_serve"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=tp_serve_child, args=(
        r, 2, f"tcp://127.0.0.1:{ports[0]}", str(out), ports[1]))
        for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             if (out / f"rank{r}.json").exists() else {} for r in range(2)]
    probes = (torch.load(out / "probe.pt") if (out / "probe.pt").exists()
              else None)
    shutil.rmtree(out)
    check(codes == [0, 0], f"tp_serve children exit codes {codes}")
    r0, r1 = ranks
    http = r0["http"]
    ref, ref_probe = one["meshless"]["results"], one["meshless"]["probe"]
    check(http["mesh"] == {"data": 1, "seq": 1, "model": 2},
          f"tp_serve: /v1/stats mesh {http['mesh']}")
    check(http["route"].startswith("eager (tensor parallel"),
          f"tp_serve: route {http['route']}")
    errs, greedy = [], []
    for i, (got, want) in enumerate(zip(http["results"], ref)):
        toks = got["token_ids"]
        check(len(toks) == SERVE_NEW and got["finish_reason"]
              == "max_new_tokens", f"tp_serve request {i}: {len(toks)} "
              f"tokens, {got['finish_reason']}")
        greedy.append(agreeing_prefix(toks, want.tokens))
        errs.append(logprob_err(got, want))
    served, served_ctl = (
        [decode_err(torch, probes[key], one["decode_rows"], i,
                    len(prompts[i]), agreeing_prefix(
                        got["token_ids"], one["decode_tokens"][i]))
         for i, got in enumerate(results)]
        for key, results in (("served_rows", http["results"]),
                             ("control_rows", r0["control"])))
    probe_err = [rel_l2(g, w) for g, w in zip(probes["probe"], ref_probe)]
    probe_ctl = [rel_l2(g, w) for g, w in zip(probes["control"], ref_probe)]
    dig0, dig1 = r0["digest"], r1["digest"]
    c0, c1 = r0["counts"], r1["counts"]
    log(f"tp_serve two processes (gloo): greedy prefix agreeing with "
        f"meshless {greedy}, logprob err over it {errs} (tol "
        f"{TP_LOGPROB_TOL}); served decode steps' logits rel L2 "
        f"{served}, control (swapped wq) {served_ctl}; probe "
        f"logits rel L2 {probe_err}, control {probe_ctl} (tol "
        f"{TP_LOGITS_TOL}); launches rank 0 "
        f"{c0}, rank 1 {c1}; follower digest equal "
        f"{dict(dig1, finished=[]) == dict(dig0, finished=[])}; decode ms "
        f"a step {[r['decode_ms_per_step'] for r in ranks]}, tok/s "
        f"{[r['decode_tok_s'] for r in ranks]}; peak GiB build "
        f"{[r['build_peak_gib'] for r in ranks]}, serving "
        f"{[r['serve_peak_gib'] for r in ranks]}; weights GiB "
        f"{[r['weights_gib'] for r in ranks]}; HTTP {http['wall_s']:.2f} s")
    check(all(n >= TP_GREEDY for n in greedy),
          f"tp_serve: the first {TP_GREEDY} greedy tokens equal meshless")
    check(max(errs) <= TP_LOGPROB_TOL, f"tp_serve: logprobs within "
          f"{TP_LOGPROB_TOL} of meshless")
    check(max(served) <= TP_LOGITS_TOL, f"tp_serve: the served decode "
          f"steps' logits within {TP_LOGITS_TOL} of meshless")
    check(max(probe_err) <= TP_LOGITS_TOL, f"tp_serve: probe logits "
          f"within {TP_LOGITS_TOL} of meshless")
    check(min(served_ctl) > TP_LOGITS_TOL and min(probe_ctl)
          > TP_LOGITS_TOL, "tp_serve: the swapped-wq control misses the "
          "logits bound, decode steps and probe")
    check(dict(dig1, finished=[]) == dict(dig0, finished=[])
          and dig0["live"], "tp_serve: the follower's digest is the "
          "driver's")
    for r, c in ((0, c0), (1, c1)):
        for k in ("quant_decode_attention", "quant_matmul_stacked",
                  "quant_matmul_t"):
            check(c[k] > 0, f"tp_serve rank {r}: {k} launched")
        check(c["quant_matmul"] == 0 and all(c[k] == 0 for k in FLASH),
              f"tp_serve rank {r}: B4-B7 are not on this path")
    check(c0 == c1, "tp_serve: both ranks launch the same kernels")
    check(c0["quant_decode_attention"]
          == r0["n_layers"] * r0["decode_steps"] > 0,
          "tp_serve: B1 once a layer a decode step")
    for r in ranks:
        check(r["cache_heads"] == r["kv_heads"] // 2 and r["route"]
              .startswith("eager (tensor parallel"),
              "tp_serve: half the KV heads a rank, eager")
    return {"ranks": [{k: r[k] for k in (
        "build_s", "serve_s", "build_peak_gib", "serve_peak_gib",
        "weights_gib", "decode_ms_per_step", "decode_tok_s", "counts",
        "decode_steps")} for r in ranks],
        "greedy_prefix": greedy, "logprob_err": errs,
        "tol": TP_LOGPROB_TOL, "decode_rel_l2": served,
        "decode_control_rel_l2": served_ctl, "probe_rel_l2": probe_err,
        "probe_control_rel_l2": probe_ctl, "probe_tol": TP_LOGITS_TOL,
        "http_wall_s": http["wall_s"],
        "mesh": http["mesh"], "route": http["route"]}


def phase_tp_serve(torch, ops, cfg) -> dict:
    """Tensor-parallel serving with the driver/follower op stream: B1-B3
    at a tp 2 rank's shard shapes (:func:`tp_shard_kernels`), (1) a
    mesh of one rank on NCCL around the 7B int8 engine, bit-equal to the
    meshless engine on the graph route (:func:`tp_one_rank`); then, its
    7B freed, (2) the 7B int8 server at tp 2 as two processes sharing the
    card over gloo, full width and depth (:func:`tp_two_process`). No
    scaling number: one card, and gloo stages every collective through
    host memory."""
    # the training phases leave TF32 on; the plain versions of B1-B3 are
    # fp32 products, held to 2e-5 of the kernels' as in phase_kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    prompts = tp_prompts(torch, cfg.vocab_size)
    t0 = time.perf_counter()
    one = tp_one_rank(torch, ops, cfg, prompts)
    t1 = time.perf_counter()
    free_memory(torch)
    two = tp_two_process(torch, one, prompts)
    out = {"shard_kernels": one.pop("shard_kernels"),
           "one_rank": {"bit_equal": one["bit_equal"],
                        "backend": one["backend"],
                        "tok_s": {k: one[k]["tok_s"]
                                  for k in ("meshless", "mesh")}},
           "two_process": two,
           "seconds": {"one_rank": t1 - t0,
                       "two_process": time.perf_counter() - t1}}
    log(f"tp_serve: seconds by part {out['seconds']}")
    return out


# ------------------------------------------------------------ parallel_rest

#: the parallel_rest phase's training runs: the 871M widths at this depth
#: (4 until the ctl phase came, cut to pay for it: the fewest layers GPipe
#: at pipe 2 can split), a (REST_B, REST_S) batch of seed 17, 3 AdamW
#: steps at lr 3e-4, clip 1.0
REST_LAYERS = 2
REST_B, REST_S = 8, 1024
#: GPipe at pipe 2 against the one-process step on the same weights (bf16
#: over fp32 masters): the dense tp 2 bound of the parallel phase
#: (PAR_TOL), whose in-bound readings there were ~10x below it
REST_TOL = PAR_TOL
#: MoE at tp 2 (experts over model) against the one-process step, both in
#: float32 with TF32 off: top-2 routing is discontinuous, and in bf16 the
#: two summation orders flipped enough choices to read loss 3.4e-3 and
#: params 8.2e-3 (the router) on the H100, the noise of the rounding, not
#: of the code. In float32 the orders differ by ~1e-6; the
#: bound leaves room for a few flipped choices (one moves the ~1400-wide
#: loss of one token of 8192, ~6e-5 of the loss). The control hands each
#: rank the other rank's experts (``w_in`` and ``w_out``) and must miss it
REST_MOE_TOL = {"loss": 5e-4, "params": 5e-3}
#: GPipe's micro-batches (pipe 2: ticks M + P - 1 = 5 a step)
REST_MICRO = 4
#: new tokens of the MoE int8 engine's 8 prompts at tp 2
REST_MOE_NEW = 16
#: ring attention through the training CLI: the 871M widths at
#: REST_LAYERS layers, rows of 2048 tokens, 2 rows, 2 steps; the
#: two-rank run (--sp 2, gloo, both ranks on the card) against the same
#: flags in one process, whose attention is B5-B7 and not the ring: the
#: losses within REST_TOL["loss"]. Rows of 1024 took as long on the H100
#: (33.5 s against 30.9: the three processes' start is the part's time)
REST_RING_FLAGS = ("--synthetic 200000 --seq-len 2047 --global-batch 2 "
                   f"--steps 2 --n-layers {REST_LAYERS} --log-every 1 "
                   "--ring")


def rest_tokens(torch, cfg, dev):
    gen = torch.Generator(device=dev).manual_seed(17)
    return torch.randint(0, cfg.vocab_size, (REST_B, REST_S), generator=gen,
                         device=dev)


def rest_moe_prompts(torch, V: int) -> list:
    """The MoE engine phase's 8 prompt lengths (seed 11)."""
    gen = torch.Generator().manual_seed(11)
    return [torch.randint(1, V, (n,), generator=gen).tolist()
            for n in (300, 200, 129, 100, 64, 33, 17, 5)]


def rest_moe_engine_cfg(torch):
    return moe_config(torch, n_layers=REST_LAYERS, param_dtype=None,
                      remat=False)


def rest_moe_train_cfg(torch):
    """(a)'s configuration: the MoE training widths at REST_LAYERS layers
    in float32 (see REST_MOE_TOL)."""
    return moe_config(torch, n_layers=REST_LAYERS, dtype=torch.float32,
                      param_dtype=None)


def rest_references(torch, out: Path) -> dict:
    """The one-process references of the two-process runs, on the card:
    the MoE step (float32, TF32 off) and the dense step (bf16, TF32 on, as
    the training CLI runs it); each 3 steps from seed 0, losses and final
    params saved to ``out``; and the MoE int8 engine's greedy tokens
    (eager, meshless, TF32 off)."""
    from instaslice_tpu_torch.models.lm import TpuLM, init_params
    from instaslice_tpu_torch.models.quant import quantize_params
    from instaslice_tpu_torch.models.train import (
        leaf_paths,
        leaves,
        make_train_step,
    )
    from instaslice_tpu_torch.serving import ServingEngine

    refs = {}
    for name, cfg, tf32 in (
            ("moe", rest_moe_train_cfg(torch), False),
            ("dense", train_config(torch, n_layers=REST_LAYERS), True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        init_fn, step_fn = make_train_step(TpuLM(cfg), learning_rate=3e-4,
                                           grad_clip=1.0, device="cuda")
        state = init_fn(0)
        tokens = rest_tokens(torch, cfg, "cuda")
        losses = []
        for _ in range(3):
            state, loss = step_fn(state, tokens)
            losses.append(float(loss))
        torch.save({"losses": losses, "params": {
            p: t.detach().cpu() for p, t in zip(leaf_paths(state.params),
                                                leaves(state.params))}},
            out / f"{name}_ref.pt")
        refs[name] = losses
        del state, init_fn, step_fn
        free_memory(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = rest_moe_engine_cfg(torch)
    eng = ServingEngine(TpuLM(cfg), quantize_params(init_params(
        cfg, 0, device="cuda")), max_batch=8, max_len=1024, prefill_len=128,
                        kv_quant=True, device="cuda", decode_graphs=False)
    res = eng.generate(rest_moe_prompts(torch, cfg.vocab_size),
                       max_new_tokens=REST_MOE_NEW, block_size=16)
    refs["moe_engine_tokens"] = [r.tokens for r in res]
    del eng
    free_memory(torch)
    return refs


def rest_train(torch, ops, cfg, mesh, rank: int, ref, tf32: bool,
               swap=(), **opts) -> dict:
    """One two-process training run (3 steps from seed 0 on the batch
    of :func:`rest_tokens`, TF32 as its reference ran), its launches from
    the card's trace; rank 0 holds the gathered params against the
    reference's."""
    from instaslice_tpu_torch.models.lm import TpuLM
    from instaslice_tpu_torch.models.train import (
        full_params,
        leaf_paths,
        leaves,
        make_train_step,
    )

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    init_fn, step_fn = make_train_step(TpuLM(cfg), mesh=mesh,
                                       learning_rate=3e-4, grad_clip=1.0,
                                       device="cuda:0", **opts)
    state = init_fn(0)
    for path in swap:
        _swap_model_shards(torch, state, path)
    tokens = rest_tokens(torch, cfg, "cuda:0")
    losses = []
    ops.reset_launch_counts()
    with Traced(torch, ops) as tr:
        for _ in range(3):
            state, loss = step_fn(state, tokens)
            losses.append(float(loss))
    full = full_params(state)
    r = {"losses": losses, "counts": tr.counts,
         "wrapper_counts": ops.launch_counts(),
         "seconds": time.perf_counter() - t0}
    if rank == 0:
        r["loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in
                                zip(losses, ref["losses"]))
        r["params_rel_l2"] = {
            p: rel_l2(t.detach().float().cpu(), ref["params"][p].float())
            for p, t in zip(leaf_paths(full), leaves(full))}
    del state, full, init_fn, step_fn
    free_memory(torch)
    return r


def rest_moe_engine(torch, ops, mesh) -> dict:
    """(b) The MoE int8 engine at tp 2 (each rank 4 of the 8 experts, 8
    query heads, half the vocabulary), eager: 8 prompts to
    :data:`REST_MOE_NEW` tokens through ``generate``, launches from the
    card's trace."""
    from instaslice_tpu_torch.models.lm import TpuLM, init_params
    from instaslice_tpu_torch.models.quant import quantize_params
    from instaslice_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    cfg = rest_moe_engine_cfg(torch)
    eng = ServingEngine(TpuLM(cfg), quantize_params(init_params(
        cfg, 0, device="cuda:0")), mesh=mesh, max_batch=8, max_len=1024,
        prefill_len=128, kv_quant=True, device="cuda:0")
    free_memory(torch)
    prompts = rest_moe_prompts(torch, cfg.vocab_size)
    eng.decode_steps = eng.prefill_dispatches = 0
    with Traced(torch, ops, kn="quant_matmul") as tr:
        res = eng.generate(prompts, max_new_tokens=REST_MOE_NEW,
                           block_size=16)
    out = {"tokens": [r.tokens for r in res], "counts": tr.counts,
           "decode_steps": eng.decode_steps,
           "prefill_chunks": eng.prefill_dispatches,
           "experts_a_rank": eng.params["blocks"]["w_in"].q.shape[1],
           "route": eng.decode_route(), "seconds": time.perf_counter() - t0}
    del eng
    free_memory(torch)
    return out


def rest_child(rank: int, world: int, init_method: str, out: str) -> None:
    """One rank of the parallel_rest training and MoE-engine runs
    (spawned; gloo on CUDA tensors): (a) the MoE at tp 2 and its
    swapped-experts control, (b) the MoE int8 engine at tp 2, (e) GPipe
    at pipe 2. Writes ``rank<r>.json``."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(HERE))
    from instaslice_tpu_torch import ops
    from instaslice_tpu_torch.parallel import (
        initialize_distributed,
        slice_mesh,
    )

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    out = Path(out)
    initialize_distributed(backend="gloo", init_method=init_method,
                           device="cuda:0")
    res = {}
    try:
        def ref(name):
            return (torch.load(out / f"{name}_ref.pt", mmap=True,
                               weights_only=True) if rank == 0 else None)

        tp2 = slice_mesh(axis_sizes=(-1, 1, 2), device="cuda")
        moe = rest_moe_train_cfg(torch)
        res["moe_tp2"] = rest_train(torch, ops, moe, tp2, rank, ref("moe"),
                                    False)
        res["moe_tp2_swapped_experts"] = rest_train(
            torch, ops, moe, tp2, rank, ref("moe"), False,
            swap=("blocks/w_in", "blocks/w_out"))
        torch.backends.cuda.matmul.allow_tf32 = False
        res["moe_engine_tp2"] = rest_moe_engine(torch, ops, tp2)
        pipe = slice_mesh(("pipe", "data", "model"), (2, 1, 1),
                          device="cuda")
        res["gpipe"] = rest_train(
            torch, ops, train_config(torch, n_layers=REST_LAYERS), pipe,
            rank, ref("dense"), True, n_micro=REST_MICRO)
    finally:
        (out / f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def rest_spawn(target, out: Path, *args) -> list:
    """Two spawned ranks of ``target(rank, 2, init_method, out, *args)``;
    their ``rank<r>.json``."""
    import multiprocessing as mp
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(
        r, 2, f"tcp://127.0.0.1:{port}", str(out)) + args) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             if (out / f"rank{r}.json").exists() else {} for r in range(2)]
    check(codes == [0, 0], f"{target.__name__} exit codes {codes}")
    return ranks


def rest_check_train(name: str, ranks: list, control: bool,
                     want: dict, tol: dict) -> dict:
    """A two-process run against its reference (``tol``) and its launches
    per rank against ``want`` (wrapper name -> count)."""
    r0 = ranks[0][name]
    worst = max(r0["params_rel_l2"].values())
    counts = [rk[name]["counts"] for rk in ranks]
    log(f"parallel_rest {name}: losses {r0['losses']}, loss rel err "
        f"{r0['loss_rel_err']:.2e}, params rel L2 worst {worst:.2e} "
        f"({max(r0['params_rel_l2'], key=r0['params_rel_l2'].get)}); "
        f"launches per rank (trace) {[{k: c[k] for k in FLASH} for c in counts]}"
        f"; {r0['seconds']:.1f} s")
    within = r0["loss_rel_err"] <= tol["loss"] and worst <= tol["params"]
    if control:
        check(not within, f"parallel_rest {name}: the control misses {tol}")
    else:
        check(within, f"parallel_rest {name}: within {tol}")
    for r, rk in enumerate(ranks):
        c = rk[name]
        check(c["counts"] == c["wrapper_counts"],
              f"parallel_rest {name} rank {r}: the trace counts what the "
              f"wrappers launched")
        for k, n in want.items():
            check(c["counts"][k] == n, f"parallel_rest {name} rank {r}: "
                  f"{k} {c['counts'][k]} = {n}")
    return {"losses": r0["losses"], "loss_rel_err": r0["loss_rel_err"],
            "params_rel_l2_worst": worst, "counts": counts,
            "seconds": r0["seconds"]}


def rest_two_process(torch) -> dict:
    """(a), (b) and (e): the references on the card, then two spawned
    ranks (:func:`rest_child`)."""
    import shutil

    out = HERE / "build" / "parallel_rest"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    refs = rest_references(torch, out)
    t_ref = time.perf_counter() - t0
    free_memory(torch)
    ranks = rest_spawn(rest_child, out)
    shutil.rmtree(out)          # the references' params
    L, steps = REST_LAYERS, 3
    res = {"reference_s": t_ref}
    # (a) remat "dots": B5 twice a layer (the recompute), B6/B7 once
    moe_want = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
                "flash_bwd_dkv": L * steps}
    res["moe_tp2"] = rest_check_train("moe_tp2", ranks, False, moe_want,
                                      REST_MOE_TOL)
    res["moe_tp2_swapped_experts"] = rest_check_train(
        "moe_tp2_swapped_experts", ranks, True, moe_want, REST_MOE_TOL)
    # (e) each stage runs its L / 2 layers on every one of M + P - 1 ticks
    ticks = REST_MICRO + 1
    res["gpipe"] = rest_check_train("gpipe", ranks, False, {
        k: L // 2 * ticks * steps for k in FLASH}, REST_TOL)
    # (b)
    e0, e1 = ranks[0]["moe_engine_tp2"], ranks[1]["moe_engine_tp2"]
    want = refs["moe_engine_tokens"]
    greedy = [agreeing_prefix(g, w) for g, w in zip(e0["tokens"], want)]
    forwards = e0["decode_steps"] + e0["prefill_chunks"]
    log(f"parallel_rest moe_engine_tp2: {e0['experts_a_rank']} experts a "
        f"rank, route {e0['route']}; greedy prefix agreeing with meshless "
        f"{greedy} of {REST_MOE_NEW}; {forwards} forwards; launches per "
        f"rank (trace) {[e['counts'] for e in (e0, e1)]}; "
        f"{e0['seconds']:.1f} s")
    check(e0["tokens"] == e1["tokens"], "parallel_rest moe engine: both "
          "ranks sample the same tokens")
    check(all(n >= TP_GREEDY for n in greedy), f"parallel_rest moe engine: "
          f"the first {TP_GREEDY} greedy tokens equal meshless")
    check(e0["experts_a_rank"] == 4, "parallel_rest moe engine: 4 experts "
          "a rank")
    for r, e in enumerate((e0, e1)):
        c = e["counts"]
        check(c["quant_matmul"] == 4 * L * forwards > 0,
              f"parallel_rest moe engine rank {r}: B4 = 4 x layers x "
              "forwards")
        check(c["quant_matmul_t"] == forwards, f"parallel_rest moe engine "
              f"rank {r}: B3 once a forward")
        check(c["quant_matmul_stacked"] == 0
              and c["quant_decode_attention"] == 0
              and all(c[k] == 0 for k in FLASH),
              f"parallel_rest moe engine rank {r}: B1, B2, B5-B7 none")
    res["moe_engine_tp2"] = {"greedy_prefix": greedy,
                             "counts": [e0["counts"], e1["counts"]],
                             "forwards": forwards,
                             "seconds": e0["seconds"]}
    return res


def rest_lora_child(rank: int, world: int, init_method: str, out: str,
                    oplog_port: int, dirs: list) -> None:
    """One rank of the 7B int8 server at tp 2 with 4 stacked adapters
    (spawned): the port's own CLI wiring with ``--from-env`` and ``--lora``
    x 4, then ``split_ranks``; rank 0 answers the lora phase's 8
    completions (adapters i % 5) over HTTP, rank 1 follows. Launches from
    the card's trace of each rank's serving. Writes ``rank<r>.json``."""
    import os
    import threading

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(HERE))
    from instaslice_tpu_torch import ops
    from instaslice_tpu_torch.parallel import initialize_distributed
    from instaslice_tpu_torch.serving import api_server

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    out = Path(out)
    initialize_distributed(backend="gloo", init_method=init_method,
                           device="cuda:0")
    res = {"rank": rank}
    try:
        t0 = time.perf_counter()
        flags = SERVE_FLAGS.split() + ["--from-env", "--oplog-port",
                                       str(oplog_port)]
        for d in dirs:
            flags += ["--lora", d]
        args = api_server.build_parser().parse_args(flags)
        eng = api_server.build_engine(args)
        res["build_s"] = time.perf_counter() - t0
        check(eng.n_adapters == LORA_N and eng._axes.model.size == 2,
              f"parallel_rest lora rank {rank}: 4 adapters at tp 2")
        res["route"] = eng.decode_route()
        gen = torch.Generator().manual_seed(31)
        prompts = [torch.randint(1, args.vocab_size, (n,), generator=gen)
                   .tolist() for n in LORA_PLENS]
        adapters = [i % (LORA_N + 1) for i in range(len(prompts))]
        names = [Path(d).name for d in dirs]
        results, errors = [None] * len(prompts), []
        g0, f0 = eng.gathered_rounds, eng.fastpath_rounds
        # the warm-ups in build_engine launched kernels too
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with Traced(torch, ops) as tr:
            deng = api_server.split_ranks(eng, args)
            if deng is not None:
                srv = api_server.ApiServer(deng, host=args.host,
                                           port=args.port).start()
                try:
                    wait_ready(srv.url)

                    def one(i):
                        body = {"prompt": prompts[i], "max_tokens": LORA_NEW,
                                "temperature": 0.0, "logprobs": True}
                        if adapters[i]:
                            body["adapter"] = names[adapters[i] - 1]
                        try:
                            results[i] = http_json(
                                srv.url + "/v1/completions", body)[
                                "choices"][0]
                        except Exception as e:  # noqa: BLE001
                            errors.append(f"request {i}: {e!r}")

                    threads = [threading.Thread(target=one, args=(i,))
                               for i in range(len(prompts))]
                    for th in threads:
                        th.start()
                    for th in threads:
                        th.join()
                    res["mesh"] = http_json(srv.url + "/v1/stats")["mesh"]
                finally:
                    srv.stop()
                    deng.shutdown()
        res["serve_s"] = time.perf_counter() - t0
        check(not errors, f"parallel_rest lora: {errors}")
        res["counts"] = tr.counts
        res["wrapper_counts"] = ops.launch_counts()
        res["decode_steps"] = eng.decode_steps
        res["rounds"] = [eng.gathered_rounds - g0, eng.fastpath_rounds - f0]
        res["n_layers"] = args.n_layers
        if rank == 0:
            res["served"] = [{k: r[k] for k in ("token_ids", "logprobs")}
                             for r in results]
    finally:
        (out / f"rank{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


def rest_lora_serve(torch, meshless: list) -> dict:
    """(c) The 7B int8 server at tp 2 with 4 stacked adapters: its served
    tokens against the meshless adapter server's (the lora phase's
    ``served``, the same weights, adapters, prompts and flags), B1-B3 on
    both ranks."""
    import shutil
    import socket

    from instaslice_tpu_torch.models.lm import ModelConfig
    from instaslice_tpu_torch.serving import api_server

    out = HERE / "build" / "parallel_rest_lora"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    a = api_server.build_parser().parse_args(SERVE_FLAGS.split())
    cfg = ModelConfig(vocab_size=a.vocab_size, d_model=a.d_model,
                      n_heads=a.n_heads, n_kv_heads=a.n_kv_heads,
                      n_layers=a.n_layers, d_ff=a.d_ff,
                      max_seq_len=a.max_len, dtype=torch.bfloat16,
                      remat=False)
    dirs = [str(d) for d in lora_adapter_dirs(torch, cfg, out / "adapters")]
    free_memory(torch)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        oplog = s.getsockname()[1]
    ranks = rest_spawn(rest_lora_child, out, oplog, dirs)
    shutil.rmtree(out)
    r0, r1 = ranks
    greedy = [agreeing_prefix(g["token_ids"], w["token_ids"])
              for g, w in zip(r0["served"], meshless)]
    errs = [max([abs(x - y) for x, y in zip(
        g["logprobs"][:n], w["logprobs"][:n])] or [0.0])
        for g, w, n in zip(r0["served"], meshless, greedy)]
    c0, c1 = r0["counts"], r1["counts"]
    L, steps = r0["n_layers"], r0["decode_steps"]
    log(f"parallel_rest lora_serve_tp2: mesh {r0['mesh']}, route "
        f"{r0['route']}; greedy prefix agreeing with the meshless adapter "
        f"server {greedy} of {LORA_NEW}, logprob err over it {errs}; "
        f"gathered and single-adapter rounds {r0['rounds']}; {steps} "
        f"decode steps; launches (trace) rank 0 {c0}, rank 1 {c1}; build "
        f"{[r['build_s'] for r in ranks]} s, serve "
        f"{[r['serve_s'] for r in ranks]} s")
    check(r0["mesh"] == {"data": 1, "seq": 1, "model": 2},
          f"parallel_rest lora: mesh {r0['mesh']}")
    check(all(n >= TP_GREEDY for n in greedy), f"parallel_rest lora: the "
          f"first {TP_GREEDY} greedy tokens equal the meshless server's")
    check(max(errs) <= TP_LOGPROB_TOL, f"parallel_rest lora: logprobs "
          f"within {TP_LOGPROB_TOL}")
    check(c0 == c1, "parallel_rest lora: both ranks launch the same kernels")
    for r, rk in enumerate(ranks):
        c = rk["counts"]
        check(c == rk["wrapper_counts"], f"parallel_rest lora rank {r}: the "
              "trace counts what the wrappers launched (eager route)")
        check(c["quant_decode_attention"] == L * steps > 0,
              f"parallel_rest lora rank {r}: B1 once a layer a decode step")
        check(c["quant_matmul_stacked"] > 0 and c["quant_matmul_t"] > 0,
              f"parallel_rest lora rank {r}: B2 and B3 launched")
        check(c["quant_matmul"] == 0 and all(c[k] == 0 for k in FLASH),
              f"parallel_rest lora rank {r}: B4-B7 are not on this path")
    check(r0["rounds"][0] > 0, "parallel_rest lora: mixed adapters take the "
          "gathered path")
    return {"greedy_prefix": greedy, "logprob_err": errs,
            "counts": [c0, c1], "decode_steps": steps,
            "rounds": r0["rounds"], "build_s": [r["build_s"] for r in ranks],
            "serve_s": [r["serve_s"] for r in ranks]}


def rest_ring_cli(torch) -> dict:
    """(d) Ring attention through the training CLI: ``--ring --sp 2``
    under ``torch.distributed.run`` (two ranks on the one card: the CLI
    puts them in a gloo group) and the same flags in one process at once; the losses (the JSON lines' unrounded
    ``losses``) within ``REST_TOL["loss"]``. The ring is plain PyTorch
    (no TPU kernel computes it), so the two-rank run launches none of
    B5-B7; the one-process run's attention is B5-B7."""
    import os

    flags = REST_RING_FLAGS.split()
    env = dict(os.environ, OMP_NUM_THREADS="4")
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    mod = ["-m", "instaslice_tpu_torch.cli.train_main"]
    jobs = {
        "sp2": [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", "2"] + mod + flags
        + ["--sp", "2"],
        "one": [sys.executable] + mod + flags,
    }
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(cmd, cwd=HERE, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, cmd in jobs.items()}
    lines = {}
    try:
        for k, p in procs.items():
            o, e = p.communicate(timeout=600)
            check(p.returncode == 0, f"parallel_rest ring CLI {k}: rc "
                  f"{p.returncode}: {e[-2000:]}")
            lines[k] = json.loads(o.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    got = [x for _, x in lines["sp2"]["losses"]]
    want = [x for _, x in lines["one"]["losses"]]
    err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    log(f"parallel_rest ring_cli: mesh {lines['sp2']['mesh']}, losses "
        f"{got} vs one process {want}, rel err {err:.2e} (tol "
        f"{REST_TOL['loss']}); {wall:.1f} s both")
    check(lines["sp2"]["mesh"] == {"data": 1, "seq": 2, "model": 1},
          "parallel_rest ring CLI: a seq axis of 2")
    check(len(got) == len(want) == 2 and all(math.isfinite(x) for x in got),
          "parallel_rest ring CLI: 2 finite losses")
    check(err <= REST_TOL["loss"], f"parallel_rest ring CLI: losses within "
          f"{REST_TOL['loss']} of one process")
    return {"losses": got, "one_process_losses": want, "loss_rel_err": err,
            "mesh": lines["sp2"]["mesh"], "seconds": wall}


def phase_parallel_rest(torch, ops, lora_served: list) -> dict:
    """The rest of the parallel layer on one card, two processes over gloo
    on CUDA tensors each time (no scaling number): (a) the MoE at tp 2,
    (b) the MoE int8 engine at tp 2, (e) GPipe at pipe 2
    (:func:`rest_two_process`); (c) the 7B int8 server at tp 2 with 4
    stacked adapters (:func:`rest_lora_serve`); (d) ring attention
    through the training CLI (:func:`rest_ring_cli`)."""
    secs, t0, out, failed = {}, time.perf_counter(), {}, []
    # every part runs and logs; a part's failed check fails the phase
    # after the others have run
    for key, part, run in (
            ("two_process", "a_b_e", lambda: rest_two_process(torch)),
            ("lora_serve_tp2", "c",
             lambda: rest_lora_serve(torch, lora_served)),
            ("ring_cli", "d", lambda: rest_ring_cli(torch))):
        t1 = time.perf_counter()
        try:
            out[key] = run()
        except RuntimeError as e:
            failed.append(f"{part}: {e}")
            log(f"parallel_rest {part}: {e}")
        secs[part] = time.perf_counter() - t1
        free_memory(torch)
    secs["total"] = time.perf_counter() - t0
    out["seconds"] = secs
    log(f"parallel_rest: seconds by part {secs}")
    check(not failed, f"parallel_rest: {failed}")
    return out


# ------------------------------------------------------------------ slice

#: the workload the granted device runs: the serve phase's 7B int8 server
#: from its own CLI wiring, at full width and depth (no cut)
SLICE_FLAGS = SERVE_FLAGS
#: the MIG profile the workload asks for when the card has MIG on: 40 GB,
#: room for the 7B int8 weights (6.4 GiB) and its KV cache
SLICE_MIG_PROFILE = "3g.40gb"
#: the smoke's own registry: a process of its own must see it
_SLICE_PROBE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from instaslice_tpu_torch.device import ChipsBusy, NvmlBackend
b = NvmlBackend(registry_dir=sys.argv[2])
out = {"list": [[r.slice_uuid, r.profile, list(r.device_uuids)]
                for r in b.list_reservations()]}
try:
    b.reserve("intruder", [int(sys.argv[3])])
    out["reserve"] = "granted"
    b.release("intruder")
except ChipsBusy as e:
    out["reserve"] = "ChipsBusy: " + str(e)
print(json.dumps(out))
"""


def nvml_layout_check(work: Path) -> dict:
    """``device/nvml_layout.c`` built against the toolkit's ``nvml.h``:
    every struct's size and offsets and the v2 version word, against the
    ctypes layouts of ``device/nvml.py``."""
    from instaslice_tpu_torch.device import nvml

    exe = work / "nvml_layout"
    src = HERE / "instaslice_tpu_torch" / "device" / "nvml_layout.c"
    subprocess.run(["cc", "-I/usr/local/cuda/include", "-o", str(exe),
                    str(src)], check=True, capture_output=True, timeout=120)
    header = json.loads(subprocess.run(
        [str(exe)], check=True, capture_output=True, text=True,
        timeout=60).stdout)
    mine = nvml.struct_layout()
    diff = {k: (header.get(k), v) for k, v in mine.items()
            if header.get(k) != v}
    check(not diff, f"slice: nvml.h layouts differ from ctypes: {diff}")
    return header


def slice_child(out: str) -> int:
    """The workload on the granted device, in a fresh process whose
    environment the handoff decided: the 7B int8 server from its CLI
    wiring (``SLICE_FLAGS``), the serve phase's 8 completions over HTTP
    (their tokens and logprobs kept, for the serve phase's to be held
    against) with the card's trace counting B1-B3 (``Traced``: the
    single-device engine replays CUDA graphs), the wrappers' counts
    beside it, then a
    burst of 8 new prompts untraced (the warm tok/s); what torch sees
    and the slice topology the env gives. Writes ``out``."""
    import os

    import torch

    from instaslice_tpu_torch import ops
    from instaslice_tpu_torch.parallel.meshenv import SliceTopology
    from instaslice_tpu_torch.serving import api_server

    topo = SliceTopology.from_env()
    res = {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "count": torch.cuda.device_count(),
           "uuid": str(torch.cuda.get_device_properties(0).uuid),
           "name": torch.cuda.get_device_name(0),
           "topology": {"num_chips": topo.num_chips,
                        "num_workers": topo.num_workers,
                        "profile": topo.profile}}
    t0 = time.perf_counter()
    args = api_server.build_parser().parse_args(SLICE_FLAGS.split())
    eng = api_server.build_engine(args)
    srv = api_server.ApiServer(eng, host=args.host, port=args.port).start()
    res["build_s"] = time.perf_counter() - t0
    res["n_layers"], res["route"] = args.n_layers, eng.decode_route()
    try:
        wait_ready(srv.url)
        gen = torch.Generator().manual_seed(17)
        prompts = [torch.randint(1, args.vocab_size, (n,),
                                 generator=gen).tolist()
                   for n in SERVE_PLENS]
        ops.reset_launch_counts()
        steps0 = eng.decode_steps
        t0 = time.perf_counter()
        with Traced(torch, ops) as tr:
            results, errors = http_burst(srv.url, prompts, SERVE_NEW)
        res["wall_s"] = tr.t_end - t0
        res["counts"], res["wrapper_counts"] = tr.counts, ops.launch_counts()
        res["decode_steps"] = eng.decode_steps - steps0
        res["errors"] = errors
        res["completions"] = [
            {"n": len(r["token_ids"]), "finish": r["finish_reason"],
             "in_range": all(0 <= t < args.vocab_size
                             for t in r["token_ids"])}
            for r in results if r is not None]
        res["served"] = [r and {"token_ids": r["token_ids"],
                                "logprobs": r["logprobs"]} for r in results]
        res["tok_s"] = sum(c["n"] for c in res["completions"]) / res["wall_s"]
        # a second burst of new prompts (no radix hit) at the same
        # lengths: the first paid the fresh process's one-time costs (the
        # serve phase's burst runs in a warm one)
        fresh = [torch.randint(1, args.vocab_size, (n,),
                               generator=gen).tolist() for n in SERVE_PLENS]
        t0 = time.perf_counter()
        again, errors = http_burst(srv.url, fresh, SERVE_NEW)
        res["warm_wall_s"] = time.perf_counter() - t0
        res["errors"] += errors
        res["warm_tok_s"] = sum(len(r["token_ids"]) for r in again
                                if r is not None) / res["warm_wall_s"]
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        srv.stop()
        Path(out).write_text(json.dumps(res))
    return 0


#: the slice manager's poll period (and its plugins' health poll): a
#: removed plugin socket is served and registered again within it
PLUGIN_POLL_S = 0.5


class SmokeKubelet:
    """The kubelet's Registration service on the port's own wire: records
    each ``Register`` and when it arrived."""

    def __init__(self, plugin_dir: str) -> None:
        import os
        import threading

        from instaslice_tpu_torch.deviceplugin.wire import (
            KUBELET_SOCKET,
            Server,
            registration_handler,
        )

        self.registrations = []
        self.cv = threading.Condition()
        self._server = Server(name="smoke-kubelet")
        self._server.add_handlers(registration_handler(self))
        self._server.start(os.path.join(plugin_dir, KUBELET_SOCKET))

    def Register(self, request, context):
        from instaslice_tpu_torch.deviceplugin import proto

        with self.cv:
            self.registrations.append((time.perf_counter(), request))
            self.cv.notify_all()
        return proto.Empty()

    def wait_for(self, n: int, timeout: float) -> float:
        """The time of the ``n``-th registration; raises after
        ``timeout`` seconds without it."""
        with self.cv:
            check(self.cv.wait_for(lambda: len(self.registrations) >= n,
                                   timeout),
                  f"slice: registration {n} within {timeout} s")
            return self.registrations[n - 1][0]

    def stop(self) -> None:
        self._server.stop(grace=0.5)


def plugin_exchange(backend, res, gpu: int, pdir: str) -> dict:
    """The device plugin on the card's reservation, driven as the
    kubelet drives it, through the port's wire only: the slice manager
    over ``backend``, its sockets in ``pdir`` (the kubelet's directory
    as the phase maps it), registered with a kubelet of the port's wire; on
    one connection the options, the first ListAndWatch update (exactly
    ``slice-<uuid>``, Healthy), GPU ``gpu`` marked unhealthy and healed
    (each update within 1 s), GetPreferredAllocation, Allocate; the
    controls (``slice-nope`` NOT_FOUND, ``gpu-0`` INVALID_ARGUMENT, the
    plugin's socket removed: a second Register within the poll period).
    Returns the readings and Allocate's container response."""
    import os

    from instaslice_tpu_torch.deviceplugin.server import (
        SlicePluginManager,
        profile_resource,
        reservation_profile,
    )
    from instaslice_tpu_torch.deviceplugin.wire import (
        HEALTHY,
        UNHEALTHY,
        Channel,
        DevicePluginClient,
        RpcError,
        StatusCode,
    )

    kubelet = SmokeKubelet(pdir)
    mgr = None
    out = {}
    try:
        profile = reservation_profile(res)
        dev_id = f"slice-{res.slice_uuid}"
        t0 = time.perf_counter()
        mgr = SlicePluginManager(backend, plugin_dir=pdir,
                                 poll_seconds=PLUGIN_POLL_S).start()
        out["register_ms"] = (kubelet.wait_for(1, 30) - t0) * 1e3
        reg = kubelet.registrations[0][1]
        out["registration"] = {"version": reg.version,
                               "endpoint": reg.endpoint,
                               "resource": reg.resource_name}
        check((reg.version, reg.resource_name, reg.endpoint) == (
            "v1beta1", profile_resource(profile),
            f"tpuslice-{profile}.sock"),
            f"slice: the plugin's registration {out['registration']}")
        # the manager records a plugin once its start() has registered
        deadline = time.monotonic() + 10
        while profile not in mgr.plugins:
            check(time.monotonic() < deadline, "slice: the manager's plugin")
            time.sleep(0.01)
        plugin = mgr.plugins[profile]
        with Channel(plugin.socket_path) as ch:
            c = DevicePluginClient(ch)
            check(c.options().get_preferred_allocation_available,
                  "slice: the plugin offers GetPreferredAllocation")
            stream = c.list_and_watch(timeout=60)
            first = stream.next(timeout=5)
            out["advertised"] = [(d.ID, d.health) for d in first.devices]
            check(out["advertised"] == [(dev_id, HEALTHY)],
                  f"slice: ListAndWatch lists {out['advertised']}")
            health_ms = []
            for healthy, want in ((False, UNHEALTHY), (True, HEALTHY)):
                t1 = time.perf_counter()
                plugin.set_chip_health(gpu, healthy)
                upd = stream.next(timeout=1.0)
                health_ms.append((time.perf_counter() - t1) * 1e3)
                check([(d.ID, d.health) for d in upd.devices]
                      == [(dev_id, want)], f"slice: health update {want}")
            out["health_update_ms"] = health_ms
            pref = c.preferred([dev_id], 1)
            check(list(pref.container_responses[0].deviceIDs) == [dev_id],
                  "slice: GetPreferredAllocation")
            t1 = time.perf_counter()
            (cresp,) = c.allocate([dev_id]).container_responses
            out["allocate_ms"] = (time.perf_counter() - t1) * 1e3
            codes = {}
            for bad, want in (("slice-nope", StatusCode.NOT_FOUND),
                              ("gpu-0", StatusCode.INVALID_ARGUMENT)):
                try:
                    c.allocate([bad])
                    codes[bad] = "OK"
                except RpcError as e:
                    codes[bad] = e.code().name
                check(codes[bad] == want.name,
                      f"slice: Allocate {bad} gave {codes[bad]}")
            out["controls"] = codes
            stream.cancel()
        t1 = time.perf_counter()
        os.unlink(plugin.socket_path)
        out["reregister_ms"] = (kubelet.wait_for(2, 10) - t1) * 1e3
        # found within one poll, then served and registered anew
        check(out["reregister_ms"] <= (PLUGIN_POLL_S + 0.5) * 1e3,
              f"slice: re-registered in {out['reregister_ms']:.0f} ms")
    finally:
        if mgr is not None:
            mgr.stop()
        kubelet.stop()
    out["allocate"] = {"envs": dict(cresp.envs),
                       "devices": [d.host_path for d in cresp.devices],
                       "annotations": dict(cresp.annotations)}
    return out


def dcn_smoke_on_card(res) -> dict:
    """``parallel/dcn_smoke.py`` on the granted device: two workers of a
    two-worker grant's handoff env (a v5e-4x4 over two hosts, the
    reference test's grant, its ``CUDA_VISIBLE_DEVICES`` the granted
    UUID), two processes sharing the card over gloo by name."""
    import os
    import socket

    from instaslice_tpu_torch.agent.handoff import slice_env
    from instaslice_tpu_torch.api.types import AllocationDetails, PodRef
    from instaslice_tpu_torch.topology.grid import (
        NodeGrid,
        TorusGroup,
        get_generation,
    )
    from instaslice_tpu_torch.topology.placement import legal_placements
    from instaslice_tpu_torch.topology.profiles import parse_profile_name

    gen = get_generation("v5e")
    group = TorusGroup("g", gen, (4, 4, 1), {
        "node-0": NodeGrid(gen, host_offset=(0, 0, 0), torus_group="g"),
        "node-1": NodeGrid(gen, host_offset=(2, 0, 0), torus_group="g")})
    pl = legal_placements(group, parse_profile_name("v5e-4x4"))[0]
    pods = [PodRef(f"uid-{p.worker_id}", f"worker-{p.worker_id}",
                   "default", worker_id=p.worker_id) for p in pl.parts]
    alloc = AllocationDetails.from_placement(pl, pods)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    for i, pod in enumerate(pods):
        env = {k: v for k, v in os.environ.items()
               if k not in ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES")}
        env.update(slice_env(alloc, pod, pl.parts[i].node_name, "v5e",
                             res.device_uuids))
        env.update(TPU_WORKER_HOSTNAMES="127.0.0.1,127.0.0.1",
                   TPUSLICE_SMOKE_PORT=str(port),
                   TPUSLICE_SMOKE_BACKEND="gloo")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "instaslice_tpu_torch.parallel.dcn_smoke"],
            cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=180)
            check(p.returncode == 0, f"slice: dcn_smoke failed: {e[-2000:]}")
            outs.append(json.loads(o.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for o in outs:
        check(o["psum_total"] == 3.0 and o["processes_seen"] == 2
              and o["local_devices"] == 1,
              f"slice: dcn_smoke worker {o}")
    return {"workers": outs, "seconds": time.perf_counter() - t0}


def phase_slice(torch, card: str, served: list) -> dict:
    """The slice/device layer from discovery to a granted device that
    serves, and back: (a) ``select_backend("auto")`` is the NVML backend
    (its struct layouts held against the toolkit's ``nvml.h`` first);
    the inventory beside ``nvidia-smi``, MIG mode, NVML's profile table
    against the fixed H100 80GB catalog; (b) first-fit places
    ``SLICE_MIG_PROFILE`` where MIG is on (a refused create, printed by
    its NVML name, fails the phase: a GPU with MIG on is granted only by
    MIG slices), else the whole GPU; (c) the reservation, held by a
    second process, which must list it (restart safety) and be refused
    the same GPU (``ChipsBusy``); (c2) the device plugin over it, as the
    kubelet drives it (:func:`plugin_exchange`); (d) ``slice_env`` for
    one pod, overlaid with Allocate's envs (equal on every shared key,
    every DeviceSpec's host path present), and the workload
    (:func:`slice_child`) in a fresh process whose
    ``CUDA_VISIBLE_DEVICES``/``NVIDIA_VISIBLE_DEVICES`` are those alone:
    one device, the granted UUID, B1-B3 launched, and 8 completions whose
    tokens equal ``served`` (the serve phase's, from the same weights,
    prompts and greedy decoding in the parent) and whose logprobs lie
    within ``SERVE_LOGPROB_TOL`` of them; (d2) the rendezvous smoke of a
    two-worker grant on the device (:func:`dcn_smoke_on_card`); (e) the
    release: no reservation left, and no MIG instance of ours. The
    registry lives in a temporary directory of the phase's own; nothing
    changes MIG mode or touches an instance the phase did not make.

    The plugin is the port's rendered device-plugin DaemonSet
    (:func:`manifest_container`): its command resolved through
    ``pyproject.toml``'s ``[project.scripts]`` to
    ``deviceplugin_main``, whose parser reads the DaemonSet's args
    (``--backend=auto``); the backend is the one ``--backend`` names, over
    the registry host path mapped to the phase's directory, and the
    plugin's sockets go where the parsed ``--plugin-dir`` (the CLI's
    default, the DaemonSet's mount of the kubelet's directory) is mapped,
    a short directory of the phase's own under ``/tmp``. It runs in this
    process, as the slice manager that advertises reservations (the
    CLI's own loop serves whole GPUs), so that the phase can mark a GPU
    unhealthy and heal it."""
    import importlib
    import os
    import shutil
    import tempfile

    from instaslice_tpu_torch.agent.handoff import slice_env
    from instaslice_tpu_torch.api.types import (
        AllocationDetails,
        PodRef,
        slice_uuid_for,
    )
    from instaslice_tpu_torch.device import NvmlBackend, NvmlError
    from instaslice_tpu_torch.device import select_backend
    from instaslice_tpu_torch.device.nvml import DEFAULT_REGISTRY
    from instaslice_tpu_torch.deviceplugin.server import DEFAULT_PLUGIN_DIR
    from instaslice_tpu_torch.topology import Occupancy, get_policy, mig

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="slice-"))
    # a short directory: unix socket paths stop at 107 characters
    pdir = tempfile.mkdtemp(prefix="dp", dir="/tmp")
    out = {}
    backend = res = None
    try:
        # (a) the device plugin's DaemonSet, and discovery
        dp_m = manifest_container("deviceplugin", {
            DEFAULT_REGISTRY: str(work / "reg"), DEFAULT_PLUGIN_DIR: pdir,
            "/dev": "/dev"})
        dp_args = importlib.import_module(
            dp_m["module"]).build_parser().parse_args(dp_m["args"])
        check(dp_args.plugin_dir in dp_m["paths"]
              and DEFAULT_REGISTRY in dp_m["paths"],
              f"slice: the DaemonSet mounts {sorted(dp_m['paths'])}, the "
              f"plugin reads {dp_args.plugin_dir} and {DEFAULT_REGISTRY}")
        out["plugin_manifest"] = {k: dp_m[k] for k in (
            "workload", "command", "target", "args", "env", "paths")}
        log(f"slice (a): {dp_m['workload']}: {dp_m['command'][0]} -> "
            f"{dp_m['target']} {' '.join(dp_m['args'])}; env {dp_m['env']}; "
            f"host paths {dp_m['paths']}")
        out["layout"] = nvml_layout_check(work)
        backend = select_backend(
            dp_args.backend, registry_dir=dp_m["paths"][DEFAULT_REGISTRY])
        check(isinstance(backend, NvmlBackend),
              f"slice: auto gave {type(backend).__name__}")
        inv = backend.discover()
        g = inv.gpus[0]
        check(inv.chip_count == torch.cuda.device_count()
              and g.uuid == f"GPU-{torch.cuda.get_device_properties(0).uuid}",
              "slice: NVML's GPUs are torch's")
        diff = mig.compare_catalog(g.profiles) if g.profiles else []
        out["inventory"] = {
            "generation": inv.generation, "count": inv.chip_count,
            "name": g.name, "uuid": g.uuid,
            "memory_gib": g.memory_bytes / 2 ** 30,
            "power_limit_w": g.power_limit_w,
            "mig": [g.mig_current, g.mig_pending],
            "profiles": list(g.profiles), "profiles_error": g.profiles_error,
            "catalog_diff": diff, "mig_devices": list(g.mig_devices)}
        log(f"slice (a): select_backend({dp_args.backend!r}) -> "
            f"{type(backend).__name__}"
            f"; nvml.h layouts equal ctypes'; {inv.chip_count} GPU(s), "
            f"GPU 0 {g.name} {g.uuid}, {g.memory_bytes / 2 ** 30:.2f} GiB, "
            f"power limit {g.power_limit_w:.2f} W (nvidia-smi: {card}); MIG "
            f"current {g.mig_current} pending {g.mig_pending}; profile "
            f"table: " + (f"{len(g.profiles)} profiles, catalog diff {diff}"
                          if g.profiles else f"refused, {g.profiles_error}"))
        check(not diff, f"slice: NVML's profile table differs from the "
              f"fixed H100 80GB catalog: {diff}")
        before = backend.list_reservations()
        before_inst = {r.device_uuids for r in backend.instances()}
        # (b) placement with InstaSlice's policy
        group = mig.gpu_group(inv.chip_count, inv.generation)
        occ = Occupancy(group)
        for r in before + backend.dangling():
            for c in r.chip_ids:
                occ.occupy(mig.slot_box(c, *r.slots))
        ff = get_policy("first-fit")
        pod = PodRef("smoke-pod-uid", "smoke-pod", "default")
        refusal = ""
        if g.mig_current == 1:
            # a GPU with MIG on is granted only by MIG slices: a refused
            # create fails the phase
            want = mig.parse_mig_profile(SLICE_MIG_PROFILE)
        else:
            want = mig.whole_gpu(inv.generation)
            refusal = (f"MIG mode current {g.mig_current} (profile table: "
                       f"{g.profiles_error or 'read'})")
        pl = ff.choose(group, want, occ)
        check(pl is not None, f"slice: no free {want.name}")
        alloc = AllocationDetails.from_placement(pl, [pod])
        gpu, start = mig.box_gpu_start(pl.box)
        try:
            t0 = time.perf_counter()
            res = (backend.reserve(slice_uuid_for(alloc.alloc_id), [gpu],
                                   want.name, start)
                   if g.mig_current == 1 else
                   backend.reserve(slice_uuid_for(alloc.alloc_id), [gpu]))
            out["reserve_ms"] = (time.perf_counter() - t0) * 1e3
        except NvmlError as e:
            check(False, f"slice: {e.call} refused {want.name} on GPU "
                  f"{gpu}: {e.code_name}")
        out["route"] = "mig" if res.profile else "whole gpu"
        out["refusal"] = refusal
        log(f"slice (b): first-fit placed {alloc.profile} at "
            f"{pl.box.key()} (GPU {gpu}); route {out['route']}"
            + (f", MIG refused: {refusal}" if refusal else ""))
        # (c) the reservation, seen from another process
        log(f"slice (c): reserved {res.slice_uuid} -> {res.device_uuids} "
            f"in {out['reserve_ms']:.1f} ms")
        t0 = time.perf_counter()
        probe = subprocess.run(
            [sys.executable, "-c", _SLICE_PROBE, str(HERE),
             str(work / "reg"), str(gpu)], capture_output=True, text=True,
            timeout=300, cwd=HERE)
        out["probe_s"] = time.perf_counter() - t0
        check(probe.returncode == 0, f"slice: probe failed {probe.stderr}")
        seen = json.loads(probe.stdout.strip().splitlines()[-1])
        out["probe"] = seen
        log(f"slice (c): a new process lists {seen['list']}, and its "
            f"reserve of GPU {gpu}: {seen['reserve']} "
            f"({out['probe_s']:.1f} s)")
        check([res.slice_uuid, res.profile, list(res.device_uuids)]
              in seen["list"], "slice: the reservation survives into a "
              "new process")
        check(seen["reserve"].startswith("ChipsBusy"),
              "slice: a second reserve of the device is refused")
        # (c2) the device plugin, driven as the kubelet drives it
        t0 = time.perf_counter()
        dp = plugin_exchange(backend, res, gpu,
                             dp_m["paths"][dp_args.plugin_dir])
        dp["seconds"] = time.perf_counter() - t0
        out["plugin"] = dp
        log(f"slice (c2): the plugin registered {dp['registration']} in "
            f"{dp['register_ms']:.1f} ms; ListAndWatch {dp['advertised']}; "
            f"health updates (unhealthy, healed) in "
            f"{[round(x, 2) for x in dp['health_update_ms']]} ms; Allocate "
            f"round trip {dp['allocate_ms']:.2f} ms; controls "
            f"{dp['controls']}; socket removed: registered again in "
            f"{dp['reregister_ms']:.1f} ms (poll {PLUGIN_POLL_S} s); "
            f"{dp['seconds']:.1f} s")
        # (d) the handoff, overlaid with Allocate's envs as the kubelet
        # overlays them on envFrom, and the workload on the granted
        # device alone
        env = slice_env(alloc, pod, "smoke-node", inv.generation,
                        res.device_uuids)
        out["env"] = env
        granted_env = dp["allocate"]["envs"]
        shared = sorted(set(env) & set(granted_env))
        out["shared_env"] = shared
        check({"CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES",
               "TPU_VISIBLE_CHIPS"} <= set(shared)
              and all(env[k] == granted_env[k] for k in shared),
              f"slice: Allocate's env {granted_env} agrees with slice_env "
              f"on {shared}")
        missing = [p for p in dp["allocate"]["devices"]
                   if not os.path.exists(p)]
        check(not missing and dp["allocate"]["devices"],
              f"slice: Allocate's device nodes exist (missing {missing})")
        log(f"slice (d): Allocate's env agrees with slice_env on {shared}; "
            f"its device nodes {dp['allocate']['devices']} exist")
        child_env = {k: v for k, v in os.environ.items()
                     if k not in ("CUDA_VISIBLE_DEVICES",
                                  "NVIDIA_VISIBLE_DEVICES")}
        child_env.update(env)
        child_env.update(granted_env)
        result = work / "child.json"
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-c", "import sys; sys.path.insert(0, "
             f"{str(HERE)!r}); import chip_smoke; "
             f"sys.exit(chip_smoke.slice_child({str(result)!r}))"],
            env=child_env, cwd=HERE, capture_output=True, text=True,
            timeout=600)
        out["workload_s"] = time.perf_counter() - t0
        check(run.returncode == 0 and result.exists(),
              f"slice: the workload failed ({run.returncode}): "
              f"{run.stderr[-3000:]}")
        w = json.loads(result.read_text())
        out["workload"] = {k: v for k, v in w.items() if k != "served"}
        c = w["counts"]
        log(f"slice (d): CUDA_VISIBLE_DEVICES={w['visible']}: torch sees "
            f"{w['count']} device, uuid {w['uuid']} ({w['name']}); topology "
            f"{w['topology']}; 7B int8 server, {w['n_layers']} layers (no "
            f"cut), built in {w['build_s']:.1f} s, route {w['route']}; 8 "
            f"completions x {SERVE_NEW} in {w['wall_s']:.2f} s = "
            f"{w['tok_s']:.1f} tok/s over HTTP on {card} (a second burst, "
            f"new prompts: {w['warm_tok_s']:.1f} tok/s); {w['decode_steps']}"
            f" decode steps; launches on the card's trace {c}, wrappers "
            f"{w['wrapper_counts']}; peak {w['peak_gib']:.2f} GiB; the "
            f"process {out['workload_s']:.1f} s")
        granted = res.device_uuids[0]
        check(w["count"] == 1 and w["visible"] == granted,
              "slice: the workload sees exactly the granted device")
        check(granted.endswith(w["uuid"]),
              f"slice: torch's device is the granted {granted}")
        check(w["topology"]["num_chips"] == 1
              and w["topology"]["profile"] == alloc.profile,
              "slice: the handoff env's topology is one device")
        check(not w["errors"] and len(w["completions"]) == len(SERVE_PLENS)
              and all(x["n"] == SERVE_NEW and x["in_range"]
                      and x["finish"] == "max_new_tokens"
                      for x in w["completions"]),
              f"slice: the completions ({w['errors']})")
        same = [a is not None and a["token_ids"] == b["token_ids"]
                for a, b in zip(w["served"], served)]
        lp = max((abs(x - y) for a, b in zip(w["served"], served) if a
                  for x, y in zip(a["logprobs"], b["logprobs"])),
                 default=float("inf"))
        out["served_equal"], out["served_logprob_diff"] = same, lp
        log(f"slice (d): tokens equal to the serve phase's, by request "
            f"{same}; largest logprob difference {lp:.3g} (tol "
            f"{SERVE_LOGPROB_TOL})")
        check(len(same) == len(served) and all(same),
              "slice: the granted device serves the serve phase's tokens")
        check(lp <= SERVE_LOGPROB_TOL,
              f"slice: logprobs differ from the serve phase's by {lp}")
        for k in ("quant_decode_attention", "quant_matmul_stacked",
                  "quant_matmul_t"):
            check(c[k] > 0, f"slice: {k} launched on the granted device")
        check(c["quant_decode_attention"]
              == w["n_layers"] * w["decode_steps"],
              "slice: B1 once a layer a decode step")
        # (d2) the rendezvous smoke of a two-worker grant on the device
        out["dcn_smoke"] = dcn_smoke_on_card(res)
        log(f"slice (d2): dcn_smoke, two workers over gloo on the granted "
            f"device: {out['dcn_smoke']['workers']} "
            f"({out['dcn_smoke']['seconds']:.1f} s)")
        # (e) release
        t0 = time.perf_counter()
        backend.release(res.slice_uuid)
        out["release_ms"] = (time.perf_counter() - t0) * 1e3
        res = None
        after = backend.list_reservations()
        left = {r.device_uuids for r in backend.instances()}
        log(f"slice (e): released in {out['release_ms']:.1f} ms; "
            f"reservations {after}; MIG instances left {sorted(left)}")
        check(after == before, "slice: no reservation left")
        check(left == before_inst, "slice: no MIG instance of ours left")
    finally:
        # a failed step still gives back what the phase made
        if res is not None:
            backend.release(res.slice_uuid)
        if backend is not None:
            backend.close()
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(pdir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"slice: {out['seconds']:.1f} s")
    return out


#: the agent's health sweep period in the agent phase (the CLI's default
#: is 10 s; the phase waits for two sweeps)
AGENT_HEALTH_S = 0.5
#: the longest the agent phase waits for one step of the agent
AGENT_WAIT_S = 120.0
#: the bearer token the phase's apiserver takes
AGENT_TOKEN = "agent-smoke-token"
AGENT_NODE = "smoke-node"
#: the agent phase's partition step: the agent restarted under
#: ``TPUSLICE_NEMESIS_PLAN``, cut from the apiserver this many seconds after
#: its start (its boot, which needs the apiserver, done by then) for this
#: many, with this seed
AGENT_CUT_AT_S = 2.5
AGENT_CUT_S = 4.0
AGENT_CUT_SEED = 1234
_AGENT_PROBE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from instaslice_tpu_torch.device import NvmlBackend
b = NvmlBackend(registry_dir=sys.argv[2])
print(json.dumps([[r.slice_uuid, r.profile, list(r.device_uuids)]
                  for r in b.list_reservations()]))
"""


def agent_child(kubeconfig: str, registry: str, probe: str) -> int:
    """The node agent as ``tpuslice-gpu-agent --backend nvml`` runs it:
    ``agent_main``'s parser, and the :class:`AgentRunner` that
    ``run_agent`` starts, built as its ``from_args`` builds it, but with
    the NVML backend on the phase's own registry directory (the CLI has
    no flag for it, as the reference's has none) and a health sweep every
    ``AGENT_HEALTH_S``. ``TPUSLICE_CRASH_AT`` in the environment arms its
    crash points; ``TPUSLICE_NEMESIS_PLAN`` puts its kube client behind
    the network nemesis as the sim puts each component's (identity
    ``agent-<node>``), the plan's schedule counted from here."""
    from instaslice_tpu_torch.agent.runner import AgentRunner
    from instaslice_tpu_torch.cli import agent_main
    from instaslice_tpu_torch.device import select_backend
    from instaslice_tpu_torch.faults.netchaos import (
        NemesisKubeClient,
        get_nemesis,
    )
    from instaslice_tpu_torch.kube.real import build_client

    args = agent_main.build_parser().parse_args([
        "--node-name", AGENT_NODE, "--backend", "nvml",
        "--kubeconfig", kubeconfig, "--health-probe-bind-address", probe,
        "--metrics-bind-address", "127.0.0.1:0"])
    client = build_client(args.kubeconfig)
    plan = get_nemesis()
    if plan is not None:
        client = NemesisKubeClient(client, plan.start(),
                                   f"agent-{args.node_name}")
    runner = AgentRunner(
        client,
        select_backend(args.backend, registry_dir=registry),
        node_name=args.node_name, namespace=args.namespace,
        metrics_bind_address=args.metrics_bind_address,
        health_probe_bind_address=args.health_probe_bind_address)
    runner.agent.health_interval = AGENT_HEALTH_S
    return runner.run()


def http_get(url: str):
    """(status, parsed JSON or text) of a GET; (0, None) while nothing
    listens."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            code, body = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    except (urllib.error.URLError, ConnectionError):
        return 0, None
    try:
        return code, json.loads(body)
    except ValueError:
        return code, body.decode(errors="replace")


def wait_until(fn, what: str, timeout: float = AGENT_WAIT_S,
               poll: float = 0.01, phase: str = "agent"):
    """``fn()``'s first truthy value, polled; fails the phase after
    ``timeout`` seconds without one."""
    end = time.perf_counter() + timeout
    while True:
        val = fn()
        if val:
            return val
        check(time.perf_counter() < end, f"{phase}: {what} within {timeout} s")
        time.sleep(poll)


def manifest_container(component: str, mounts: dict,
                       values: dict | None = None) -> dict:
    """The port's rendered workload ``component`` (``controller``,
    ``agent`` or ``deviceplugin``: ``deploy/manifests.py`` after
    ``config/default``'s patches, read as dicts, no YAML) as a process
    here: its container's command resolved through ``pyproject.toml``'s
    ``[project.scripts]`` to ``module:function``, its env (``NODE_NAME``
    from the downward API as the phase's node), and each host path it
    mounts mapped through ``mounts`` (host path -> a directory of the
    phase's own; ``/dev`` is the host's). Where the code reads a mounted
    path by itself, the package's override (``device/nvml.REGISTRY_ENV``,
    ``TPUSLICE_REGISTRY_DIR``, for the registry) names the phase's
    directory in the env; ``paths`` maps each mount path for a caller
    that hands it on. Its args are the manifest's, with two kinds of
    value mapped as the host paths are: each bind address
    (``--metrics-bind-address=``, ``--health-probe-bind-address=``) to
    a free port on 127.0.0.1, so that nothing binds a fixed port or
    every interface of this host (``binds``: the manifest's value ->
    the phase's), and each flag of ``values`` (which the manifest must
    carry) to the value given there. Nothing is written under ``/run``
    or ``/var/lib``. The sidecar (kube-rbac-proxy, not the port's) is not
    run."""
    import socket
    import tomllib

    from instaslice_tpu_torch.deploy.manifests import PREFIX, workload
    from instaslice_tpu_torch.device.nvml import (
        DEFAULT_REGISTRY,
        REGISTRY_ENV,
    )

    doc = workload(component)
    spec = doc["spec"]["template"]["spec"]
    (ctr,) = [c for c in spec["containers"]
              if c["image"].startswith(PREFIX)]
    with open(HERE / "pyproject.toml", "rb") as f:
        target = tomllib.load(f)["project"]["scripts"][ctr["command"][0]]
    module, func = target.split(":")
    env = {}
    for e in ctr.get("env", []):
        if "value" in e:
            env[e["name"]] = e["value"]
        else:
            check(e["valueFrom"]["fieldRef"]["fieldPath"] == "spec.nodeName",
                  f"manifest: {component} env {e}")
            env[e["name"]] = AGENT_NODE
    hosts = {v["name"]: v["hostPath"]["path"] for v in spec.get("volumes", [])}
    paths = {}
    for m in ctr.get("volumeMounts", []):
        host = hosts[m["name"]]
        check(host in mounts, f"manifest: no directory for {component}'s "
              f"host path {host}")
        paths[m["mountPath"]] = mounts[host]
        if m["mountPath"] == DEFAULT_REGISTRY:
            env[REGISTRY_ENV] = mounts[host]
    values = dict(values or {})
    args, binds, probe_port = [], {}, 0
    for a in ctr.get("args", []):
        flag, eq, val = a.partition("=")
        if flag in ("--metrics-bind-address", "--health-probe-bind-address"):
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            binds[val] = f"127.0.0.1:{port}"
            if flag == "--health-probe-bind-address":
                probe_port = port
            a = f"{flag}=127.0.0.1:{port}"
        elif eq and flag in values:
            a = f"{flag}={values.pop(flag)}"
        args.append(a)
    check(not values, f"manifest: {component} carries no "
          f"{sorted(values)}")
    return {"workload": f"{doc['kind']}/{doc['metadata']['name']}",
            "command": ctr["command"], "target": target, "module": module,
            "function": func, "args": args, "binds": binds,
            "env": env, "paths": paths, "probe_port": probe_port}


class AgentProcess:
    """One run of :func:`agent_child`, or with ``manifest`` of the port's
    rendered workload of that name (:func:`manifest_container`: its
    console script's function on its args, its env, its host paths in
    ``work``), in a fresh process, its output in ``log``. A manifest's
    process reads the phase's JSON kubeconfig (``KUBECONFIG``, standing in
    for the in-cluster service account: the child's env has no
    ``KUBERNETES_SERVICE_HOST``), runs the controller's
    ``--deletion-grace-seconds`` at ``CONTROLLER_GRACE_S``, and answers
    its probes on the free port its probe bind address was mapped to.
    With ``sinks`` the process writes its journal to
    ``sinks/<name><n>.events.jsonl`` (``TPUSLICE_EVENT_FILE``) and its
    spans to ``sinks/<name><n>.trace.jsonl`` (``TPUSLICE_TRACE_FILE``),
    the latter unless it is armed to crash: a hard crash inside a span
    never writes that span, so the children it wrote before would stand
    in the file as orphans by design. ``nemesis``: the process's
    ``TPUSLICE_NEMESIS_PLAN`` (:func:`agent_child` honours it)."""

    def __init__(self, work: Path, n: int, crash_at: str = "",
                 manifest: str = "", sinks: Path | None = None,
                 nemesis: str = "") -> None:
        import os
        import socket

        env = dict(os.environ)
        for k in ("TPUSLICE_CRASH_AT", "TPUSLICE_TRACE_FILE",
                  "TPUSLICE_EVENT_FILE", "TPUSLICE_NEMESIS_PLAN"):
            env.pop(k, None)
        if crash_at:
            env.update(TPUSLICE_CRASH_AT=crash_at, TPUSLICE_CRASH_HARD="1")
        if nemesis:
            env["TPUSLICE_NEMESIS_PLAN"] = nemesis
        kubeconfig = str(work / "kubeconfig.json")
        if manifest:
            from instaslice_tpu_torch.device.nvml import DEFAULT_REGISTRY

            m = manifest_container(
                manifest, {DEFAULT_REGISTRY: str(work / "reg"),
                           "/dev": "/dev"},
                {"--deletion-grace-seconds": str(CONTROLLER_GRACE_S)}
                if manifest == "controller" else None)
            for k in ("KUBERNETES_SERVICE_HOST", "KUBERNETES_SERVICE_PORT"):
                env.pop(k, None)
            env.update(m["env"], KUBECONFIG=kubeconfig)
            self.manifest = m
            port = m["probe_port"]
            code = (f"import sys; sys.path.insert(0, {str(HERE)!r}); "
                    f"from {m['module']} import {m['function']}; "
                    f"sys.exit({m['function']}(sys.argv[1:]))")
            argv = [sys.executable, "-c", code, *m["args"]]
            name = manifest
        else:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            call = (f"agent_child({kubeconfig!r}, {str(work / 'reg')!r}, "
                    f"'127.0.0.1:{port}')")
            argv = [sys.executable, "-c", "import sys; sys.path.insert(0, "
                    f"{str(HERE)!r}); import chip_smoke; sys.exit(chip_smoke."
                    f"{call})"]
            name = "agent"
        self.trace_file = self.event_file = None
        if sinks is not None:
            self.event_file = sinks / f"{name}{n}.events.jsonl"
            env["TPUSLICE_EVENT_FILE"] = str(self.event_file)
            if not crash_at:
                self.trace_file = sinks / f"{name}{n}.trace.jsonl"
                env["TPUSLICE_TRACE_FILE"] = str(self.trace_file)
        self.url = f"http://127.0.0.1:{port}"
        self.log = work / f"{name}{n}.log"
        self.t0 = time.perf_counter()
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(argv, env=env, cwd=HERE, stdout=out,
                                         stderr=subprocess.STDOUT)

    def tail(self) -> str:
        return self.log.read_text()[-3000:]

    def alive(self) -> bool:
        return self.proc.poll() is None

    def probes_up(self, phase: str) -> bool:
        """True once ``/healthz`` and ``/readyz`` both answer 200; fails
        the phase if the process has exited."""
        if not self.alive():
            check(False, f"{phase}: {self.log.stem} exited "
                  f"({self.proc.returncode}): {self.tail()}")
        return all(http_get(f"{self.url}/{x}")[0] == 200
                   for x in ("healthz", "readyz"))

    def stop(self) -> int:
        """SIGTERM, as the kubelet stops a pod; the exit code."""
        if self.alive():
            self.proc.terminate()
        try:
            return self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait()


def granted_workload(out: dict, work: Path, cm_data: dict, granted: str,
                     served: list, phase: str):
    """The workload (:func:`slice_child`) in a fresh process on the
    parent's environment less ``CUDA_VISIBLE_DEVICES`` and
    ``NVIDIA_VISIBLE_DEVICES``, plus a handoff ConfigMap's data, as
    ``envFrom`` gives it: one device, the ``granted`` UUID, the serve
    phase's 8 completions (tokens equal, logprobs within
    ``SERVE_LOGPROB_TOL``), B1-B3 on the card's trace. Fills ``out``'s
    ``workload_s``, ``workload``, ``served_equal`` and
    ``served_logprob_diff``; returns the child's result, the per-row
    token equality and the largest logprob difference."""
    import os

    child_env = {k: v for k, v in os.environ.items()
                 if k not in ("CUDA_VISIBLE_DEVICES",
                              "NVIDIA_VISIBLE_DEVICES")}
    child_env.update(cm_data)
    result = work / "child.json"
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, "
         f"{str(HERE)!r}); import chip_smoke; "
         f"sys.exit(chip_smoke.slice_child({str(result)!r}))"],
        env=child_env, cwd=HERE, capture_output=True, text=True,
        timeout=600)
    out["workload_s"] = time.perf_counter() - t0
    check(run.returncode == 0 and result.exists(),
          f"{phase}: the workload failed ({run.returncode}): "
          f"{run.stderr[-3000:]}")
    w = json.loads(result.read_text())
    out["workload"] = {k: v for k, v in w.items() if k != "served"}
    c = w["counts"]
    check(w["count"] == 1 and w["visible"] == granted
          and granted.endswith(w["uuid"]),
          f"{phase}: the workload sees {w['count']} device(s), "
          f"{w['visible']} / {w['uuid']}, not the granted {granted}")
    check(not w["errors"] and len(w["completions"]) == len(SERVE_PLENS)
          and all(x["n"] == SERVE_NEW and x["in_range"]
                  and x["finish"] == "max_new_tokens"
                  for x in w["completions"]),
          f"{phase}: the completions ({w['errors']})")
    same = [r is not None and r["token_ids"] == s["token_ids"]
            for r, s in zip(w["served"], served)]
    lp = max((abs(x - y) for r, s in zip(w["served"], served) if r
              for x, y in zip(r["logprobs"], s["logprobs"])),
             default=float("inf"))
    out["served_equal"], out["served_logprob_diff"] = same, lp
    check(len(same) == len(served) and all(same),
          f"{phase}: the granted device serves the serve phase's tokens")
    check(lp <= SERVE_LOGPROB_TOL,
          f"{phase}: logprobs differ from the serve phase's by {lp}")
    for k in ("quant_decode_attention", "quant_matmul_stacked",
              "quant_matmul_t"):
        check(c[k] > 0, f"{phase}: {k} launched on the granted device")
    check(c["quant_decode_attention"]
          == w["n_layers"] * w["decode_steps"],
          f"{phase}: B1 once a layer a decode step")
    return w, same, lp


def phase_agent(torch, card: str, served: list) -> dict:
    """The node agent on the card, from an allocation record to a pod's
    device and back: (a) the port's ``kube/httptest`` serves a port
    ``FakeKube`` on 127.0.0.1 behind a bearer token, with a JSON
    kubeconfig and a ``Node``; (b) the agent (:func:`agent_child`) in a
    fresh process over the real HTTP client and the NVML backend
    publishes the node's CR (the card's grid, one chip a GPU, its
    catalog), and its ``/healthz`` and ``/readyz`` answer 200; (c) the
    smoke, as the controller, writes a ``creating`` allocation for one
    pod, placed first-fit on the CR's grid (``SLICE_MIG_PROFILE`` where
    MIG is on, else the whole GPU), and the agent realizes it: the pod's
    ConfigMap with the granted UUID alone in ``CUDA_VISIBLE_DEVICES``,
    ``realized_on`` and ``prepared`` under the part's key, the Node's
    per-pod resource, the reservation listed by another process; (d)
    the workload (:func:`slice_child`) in a fresh process on the
    ConfigMap's env, as ``envFrom`` gives it: one device, the granted
    UUID, the serve phase's tokens, B1-B3 on the card's trace; (e) two
    health sweeps leave ``status.unhealthyChips`` at ``[]``; (h) the
    agent, holding the grant, restarted under ``TPUSLICE_NEMESIS_PLAN``
    (``AGENT_CUT_AT_S`` into its run, for ``AGENT_CUT_S``):
    ``DegradedModeEntered`` once on its ``/v1/debug/events``, another
    process listing the reservation unchanged during the cut,
    ``DegradedModeExited`` after it, the CR's ``prepared`` equal to the
    device's reservations, MIG instances unchanged; (g) the
    allocation flipped to ``deleted`` is torn down: reservation,
    ConfigMap, Node resource and record gone, and then (h) ends with a
    pod submitted after the heal granted and torn down; (f), after (g) so that it
    runs on a card of one GPU with MIG off too, an agent armed to crash
    hard at ``agent.realize`` dies on a second allocation with its
    reservation made and unrecorded; that allocation removed from the
    CR, a restarted agent's boot sweep reaps the orphan (released, no
    MIG instance of ours left, ``OrphanReaped`` on its
    ``/v1/debug/events``). The phase reads MIG mode and never sets it."""
    import shutil
    import tempfile

    from instaslice_tpu_torch.api.constants import (
        POD_RESOURCE_PREFIX,
        REASON_DEGRADED_ENTERED,
        REASON_DEGRADED_EXITED,
        REASON_ORPHAN_REAPED,
    )
    from instaslice_tpu_torch.api.types import (
        AllocationDetails,
        AllocationStatus,
        PodRef,
        TpuSlice,
        slice_uuid_for,
    )
    from instaslice_tpu_torch.device import NvmlBackend
    from instaslice_tpu_torch.kube import FakeKube, NotFound
    from instaslice_tpu_torch.kube.client import update_with_retry
    from instaslice_tpu_torch.kube.httptest import FakeApiServer
    from instaslice_tpu_torch.topology import Occupancy, get_policy, mig
    from instaslice_tpu_torch.topology.placement import Box

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="agent-"))
    ns = "instaslice-tpu-system"
    out = {}
    kube = FakeKube()
    srv = agents = backend = None
    try:
        # (a) the apiserver, its kubeconfig and the Node
        srv = FakeApiServer(kube).start()
        srv.handler.token_validator = lambda t: t == AGENT_TOKEN
        (work / "kubeconfig.json").write_text(json.dumps({
            "apiVersion": "v1", "kind": "Config",
            "current-context": "smoke",
            "clusters": [{"name": "smoke", "cluster": {"server": srv.url}}],
            "users": [{"name": "smoke", "user": {"token": AGENT_TOKEN}}],
            "contexts": [{"name": "smoke", "context": {
                "cluster": "smoke", "user": "smoke"}}]}))
        kube.create("Node", {"apiVersion": "v1", "kind": "Node",
                             "metadata": {"name": AGENT_NODE},
                             "status": {"capacity": {}, "allocatable": {}}})
        backend = NvmlBackend(registry_dir=str(work / "reg"))
        inv = backend.discover()
        g = inv.gpus[0]
        mig_on = g.mig_current == 1
        before_inst = {r.device_uuids for r in backend.instances()}
        log(f"agent (a): apiserver {srv.url} (bearer token), Node "
            f"{AGENT_NODE}; NVML: {inv.chip_count} GPU(s), generation "
            f"{inv.generation!r}, MIG current {g.mig_current}")

        def cr():
            try:
                return TpuSlice.from_manifest(kube.get("TpuSlice", ns,
                                                       AGENT_NODE))
            except NotFound:
                return None

        # (b) the agent in a fresh process
        agents = [AgentProcess(work, 0)]
        a = agents[0]
        ts = wait_until(lambda: cr() or (not a.alive() and check(
            False, f"agent: the agent exited ({a.proc.returncode}): "
            f"{a.tail()}")), "the agent's CR")
        out["boot_to_cr_s"] = time.perf_counter() - a.t0
        gen = mig.grid_generation(inv.generation)
        catalog = [p.name for p in mig.mig_catalog(gen)]
        if mig.whole_gpu(gen).name not in catalog:
            catalog.append(mig.whole_gpu(gen).name)
        check(ts.spec.generation == gen, f"agent: CR generation "
              f"{ts.spec.generation!r}, the card's grid {gen!r}")
        check(ts.spec.chips == {str(i): p for i, p in
                                inv.chip_paths.items()},
              f"agent: CR chips {ts.spec.chips}")
        check([p["name"] for p in ts.spec.profiles] == catalog,
              f"agent: CR profiles {ts.spec.profiles}")
        probes = wait_until(lambda: all(
            http_get(f"{a.url}/{p}")[0] == 200 for p in ("healthz",
                                                         "readyz")),
            "/healthz and /readyz 200", poll=0.05)
        log(f"agent (b): the agent process published TpuSlice "
            f"{ns}/{AGENT_NODE} {out['boot_to_cr_s']:.2f} s after its "
            f"start: generation {gen}, chips {ts.spec.chips}, profiles "
            f"{catalog}; /healthz and /readyz 200: {probes}")

        # (c) the controller's write, and the agent's realize
        group = mig.gpu_group(len(ts.spec.chips), ts.spec.generation)
        occ = Occupancy(group)
        for prep in ts.spec.prepared.values():
            occ.occupy(Box.from_key(prep.box))
        want = (mig.parse_mig_profile(SLICE_MIG_PROFILE, gen) if mig_on
                else mig.whole_gpu(gen))
        ff = get_policy("first-fit")
        pl = ff.choose(group, want, occ)
        check(pl is not None, f"agent: no free {want.name}")
        pod = PodRef("agent-pod-uid", "agent-pod", "default")
        alloc = AllocationDetails.from_placement(pl, [pod])
        key = next(iter(alloc.parts))
        suid = slice_uuid_for(alloc.alloc_id)

        def write(fn):
            def mut(obj):
                t = TpuSlice.from_manifest(obj)
                fn(t)
                return t.to_manifest()
            update_with_retry(kube, "TpuSlice", ns, AGENT_NODE, mut)

        def configmap():
            try:
                return kube.get("ConfigMap", "default", pod.pod_name)
            except NotFound:
                return None

        t0 = time.perf_counter()
        write(lambda t: t.spec.allocations.__setitem__(alloc.alloc_id,
                                                       alloc))
        cm = wait_until(configmap, "the pod's ConfigMap")
        out["realize_configmap_ms"] = (time.perf_counter() - t0) * 1e3
        ts = wait_until(lambda: (lambda t: t if key in t.spec.allocations[
            alloc.alloc_id].realized_on else None)(cr()), "realized_on")
        out["realize_ms"] = (time.perf_counter() - t0) * 1e3
        res = [r for r in backend.list_reservations()
               if r.slice_uuid == suid]
        check(len(res) == 1, f"agent: one reservation {suid}: {res}")
        res = res[0]
        gpu, start = mig.box_gpu_start(pl.box)
        granted = cm["data"]["CUDA_VISIBLE_DEVICES"]
        check(res.chip_ids == (gpu,) and granted == res.device_uuids[0]
              and len(res.device_uuids) == 1
              and cm["data"]["NVIDIA_VISIBLE_DEVICES"] == granted,
              f"agent: the ConfigMap grants {granted}, the reservation "
              f"{res}")
        check(res.profile == ("" if want.name == mig.WHOLE_GPU
                              else want.name)
              and (not res.profile or res.start == start),
              f"agent: reserved {res.profile}@{res.start}, placed "
              f"{want.name}@{start}")
        prep = ts.spec.prepared.get(suid)
        check(prep is not None and list(prep.parts) == [key]
              and prep.parts[key].chip_ids == [gpu]
              and prep.pod_uuid == pod.pod_uuid,
              f"agent: prepared {prep and prep.to_dict()}")
        node = kube.get("Node", "", AGENT_NODE)["status"]
        resname = POD_RESOURCE_PREFIX + pod.pod_name
        check(node["capacity"].get(resname) == "1"
              and node["allocatable"].get(resname) == "1",
              f"agent: the Node's {resname}: {node}")
        probe = subprocess.run(
            [sys.executable, "-c", _AGENT_PROBE, str(HERE),
             str(work / "reg")], capture_output=True, text=True,
            timeout=300, cwd=HERE)
        check(probe.returncode == 0, f"agent: probe failed {probe.stderr}")
        seen = json.loads(probe.stdout.strip().splitlines()[-1])
        check([suid, res.profile, list(res.device_uuids)] in seen,
              f"agent: another process lists {seen}")
        out["grant"] = {"key": key, "box": alloc.box, "profile": want.name,
                        "reservation": [res.profile, res.start,
                                        list(res.device_uuids)]}
        log(f"agent (c): first-fit placed {want.name} at {alloc.box} "
            f"(part {key}); ConfigMap {out['realize_configmap_ms']:.1f} ms "
            f"and realized_on {out['realize_ms']:.1f} ms after the write; "
            f"CUDA_VISIBLE_DEVICES={granted}; prepared[{suid}] under {key}; "
            f"Node {resname}=1; another process lists {seen}")
        write(lambda t: t.spec.allocations[alloc.alloc_id].set_status(
            AllocationStatus.CREATED))
        write(lambda t: t.spec.allocations[alloc.alloc_id].set_status(
            AllocationStatus.UNGATED))

        # (d) the workload on the ConfigMap's env alone
        w, same, lp = granted_workload(out, work, cm["data"], granted,
                                       served, "agent")
        c = w["counts"]
        log(f"agent (d): the workload on the ConfigMap's env: "
            f"CUDA_VISIBLE_DEVICES={w['visible']}, torch sees {w['count']} "
            f"device, uuid {w['uuid']}; 7B int8, {w['n_layers']} layers, "
            f"built in {w['build_s']:.1f} s; first burst 8 x {SERVE_NEW} in "
            f"{w['wall_s']:.2f} s = {w['tok_s']:.1f} tok/s on {card} (second "
            f"burst {w['warm_tok_s']:.1f} tok/s); tokens equal to the serve "
            f"phase's {same}, largest logprob difference {lp:.3g} (tol "
            f"{SERVE_LOGPROB_TOL}); launches on the card's trace {c}; the "
            f"process {out['workload_s']:.1f} s")

        # (e) the health sweep on a healthy card
        def sweeps():
            """The agent's health sweeps, once there are two, from the
            reconcile spans on its ``/v1/debug/trace``."""
            code, tr = http_get(f"{a.url}/v1/debug/trace?n=4096")
            n = code == 200 and sum(
                1 for s in tr["recent"]
                if s["name"] == f"agent-{AGENT_NODE}.reconcile"
                and s.get("attrs", {}).get("key") == "#health")
            return n if n >= 2 else None
        n_sweeps = wait_until(sweeps, "two health sweeps", poll=0.1)
        ts = cr()
        check(ts.status.unhealthy_chips == [],
              f"agent: unhealthyChips {ts.status.unhealthy_chips}")
        out["health_sweeps"] = n_sweeps
        log(f"agent (e): {n_sweeps} health sweeps, unhealthyChips "
            f"{ts.status.unhealthy_chips}")

        # (h) static mode: the agent, holding the grant, restarted under a
        # partition from the apiserver; then the heal
        t_cut = time.perf_counter()
        code = a.stop()
        check(code == 0, f"agent: SIGTERM exit {code}: {a.tail()}")
        held = [[r.slice_uuid, r.profile, list(r.device_uuids)]
                for r in backend.list_reservations()]
        inst = {r.device_uuids for r in backend.instances()}
        plan = (f"seed={AGENT_CUT_SEED};agent-{AGENT_NODE}>apiserver:"
                f"kind=partition,start={AGENT_CUT_AT_S},"
                f"duration={AGENT_CUT_S}")
        a = AgentProcess(work, 3, nemesis=plan)
        agents.append(a)
        wait_until(lambda: a.probes_up("agent (h)"),
                   "the cut agent's probes", poll=0.05)

        def events(reason):
            code, body = http_get(f"{a.url}/v1/debug/events?reason={reason}")
            return body["events"] if code == 200 else None

        wait_until(lambda: events(REASON_DEGRADED_ENTERED),
                   "DegradedModeEntered", poll=0.05)
        t_entered = time.perf_counter() - a.t0
        probe = subprocess.run(
            [sys.executable, "-c", _AGENT_PROBE, str(HERE),
             str(work / "reg")], capture_output=True, text=True,
            timeout=300, cwd=HERE)
        check(probe.returncode == 0, f"agent: probe failed {probe.stderr}")
        seen = json.loads(probe.stdout.strip().splitlines()[-1])
        check(not events(REASON_DEGRADED_EXITED),
              "agent (h): the probe ran inside the cut")
        check(seen == held, f"agent (h): during the cut another process "
              f"lists {seen}, {held} before it")
        wait_until(lambda: events(REASON_DEGRADED_EXITED),
                   "DegradedModeExited", poll=0.05)
        t_exited = time.perf_counter() - a.t0
        entered = events(REASON_DEGRADED_ENTERED)
        check(len(entered) == 1, f"agent (h): DegradedModeEntered "
              f"{len(entered)} times")
        ts = cr()
        dev = sorted(r.slice_uuid for r in backend.list_reservations())
        check(sorted(ts.spec.prepared) == dev == [suid]
              and key in ts.spec.allocations[alloc.alloc_id].realized_on,
              f"agent (h): after the heal the CR's prepared "
              f"{sorted(ts.spec.prepared)}, the device's {dev}")
        left = {r.device_uuids for r in backend.instances()}
        check(left == inst, f"agent (h): MIG instances {inst} -> {left}")
        out["partition"] = {
            "entered_s": t_entered, "exited_s": t_exited,
            "cut": [AGENT_CUT_AT_S, AGENT_CUT_S], "listed": seen,
            "entered": len(entered)}
        log(f"agent (h): restarted under {plan!r}: DegradedModeEntered "
            f"once, {t_entered:.2f} s after its start; during the cut "
            f"another process lists {seen} unchanged; DegradedModeExited "
            f"{t_exited:.2f} s after its start; the CR's prepared equals "
            f"the device's {dev}; MIG instances unchanged")

        # (g) teardown
        t0 = time.perf_counter()
        write(lambda t: t.spec.allocations[alloc.alloc_id].set_status(
            AllocationStatus.DELETED))
        wait_until(lambda: alloc.alloc_id not in cr().spec.allocations,
                   "the erased allocation record")
        out["teardown_ms"] = (time.perf_counter() - t0) * 1e3
        ts = cr()
        node = kube.get("Node", "", AGENT_NODE)["status"]
        check(configmap() is None, "agent: the ConfigMap is deleted")
        check(resname not in node["capacity"]
              and resname not in node["allocatable"],
              f"agent: the Node's {resname} is removed: {node}")
        check(suid not in ts.spec.prepared, "agent: prepared is cleared")
        check(not backend.list_reservations(), "agent: no reservation left")
        left = {r.device_uuids for r in backend.instances()}
        check(left == before_inst, f"agent: MIG instances left {left}")
        log(f"agent (g): deleted -> record erased in "
            f"{out['teardown_ms']:.1f} ms; ConfigMap, Node resource, "
            f"reservation gone; MIG instances {sorted(left)}")
        # (h) ends: a pod submitted after the heal is granted (after (g):
        # a card of one GPU with MIG off has no room beside the first)
        pod3 = PodRef("agent-pod3-uid", "agent-pod3", "default")
        alloc3 = AllocationDetails.from_placement(pl, [pod3])
        write(lambda t: t.spec.allocations.__setitem__(alloc3.alloc_id,
                                                       alloc3))
        wait_until(lambda: key in cr().spec.allocations[
            alloc3.alloc_id].realized_on, "the post-heal grant")
        check([r.slice_uuid for r in backend.list_reservations()]
              == [slice_uuid_for(alloc3.alloc_id)],
              "agent (h): the post-heal pod's reservation")
        write(lambda t: t.spec.allocations[alloc3.alloc_id].set_status(
            AllocationStatus.DELETED))
        wait_until(lambda: alloc3.alloc_id not in cr().spec.allocations,
                   "the post-heal grant's erased record")
        check(not backend.list_reservations()
              and {r.device_uuids for r in backend.instances()}
              == before_inst, "agent (h): the post-heal grant torn down")
        out["partition"]["seconds"] = time.perf_counter() - t_cut
        log(f"agent (h): a pod submitted after the heal granted and torn "
            f"down; the step {out['partition']['seconds']:.1f} s")
        code = a.stop()
        check(code == 0, f"agent: SIGTERM exit {code}: {a.tail()}")

        # (f) a crash at agent.realize, and the restart's orphan reap
        crasher = AgentProcess(work, 1, crash_at="agent.realize")
        agents.append(crasher)
        wait_until(lambda: http_get(f"{crasher.url}/readyz")[0] == 200
                   if crasher.alive() else None,
                   "the armed agent's readiness", poll=0.05)
        pod2 = PodRef("agent-pod2-uid", "agent-pod2", "default")
        alloc2 = AllocationDetails.from_placement(pl, [pod2])
        suid2 = slice_uuid_for(alloc2.alloc_id)
        write(lambda t: t.spec.allocations.__setitem__(alloc2.alloc_id,
                                                       alloc2))
        code = crasher.proc.wait(timeout=AGENT_WAIT_S)
        check(code == 17, f"agent: the armed agent exit {code} (want 17): "
              f"{crasher.tail()}")
        orphan = [r for r in backend.list_reservations()
                  if r.slice_uuid == suid2]
        ts = cr()
        check(len(orphan) == 1 and suid2 not in ts.spec.prepared
              and not ts.spec.allocations[alloc2.alloc_id].realized_on,
              f"agent: the crash left {orphan}, recorded "
              f"{suid2 in ts.spec.prepared}")
        write(lambda t: t.spec.allocations.pop(alloc2.alloc_id))
        t0 = time.perf_counter()
        b = AgentProcess(work, 2)
        agents.append(b)
        wait_until(lambda: not backend.list_reservations(),
                   "the orphan's release", poll=0.05)
        out["orphan_reap_s"] = time.perf_counter() - t0
        left = {r.device_uuids for r in backend.instances()}
        check(left == before_inst, f"agent: MIG instances left {left}")
        evs = wait_until(lambda: (lambda r: r[0] == 200 and r[1]["events"])(
            http_get(f"{b.url}/v1/debug/events?reason="
                     f"{REASON_ORPHAN_REAPED}")), "OrphanReaped", poll=0.05)
        check(any(e["objectRef"] == f"slice/{suid2}" for e in evs),
              f"agent: OrphanReaped events {evs}")
        code = b.stop()
        check(code == 0, f"agent: SIGTERM exit {code}: {b.tail()}")
        out["orphan"] = {"reservation": [orphan[0].profile, orphan[0].start,
                                         list(orphan[0].device_uuids)],
                         "events": [e["message"] for e in evs]}
        log(f"agent (f): armed at agent.realize, the agent exited 17 with "
            f"{suid2} reserved and unrecorded; the allocation removed, a "
            f"restarted agent reaped it {out['orphan_reap_s']:.2f} s after "
            f"its start; MIG instances {sorted(left)}; /v1/debug/events: "
            f"{out['orphan']['events']}")
        out["numbers"] = {
            "card": card, "boot_to_cr_s": out["boot_to_cr_s"],
            "realize_configmap_ms": out["realize_configmap_ms"],
            "realize_ms": out["realize_ms"],
            "teardown_ms": out["teardown_ms"],
            "first_burst_tok_s": w["tok_s"],
            "second_burst_tok_s": w["warm_tok_s"]}
        log("agent: " + json.dumps(out["numbers"]))
    finally:
        # a failed step still stops what the phase started and gives
        # back what it reserved
        for p in agents or ():
            p.stop()
        if backend is not None:
            for r in backend.list_reservations():
                backend.release(r.slice_uuid)
            backend.close()
        if srv is not None:
            srv.stop()
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"agent: {out['seconds']:.1f} s")
    return out


#: the deletion grace the controller phase's controller runs with, in
#: place of the Deployment's ``--deletion-grace-seconds=30``
CONTROLLER_GRACE_S = 1.0
#: how often the controller phase polls the apiserver for a step's effect
CONTROLLER_POLL_S = 0.002


def first_times(conds: dict, what: str, t0: float,
                timeout: float = AGENT_WAIT_S) -> dict:
    """Seconds from ``t0`` to the first poll at which each of ``conds``
    (name -> predicate) held, polling every ``CONTROLLER_POLL_S`` until
    all have; fails the phase after ``timeout`` seconds."""
    got: dict = {}
    end = time.perf_counter() + timeout
    while len(got) < len(conds):
        for name, fn in conds.items():
            if name not in got and fn():
                got[name] = time.perf_counter() - t0
        check(time.perf_counter() < end,
              f"controller: {what} within {timeout} s (held: {sorted(got)})")
        time.sleep(CONTROLLER_POLL_S)
    return got


def phase_controller(torch, card: str, served: list, sinks: Path) -> dict:
    """InstaSlice's whole pod loop on the card, the port's controller and
    node agent each in a process of its own over HTTP, the agent over
    NVML, each started from the port's deploy plane as a cluster would
    start it: (a) the port's ``kube/httptest`` serves a ``FakeKube`` on
    127.0.0.1 behind a bearer token, with a JSON kubeconfig, a ``Node``
    and the ``TpuSlice`` CRD; (b) the agent DaemonSet's and the manager
    Deployment's containers (``deploy/manifests.py`` rendered with
    ``config/default``'s patches, read as dicts:
    :func:`manifest_container`) run as processes: each command resolved
    through ``pyproject.toml``'s ``[project.scripts]``
    (``tpuslice-gpu-agent --backend=auto --metrics-bind-address=:8084
    --health-probe-bind-address=:8085`` with ``NODE_NAME`` and NVIDIA's
    runtime env; ``tpuslice-gpu-controller --leader-elect
    --metrics-bind-address=127.0.0.1:8080
    --health-probe-bind-address=:8081 --deletion-grace-seconds=30``),
    the registry's host path mapped to the phase's directory
    (``TPUSLICE_REGISTRY_DIR``), each bind address to a free port on
    127.0.0.1 and the grace to ``CONTROLLER_GRACE_S`` (values of flags
    the manifests carry, the mapping logged), the JSON kubeconfig in
    place of the in-cluster service account (``KUBECONFIG``): no flag the
    manifests do not carry. The agent publishes the node's CR and the controller takes the
    Lease; the seconds from each spawn to both probes answering 200 are
    logged; (c) a gated pod, the port's ``deploy/samples/test-pod.yaml``
    renamed, its MIG request replaced by ``nvidia.com/mig-3g.40gb: 1``
    where MIG is on, else ``nvidia.com/gpu: 1`` (the gate, the finalizer,
    the per-pod resource and ``envFrom`` its ConfigMap kept), is placed
    first-fit on ``gpu0`` in the node's CR, realized and ungated by the
    two processes alone, with ``Admitted``, ``Placed`` and ``Ungated`` in
    the controller's journal; (d) the smoke, as the scheduler, finds the
    pod's resource on the Node and binds the pod, and the workload
    (:func:`granted_workload`, in place of the sample's container)
    serves the serve phase's tokens on the ConfigMap's env; (e) a second
    pod that cannot fit beside it (``nvidia.com/gpu`` with MIG off,
    ``7g.80gb`` with MIG on) waits with ``NoCapacity`` and no record; (f)
    the first pod deleted is torn down after the grace (record deleted,
    then erased by the agent; ConfigMap, Node resource, reservation and
    pod gone) and the waiting pod is granted; (g) the controller is
    replaced by one armed to crash hard at ``controller.ungate``; the
    second pod deleted, a third is placed and realized, and the armed
    controller dies with its gate removed and its record ``created``; a
    new controller takes the Lease once the dead one's expires and brings
    the record to ``ungated`` without a second placement or reservation
    (its journal: ``Ungated`` for the pod, no ``Admitted`` or
    ``Placed``). The third pod deleted, nothing of the phase's is left:
    no reservation, MIG instance, ConfigMap or record. The phase reads MIG
    mode and never sets it; the device plugin stays out of this chain.
    Each process writes its trace and event files in ``sinks``
    (:class:`AgentProcess`), listed in ``out["sinks"]`` for
    :func:`phase_obs`."""
    import copy
    import shutil
    import tempfile

    from instaslice_tpu_torch.api.constants import (
        FINALIZER,
        GATE_NAME,
        GPU_RESOURCE,
        MIG_RESOURCE_PREFIX,
        POD_RESOURCE_PREFIX,
        REASON_ADMITTED,
        REASON_NO_CAPACITY,
        REASON_PLACED,
        REASON_UNGATED,
    )
    from instaslice_tpu_torch.api.crd import crd_manifest
    from instaslice_tpu_torch.api.types import (
        AllocationStatus,
        TpuSlice,
        slice_uuid_for,
    )
    from instaslice_tpu_torch.controller.runner import LEASE_NAME
    from instaslice_tpu_torch.device import NvmlBackend
    from instaslice_tpu_torch.kube import FakeKube, NotFound
    from instaslice_tpu_torch.kube.client import update_with_retry
    from instaslice_tpu_torch.kube.httptest import FakeApiServer
    from instaslice_tpu_torch.topology import Occupancy, get_policy, mig
    from instaslice_tpu_torch.topology.placement import Box

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="controller-"))
    ns = "instaslice-tpu-system"
    out = {}
    kube = FakeKube()
    srv = backend = None
    procs = []

    def get(kind, namespace, name):
        try:
            return kube.get(kind, namespace, name)
        except NotFound:
            return None

    def cr():
        obj = get("TpuSlice", ns, AGENT_NODE)
        return obj and TpuSlice.from_manifest(obj)

    def record(pod):
        """The pod's allocation record in the node's CR, or None."""
        ts = cr()
        found = [a for a in ts.spec.allocations.values()
                 if a.pods and a.pods[0].pod_name == pod] if ts else []
        return found[0] if found else None

    def gates(pod):
        obj = get("Pod", "default", pod)
        return obj and obj["spec"].get("schedulingGates")

    def events(proc, pod, reason=""):
        code, body = http_get(
            f"{proc.url}/v1/debug/events?n=1000&object=Pod/default/{pod}"
            + (f"&reason={reason}" if reason else ""))
        return [e["reason"] for e in body["events"]] if code == 200 else []

    def lease_holder():
        lease = get("Lease", ns, LEASE_NAME)
        return lease and lease["spec"].get("holderIdentity")

    def holds_lease(proc):
        return (lease_holder() or "").endswith(f"-{proc.proc.pid}")

    def controller(n, crash_at=""):
        p = AgentProcess(work, n, crash_at=crash_at, manifest="controller",
                         sinks=sinks)
        procs.append(p)
        return p

    def wait(fn, what, poll=0.01):
        return wait_until(fn, what, poll=poll, phase="controller")

    def sample_pod(name, request):
        """The port's sample pod (``deploy/samples/test-pod.yaml``, read
        as dicts) as ``name``, asking for ``request``: its per-pod
        resource and ``envFrom`` renamed with it, its MIG request
        replaced by ``request``, the status the apiserver adds."""
        from instaslice_tpu_torch.deploy.manifests import samples

        (pod,) = copy.deepcopy(samples()["test-pod.yaml"][1])
        old = pod["metadata"]["name"]
        pod["metadata"].update(name=name, namespace="default")
        (ctr,) = pod["spec"]["containers"]
        limits = ctr["resources"]["limits"]
        check(limits.pop(f"{POD_RESOURCE_PREFIX}{old}") == "1"
              and [k for k in limits if k.startswith(MIG_RESOURCE_PREFIX)]
              and ctr["envFrom"] == [{"configMapRef": {"name": old}}]
              and pod["spec"]["schedulingGates"] == [{"name": GATE_NAME}]
              and pod["metadata"]["finalizers"] == [FINALIZER],
              f"controller: the sample pod {pod}")
        ctr["resources"]["limits"] = {
            request: "1", f"{POD_RESOURCE_PREFIX}{name}": "1"}
        ctr["envFrom"] = [{"configMapRef": {"name": name}}]
        pod["status"] = {"phase": "Pending"}
        return pod

    try:
        # (a) the apiserver, its kubeconfig, the Node and the CRD
        srv = FakeApiServer(kube).start()
        srv.handler.token_validator = lambda t: t == AGENT_TOKEN
        (work / "kubeconfig.json").write_text(json.dumps({
            "apiVersion": "v1", "kind": "Config",
            "current-context": "smoke",
            "clusters": [{"name": "smoke", "cluster": {"server": srv.url}}],
            "users": [{"name": "smoke", "user": {"token": AGENT_TOKEN}}],
            "contexts": [{"name": "smoke", "context": {
                "cluster": "smoke", "user": "smoke"}}]}))
        kube.create("Node", {"apiVersion": "v1", "kind": "Node",
                             "metadata": {"name": AGENT_NODE},
                             "status": {"capacity": {}, "allocatable": {}}})
        kube.create("CustomResourceDefinition", crd_manifest())
        backend = NvmlBackend(registry_dir=str(work / "reg"))
        inv = backend.discover()
        mig_on = inv.gpus[0].mig_current == 1
        before_inst = {r.device_uuids for r in backend.instances()}
        gen = mig.grid_generation(inv.generation)
        request = (MIG_RESOURCE_PREFIX + SLICE_MIG_PROFILE if mig_on
                   else GPU_RESOURCE)
        blocker = MIG_RESOURCE_PREFIX + "7g.80gb" if mig_on else GPU_RESOURCE
        log(f"controller (a): apiserver {srv.url} (bearer token), Node "
            f"{AGENT_NODE}, CRD {crd_manifest()['metadata']['name']}; "
            f"NVML: {inv.chip_count} GPU(s), generation {inv.generation!r}, "
            f"MIG current {inv.gpus[0].mig_current}; the pods ask for "
            f"{request}, the waiting one for {blocker}")

        # (b) the agent and the controller, each in a fresh process
        agent = AgentProcess(work, 0, manifest="agent", sinks=sinks)
        procs.append(agent)
        ctl = controller(1)
        for p in (agent, ctl):
            m = p.manifest
            log(f"controller (b): {m['workload']}: {m['command'][0]} -> "
                f"{m['target']} {' '.join(m['args'])}; env "
                f"{m['env']}; host paths {m['paths']}; binds {m['binds']}")
        t = first_times({
            "agent_probe": lambda: agent.probes_up("controller"),
            "controller_probe": lambda: ctl.probes_up("controller"),
            "cr": lambda: cr() is not None,
            "lease": lambda: holds_lease(ctl)},
            "the agent's CR, the controller's Lease and both probes",
            agent.t0)
        ts = cr()
        lag = ctl.t0 - agent.t0
        out["probe_s"] = {"agent": t["agent_probe"],
                          "controller": t["controller_probe"] - lag}
        out["boot_to_cr_s"] = t["cr"]
        out["boot_to_lease_s"] = t["lease"] - lag
        check(ts.spec.generation == gen and ts.spec.torus_group == AGENT_NODE,
              f"controller: CR {ts.spec.generation} {ts.spec.torus_group}")
        log(f"controller (b): the agent's CR {ns}/{AGENT_NODE} ({gen}, "
            f"chips {ts.spec.chips}) {out['boot_to_cr_s']:.2f} s after its "
            f"spawn; the controller (pid {ctl.proc.pid}) holds Lease "
            f"{LEASE_NAME} {out['boot_to_lease_s']:.2f} s after its spawn; "
            f"spawn to /healthz and /readyz 200: agent "
            f"{out['probe_s']['agent']:.3f} s, controller "
            f"{out['probe_s']['controller']:.3f} s, on {card}")

        # (c) a gated pod, granted by the two processes alone
        group = mig.gpu_group(len(ts.spec.chips), gen, group_id=AGENT_NODE)
        occ = Occupancy(group)
        for prep in ts.spec.prepared.values():
            occ.occupy(Box.from_key(prep.box))
        want = mig.parse_mig_profile(request, gen)
        pl = get_policy("first-fit").choose(group, want, occ)
        check(pl is not None, f"controller: no free {want.name}")
        t0 = time.perf_counter()
        kube.create("Pod", sample_pod("ctl-pod", request))
        t = first_times({
            "record": lambda: record("ctl-pod") is not None,
            "configmap": lambda: get("ConfigMap", "default", "ctl-pod"),
            "ungate": lambda: gates("ctl-pod") == []}, "the grant", t0)
        out["create_to_record_ms"] = t["record"] * 1e3
        out["create_to_configmap_ms"] = t["configmap"] * 1e3
        out["time_to_grant_ms"] = t["ungate"] * 1e3
        a = wait(lambda: (lambda r: r if r and r.status
                          == AllocationStatus.UNGATED else None)(
            record("ctl-pod")), "the record ungated")
        check(list(a.parts) == ["gpu0"] and a.box == pl.box.key()
              and a.profile == want.name and a.realized_on == ["gpu0"]
              and a.torus_group == AGENT_NODE,
              f"controller: record {a.to_dict()}, first-fit {pl.box.key()}")
        suid = slice_uuid_for(a.alloc_id)
        (res,) = [r for r in backend.list_reservations()
                  if r.slice_uuid == suid]
        cm = get("ConfigMap", "default", "ctl-pod")["data"]
        granted = cm["CUDA_VISIBLE_DEVICES"]
        check(granted == res.device_uuids[0] and len(res.device_uuids) == 1
              and "," not in granted, f"controller: ConfigMap grants "
              f"{granted}, reservation {res}")
        evs = wait(lambda: (lambda e: e if {REASON_ADMITTED, REASON_PLACED,
                                            REASON_UNGATED} <= set(e)
                            else None)(events(ctl, "ctl-pod")),
                   "Admitted, Placed and Ungated")
        pod = get("Pod", "default", "ctl-pod")
        check(pod["metadata"]["finalizers"] == [FINALIZER],
              f"controller: finalizers {pod['metadata']['finalizers']}")
        out["grant"] = {"profile": a.profile, "box": a.box,
                        "parts": list(a.parts), "uuid": granted,
                        "events": evs}
        log(f"controller (c): ctl-pod ({request}) placed {a.profile} at "
            f"{a.box} (part gpu0, first-fit) in {AGENT_NODE}'s CR "
            f"{out['create_to_record_ms']:.1f} ms after its create, its "
            f"ConfigMap at {out['create_to_configmap_ms']:.1f} ms "
            f"(CUDA_VISIBLE_DEVICES={granted}), the gate removed at "
            f"{out['time_to_grant_ms']:.1f} ms (time to grant) on {card}; "
            f"the controller's journal for it: {evs}")

        # (c2) the operator CLI against the live apiserver
        out["ctl"] = ctl_status_describe(
            work / "kubeconfig.json", ns, gen, a, "ctl-pod")

        # (d) the scheduler's part, and the workload
        resname = f"{POD_RESOURCE_PREFIX}ctl-pod"
        node = kube.get("Node", "", AGENT_NODE)["status"]
        check(node["capacity"].get(resname) == "1"
              and node["allocatable"].get(resname) == "1",
              f"controller: the Node's {resname}: {node}")

        def bind(obj):
            obj["spec"]["nodeName"] = AGENT_NODE
            obj["status"]["phase"] = "Running"
            return obj

        update_with_retry(kube, "Pod", "default", "ctl-pod", bind)
        w, same, lp = granted_workload(out, work, cm, granted, served,
                                       "controller")
        log(f"controller (d): bound to {AGENT_NODE} ({resname}=1 on the "
            f"Node); the workload on the ConfigMap's env: torch sees "
            f"{w['count']} device, uuid {w['uuid']}; first burst "
            f"{w['tok_s']:.1f} tok/s, second {w['warm_tok_s']:.1f} on "
            f"{card}; tokens equal to the serve phase's {same}, largest "
            f"logprob difference {lp:.3g}; launches on the card's trace "
            f"{w['counts']}; the process {out['workload_s']:.1f} s")

        # (e) a pod that cannot fit waits
        kube.create("Pod", sample_pod("ctl-wait", blocker))
        wait(lambda: REASON_NO_CAPACITY in events(ctl, "ctl-wait"),
             "NoCapacity for ctl-wait", poll=0.05)
        check(record("ctl-wait") is None and gates("ctl-wait"),
              "controller: ctl-wait waits gated, without a record")
        log(f"controller (e): ctl-wait ({blocker}) NoCapacity, gated, no "
            "record")

        # (f) teardown by deletion, and the waiting pod's grant
        t0 = time.perf_counter()
        kube.delete("Pod", "default", "ctl-pod")
        t = first_times({
            "deleted": lambda: (lambda r: r is None or r.status
                                == AllocationStatus.DELETED)(
                record("ctl-pod")),
            "erased": lambda: record("ctl-pod") is None,
            "pod_gone": lambda: get("Pod", "default", "ctl-pod") is None,
            "configmap_gone": lambda: get("ConfigMap", "default",
                                          "ctl-pod") is None,
            "waiting_granted": lambda: gates("ctl-wait") == []},
            "the teardown and the waiting pod's grant", t0)
        out["delete_to_erased_ms"] = (t["erased"] - CONTROLLER_GRACE_S) * 1e3
        out["delete_to_pod_gone_ms"] = (t["pod_gone"]
                                        - CONTROLLER_GRACE_S) * 1e3
        out["delete_to_waiting_grant_ms"] = t["waiting_granted"] * 1e3
        node = kube.get("Node", "", AGENT_NODE)["status"]
        check(resname not in node["capacity"],
              f"controller: the Node's {resname} is removed: {node}")
        check(t["deleted"] >= CONTROLLER_GRACE_S,
              f"controller: torn down {t['deleted']:.3f} s after the "
              f"delete, inside the grace of {CONTROLLER_GRACE_S} s")
        check(not [r for r in backend.list_reservations()
                   if r.slice_uuid == suid],
              "controller: ctl-pod's reservation released")
        b = wait(lambda: (lambda r: r if r and r.status
                          == AllocationStatus.UNGATED else None)(
            record("ctl-wait")), "ctl-wait's record ungated")
        log(f"controller (f): ctl-pod deleted: record deleted "
            f"{t['deleted'] * 1e3:.1f} ms and erased "
            f"{t['erased'] * 1e3:.1f} ms after the delete (grace "
            f"{CONTROLLER_GRACE_S} s), pod gone at "
            f"{t['pod_gone'] * 1e3:.1f} ms, ConfigMap, Node resource and "
            f"reservation gone; ctl-wait granted {b.profile} at {b.box} "
            f"{out['delete_to_waiting_grant_ms']:.1f} ms after the delete")

        # (g) a controller killed at controller.ungate, and its successor
        code = ctl.stop()
        check(code == 0, f"controller: SIGTERM exit {code}: {ctl.tail()}")
        armed = controller(2, crash_at="controller.ungate")
        t = first_times({"probe": lambda: armed.probes_up("controller"),
                         "lease": lambda: holds_lease(armed)},
                        "the armed controller's Lease and probes", armed.t0)
        out["probe_s"]["armed_controller"] = t["probe"]
        kube.delete("Pod", "default", "ctl-wait")
        wait(lambda: record("ctl-wait") is None
             and get("Pod", "default", "ctl-wait") is None,
             "ctl-wait torn down")
        kube.create("Pod", sample_pod("ctl-crash", request))
        code = armed.proc.wait(timeout=AGENT_WAIT_S)
        t_dead = time.perf_counter()
        check(code == 17, f"controller: the armed controller exit {code} "
              f"(want 17): {armed.tail()}")
        c = record("ctl-crash")
        check(gates("ctl-crash") == [] and c is not None
              and c.status == AllocationStatus.CREATED,
              f"controller: the crash left gates {gates('ctl-crash')}, "
              f"record {c and c.status}")
        succ = controller(3)
        t = first_times({"lease": lambda: holds_lease(succ),
                         "probe": lambda: succ.probes_up("controller")},
                        "the successor's Lease and probes", succ.t0)
        out["failover_s"] = succ.t0 + t["lease"] - t_dead
        out["successor_start_to_lease_s"] = t["lease"]
        out["probe_s"]["successor"] = t["probe"]
        c2 = wait(lambda: (lambda r: r if r and r.status
                           == AllocationStatus.UNGATED else None)(
            record("ctl-crash")), "ctl-crash's record ungated")
        reserved = backend.list_reservations()
        check(c2.attempt_epoch == c.attempt_epoch and c2.box == c.box
              and len(reserved) == 1
              and reserved[0].slice_uuid == slice_uuid_for(c.alloc_id),
              f"controller: the successor re-placed or re-reserved: "
              f"{c2.to_dict()}, {reserved}")
        evs = wait(lambda: (lambda e: e if REASON_UNGATED in e else None)(
            events(succ, "ctl-crash")), "the successor's Ungated")
        check(REASON_ADMITTED not in evs and REASON_PLACED not in evs,
              f"controller: the successor placed ctl-crash again: {evs}")
        out["recovery"] = {"record": c2.status.value, "box": c2.box,
                           "reservations": len(reserved), "events": evs}
        log(f"controller (g): armed at controller.ungate, the controller "
            f"exited 17 with ctl-crash's gate removed and its record "
            f"created; the successor took the Lease "
            f"{out['failover_s']:.2f} s after the death "
            f"({out['successor_start_to_lease_s']:.2f} s after its own "
            f"start) and brought the record to ungated at {c2.box}, one "
            f"reservation in the registry; its journal for ctl-crash: {evs}; "
            f"spawn to /healthz and /readyz 200: armed "
            f"{out['probe_s']['armed_controller']:.3f} s, successor "
            f"{out['probe_s']['successor']:.3f} s")
        kube.delete("Pod", "default", "ctl-crash")
        wait(lambda: record("ctl-crash") is None
             and get("Pod", "default", "ctl-crash") is None,
             "ctl-crash torn down")
        left = {r.device_uuids for r in backend.instances()}
        check(not backend.list_reservations() and left == before_inst
              and not kube.list("ConfigMap")
              and not cr().spec.allocations,
              f"controller: left behind reservations "
              f"{backend.list_reservations()}, MIG instances {left}, "
              f"ConfigMaps {kube.list('ConfigMap')}, records "
              f"{list(cr().spec.allocations)}")
        for p in (succ, agent):
            code = p.stop()
            check(code == 0, f"controller: SIGTERM exit {code}: {p.tail()}")
        out["sinks"] = {
            kind: {p.log.stem: str(getattr(p, f"{kind}_file"))
                   for p in procs if getattr(p, f"{kind}_file")}
            for kind in ("trace", "event")}
        out["numbers"] = {
            "card": card,
            "time_to_grant_ms": out["time_to_grant_ms"],
            "create_to_record_ms": out["create_to_record_ms"],
            "create_to_configmap_ms": out["create_to_configmap_ms"],
            "delete_to_erased_ms": out["delete_to_erased_ms"],
            "delete_to_pod_gone_ms": out["delete_to_pod_gone_ms"],
            "delete_to_waiting_grant_ms": out["delete_to_waiting_grant_ms"],
            "failover_s": out["failover_s"],
            "spawn_to_probe_s": out["probe_s"],
            "first_burst_tok_s": w["tok_s"],
            "second_burst_tok_s": w["warm_tok_s"]}
        log("controller: " + json.dumps(out["numbers"]))
    finally:
        # a failed step still stops what the phase started and gives
        # back what it reserved
        for p in procs:
            p.stop()
        if backend is not None:
            for r in backend.list_reservations():
                backend.release(r.slice_uuid)
            backend.close()
        if srv is not None:
            srv.stop()
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"controller: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------- trace and event files

def phase_obs(migrate_sinks: dict, kill_sinks: dict,
              controller_sinks: dict, work: Path) -> dict:
    """The port's validators (``analysis/validate_trace.py``,
    ``validate_events.py``) on the files the migrate phase (its two 7B
    int8 servers, its router and its engines: one process), the kill
    phase (its router in this process, the survivor and the fresh
    replica each a process of its own) and the controller phase (the
    node agent and each controller, a process each) wrote. (a) Each trace
    file alone passes ``validate`` (no process's span names a parent in
    another's file); (b) ``--fleet``: the store of every trace file
    merged has no orphan, the propagation contract holds over it
    (``check_propagation``: a trace links ``controller.allocate``,
    ``device.reserve`` and ``controller.ungate``; every ``serve.request``
    root has children), a grant's trace crosses a controller's file and
    the agent's, and a request's trace crosses the kill phase's router
    file (``router.route``) and a replica process's (``serve.request``);
    (c) each event file alone passes ``read_events``
    (parse, fields, the reason catalog, unique ``seq``), and the
    allocation chains of all of them merged by time pass ``check_chains``
    strictly (a grant's chain is written by the controller and the agent
    in turn); the fleet file holds the migrate phase's drain; (d) the
    control: a copy of the agent's trace file with one span's parent
    renamed is refused alone and in the merged store."""
    from collections import Counter

    from instaslice_tpu_torch.analysis import validate_events as ve
    from instaslice_tpu_torch.analysis import validate_trace as vt
    from instaslice_tpu_torch.api.constants import (
        REASON_DRAIN_BEGIN,
        REASON_DRAIN_END,
        TRANSITION_REASONS,
    )

    t0 = time.perf_counter()
    traces = {**migrate_sinks["trace"], **kill_sinks["trace"],
              **controller_sinks["trace"]}
    events = {**migrate_sinks["event"], **kill_sinks["event"],
              **controller_sinks["event"]}
    check(any(n.startswith("agent") for n in traces)
          and any(n.startswith("controller") for n in traces)
          and {"fleet", "chaos_router", "chaos_survivor", "chaos_fresh"}
          <= set(traces), f"obs: trace files {sorted(traces)}")
    out = {"trace_files": {}, "event_files": {}}
    spans, by_file = [], {}
    # (a)
    for name, path in traces.items():
        rep = vt.validate(path)
        check(not rep["errors"] and rep["spans"] > 0,
              f"obs (a): {name}'s trace file: {rep['spans']} spans, "
              f"errors {rep['errors'][:5]}")
        out["trace_files"][name] = {"spans": rep["spans"],
                                    "traces": rep["traces"]}
        by_file[name] = rep["_spans"]
        spans += rep["_spans"]
    # (b)
    fleet = vt.check_fleet(list(traces.values()))
    merged = {"_spans": spans, "errors": []}
    vt.check_propagation(merged)
    check(fleet["orphans"] == 0 and fleet["spans_ingested"] == len(spans)
          and not merged["errors"],
          f"obs (b): --fleet over {len(traces)} files: {fleet}, "
          f"propagation {merged['errors'][:5]}")
    allocated = {s["traceId"] for n, ss in by_file.items()
                 if n.startswith("controller") for s in ss
                 if s["name"] == "controller.allocate"}
    reserved = {s["traceId"] for n, ss in by_file.items()
                if n.startswith("agent") for s in ss
                if s["name"] == "device.reserve"}
    crossing = sorted(allocated & reserved)
    check(crossing, f"obs (b): no grant trace crosses a controller's file "
          f"and the agent's: allocate {sorted(allocated)}, reserve "
          f"{sorted(reserved)}")
    routed = {s["traceId"] for s in by_file["chaos_router"]
              if s["name"] == "router.route"}
    served = {s["traceId"] for n in ("chaos_survivor", "chaos_fresh")
              for s in by_file[n] if s["name"] == "serve.request"}
    serving = sorted(routed & served)
    check(serving, f"obs (b): no serving trace crosses the router's file "
          f"and a replica process's: {len(routed)} routed, {len(served)} "
          f"served")
    out["fleet"] = {k: fleet[k] for k in ("files", "spans_ingested",
                                          "traces", "orphans")}
    out["grant_traces_across_files"] = len(crossing)
    out["serving_traces_across_files"] = len(serving)
    # (c)
    merged_ev = []
    for i, (name, path) in enumerate(events.items()):
        got, errors = ve.read_events(path)
        check(got and not errors, f"obs (c): {name}'s event file: "
              f"{len(got)} events, errors {errors[:5]}")
        out["event_files"][name] = dict(Counter(e["reason"] for e in got))
        merged_ev += [((e["ts"], i, e["seq"]), e) for e in got]
    # seq counts per process: the merged journal is ordered by time and
    # numbered anew (check_chains orders an allocation's events by seq)
    merged_ev = [dict(e, seq=n) for n, (_, e) in enumerate(
        sorted(merged_ev, key=lambda x: x[0]), 1)]
    chains = ve.check_chains(merged_ev, strict=True)
    ungated = {e["objectRef"] for e in merged_ev
               if e["reason"] == TRANSITION_REASONS["ungated"]}
    check(not chains and len(ungated) >= 3,
          f"obs (c): merged chains strict: {chains[:5]}; grants "
          f"{sorted(ungated)}")
    drains = out["event_files"]["fleet"]
    check(drains.get(REASON_DRAIN_BEGIN) and drains.get(REASON_DRAIN_END),
          f"obs (c): the fleet file's drain: {drains}")
    out["granted_chains"] = len(ungated)
    # (d)
    agent = next(n for n in traces if n.startswith("agent"))
    recs = [json.loads(line) for line in open(traces[agent])
            if line.strip()]
    child = next(r for r in recs if r.get("parentId"))
    child["parentId"] = "f" * 16
    bad = work / f"{agent}.orphan.trace.jsonl"
    bad.write_text("".join(json.dumps(r) + "\n" for r in recs))
    alone = vt.validate(str(bad))["errors"]
    refused = vt.check_fleet([str(bad) if p == traces[agent] else p
                              for p in traces.values()])
    check(any(e.startswith("orphan span ") for e in alone)
          and refused["orphans"] == 1,
          f"obs (d): the corrupted copy passed: alone {alone[:3]}, "
          f"merged {refused['orphans']} orphans")
    out["control"] = {"alone": len(alone), "merged_orphans":
                      refused["orphans"]}
    out["seconds"] = time.perf_counter() - t0
    log(f"obs: trace files {out['trace_files']}; --fleet {out['fleet']}, "
        f"{len(crossing)} grant trace(s) across a controller's file and "
        f"the agent's, {len(serving)} serving trace(s) across the kill "
        f"phase's router file and a replica's; event files {out['event_files']}; merged chains "
        f"strict over {out['granted_chains']} grants; the control (one "
        f"orphan parent in a copy of {agent}'s trace file) refused alone "
        f"and merged; the step {out['seconds']:.2f} s")
    return out


# -------------------------------------------------------------------- ctl

#: the keys of the reference's ``serve-bench`` JSON line
#: (``instaslice_tpu/cli/tpuslicectl.py:49-67``; ``spec_tokens_per_round``
#: with ``--spec`` only). The port's line must have exactly these
CTL_BENCH_KEYS = ("metric", "unit", "backend", "batch", "quantized",
                  "speculative", "model", "value")
#: ``tpuslice-gpu serve-bench`` at the 871M configuration's full widths
#: and depth (``instaslice_tpu/bench_tpu.py:341-352``, MHA: 16 KV heads),
#: batch 8, the engine's max_len and prefill of the serving phases; the
#: reference's default of 30 timed steps (or rounds)
CTL_BENCH_FLAGS = ("serve-bench --vocab 32000 --d-model 2048 --n-heads 16 "
                   "--n-kv-heads 16 --n-layers 16 --d-ff 8192 --batch 8 "
                   "--max-len 1024 --prefill-len 128")
#: the 871M's decode forward: B1 once a layer, B2 six times a layer (wq,
#: wk, wv, wo, w_in, w_out), B3 once (the unembedding)
CTL_LAYERS = 16


def ctl_cli(argv: list) -> tuple:
    """``tpuslice-gpu`` in this process: (exit code, stdout, ms)."""
    import contextlib
    import io

    from instaslice_tpu_torch.cli import tpuslicectl

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = tpuslicectl.main(argv)
    return rc, buf.getvalue(), (time.perf_counter() - t0) * 1e3


def ctl_status_describe(kubeconfig: Path, ns: str, gen: str, alloc,
                        pod: str) -> dict:
    """The controller phase's (c2): ``tpuslice-gpu status --json`` and
    ``describe pod --json`` against the phase's live apiserver while
    ``pod`` is granted (``alloc`` its ungated record): one node of the
    card's generation, one slice (the record's profile and box,
    ``ungated``, realized 1/1, the pod), and a timeline holding
    ``Admitted``, ``Placed`` and ``Ungated`` in that order."""
    from instaslice_tpu_torch.api.constants import (
        REASON_ADMITTED,
        REASON_PLACED,
        REASON_UNGATED,
    )

    rc, text, st_ms = ctl_cli(["status", "--kubeconfig", str(kubeconfig),
                               "--namespace", ns, "--json"])
    check(rc == 0, f"controller: status exit {rc}: {text}")
    st = json.loads(text)
    check([(n["node"], n["generation"]) for n in st["nodes"]]
          == [(AGENT_NODE, gen)], f"controller: status nodes {st['nodes']}")
    check(len(st["slices"]) == 1, f"controller: status slices {st}")
    sl = st["slices"][0]
    got = (sl["profile"], sl["box"], sl["status"],
           f"{len(sl['realizedOn'])}/{sl['parts']}", sl["pods"])
    want = (alloc.profile, alloc.box, "ungated", "1/1", [pod])
    check(got == want, f"controller: status slice {got}, want {want}")
    rc, text, de_ms = ctl_cli(["describe", "pod", pod, "--kubeconfig",
                               str(kubeconfig), "--operator-namespace", ns,
                               "--json"])
    check(rc == 0, f"controller: describe exit {rc}: {text}")
    info = json.loads(text)
    reasons = [t["reason"] for t in info["timeline"]]
    order = [reasons.index(r) if r in reasons else -1
             for r in (REASON_ADMITTED, REASON_PLACED, REASON_UNGATED)]
    check(min(order) >= 0 and order == sorted(order)
          and info["allocation"]["id"] == alloc.alloc_id,
          f"controller: describe timeline {reasons}, allocation "
          f"{info['allocation']}")
    log(f"controller (c2): tpuslice-gpu status --json {st_ms:.1f} ms: "
        f"{AGENT_NODE} ({gen}), slice {sl['profile']} at {sl['box']} "
        f"{sl['status']}, realized {got[3]}, pods {sl['pods']}; describe "
        f"pod {pod} --json {de_ms:.1f} ms: timeline {reasons}")
    return {"status_ms": st_ms, "describe_ms": de_ms, "slice": sl,
            "timeline": reasons}


def ctl_bench(torch, ops, extra: str) -> dict:
    """``tpuslice-gpu serve-bench`` (:data:`CTL_BENCH_FLAGS` plus
    ``extra``) in this process, its launches from the card's trace over
    the whole command, and the engine it built (recorded as the command
    makes it) for the counts the engine's code implies."""
    from instaslice_tpu_torch import serving

    made = []
    base = serving.ServingEngine

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    serving.ServingEngine = Recorded
    t0 = time.perf_counter()
    try:
        ops.reset_launch_counts()
        with Traced(torch, ops) as tr:
            rc, text, _ = ctl_cli((CTL_BENCH_FLAGS + " " + extra).split())
    finally:
        serving.ServingEngine = base
    secs = time.perf_counter() - t0
    check(rc == 0 and len(made) == 1,
          f"ctl: serve-bench {extra} exit {rc}, {len(made)} engine(s)")
    line = json.loads(text.strip().splitlines()[-1])
    keys = set(CTL_BENCH_KEYS) | ({"spec_tokens_per_round"}
                                  if "--spec" in extra else set())
    check(set(line) == keys and line["backend"] == "cuda"
          and line["value"] > 0, f"ctl: serve-bench {extra} line {line}")
    eng = made[0]
    out = {"line": line, "counts": tr.counts, "seconds": secs,
           "decode_steps": eng.decode_steps,
           "prefill_chunks": eng.prefill_dispatches,
           "graphs": sorted(str(k) for k in eng._graphs),
           "replays": {str(k): n for k, n in eng.graph_replays.items()}}
    del eng, made
    free_memory(torch)
    return out


def phase_ctl(torch, ops, controller: dict) -> dict:
    """The operator CLIs on the card: (a) ``tpuslice-gpu serve-bench`` at
    the 871M configuration (:data:`CTL_BENCH_FLAGS`), first
    ``--quantize`` (int8 weights and KV: B1, B2 and B3 on every decode
    forward, B2 and B3 on every prefill chunk), then ``--spec`` (the bf16
    target with its int8 self-draft at spec_k 4: B2 and B3 on every draft
    forward, no B1): each JSON line with the reference's keys, backend
    ``cuda``, tok/s above 0, and the launches on the card's trace equal
    to what the engine's code runs for the steps it ran; (b) the
    controller phase's ``status`` and ``describe`` readings; (c) ``python
    -m instaslice_tpu_torch.cli.demo --transport http`` in a fresh
    process: exit 0 and its last line ``{"demo": "ok", ...}``, its
    grant on the fake GPU backend (host work, no device)."""
    import os

    t_phase = time.perf_counter()
    L, out = CTL_LAYERS, {}
    # (a) --quantize. A decode block replays its step's captured graph
    # once a step (decode_steps counts them), and each capture first runs
    # the step once for real (its warm-up): decode forwards F = steps +
    # captures; each admission of a 3-token prompt is one 128-row chunk
    # (prefill_chunks P). B1 = L * F, B2 = 6 * L * (F + P), B3 = F + P
    q = ctl_bench(torch, ops, "--quantize")
    caps = [g for g in q["graphs"] if "decode_block" in g]
    F = q["decode_steps"] + len(caps)
    P = q["prefill_chunks"]
    want = {"quant_decode_attention": L * F,
            "quant_matmul_stacked": 6 * L * (F + P),
            "quant_matmul_t": F + P, "quant_matmul": 0,
            **{k: 0 for k in FLASH}}
    # throughput(30): 8 admissions, a warm block and a timed block of
    # min(30, (1024 - 2 - 3) // 2) = 30 steps, one attend bucket (256)
    check(q["decode_steps"] == 60 and P == 8 and len(caps) == 1,
          f"ctl: --quantize ran {q['decode_steps']} decode steps, {P} "
          f"chunks, graphs {q['graphs']} (want 60, 8, one)")
    check(q["counts"] == want, f"ctl: --quantize launches {q['counts']}, "
          f"want {want} (B1 = {L} x {F}, B2 = {6 * L} x ({F} + {P}), "
          f"B3 = {F} + {P})")
    log(f"ctl (a) serve-bench --quantize on the card: "
        f"{q['line']['value']} tok/s at batch 8; {q['decode_steps']} "
        f"decode steps + {len(caps)} capture warm-up, {P} prefill chunks; "
        f"launches (trace) {q['counts']} = B1 {L} x {F}, B2 {6 * L} x "
        f"({F} + {P}), B3 {F} + {P}; {q['seconds']:.1f} s")
    # (a) --spec. A round of depth k runs k + 1 draft forwards (int8: B2,
    # B3) and one bf16 verify forward (no kernel); each captured round
    # key ran once for real before its capture, and each admission runs
    # one draft chunk: D = P + sum over round keys of (replays + 1)(k + 1)
    # (a key's capture is followed by its first replay). B2 = 6 L D,
    # B3 = D, B1 none (no cache is int8)
    sp = ctl_bench(torch, ops, "--spec")
    rounds = {}
    for key, n in sp["replays"].items():
        if "spec_round" in key:
            k = int(re.search(r"'spec_round', (\d+)", key).group(1))
            rounds[key] = (n, k)
    D = sp["prefill_chunks"] + sum((n + 1) * (k + 1)
                                   for n, k in rounds.values())
    want = {"quant_decode_attention": 0,
            "quant_matmul_stacked": 6 * L * D, "quant_matmul_t": D,
            "quant_matmul": 0, **{k: 0 for k in FLASH}}
    per = sp["line"]["spec_tokens_per_round"]
    check(len(rounds) == len([g for g in sp["graphs"] if "spec_round" in g])
          and sum(n for n, _ in rounds.values()) == 31,
          f"ctl: --spec rounds {rounds}, graphs {sp['graphs']} (want 31 "
          "replays: one warm round and 30 timed)")
    check(sp["counts"] == want, f"ctl: --spec launches {sp['counts']}, "
          f"want {want} (D = {D} draft forwards)")
    check(1.0 <= per <= 5.0, f"ctl: --spec tokens per round {per} "
          "outside [1, 5]")
    log(f"ctl (a) serve-bench --spec on the card: {sp['line']['value']} "
        f"tok/s at batch 8, {per} tokens per round; rounds by key "
        f"(replays, k) {list(rounds.values())}; {D} draft forwards; "
        f"launches (trace) {sp['counts']} = B2 {6 * L} x {D}, B3 {D}; "
        f"{sp['seconds']:.1f} s")
    out["serve_bench"] = {"quantize": q, "spec": sp}
    # (b)
    out["status_describe"] = controller["ctl"]
    # (c)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "instaslice_tpu_torch.cli.demo",
         "--transport", "http"], cwd=HERE, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(HERE)))
    demo_s = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines else {}
    check(res.returncode == 0 and last.get("demo") == "ok"
          and set(last) == {"demo", "grant_seconds"}
          and any("CUDA_VISIBLE_DEVICES=" in x for x in lines),
          f"ctl: demo exit {res.returncode}: {res.stdout[-2000:]} "
          f"{res.stderr[-2000:]}")
    out["demo"] = {"grant_seconds": last["grant_seconds"],
                   "process_s": demo_s}
    log(f"ctl (c) demo --transport http in a fresh process: grant "
        f"{last['grant_seconds']} s on the fake GPU backend (host work, "
        f"no device), the process {demo_s:.1f} s")
    out["counts"] = {"quantize": q["counts"], "spec": sp["counts"]}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"ctl: {out['seconds']:.1f} s")
    return out


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
    timings, held = {}, {}

    def mark(name: str, t0: float) -> None:
        """A phase's seconds; then, its garbage collected, the GiB still
        allocated after it (what a phase leaves behind raises every
        later phase's peak reading)."""
        timings[name] = time.perf_counter() - t0
        free_memory(torch)
        held[name] = round(torch.cuda.memory_allocated() / 2 ** 30, 2)

    t0 = time.perf_counter()
    phase_build(build)
    mark("build", t0)
    t0 = time.perf_counter()
    gates = phase_gates()
    mark("gates", t0)
    import shutil
    import tempfile

    sinks = Path(tempfile.mkdtemp(prefix="smoke-obs-"))

    t0 = time.perf_counter()
    cfg = ModelConfig(vocab_size=32000, d_model=4096, n_heads=32,
                      n_kv_heads=8, n_layers=32, d_ff=20480,
                      max_seq_len=2048, dtype=torch.bfloat16, remat=False)
    qp = quantize_params(init_params(cfg, 0))
    torch.cuda.synchronize()
    mark("init", t0)
    log(f"init: 7B int8 weights in {timings['init']:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")

    t0 = time.perf_counter()
    kernels = phase_kernels(torch, cfg, qp, ops)
    mark("kernels", t0)
    t0 = time.perf_counter()
    eng = phase_engine(torch, cfg, qp, ops)
    mark("engine", t0)
    t0 = time.perf_counter()
    graph = phase_graph(torch, cfg, qp, ops)
    mark("graph", t0)
    t0 = time.perf_counter()
    phase_cut(torch, cfg, qp)
    mark("cut", t0)
    del qp
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve = phase_serve(torch, ops)
    mark("serve", t0)
    t0 = time.perf_counter()
    spec = phase_spec(torch, ops)
    mark("spec", t0)
    t0 = time.perf_counter()
    migrate = phase_migrate(torch, ops, sinks)
    mark("migrate", t0)
    t0 = time.perf_counter()
    kill = phase_kill(torch, sinks)
    mark("kill", t0)
    t0 = time.perf_counter()
    lora_serve = phase_lora_serve(torch, ops)
    mark("lora_serve", t0)
    t0 = time.perf_counter()
    window = phase_window(torch, ops)
    mark("window", t0)
    t0 = time.perf_counter()
    int4 = phase_int4(torch, ops)
    mark("int4", t0)

    t0 = time.perf_counter()
    train_kernels = phase_train_kernels(torch, ops.flash_attention)
    mark("train_kernels", t0)
    t0 = time.perf_counter()
    bf16_cut = phase_bf16_cut(torch, ops)
    mark("bf16_cut", t0)
    t0 = time.perf_counter()
    train = phase_train(torch, ops)
    mark("train", t0)
    t0 = time.perf_counter()
    moe = phase_moe(torch, ops)
    mark("moe", t0)
    t0 = time.perf_counter()
    cli = phase_cli(torch, ops)
    mark("cli", t0)
    t0 = time.perf_counter()
    cut = phase_train_cut(torch, train_config(
        torch, n_layers=TRAIN_CUT_LAYERS, dtype=torch.float32,
        param_dtype=None), rows=TRAIN_CUT_ROWS)
    mark("train_cut", t0)
    t0 = time.perf_counter()
    lora_train = phase_lora_train(torch, ops, train)
    mark("lora_train", t0)
    t0 = time.perf_counter()
    parallel = phase_parallel(torch, ops)
    mark("parallel", t0)
    t0 = time.perf_counter()
    tp_serve = phase_tp_serve(torch, ops, cfg)
    mark("tp_serve", t0)
    t0 = time.perf_counter()
    parallel_rest = phase_parallel_rest(torch, ops, lora_serve.pop("served"))
    mark("parallel_rest", t0)
    served = serve.pop("served")
    t0 = time.perf_counter()
    slice_ = phase_slice(torch, card, served)
    mark("slice", t0)
    t0 = time.perf_counter()
    agent = phase_agent(torch, card, served)
    mark("agent", t0)
    t0 = time.perf_counter()
    controller = phase_controller(torch, card, served, sinks)
    mark("controller", t0)
    t0 = time.perf_counter()
    obs = phase_obs(migrate.pop("sinks"), kill.pop("sinks"),
                    controller.pop("sinks"), sinks)
    shutil.rmtree(sinks, ignore_errors=True)
    mark("obs", t0)
    t0 = time.perf_counter()
    ctl = phase_ctl(torch, ops, controller)
    mark("ctl", t0)
    timings["total"] = time.perf_counter() - t_all
    log(f"trace: the end marker's margin {trace_margins()}")

    # launches: each kernel's count from the main path that runs it (the
    # server's completions for B1-B4, the 871M train steps for B5-B7);
    # the engine's generate is the earlier serving path, spec_launches
    # the 871M spec engine's admission and greedy rounds (its int8 draft),
    # lora_launches the multi-LoRA server's completions (B1-B4) and the
    # QLoRA train steps (B5-B7), window_launches and int4_launches the
    # windowed and the int4 servers' completions
    for k in kernels:
        k["launches"] = serve["counts"][k["name"]]
        k["engine_launches"] = eng["counts"][k["name"]]
        k["spec_launches"] = spec["counts"][k["name"]]
        k["lora_launches"] = lora_serve["counts"][k["name"]]
        k["moe_launches"] = moe["engine"]["counts"][k["name"]]
        if k["name"] in spec["kernels"]:
            k["spec_detail"] = spec["kernels"][k["name"]]
    # B4's main path is the MoE int8 engine: its launches there, its
    # times at that path's shape; the 7B-shaped reading stays as detail
    b4 = next(k for k in kernels if k["name"] == "quant_matmul")
    b4["detail_7b_wq"] = {key: b4[key] for key in (
        "work", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "gb_per_s")}
    mb4 = moe["b4"]
    b4.update(
        work="one layer's wq of the MoE int8 engine, 2048 x 2048 at M=8",
        launches=moe["engine"]["counts"]["quant_matmul"],
        ms=mb4["ms"], plain_ms=mb4["plain_ms"], bound_ms=mb4["bound_ms"],
        bound_by=mb4["bound_by"], library_ms=mb4["library_ms"],
        gb_per_s=mb4["gb_per_s"],
        max_abs_err=max(b4["max_abs_err"], mb4["errs"]["max_abs"]),
        rel_l2_err=max(b4["rel_l2_err"], mb4["errs"]["rel_l2"]),
        tile_rel_l2_err=max(b4["tile_rel_l2_err"],
                            mb4["errs"]["tile_rel_l2"]))
    for k in train_kernels:
        k["launches"] = train["counts"][k["name"]]
        k["spec_launches"] = spec["counts"][k["name"]]
        k["lora_launches"] = lora_train["counts"][k["name"]]
        k["moe_launches"] = moe["train"]["counts"][k["name"]]
    kernels += train_kernels
    for k in kernels:
        k["window_launches"] = window["counts"][k["name"]]
        k["int4_launches"] = int4["counts"][k["name"]]
        # the parallel phase: its world-size-1 mesh step at the full 871M,
        # and per rank (rank 0, rank 1) of each two-process run
        k["parallel_launches"] = parallel["ws1"]["mesh"]["counts"][k["name"]]
        k["parallel_rank_launches"] = {
            run: [c[k["name"]] for c in r["counts"]]
            for run, r in parallel["two_process"]["runs"].items()}
        # the tp 2 server's ranks (rank 0, rank 1): its HTTP completions
        # and run_script over the op stream
        k["tp_serve_launches"] = [
            r["counts"][k["name"]]
            for r in tp_serve["two_process"]["ranks"]]
        # the parallel_rest phase per rank (rank 0, rank 1), or per stage
        # for GPipe, from the card's trace; its ring run launches none
        rest, two = parallel_rest, parallel_rest["two_process"]
        k["parallel_rest_launches"] = {
            "moe_tp2": [c[k["name"]] for c in two["moe_tp2"]["counts"]],
            "moe_engine_tp2": [c[k["name"]] for c in
                               two["moe_engine_tp2"]["counts"]],
            "lora_serve_tp2": [c[k["name"]] for c in
                               rest["lora_serve_tp2"]["counts"]],
            "gpipe_pipe2": [c[k["name"]] for c in two["gpipe"]["counts"]]}
        # the workload on the granted device (the slice phase's child),
        # from the card's trace
        k["slice_launches"] = slice_["workload"]["counts"][k["name"]]
        # the workload on the grant the node agent made (the agent
        # phase's child), from the card's trace
        k["agent_launches"] = agent["workload"]["counts"][k["name"]]
        # the workload on the grant the controller made (the controller
        # phase's child), from the card's trace
        k["controller_launches"] = controller["workload"]["counts"][
            k["name"]]
        # tpuslice-gpu serve-bench at the 871M (the ctl phase), from the
        # card's trace: --quantize, then --spec
        k["ctl_launches"] = {run: c[k["name"]]
                             for run, c in ctl["counts"].items()}
        # the port's loadgen through the port's router in front of the
        # migrate phase's two servers (its fleet step), from the card's
        # trace
        k["fleet_launches"] = migrate["fleet"]["counts"][k["name"]]
        # the chaos step's kill arm: the survivor's and the fresh
        # replica's own processes, from each one's card trace
        k["kill_launches"] = {n: c[k["name"]]
                              for n, c in kill["counts"].items()}
        # B1-B3 at the shapes of a tp 2 rank's shards (tp_shard_kernels)
        tp = tp_serve["shard_kernels"].get(k["name"])
        if tp is not None:
            k["tp_serve_detail"] = tp["detail"]
            for key, err in tp.items():
                if key != "detail":
                    k[key] = max(k[key], err)
    for k in kernels:
        lib = k["library_ms"]
        log(f"kernel {k['name']} ({k['work']}): launches {k['launches']}, "
            f"{k['ms'] * 1e3:.1f} us, bound {k['bound_ms'] * 1e3:.1f} us "
            f"({k['bound_by']}), plain {k['plain_ms'] * 1e3:.1f} us, "
            f"library {'-' if lib is None else f'{lib * 1e3:.1f} us'}, "
            f"max abs err {k['max_abs_err']:.2e} (tol {k['tol']})")
    log("phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in timings.items()))
    log(f"GiB allocated after each phase: {held}")
    busy = eng["device_busy"]
    log(json.dumps({"card": card, "decode_tok_s_b8": eng["decode_tok_s"],
                    "step_ms": eng["step_ms"], "ttft_ms": eng["ttft_ms"],
                    "device_ms_per_step": busy and busy["ms_per_step"],
                    "device_ms_per_prefill_chunk":
                        eng["chunk_busy"] and eng["chunk_busy"]["ms_per_step"],
                    "decode_steps": eng["decode_steps"],
                    "prefill_chunks": eng["prefill_chunks"]}))
    log(json.dumps({"card": card, "graph": graph}))
    log(json.dumps({"card": card, "serve": serve}))
    log(json.dumps({"card": card, "spec": {k: v for k, v in spec.items()
                                           if k != "kernels"}}))
    log(json.dumps({"card": card, "migrate": migrate}))
    tele = migrate["fleet"]["telemetry"]
    log(json.dumps({"card": card, "telemetry": {
        key: tele[key] for key in ("seconds", "poll_ms_median",
                                   "prometheus_client")}}))
    log(json.dumps({"card": card, "lora": {"serve": lora_serve,
                                           "train": lora_train}}))
    log(json.dumps({"card": card, "window": window, "int4": int4,
                    "int8_engine": {
                        "decode_tok_s_b8": eng["decode_tok_s"],
                        "device_ms_per_step": busy and busy["ms_per_step"]}}))
    log(json.dumps({"card": card, "moe": moe}))
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
                    "train_remat_sweep": train["remat_sweep"],
                    "cli": cli["line"], "bf16_cut": bf16_cut,
                    "train_cut": cut}))
    log(json.dumps({"card": card, "parallel": parallel}))
    log(json.dumps({"card": card, "tp_serve": {
        k: v for k, v in tp_serve.items() if k != "shard_kernels"}}))
    log(json.dumps({"card": card, "parallel_rest": parallel_rest}))
    log(json.dumps({"card": card, "slice": slice_}))
    log(json.dumps({"card": card, "agent": agent}))
    log(json.dumps({"card": card, "controller": controller}))
    log(json.dumps({"card": card, "ctl": ctl}))
    # the chaos step: the migrate phase's gray arm, the kill phase, the
    # agent phase's partition step
    gray, part = migrate["gray"], agent["partition"]
    log(json.dumps({"card": card, "chaos": {
        "seconds": gray["seconds"] + kill["seconds"] + part["seconds"],
        "gray": {k: gray[k] for k in (
            "eject_s", "readmit_s", "around_outcomes", "nemesis_arm",
            "ejections", "seconds")},
        "kill": {k: kill[k] for k in (
            "outcomes", "victim_exit", "kill_to_removed_ms",
            "fresh_first_token_s", "build_s", "turn_s", "warm_s",
            "start_s", "torn", "ledger", "seconds")},
        "partition": part}}))
    log(json.dumps({"card": card, "gates": gates, "obs": obs,
                    "profile": serve["profile"]}))
    print(json.dumps({"card": card, "kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
