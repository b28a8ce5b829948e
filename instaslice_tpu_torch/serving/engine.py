"""Slot-based continuous-batching serving engine (port of
``instaslice_tpu/serving/engine.py``).

Requests occupy slots of a fixed ``(max_batch, max_len)`` KV cache;
prompts prefill in ``prefill_len`` chunks into their slot's stripe
(several admissions at once through :meth:`ServingEngine.add_requests`'
bucketed batched prefill), the first token is sampled at admission, and
:meth:`ServingEngine.decode_block` advances every slot ``n_steps`` tokens
with one host readback per block. Paged KV accounting uses the copied
:class:`~instaslice_tpu_torch.serving.kvcache.KVBlockPool`.

As in the JAX engine:

- **radix prefix cache** (``radix_cache``, on by default): every
  completion inserts its prompt (and, with ``radix_decoded``, its decoded
  tokens) into a :class:`~instaslice_tpu_torch.serving.kvcache.RadixIndex`
  at prefill-chunk granules, with each granule's KV stripe read out of
  the cache as an independent copy; a later prompt sharing a prefix
  writes those stripes back into its slot and prefills only the
  remaining chunks. :meth:`ServingEngine.register_prefix` pins a path;
  the admission cost model (:meth:`ServingEngine.admit_block_cost`,
  :meth:`ServingEngine.match_reserve`, :meth:`ServingEngine.can_admit`)
  charges only a hit's non-shared suffix and counts unreferenced cached
  blocks as free;
- **preempt/resume**: :meth:`ServingEngine.preempt_slot` reads a live
  slot's stripe out and parks the request with its block table;
  :meth:`ServingEngine.resume_request` writes it back, no re-prefill;
- **recovery**: a cache-writing device call that raises (prefill, stripe
  write, decode) may have left a stripe half written, so it marks the
  cache poisoned (:meth:`ServingEngine.cache_poisoned`) and every later
  device call refuses until :meth:`ServingEngine.recover` drops the live
  slots and rebuilds a zeroed cache. PyTorch donates no buffer, so this
  mark stands in for the JAX engine's consumed-donation check;
- the ``fault_hook`` seam, consulted before each dispatch at the
  reference's sites, and the tracer/profiler spans and events;
- **speculative decoding** (``draft_model``): :meth:`ServingEngine.
  spec_step` drafts up to ``spec_k`` tokens per slot with the draft
  model (k+1 draft forwards, a Python loop of device steps), verifies
  them with ONE target forward over k+1 rows, and emits the accepted
  prefix plus one bonus or resampled token; greedy engines emit the
  plain greedy chain, sampled ones are rejection-sampled
  (:func:`~instaslice_tpu_torch.serving.sampling.speculative_accept`).
  The adaptive k ladder, the cache-end clamp and the periodic k = 1
  probe are the reference's. The draft's own bf16 KV cache rides every
  path the target's does: chunked and burst prefill, radix granule
  stripes, forks, preempt/resume, recovery, and the catch-up after a
  plain ``step``/``decode_block``;
- **session migration**: :meth:`ServingEngine.export_session` writes a
  parked request (both stripes, host decode state) in the reference's
  versioned wire format (``serving/kvcache.py``) and
  :meth:`ServingEngine.import_session` parks one on this engine; a blob
  exported by either engine imports into the other when the model
  signatures agree;
- **multi-LoRA** (``lora_adapters``): every request picks an adapter
  (``add_request(..., adapter=k)``, 1-based; 0 = the base model) and
  every forward adds each row's adapter delta
  (:func:`~instaslice_tpu_torch.models.lm.apply_with_cache`); decode
  rounds whose live slots share one adapter take the single-adapter
  path (``adapter_fastpath``), counted in ``fastpath_rounds`` against
  ``gathered_rounds``. Adapter requests neither read nor feed the radix
  cache, which holds base-model KV only; the adapter rides
  preempt/resume and session export/import;
- **sliding windows and int4**: a windowed model (``ModelConfig.window``)
  serves through every path above; a decode step whose attended bucket
  is wider than ``window - 1`` reads each row's window band
  (:func:`~instaslice_tpu_torch.models.lm.window_band`) instead of B1, a
  route by shape counted in ``band_steps``. Int4 weights
  (:class:`~instaslice_tpu_torch.models.quant.Int4Tensor`) serve like
  int8 ones, dequantized at each use.

**Tensor parallelism** (``mesh=``, a ``DeviceMesh`` of
:func:`~instaslice_tpu_torch.parallel.slice_mesh` with a ``model`` axis;
the reference's ``engine.py:594-633``): the engine takes the WHOLE params
and keeps this rank's shards of them (:meth:`_shard_model_state`:
:func:`~instaslice_tpu_torch.models.quant.shard_params` over
:func:`~instaslice_tpu_torch.models.lm.param_specs`: heads, the FFN
hidden dim and the vocabulary over ``model``), the KV caches hold the
rank's ``kv_heads / tp`` heads, and the decode state (``lengths``,
``last_token``, ``slot_adapter``, ``seen``, the generator) is replicated:
every rank builds the same tensors and, since the gathered logits are
identical on every rank, samples the same tokens. The target and the
draft share one layout routine, so the two cannot drift. PyTorch is
multi-controller: every rank is a process that must issue the same
forwards in the same order, which
:mod:`~instaslice_tpu_torch.serving.distributed`'s op stream arranges;
so every port mesh above one rank is multi-process (``_multiproc``) and
:meth:`ServingEngine.export_session` refuses there, as the reference does
on a multi-process mesh. The reference turns its Pallas kernels off at
mesh size > 1, because ``pallas_call`` does not auto-partition; here a
rank's product is a local dense product on local shards, so B1, B2 and
B3 run on each rank's shards and compute the same function. A
mixture-of-experts model serves its experts over ``model`` (each rank
holds E / tp of them and dequantizes only those; B4 runs on its
attention heads), and stacked adapters stay whole on every rank, as the
reference replicates them, each rank adding its part of every delta
(the fast path and the gathered rounds as on one card). Decode blocks
run eagerly at a model axis above 1 (a collective is not captured into a
CUDA graph here: ROADMAP queue A item 1a).

Where the JAX engine compiles a ``lax.scan`` of decode steps (one
program per static key), a CUDA engine captures ONE decode step as a CUDA
graph per key (attend bucket, greedy or sampled, adapter variant) and
replays it ``n_steps`` times; a spec round (k+1 draft steps, the verify
forward, the acceptance and the advance) is one graph per (k, attend
bucket, greedy or sampled), and the draft's catch-up after a block one
per (n_steps, attend bucket). :meth:`ServingEngine.compile_budget` bounds
the set. A graph replays fixed device addresses, so the decode state
(``last_token``, ``lengths``, ``seen``, the adapter ids, a step counter
and the token/logprob block buffers) is allocated once and every path
writes it in place. The eager step is what is captured: the CPU, and a
CUDA engine built with ``decode_graphs=False``, run it as it is. Sampled
tokens stay on the device and feed the next step, and the (n_steps, B)
token block is copied to the host once (asynchronously, between
:meth:`decode_block_start` and :meth:`decode_block_finish`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import time
from typing import Dict, List, Optional

import torch

from instaslice_tpu_torch import resolve_device
from instaslice_tpu_torch.models.lm import (
    Params,
    TpuLM,
    param_specs,
    window_band,
)
from instaslice_tpu_torch.models.lora import (
    _target_shapes,
    frozen,
    stack_adapters,
)
from instaslice_tpu_torch.models.quant import shard_params
from instaslice_tpu_torch.obs.profiler import get_profiler, record_compile
from instaslice_tpu_torch.ops import build
from instaslice_tpu_torch.ops import flash_decode as _fd
from instaslice_tpu_torch.parallel.collectives import mesh_axes, shard_leaf
from instaslice_tpu_torch.serving.kvcache import (
    SESSION_WIRE_VERSION,
    BlockPoolExhausted,
    BlockTable,
    KVBlockPool,
    RadixIndex,
    RadixMatch,
    RadixNode,
    array_to_wire,
    radix_granule,
    tree_to_wire,
    wire_to_array,
    wire_to_tree,
)
from instaslice_tpu_torch.serving.sampling import (
    apply_repetition_penalty,
    filter_logits,
    sample,
    speculative_accept,
    token_logprob,
)
from instaslice_tpu_torch.utils.trace import get_tracer

log = logging.getLogger("instaslice_tpu_torch.serving.engine")

#: sentinel for "no precomputed radix match passed" (None is a valid
#: match result, so it cannot be the default)
_MATCH_UNSET = object()


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    prompt: List[int]
    tokens: List[int]                 # generated ids (no prompt)
    finished_reason: str = ""         # "eos" | "max_len" | "stop" | ...
    # log-probability of each generated token under the distribution it
    # was sampled from (post temperature/top-k/top-p), 1:1 with tokens
    logprobs: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class AdmissionRequest:
    """One request of a burst admission (:meth:`ServingEngine.add_requests`)."""

    prompt: List[int]
    n: int = 1
    stop: Optional[list] = None
    adapter: int = 0


@dataclasses.dataclass
class _Slot:
    request_id: int
    prompt: List[int]
    generated: List[int]
    stop: List[List[int]] = dataclasses.field(default_factory=list)
    # positions before this are already stop-scanned (no match found)
    stop_scanned: int = 0
    logprobs: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Parked:
    """A preempted request: its host state plus its KV stripe(s), read
    out of the cache(s) (independent copies) so the slot could go back to
    the batch. The block table stays allocated
    (``ServingEngine._tables``): resume is one stripe write per cache,
    never a re-prefill."""
    req: _Slot
    stripe: Params
    draft_stripe: Optional[Params]     # the draft cache's, with a draft
    length: int                        # resident cache positions
    adapter: int = 0                   # LoRA adapter id (0 = base)


#: the dispatch forms a CUDA engine captures graphs for
#: (:meth:`ServingEngine.compile_budget`'s keys)
GRAPH_FORMS = ("decode_block", "draft_catchup", "spec_round")


class ServingEngine:
    def __init__(
        self,
        model: TpuLM,
        params: Optional[Params] = None,
        *,
        max_batch: int = 8,
        max_len: int = 512,
        prefill_len: int = 64,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        seed: int = 0,
        mesh=None,
        kv_quant: bool = False,
        top_k: int = 0,
        top_p: float = 1.0,
        min_p: float = 0.0,
        repetition_penalty: float = 1.0,
        max_prefixes: int = 8,
        kv_block_size: int = 16,
        radix_cache: bool = True,
        radix_decoded: bool = True,
        batched_prefill: bool = True,
        draft_model: Optional[TpuLM] = None,
        draft_params: Optional[Params] = None,
        spec_k: int = 4,
        spec_adaptive: bool = True,
        lora_adapters=None,
        lora_alphas=None,
        lora_names=None,
        adapter_fastpath: bool = True,
        device="cuda",
        decode_graphs: Optional[bool] = None,
    ) -> None:
        """``kv_quant=True`` stores the KV cache as int8 with per-vector
        scales (decode then runs the int8 decode-attention kernel).
        ``radix_cache``/``radix_decoded``/``max_prefixes`` and
        ``batched_prefill`` are the JAX engine's flags. ``draft_model``
        (+ ``draft_params``, seeded init 1 when omitted) enables
        lossless speculative decoding (:meth:`spec_step`), up to
        ``spec_k`` draft tokens a round, the k of each round chosen by
        the acceptance ladder unless ``spec_adaptive`` is False; the
        draft's KV cache is the model's own dtype, never int8, as in the
        reference. ``lora_adapters`` (adapter trees of
        :mod:`~instaslice_tpu_torch.models.lora`, one rank and target set)
        enables multi-LoRA serving, stacked with ``lora_alphas`` (16.0
        each by default) behind the all-zero adapter 0; ``lora_names``
        names them for requests (``adapter_names``, 1-based);
        ``adapter_fastpath`` lets decode rounds whose live slots share one
        adapter id (0 included) take the single-adapter path. Adapters
        cannot combine with a draft model. ``device`` defaults to the
        card and raises without one; pass ``device="cpu"`` to run the
        plain versions of the kernels. ``decode_graphs`` (default: on
        for a CUDA engine) replays decode blocks and spec rounds as
        captured CUDA graphs; False runs the same steps eagerly (the
        comparison route on the card; the CPU always runs them so).
        ``mesh`` (a ``DeviceMesh`` with a ``model`` axis) serves this
        rank's shards of ``params`` (whole trees in; see the module
        docstring); at a model axis above 1 ``decode_graphs`` resolves to
        the eager route and True raises."""
        self.device = resolve_device(device)
        self.mesh = mesh
        self._axes = mesh_axes(mesh)
        if mesh is not None and "model" not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"serving mesh needs a 'model' axis, got "
                             f"{mesh.mesh_dim_names}")
        #: every port mesh above one rank is a process per rank
        self._multiproc = mesh is not None and mesh.size() > 1
        tp = self._axes.model.size
        if tp > 1:
            if decode_graphs:
                raise ValueError(
                    "decode_graphs under tensor parallelism is not ported: "
                    "a collective is not captured into a CUDA graph here "
                    "(ROADMAP queue A item 1a); leave decode_graphs unset "
                    "for the eager route")
            decode_graphs = False
        if decode_graphs is None:
            decode_graphs = self.device.type == "cuda"
        if decode_graphs and self.device.type != "cuda":
            raise ValueError("decode_graphs needs a CUDA engine")
        if prefill_len > max_len:
            raise ValueError("prefill_len must be <= max_len")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if not 0.0 <= min_p <= 1.0:
            raise ValueError(f"min_p must be in [0, 1], got {min_p}")
        if repetition_penalty <= 0.0:
            raise ValueError(
                f"repetition_penalty must be > 0, got {repetition_penalty}"
            )
        if repetition_penalty != 1.0 and draft_model is not None:
            raise ValueError(
                "repetition_penalty cannot combine with speculative "
                "decoding: the penalty depends on tokens sampled INSIDE "
                "the verify window, which the one-shot verify forward "
                "cannot see; acceptance would silently diverge from "
                "the penalized chain"
            )
        if draft_model is not None and spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if not 1 <= kv_block_size <= max_len:
            raise ValueError(f"kv_block_size must be in [1, max_len], got "
                             f"{kv_block_size}")
        self.model = model
        self.params = (params if params is not None
                       else model.init(0, device=self.device))
        where = resolve_device(self.params["embed"].device)
        if where != self.device:
            raise ValueError(f"params live on {where}, the engine on "
                             f"{self.device}")
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_len = prefill_len
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.min_p = min_p
        self._repetition_penalty = repetition_penalty
        self.track_seen = repetition_penalty != 1.0
        V = model.cfg.vocab_size
        self.seen = (torch.zeros((max_batch, V), dtype=torch.bool,
                                 device=self.device)
                     if self.track_seen else None)
        self.eos_id = eos_id
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._next_id = 0
        self.kv_quant = kv_quant
        self.lora: Optional[Params] = None
        self.n_adapters = 0
        if lora_adapters:
            if draft_model is not None:
                raise ValueError(
                    "multi-LoRA cannot combine with speculative "
                    "decoding: the draft proposes from the UNADAPTED "
                    "base, so acceptance would collapse for adapted "
                    "rows — serve adapters and spec-decode separately")
            with torch.no_grad():
                self.lora = stack_adapters(
                    [frozen(ad, self.device) for ad in lora_adapters],
                    model.cfg, alphas=lora_alphas)
            shapes = _target_shapes(model.cfg)
            for t, ab in self.lora["blocks"].items():
                L, fin, fout = shapes.get(t, (0, 0, 0))
                n, r = ab["a"].shape[1], ab["a"].shape[-1]
                if (tuple(ab["a"].shape) != (L, n, fin, r)
                        or tuple(ab["b"].shape) != (L, n, r, fout)):
                    raise ValueError(
                        f"adapter target {t!r}: a {tuple(ab['a'].shape)}, "
                        f"b {tuple(ab['b'].shape)} do not fit the model's "
                        f"(L, in, out) = {(L, fin, fout)}")
            self.n_adapters = len(lora_adapters)
            if lora_names is not None and (
                    len(lora_names) != self.n_adapters
                    or len(set(lora_names)) != self.n_adapters):
                raise ValueError("lora_names must be unique and match "
                                 "lora_adapters 1:1")
        #: request-facing name -> 1-based engine adapter id (engine state:
        #: it must stay consistent with the stacking order)
        self.adapter_names: Dict[str, int] = (
            {n: i + 1 for i, n in enumerate(lora_names)}
            if self.lora is not None and lora_names else {})
        #: per-slot adapter id (0 = base), read by every gathered decode
        self.slot_adapter = torch.zeros(max_batch, dtype=torch.int64,
                                        device=self.device)
        #: host mirror of slot_adapter (the fast-path choice, preemption
        #: and the radix guard read it without a device sync; the
        #: scheduler's adapter grouping reads it too)
        self._slot_adapter_host: Dict[int, int] = {}
        #: decode rounds whose live slots share one adapter id take the
        #: single-adapter path (no per-row gather)
        self.adapter_fastpath = adapter_fastpath
        #: the adapter id of single-adapter forwards (the fast path and
        #: prefill chunks), filled in place before each use (stream
        #: order; no host-to-device copy)
        self._aidx1 = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.fastpath_rounds = 0       # decode rounds on the single-
        self.gathered_rounds = 0       # adapter path vs the gather
        self.cache = model.init_cache(max_batch, max_len, quant=kv_quant,
                                      device=self.device, mesh=mesh)
        self.lengths = torch.zeros(max_batch, dtype=torch.int32,
                                   device=self.device)
        self.last_token = torch.zeros(max_batch, dtype=torch.int64,
                                      device=self.device)
        # ---- decode state a captured graph reads and writes ----
        self._rows = torch.arange(max_batch, device=self.device)
        #: row of the block buffers the next decode step writes
        self._step_ctr = torch.zeros(1, dtype=torch.int64,
                                     device=self.device)
        #: (max_len, B) tokens and logprobs of the block in flight (a
        #: block is shorter than the cache), and each row's last token
        #: before it (the draft catch-up's first input)
        self._blk_toks = torch.zeros((max_len, max_batch), dtype=torch.int64,
                                     device=self.device)
        self._blk_lps = torch.zeros((max_len, max_batch),
                                    dtype=torch.float32, device=self.device)
        self._blk_first = torch.zeros(max_batch, dtype=torch.int64,
                                      device=self.device)
        #: spec round outputs per k: accepted (B,), tokens and logprobs
        #: (B, k+1)
        self._spec_out: Dict[int, tuple] = {}
        self.decode_graphs = bool(decode_graphs)
        #: captured graphs by key (the form first, see GRAPH_FORMS)
        self._graphs: Dict[tuple, torch.cuda.CUDAGraph] = {}
        #: replays dispatched, by graph key (the host's record of what
        #: each launched; the card's trace counts the kernels)
        self.graph_replays: Dict[tuple, int] = {}
        self._graph_pool = None
        self._capture_stream = None
        self.capture_seconds = 0.0
        self.slots: Dict[int, _Slot] = {}
        self.finished: List[GenerationResult] = []
        self.tokens_generated = 0
        self.kv_block_size = kv_block_size
        self.kv = KVBlockPool(max_batch * (-(-max_len // kv_block_size)),
                              kv_block_size)
        #: request id -> block table (live slots AND parked requests)
        self._tables: Dict[int, BlockTable] = {}
        #: preempted requests parked off-batch (request id -> state)
        self.parked: Dict[int, _Parked] = {}
        self.preempted_total = 0
        self.resumed_total = 0
        #: live-migration ledger: parked sessions serialized off this
        #: engine / deserialized onto it
        self.exported_total = 0
        self.imported_total = 0
        # ---- radix prefix cache ----
        self.radix_granule = radix_granule(prefill_len, kv_block_size)
        self.radix = RadixIndex(self.kv, self.radix_granule)
        self.radix_cache = radix_cache
        self.radix_decoded = radix_decoded
        #: registered prefix key -> its (registered, pinned) tree node
        self.prefixes: Dict[tuple, RadixNode] = {}
        self.max_prefixes = max_prefixes
        #: rid -> (deepest tree node its table forked, matched tokens)
        self._radix_locks: Dict[int, tuple] = {}
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_inserted = 0
        self.prefix_tokens_saved = 0
        #: fault-injection seam (instaslice_tpu_torch.faults.
        #: engine_fault_hook): called with the op name ("prefill" /
        #: "decode") before each device dispatch, at the JAX engine's
        #: sites; None costs one attribute read
        self.fault_hook = None
        #: set when a cache-writing device call raised (see the module
        #: docstring); cleared only by recover()
        self._poisoned = False
        # ---- engine hot path ----
        self.batched_prefill = batched_prefill
        #: power-of-two row buckets of the batched prefill (bucket 1 is
        #: absent: a lone row takes the per-slot prefill)
        self._prefill_buckets = [
            1 << i for i in range(1, max_batch.bit_length())
            if (1 << i) <= max_batch
        ]
        self.prefill_batches = 0       # batched chunk dispatches
        self.prefill_rows = 0          # real rows across them
        self.prefill_pad_rows = 0      # bucket-padding rows across them
        #: per-dispatch batched-prefill occupancy samples (real rows /
        #: bucket rows), drained by the scheduler
        self._prefill_occ: List[float] = []
        #: forward passes run, by kind: prefill chunks (single-slot or
        #: batched) and decode steps (every step of every block)
        self.prefill_dispatches = 0
        self.decode_steps = 0
        #: decode steps that read the sliding-window band (no B1)
        self.band_steps = 0
        #: an in-flight decode block (dispatched, tokens not yet read)
        self._pending_block: Optional[dict] = None
        #: time.monotonic() stamp of the most recent decode readback
        #: landing (decode_block_finish / spec_step_finish / step): the
        #: scheduler splits device-bound time from host bookkeeping there
        self.last_dispatch_landed: Optional[float] = None

        # ---- speculative decoding ----
        self.draft_model = draft_model
        self.spec_k = spec_k
        #: adaptive k: each round's depth from the bounded shape set
        #: below by an acceptance-rate EMA; False pins it at spec_k
        self.spec_adaptive = spec_adaptive
        self.draft_params = None
        self.draft_cache: Optional[Params] = None
        if draft_model is not None:
            self.draft_params = (draft_params if draft_params is not None
                                 else draft_model.init(1,
                                                       device=self.device))
            self.draft_cache = draft_model.init_cache(max_batch, max_len,
                                                      device=self.device,
                                                      mesh=mesh)
        if mesh is not None:
            self._shard_over()
        #: the bounded k shape set: 0 (a plain, draft-cache-maintaining
        #: step: the graceful-degradation floor), the powers of two below
        #: spec_k, and spec_k itself; every dispatched k is a member
        kset = {0}
        if draft_model is not None:
            b = 1
            while b < spec_k:
                kset.add(b)
                b <<= 1
            kset.add(spec_k)
        self._spec_kset = sorted(kset)
        #: ladder position into ``_spec_kset``: starts optimistic (at
        #: spec_k); the acceptance EMA walks it one rung per crossing
        self._spec_idx = len(self._spec_kset) - 1
        #: acceptance-rate EMA (accepted draft tokens / proposed)
        self.spec_accept_ema = 1.0
        #: consecutive k = 0 rounds (drives the periodic k = 1 probe)
        self._spec_zero_rounds = 0
        self.spec_rounds = 0
        self.spec_proposed = 0         # draft tokens proposed (k*batch)
        self.spec_accepted = 0         # draft tokens accepted
        #: per-round acceptance-rate samples, drained by the scheduler
        self._spec_rate_samples: List[float] = []
        #: an in-flight spec round (dispatched, outputs not yet read),
        #: drained by _drain_pending like _pending_block
        self._pending_spec: Optional[dict] = None

    @property
    def repetition_penalty(self) -> float:
        return self._repetition_penalty

    # ------------------------------------------------- tensor parallelism

    def _shard_model_state(self, model: TpuLM, params: Params) -> Params:
        """One model's tensor-parallel layout over the mesh's ``model``
        axis (``engine.py:594-624``): this rank's shards of the whole
        ``params`` per :func:`param_specs` (heads, FFN hidden dim and
        vocabulary split, quant-aware). Its cache was built at the rank's
        heads by ``init_cache(mesh=)``, which ran the reference's checks
        (``check_mesh``)."""
        return shard_params(params, param_specs(model.cfg), self._axes)

    def _shard_over(self) -> None:
        """The target's and the draft's shards through one routine, so
        the two layouts cannot drift. The decode state needs nothing:
        every rank builds the same tensors (replicated). :meth:`recover`
        zeroes the sharded caches in place, so the layout survives it
        (the reference re-shards there, ``engine.py:1612-1620``)."""
        self.params = self._shard_model_state(self.model, self.params)
        if self.draft_model is not None:
            self.draft_params = self._shard_model_state(self.draft_model,
                                                        self.draft_params)

    # ------------------------------------------------------------ device

    @contextlib.contextmanager
    def _cache_write(self):
        """Bracket a device call that writes the cache: refuses while the
        cache is poisoned, and poisons it if the call raises (a stripe
        may be half written)."""
        self._check_not_poisoned()
        try:
            yield
        except BaseException:
            self._poisoned = True
            raise

    def _check_not_poisoned(self) -> None:
        if self._poisoned:
            raise RuntimeError("the KV cache is poisoned by a failed device "
                               "call; recover() first")

    def _forward(self, tokens: torch.Tensor, cache: Params,
                 lengths: torch.Tensor, attend_len: int = 0,
                 aidx: Optional[torch.Tensor] = None, single: bool = False):
        """The target's incremental forward; with adapters, ``aidx``
        holds each row's adapter id ((1,) with ``single``)."""
        if self.lora is None or aidx is None:
            return self.model.apply_with_cache(self.params, tokens, cache,
                                               lengths,
                                               attend_len=attend_len,
                                               mesh=self.mesh)
        return self.model.apply_with_cache(
            self.params, tokens, cache, lengths, attend_len=attend_len,
            lora=self.lora, adapter_idx=aidx, single_adapter=single,
            mesh=self.mesh)

    def _adapter_args(self):
        """(aidx, single) for this round's decode dispatch
        (``engine.py:944-960``): when every live slot shares one adapter
        id (0 included) and the fast path is on, the single-adapter path
        with that id; else the per-row gather over ``slot_adapter``.
        Chosen host-side from ``_slot_adapter_host``; each call is one
        round of ``fastpath_rounds`` or ``gathered_rounds``. Both are
        persistent buffers, so a captured step reads whatever ids they
        hold when it replays."""
        if self.lora is None:
            return None, False
        if self.adapter_fastpath:
            ids = {self._slot_adapter_host.get(s, 0) for s in self.slots}
            if len(ids) == 1:
                self.fastpath_rounds += 1
                return self._aidx1.fill_(ids.pop()), True
        self.gathered_rounds += 1
        return self.slot_adapter, False

    def _set_slot_adapters(self, slots: List[int],
                           adapters: List[int]) -> None:
        """Record each slot's adapter id, host mirror and device copy."""
        for s, a in zip(slots, adapters):
            self._slot_adapter_host[s] = a
        if self.lora is not None:
            self.slot_adapter[torch.tensor(slots, device=self.device)] = (
                torch.tensor(adapters, dtype=torch.int64,
                             device=self.device))

    def _draft_forward(self, tokens: torch.Tensor, cache: Params,
                       lengths: torch.Tensor, attend_len: int = 0):
        """The draft model's incremental forward (its own params and
        cache): prefill chunks, catch-up and proposal steps."""
        return self.draft_model.apply_with_cache(
            self.draft_params, tokens, cache, lengths,
            attend_len=attend_len, mesh=self.mesh)

    def _prefill(self, tokens: List[int], slot: int, offset: int,
                 adapter: int = 0) -> torch.Tensor:
        """One (1, prefill_len) chunk into slot ``slot``'s stripe at
        ``offset`` (the draft cache's too, its logits dropped); returns
        the chunk's (prefill_len, vocab) logits. The stripe is a view of
        the cache, so the chunk's K/V land in place; stale data of a
        prior occupant is never attended (the mask admits only positions
        below ``offset + t``)."""
        with self._cache_write():
            stripe = {k: c[:, slot:slot + 1] for k, c in self.cache.items()}
            toks = torch.tensor([tokens], dtype=torch.int64,
                                device=self.device)
            lens = torch.full((1,), offset, dtype=torch.int32,
                              device=self.device)
            logits, _ = self._forward(toks, stripe, lens,
                                      aidx=self._aidx1.fill_(adapter))
            if self.draft_model is not None:
                self._draft_forward(toks, {k: c[:, slot:slot + 1] for k, c
                                           in self.draft_cache.items()},
                                    lens)
        self.prefill_dispatches += 1
        return logits[0]

    def _prefill_batch(self, tokens: List[List[int]], slots: List[int],
                       offsets: List[int], n_real: int,
                       adapters: Optional[List[int]] = None) -> torch.Tensor:
        """P same-shaped chunks into P slots' stripes in one forward:
        gather the stripes, run the (P, prefill_len) batch (each row at
        its own offset), scatter the ``n_real`` real rows back (padding
        rows duplicate a real row). The draft cache takes the real rows
        one chunk forward each, as the reference dispatches them.
        Returns (P, prefill_len, vocab)."""
        with self._cache_write():
            idx = torch.tensor(slots, dtype=torch.int64, device=self.device)
            stripes = {k: c.index_select(1, idx)
                       for k, c in self.cache.items()}
            toks = torch.tensor(tokens, dtype=torch.int64,
                                device=self.device)
            lens = torch.tensor(offsets, dtype=torch.int32,
                                device=self.device)
            aidx = (None if self.lora is None else torch.tensor(
                adapters or [0] * len(slots), dtype=torch.int64,
                device=self.device))
            logits, stripes = self._forward(toks, stripes, lens, aidx=aidx)
            for k, c in self.cache.items():
                c.index_copy_(1, idx[:n_real], stripes[k][:, :n_real])
            if self.draft_model is not None:
                for r in range(n_real):
                    s = slots[r]
                    self._draft_forward(
                        toks[r:r + 1],
                        {k: c[:, s:s + 1]
                         for k, c in self.draft_cache.items()},
                        lens[r:r + 1])
        self.prefill_dispatches += 1
        return logits

    def _read_stripe(self, slot: int, start: int, length: int,
                     cache: Optional[Params] = None) -> Params:
        """An independent copy of one slot's positions [start, start +
        length) of ``cache`` (the target's by default): every leaf is (L,
        B, Hkv, S[, hd]) with the slot on axis 1 and the position on axis
        3. A copy, never a view: the cache is written in place, so a view
        would change under the slot's next occupant."""
        self._check_not_poisoned()
        cache = self.cache if cache is None else cache
        return {k: c[:, slot:slot + 1, :, start:start + length].clone()
                for k, c in cache.items()}

    def _write_stripe(self, stripe: Params, slot: int, start: int,
                      cache: Optional[Params] = None) -> None:
        """Write a stored stripe into a slot of ``cache`` (the target's by
        default) at position ``start``. Stripes are absolute-position
        entities (RoPE bakes positions into K), so a segment only ever
        writes back at the offset it was read from."""
        cache = self.cache if cache is None else cache
        with self._cache_write():
            for k, c in cache.items():
                s = stripe[k]
                c[:, slot:slot + 1, :, start:start + s.shape[3]].copy_(s)

    def _decode_logits(self, last: torch.Tensor, lens: torch.Tensor,
                       attend_len: int, aidx: Optional[torch.Tensor] = None,
                       single: bool = False) -> torch.Tensor:
        logits, _ = self._forward(last[:, None], self.cache, lens,
                                  attend_len=attend_len, aidx=aidx,
                                  single=single)
        return logits[:, 0]

    def _count_steps(self, n: int, attend: int) -> None:
        """Count ``n`` decode steps dispatched attending ``attend``, on
        the host where they are dispatched (eager or replayed alike)."""
        self.decode_steps += n
        if window_band(self.model.cfg, self.max_len, attend or self.max_len):
            self.band_steps += n

    def _sample(self, logits: torch.Tensor, rows=None):
        """(tokens (B,) int64, logprobs (B,)) for a (B, vocab) batch, on
        the device: penalty, then temperature, then the filters. ``rows``
        maps logits rows to slots when the batch is a subset (admission);
        None means row i IS slot i."""
        if self.track_seen:
            seen = self.seen if rows is None else self.seen[list(rows)]
            logits = apply_repetition_penalty(logits, seen,
                                              self.repetition_penalty)
        logits = logits.float()
        if self.temperature <= 0.0:
            toks = torch.argmax(logits, dim=-1)
        else:
            logits = filter_logits(logits / self.temperature, self.top_k,
                                   self.top_p, self.min_p)
            toks = sample(logits, self._gen)
        if self.track_seen:
            r = (torch.arange(self.max_batch, device=self.device)
                 if rows is None else torch.tensor(list(rows),
                                                   device=self.device))
            self.seen[r, toks] = True
        return toks, token_logprob(logits, toks)

    # --------------------------------------------------- captured steps

    def _decode_step(self, attend: int, greedy: bool, aidx, single: bool):
        """One decode step of every row on the persistent decode state,
        the body of the reference's ``_decode_block_impl`` scan and what
        a decode graph captures: the forward, the repetition penalty,
        argmax or the filters and a draw, the ``seen`` update, the
        step's tokens and logprobs into row ``_step_ctr`` of the block
        buffers, then ``last_token``, ``lengths`` and the counter
        advance. Nothing here reads a value back to the host."""
        logits = self._decode_logits(self.last_token, self.lengths, attend,
                                     aidx, single)
        if self.track_seen:
            logits = apply_repetition_penalty(logits, self.seen,
                                              self.repetition_penalty)
        if greedy:
            toks = torch.argmax(logits, dim=-1)
        else:
            logits = filter_logits(logits / max(self.temperature, 1e-6),
                                   self.top_k, self.top_p, self.min_p)
            toks = sample(logits, self._gen)
        if self.track_seen:
            self.seen[self._rows, toks] = True
        self._blk_toks.index_copy_(0, self._step_ctr, toks[None])
        self._blk_lps.index_copy_(0, self._step_ctr,
                                  token_logprob(logits, toks)[None])
        self.last_token.copy_(toks)
        self.lengths.add_(1)
        self._step_ctr.add_(1)

    def _draft_catchup(self, n_steps: int, attend: int) -> None:
        """Teacher-force a finished block's inputs (``[last, toks[:-1]]``)
        through the draft in ONE (B, n_steps) forward, so its cache
        tracks the positions produced outside spec rounds."""
        consumed = torch.cat([self._blk_first[:, None],
                              self._blk_toks[:n_steps - 1].t()], dim=1)
        self._draft_forward(consumed, self.draft_cache,
                            self.lengths - n_steps, attend)

    def _spec_buffers(self, k: int) -> tuple:
        """The (accepted, tokens, logprobs) buffers of rounds of depth
        ``k``, allocated outside any capture on first use."""
        bufs = self._spec_out.get(k)
        if bufs is None:
            B, dev = self.max_batch, self.device
            bufs = (torch.zeros(B, dtype=torch.int64, device=dev),
                    torch.zeros((B, k + 1), dtype=torch.int64, device=dev),
                    torch.zeros((B, k + 1), dtype=torch.float32, device=dev))
            self._spec_out[k] = bufs
        return bufs

    def _spec_round(self, k: int, greedy: bool, attend: int) -> None:
        """One speculative round on the persistent decode state, what a
        spec graph captures: k+1 draft steps (step j consumes [last,
        d0..d_{j-1}], so on full acceptance every admitted draft-cache
        position is really written), the verify forward over (B, k+1)
        with the acceptance, the outputs into this k's buffers, and the
        on-device advance of ``last_token`` and ``lengths``."""
        temp = max(self.temperature, 1e-6)
        d_all, q_all = self._spec_draft(k + 1, greedy, temp, attend)
        accepted, out, lps, final = self._spec_verify(
            d_all[:, :k], None if greedy else q_all[:, :k], greedy, temp,
            attend)
        acc_b, out_b, lps_b = self._spec_out[k]
        acc_b.copy_(accepted)
        out_b.copy_(out)
        lps_b.copy_(lps)
        self.last_token.copy_(final)
        self.lengths.add_((accepted + 1).to(torch.int32))

    # ------------------------------------------------------ CUDA graphs

    def _sampling_key(self, greedy: bool):
        """What a sampled graph bakes in besides its shapes."""
        return ("greedy",) if greedy else (
            "sampled", self.temperature, self.top_k, self.top_p, self.min_p)

    def _decode_key(self, attend: int, greedy: bool, aidx,
                    single: bool) -> tuple:
        variant = ("none" if aidx is None
                   else "single" if single else "gathered")
        return ("decode_block", attend, variant, self._sampling_key(greedy))

    def _program(self, key: tuple, fn):
        """``fn`` as this engine runs it: on a graph engine a replay of
        its captured graph under ``key`` (captured on first use), else
        ``fn`` itself. Called inside :meth:`_cache_write`: a capture or
        replay that raises poisons the cache, and nothing falls back to
        the eager step."""
        if not self.decode_graphs:
            return fn
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._capture(key, fn)
        return functools.partial(self._replay, key, graph)

    def _replay(self, key: tuple, graph) -> None:
        graph.replay()
        self.graph_replays[key] = self.graph_replays.get(key, 0) + 1

    def _state_buffers(self) -> list:
        bufs = [self.last_token, self.lengths, self._step_ctr]
        return bufs + [self.seen] if self.track_seen else bufs

    def _save_state(self):
        """Copies of the decode state a step or round advances, and the
        generator's state."""
        return ([b.clone() for b in self._state_buffers()],
                self._gen.get_state())

    def _restore_state(self, saved) -> None:
        for b, c in zip(self._state_buffers(), saved[0]):
            b.copy_(c)
        self._gen.set_state(saved[1])

    def _capture(self, key: tuple, fn):
        """Capture ``fn`` into a CUDA graph under ``key``. A warm-up run
        on the capture stream first loads the kernels' modules, sets
        their shared-memory attributes and makes the stream's cuBLAS
        workspace, none of which a capture may do. The warm-up really
        runs (its kernel launches are real, and the wrappers count
        them), so the decode state and the generator are saved before it
        and restored after it; the K/V it writes sits at each row's
        ``lengths`` and beyond, where the real step writes the same
        values (or, for a catch-up, rewrites the same positions from the
        same inputs) before anything reads them. The capture records
        launches without making them: no wrapper counts them, and a
        replay's kernels show only in the card's trace. All graphs of
        the engine share one memory pool: their outputs land in
        engine-owned buffers and every replay runs on one stream."""
        t0 = time.perf_counter()
        dev = self.device
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(dev)
        saved = self._save_state()
        cur, side = torch.cuda.current_stream(dev), self._capture_stream
        graph = torch.cuda.CUDAGraph()
        # replays draw fresh numbers from the engine's generator
        graph.register_generator_state(self._gen)
        try:
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                fn()
                self._restore_state(saved)
                graph.capture_begin(pool=self._graph_pool,
                                    capture_error_mode="thread_local")
                try:
                    fn()
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
        except BaseException:
            if not self._graphs:
                # the failed graph held the pool's only reference: the
                # allocator retires a pool nothing uses, so ask anew
                self._graph_pool = None
            raise
        finally:
            cur.wait_stream(side)
        self._graphs[key] = graph
        dt = time.perf_counter() - t0
        self.capture_seconds += dt
        record_compile(dt)
        get_profiler().event("compile", key[0], dur_ms=dt * 1e3,
                             key=str(key[1:]))
        return graph

    def _attend_buckets(self) -> List[int]:
        """Every attend value a block or round can dispatch: the
        256-position buckets below ``max_len``, and 0 (the whole
        cache)."""
        return [b for b in range(256, self.max_len, 256)] + [0]

    def _warm(self, key: tuple, fn) -> None:
        """Capture ``fn`` under ``key`` now (a graph engine), or run it
        once eagerly with the decode state restored after it."""
        if self.decode_graphs:
            if key not in self._graphs:
                self._capture(key, fn)
            return
        saved = self._save_state()
        fn()
        self._restore_state(saved)

    # ------------------------------------------------------------ queries

    def free_slots(self) -> int:
        return self.max_batch - len(self.slots)

    def _resident_tokens(self) -> int:
        """Tokens holding KV blocks: live slots, parked requests and the
        radix cache, positions a live/parked table shares with its
        matched path counted once. list() snapshots the dicts: /v1/stats
        reads this from HTTP threads while the scheduler mutates them."""
        live = sum(len(r.prompt) + len(r.generated)
                   for r in list(self.slots.values()))
        shared = sum(length
                     for _, length in list(self._radix_locks.values()))
        return max(0, live
                   + sum(p.length for p in list(self.parked.values()))
                   + self.radix.tokens_cached() - shared)

    def kv_utilization(self) -> float:
        """Block-pool occupancy: resident tokens / capacity of the blocks
        allocated for them."""
        return self.kv.utilization(self._resident_tokens())

    def kv_stats(self) -> dict:
        """Block-pool gauges (free/used/cow, parked count, radix-held
        blocks) for /v1/stats and the ``tpuslice_kv_blocks_*``
        metrics."""
        out = self.kv.stats(dict(self._tables))
        out["parked"] = len(self.parked)
        out["utilization"] = self.kv_utilization()
        out["prefix_blocks"] = self.radix.pool_blocks()
        out["prefix_evictable"] = self.radix.evictable_blocks()
        return out

    @property
    def prefix_evicted(self) -> int:
        """Radix nodes evicted since construction."""
        return self.radix.evictions

    def radix_stats(self) -> dict:
        """The radix prefix cache's /v1/stats ``radix`` block."""
        return {
            "enabled": self.radix_cache,
            "decoded": self.radix_decoded,
            "granule": self.radix_granule,
            "nodes": self.radix.node_count(),
            "tokens": self.radix.tokens_cached(),
            "blocks": self.radix.pool_blocks(),
            "evictable_blocks": self.radix.evictable_blocks(),
            "hits": self.prefix_hits,
            "misses": self.prefix_misses,
            "inserted": self.prefix_inserted,
            "evicted": self.prefix_evicted,
            "tokens_saved": self.prefix_tokens_saved,
        }

    def radix_digest(self, max_paths: int = 32) -> dict:
        """Hashed hot-prefix summary for the fleet router: the granule
        size plus the most-recently-used cached paths as granule-hash
        chains."""
        return {
            "granule": self.radix_granule,
            "paths": self.radix.hot_paths(max_paths),
        }

    def compiled_programs(self) -> Dict[str, int]:
        """The kernel libraries this process has built and loaded, by
        source name, and this engine's captured CUDA graphs by dispatch
        form (:data:`GRAPH_FORMS`): the port's counterpart of the JAX
        engine's per-jit compile-cache sizes (the profiler's compile
        watch reports any that appear mid-traffic)."""
        out = {name: 1 for name in build.loaded()}
        for key in list(self._graphs):
            out[key[0]] = out.get(key[0], 0) + 1
        return out

    def compile_budget(self, block_cap: int = 0) -> Dict[str, int]:
        """The documented upper bound on captured graphs per dispatch
        form for this engine's configuration (the reference's
        ``compile_budget``, ``engine.py:1076-1126``), what
        :meth:`compiled_programs` is held to. ``block_cap`` is the
        largest decode block the caller dispatches (the scheduler's
        ``block_size``; 0 = up to ``max_len``).

        - decode_block: attend buckets (256-position steps below
          ``max_len``, plus the whole cache) x adapter variants (1, or 2
          with adapters: single and gathered) x greedy/sampled. Where the
          reference compiles one scan per power-of-two ``n_steps``, the
          port captures ONE step and replays it ``n_steps`` times, so
          the step count is no factor; the sampling mode is, because the
          port keys it (temperature is mutable between calls; the
          reference counts it only in its spec forms);
        - draft_catchup (with a draft): one per power-of-two ``n_steps``
          up to ``block_cap`` x attend buckets. The reference counts
          ``1 + n_steps``: its catch-up attends the whole cache and its
          ``step()`` catch-up is a program of its own; the port's
          attends the block's bucket, and ``step()`` runs eagerly;
        - spec_round (with a draft): ``len(_spec_kset)`` x attend
          buckets x greedy/sampled: ONE graph holds the reference's
          ``spec_draft`` and ``spec_verify`` programs (each
          ``2 x len(_spec_kset)`` there) with the acceptance and the
          advance.

        Prefill, stripes and ``step()`` run eagerly: no graph form.
        A sampled form assumes one sampling configuration (temperature,
        top-k, top-p, min-p); changing it captures its set again."""
        cap = block_cap or self.max_len
        n_steps = max(1, cap).bit_length()
        attend = len(self._attend_buckets())
        variants = 2 if self.lora is not None else 1
        out = {"decode_block": attend * variants * 2}
        if self.draft_model is not None:
            out["draft_catchup"] = n_steps * attend
            out["spec_round"] = len(self._spec_kset) * attend * 2
        return out

    def decode_route(self) -> str:
        """What runs a decode block and a spec round: "cuda graphs", or
        "eager" and why."""
        if self.decode_graphs:
            return "cuda graphs"
        if self._axes.model.size > 1:
            return (f"eager (tensor parallel over {self._axes.model.size} "
                    "ranks: collectives are not captured)")
        if self.device.type != "cuda":
            return "eager (cpu)"
        return "eager (decode_graphs=False)"

    def graph_stats(self) -> dict:
        """The ``/v1/stats`` engine block's graph gauges: the route, the
        captured graphs by form against :meth:`compile_budget`, the
        replays dispatched by form, and the seconds spent capturing."""
        got = self.compiled_programs()
        replays = {f: 0 for f in self.compile_budget()}
        for key, n in list(self.graph_replays.items()):
            replays[key[0]] += n
        return {
            "route": self.decode_route(),
            "graphs": {f: got.get(f, 0) for f in self.compile_budget()},
            "budget": self.compile_budget(),
            "replays": replays,
            "capture_seconds": round(self.capture_seconds, 3),
        }

    def graph_pool_gib(self) -> Optional[float]:
        """GiB the graphs' shared memory pool holds on the card (None
        before the first capture, or where the allocator's snapshot
        names no pool)."""
        if self._graph_pool is None:
            return None
        pool = tuple(self._graph_pool)
        segs = [sg for sg in torch.cuda.memory_snapshot()
                if tuple(sg.get("segment_pool_id", ())) == pool]
        if not segs:
            return None
        return sum(sg["total_size"] for sg in segs) / 2 ** 30

    def attention_route(self) -> str:
        """What computes a decode step's attention: "B1" where the int8
        decode kernel launches, else "plain" and why. A model at an
        (hd, G) that B1 is not built for serves on the card all the
        same, through the plain formulation; ``/v1/stats`` says so. A
        windowed model takes B1 up to ``window - 1`` attended positions
        and its window band past them; a mixture-of-experts model never
        takes it (the reference gates it off)."""
        cfg = self.model.cfg
        hd, G = cfg.head_dim, cfg.n_heads // cfg.kv_heads
        if self.device.type != "cuda":
            return "plain (cpu)"
        if not self.kv_quant:
            return "plain (kv cache not int8)"
        if cfg.n_experts:
            return "plain (mixture-of-experts: no B1, as in the reference)"
        if not _fd.kernel_built(hd, G):
            return f"plain (no B1 built for hd {hd}, G {G})"
        if cfg.window and window_band(cfg, self.max_len, self.max_len):
            return (f"B1 to {cfg.window - 1} attended positions, the "
                    "window band past them")
        return "B1"

    def warm_prefill_buckets(self) -> None:
        """Run one chunk through every batched-prefill bucket, one
        single-row chunk and one decode step NOW, with zero admissions,
        so the kernel builds, library loads and cuBLAS handles happen
        before traffic; a graph engine captures its decode step for
        every attend bucket and adapter variant at the engine's sampling
        mode here. The dummy rows write masked positions of slot 0's
        stripe (and one position of every slot): harmless while no slot
        is live. Forward and block counters are left as they were."""
        if self.slots:
            raise RuntimeError(
                "warm_prefill_buckets must run before any admission "
                "(it scribbles on slot 0's masked stripe)")
        counts = (self.prefill_dispatches, self.decode_steps,
                  self.band_steps)
        P = self.prefill_len
        if self.batched_prefill:
            for b in self._prefill_buckets:
                self._prefill_batch([[0] * P] * b, [0] * b, [0] * b, b)
        self._prefill([0] * P, 0, 0)
        greedy = self.temperature <= 0.0
        # eagerly, the first 256-position bucket, as a short decode
        # block attends: a windowed model's whole cache would read its
        # band, not B1
        attends = (self._attend_buckets() if self.decode_graphs
                   else [256 if self.max_len > 256 else 0])
        variants = ([(None, False)] if self.lora is None
                    else [(self._aidx1.fill_(0), True),
                          (self.slot_adapter, False)])
        with self._cache_write():
            for attend in attends:
                for aidx, single in variants:
                    self._warm(self._decode_key(attend, greedy, aidx,
                                                single),
                               functools.partial(self._decode_step, attend,
                                                 greedy, aidx, single))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prefill_dispatches, self.decode_steps, self.band_steps = \
            counts

    # ------------------------------------------------------- slot release

    def _release_table(self, rid: int) -> None:
        """THE per-rid teardown choke point: returns the block table's
        references AND the radix-path lock the admission took."""
        t = self._tables.pop(rid, None)
        if t is not None:
            self.kv.release(t)
        held = self._radix_locks.pop(rid, None)
        if held is not None:
            self.radix.unlock(held[0])

    def _sync_tables(self) -> None:
        """Grow every live slot's block table to its token count;
        cached-but-unreferenced radix blocks yield to live growth."""
        for req in self.slots.values():
            t = self._tables.get(req.request_id)
            if t is None:
                continue
            total = len(req.prompt) + len(req.generated)
            if not self.kv.bump(t, total):
                self._reclaim_for(self.kv.growth_cost(t, total))
                self.kv.ensure(t, total)

    def can_admit(self, prompt, n: int = 1, adapter: int = 0,
                  match=_MATCH_UNSET) -> bool:
        """Step-level admission check: free slots AND free KV blocks.
        ``prompt`` is the token list (the block count charges only the
        non-shared suffix of a radix hit) or a bare length (the
        conservative full-prompt charge); cached-but-unreferenced radix
        blocks count as free."""
        if self.free_slots() < n:
            return False
        if isinstance(prompt, int):
            need = self.kv.blocks_for(prompt + 1) + (n - 1)
        else:
            if match is _MATCH_UNSET:
                match = (self._match_prefix(prompt) if adapter == 0
                         else None)
            need = (self.admit_block_cost(prompt, n, adapter, match=match)
                    + self.match_reserve(match))
        return need <= (self.kv.free_blocks()
                        + self.radix.evictable_blocks())

    def finish_slot(self, slot: int, n_keep: Optional[int] = None,
                    reason: str = "max_new_tokens") -> None:
        """Externally finish a live slot (budget cut, client eviction),
        keeping at most ``n_keep`` tokens; its prompt (and decode chain)
        teaches the radix cache."""
        self._drain_pending()
        req = self.slots.pop(slot)
        self._release_table(req.request_id)
        self._radix_insert(slot, req)
        toks = req.generated if n_keep is None else req.generated[:n_keep]
        lps = req.logprobs if n_keep is None else req.logprobs[:n_keep]
        self.finished.append(GenerationResult(
            req.request_id, req.prompt, toks, reason, logprobs=lps))

    def evict_slot(self, slot: int) -> None:
        """Drop a live slot with no result; its blocks free at once."""
        self._drain_pending()
        req = self.slots.pop(slot)
        self._release_table(req.request_id)

    # ------------------------------------------------------ preempt/resume

    def preempt_slot(self, slot: int) -> int:
        """Park a live request off-batch: read its KV stripe(s) out of
        the cache(s), free the slot, KEEP its block table. Returns the
        parked request id."""
        self._drain_pending()
        if self.fault_hook is not None:
            self.fault_hook("prefill")
        req = self.slots[slot]
        # resident positions: generated[-1] is the pending last token,
        # not yet written to the cache
        length = len(req.prompt) + len(req.generated) - 1
        rounded = min(self.max_len,
                      self.kv.blocks_for(max(1, length)) * self.kv_block_size)
        stripe = self._read_stripe(slot, 0, rounded)
        draft_stripe = (None if self.draft_cache is None else
                        self._read_stripe(slot, 0, rounded, self.draft_cache))
        del self.slots[slot]
        self.parked[req.request_id] = _Parked(
            req, stripe, draft_stripe, length,
            adapter=self._slot_adapter_host.get(slot, 0))
        self.preempted_total += 1
        return req.request_id

    def resume_request(self, rid: int) -> int:
        """Un-park a preempted request into a free slot: write its stripe
        back, restore its decode state, return the slot. Raises when no
        slot is free or the rid is not parked."""
        self._drain_pending()
        if rid not in self.parked:
            raise ValueError(f"request {rid} is not parked")
        slot = self._first_free_slot("no free slot to resume into")
        if self.fault_hook is not None:
            self.fault_hook("prefill")
        # the entry stays parked until the write lands: a failed write
        # must leave the rid findable by drop_parked
        parked = self.parked[rid]
        req = parked.req
        self._write_stripe(parked.stripe, slot, 0)
        if self.draft_cache is not None and parked.draft_stripe is not None:
            self._write_stripe(parked.draft_stripe, slot, 0,
                               self.draft_cache)
        del self.parked[rid]
        self.lengths[slot] = parked.length
        self.last_token[slot] = req.generated[-1]
        self._set_slot_adapters([slot], [parked.adapter])
        if self.track_seen:
            seen_toks = torch.tensor(list(req.prompt) + list(req.generated),
                                     dtype=torch.int64, device=self.device)
            self.seen[slot] = False
            self.seen[slot, seen_toks] = True
        self.slots[slot] = req
        self.resumed_total += 1
        return slot

    def drop_parked(self, rid: int) -> bool:
        """Shed a parked request entirely: its blocks return to the pool
        now."""
        parked = self.parked.pop(rid, None)
        if parked is None:
            return False
        self._release_table(rid)
        return True

    # ------------------------------------------------- session migration

    def model_signature(self) -> dict:
        """What two engines must agree on for a KV session to move
        between them, checked at :meth:`import_session`: the reference's
        keys, so port and JAX engines of one configuration agree."""
        cfg = self.model.cfg
        return {
            "d_model": cfg.d_model, "n_layers": cfg.n_layers,
            "n_heads": cfg.n_heads, "kv_heads": cfg.kv_heads,
            "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
            "window": cfg.window,
            "max_len": self.max_len, "prefill_len": self.prefill_len,
            "kv_block_size": self.kv_block_size,
            "kv_quant": bool(self.kv_quant),
            "n_adapters": self.n_adapters,
            "draft": self.draft_model is not None,
        }

    def _sampling_signature(self) -> dict:
        """Sampling config is engine-level; a migrated continuation
        must sample from the same distribution it started under."""
        return {
            "temperature": float(self.temperature),
            "top_k": int(self.top_k), "top_p": float(self.top_p),
            "min_p": float(self.min_p),
            "repetition_penalty": float(self.repetition_penalty),
        }

    def export_session(self, rid: int) -> dict:
        """Serialize a PARKED request into the versioned session wire
        format (``SESSION_WIRE_VERSION``, ``serving/kvcache.py``): the
        block-rounded KV stripe :meth:`preempt_slot` read out, the draft
        stripe, the host decode state, as a JSON-safe dict a peer's
        :meth:`import_session` feeds to :meth:`resume_request` with no
        re-prefill. The stripes cross to the host here (``.cpu()``).

        Pure read: the rid STAYS parked (copy-then-delete: the caller
        drops the source copy with :meth:`drop_parked` once the blob is
        safe). Callers preempt live slots first.

        The reference writes its JAX key under ``"rng"``; this engine
        writes ``"rng": null`` (which the reference reads as "keep your
        own key") and its generator's state under ``"torch_rng"``, which
        a port engine on the same device type adopts: sampled
        continuations replay bit for bit between like engines and stay
        distribution-preserving otherwise. Greedy continuations are the
        same either way.

        Refused over a mesh of more than one rank (each process holds
        only its heads of the stripe; the reference refuses on a
        multi-process mesh, ``engine.py:1396-1402``)."""
        if self._multiproc:
            raise RuntimeError(
                "session export over a multi-process mesh is not "
                "supported: the KV stripe is sharded across processes "
                "and no single process holds it whole (migrate between "
                "slices, not out of one)")
        parked = self.parked.get(rid)
        if parked is None:
            raise ValueError(
                f"request {rid} is not parked (export serializes parked "
                "state; preempt_slot the live slot first)")
        req = parked.req

        def host(tree):
            return {k: v.cpu() for k, v in tree.items()}

        blob = {
            "version": SESSION_WIRE_VERSION,
            "model": self.model_signature(),
            "sampling": self._sampling_signature(),
            "prompt": [int(t) for t in req.prompt],
            "generated": [int(t) for t in req.generated],
            "logprobs": [float(x) for x in req.logprobs],
            "stop": [[int(x) for x in s] for s in req.stop],
            "stop_scanned": int(req.stop_scanned),
            "length": int(parked.length),
            "adapter": int(parked.adapter),
            "stripe": tree_to_wire(host(parked.stripe)),
            "draft_stripe": (tree_to_wire(host(parked.draft_stripe))
                             if parked.draft_stripe is not None else None),
            "rng": None,
            "torch_rng": {"device": self.device.type,
                          "state": array_to_wire(self._gen.get_state())},
        }
        self.exported_total += 1
        return blob

    def _validate_session_blob(self, blob) -> None:
        """Reject a blob this engine cannot resume: wire version,
        model/sampling signature, adapter range (host-side, before any
        allocation)."""
        ver = blob.get("version") if isinstance(blob, dict) else None
        if ver != SESSION_WIRE_VERSION:
            raise ValueError(
                f"unsupported session wire version {ver!r} (this engine "
                f"speaks v{SESSION_WIRE_VERSION}; re-export from a "
                "matching release)")
        sig = self.model_signature()
        if blob.get("model") != sig:
            raise ValueError(
                "session blob was exported by an incompatible engine: "
                f"theirs {blob.get('model')!r} vs ours {sig!r}")
        if blob.get("sampling") != self._sampling_signature():
            raise ValueError(
                "session blob sampling config mismatch: resuming "
                f"{blob.get('sampling')!r} under "
                f"{self._sampling_signature()!r} would silently change "
                "the output distribution")
        if not 0 <= int(blob.get("adapter", 0)) <= self.n_adapters:
            raise ValueError(
                f"session blob adapter {blob.get('adapter')} out of range "
                f"(engine has {self.n_adapters})")

    def _stripe_from_wire(self, obj, cache: Params, length: int) -> Params:
        """A wire stripe on this engine's device, checked against the
        cache it will be written into: the same leaves and dtypes, one
        slot, at least ``length`` and at most ``max_len`` positions. A
        mismatch raises here, before registration, never later inside
        the resume's cache write. Over a mesh the blob holds every head
        and this rank keeps its own (axis 2)."""
        tree = wire_to_tree(obj)
        tp = self._axes.model.size
        if not isinstance(tree, dict) or set(tree) != set(cache):
            raise ValueError(f"stripe leaves {sorted(tree)} != cache "
                             f"leaves {sorted(cache)}")
        out = {}
        for k, c in cache.items():
            t = tree[k]
            S = t.shape[3] if t.dim() >= 4 else -1
            want = (c.shape[0], 1, c.shape[2] * tp, S) + tuple(c.shape[4:])
            if (t.dtype != c.dtype or tuple(t.shape) != want
                    or not length <= S <= self.max_len):
                raise ValueError(
                    f"stripe leaf {k!r}: {t.dtype} {tuple(t.shape)} does "
                    f"not fit the cache's {c.dtype} {tuple(c.shape)} "
                    f"(x{tp} heads) at length {length}")
            out[k] = shard_leaf(t, (None, None, "model"),
                                self._axes).to(self.device)
        return out

    def import_session(self, blob: dict) -> int:
        """Deserialize an exported session into a PARKED request on this
        engine: allocate its block table, put the stripe(s) on the device
        and register the parked state, so :meth:`resume_request`
        continues the decode with no re-prefill. Returns the fresh LOCAL
        request id.

        Raises ``ValueError`` on a version / model-signature / sampling
        mismatch or a malformed payload (the allocated table is released
        first) and ``RuntimeError`` when the pool cannot hold the stripe
        even after reclaiming evictable radix cache. A ``"torch_rng"``
        state from an engine on the same device type is adopted (see
        :meth:`export_session`); a blob with only the reference's JAX
        key keeps this engine's generator."""
        self._drain_pending()
        self._validate_session_blob(blob)
        length = int(blob["length"])
        if not 0 < length < self.max_len:
            raise ValueError(
                f"session length {length} outside (0, {self.max_len})")
        need = length + 1
        # cached-but-unreferenced radix blocks yield to an inbound
        # session exactly like they yield to admission
        self._reclaim_for(self.kv.blocks_for(need))
        try:
            table = self.kv.allocate(need)
        except Exception as e:
            raise RuntimeError(
                f"kv block pool cannot hold the inbound session: {e}"
            ) from None
        # until the payload has passed, the table is released on every
        # way out (a malformed payload, a state the generator refuses):
        # repeated bad imports must not shrink the pool
        passed = False
        try:
            try:
                stripe = self._stripe_from_wire(blob["stripe"], self.cache,
                                                length)
                draft_stripe = None
                if self.draft_cache is not None:
                    draft_stripe = self._stripe_from_wire(
                        blob["draft_stripe"], self.draft_cache, length)
                req = _Slot(
                    0,  # rid assigned below, after nothing can fail
                    [int(t) for t in blob["prompt"]],
                    [int(t) for t in blob["generated"]],
                    stop=[[int(x) for x in s] for s in blob["stop"]],
                    stop_scanned=int(blob["stop_scanned"]),
                    logprobs=[float(x) for x in blob["logprobs"]],
                )
                if not req.generated:
                    raise ValueError("no generated token to resume from")
                # a missing key is the base model, as
                # _validate_session_blob reads the same field
                adapter = int(blob.get("adapter", 0))
                # parsed HERE: a truncated state must fail before
                # registration, like every other malformed field
                rng_state = None
                trng = blob.get("torch_rng")
                if trng is not None and \
                        trng.get("device") == self.device.type:
                    rng_state = wire_to_array(trng["state"])
                    if rng_state.dtype != torch.uint8:
                        raise ValueError(f"torch_rng state dtype "
                                         f"{rng_state.dtype}")
            except Exception as e:  # noqa: BLE001 - re-raised as ValueError
                # the blob passed the signature checks but its payload is
                # missing/corrupt
                raise ValueError(
                    f"malformed session blob payload: {e!r}") from None
            if rng_state is not None:
                try:
                    self._gen.set_state(rng_state)
                except RuntimeError as e:
                    raise ValueError(
                        f"malformed session blob payload: {e!r}") from None
            passed = True
        finally:
            if not passed:
                self.kv.release(table)
        rid = self._next_id
        self._next_id += 1
        req.request_id = rid
        self._tables[rid] = table
        self.parked[rid] = _Parked(req, stripe, draft_stripe, length,
                                   adapter=adapter)
        self.imported_total += 1
        return rid

    # ----------------------------------------------------------- recovery

    def cache_poisoned(self) -> bool:
        """True when a cache-writing device call raised (its stripe may
        be half written) and :meth:`recover` has not run since. A
        host-side error (validation, a fault hook's plain raise) does not
        poison, so it never needlessly drops live slots."""
        return self._poisoned

    def mark_cache_poisoned(self) -> None:
        """Poison the cache as a failed device call would (the fault
        injector's ``poison`` kind)."""
        self._poisoned = True

    def recover(self) -> List[int]:
        """Rebuild device decode state after a failed device call: drop
        every live slot (their stripes may be half written), return
        their request ids so the caller can fail those requests, and
        zero the caches (the draft's too) and the decode state IN PLACE,
        so captured graphs, which replay those addresses, stay valid (a
        capture that failed stored no graph). Delivered ``finished``
        results, parked requests and the radix stripes survive (they
        are independent copies, never views of the cache)."""
        self._pending_block = None
        self._pending_spec = None
        self.last_dispatch_landed = None
        lost = [r.request_id for r in self.slots.values()]
        for rid in lost:
            self._release_table(rid)
        self.slots.clear()
        for c in (*self.cache.values(), *(self.draft_cache or {}).values()):
            c.zero_()
        for b in self._state_buffers():
            b.zero_()
        self._poisoned = False
        return lost

    # ---------------------------------------------------------- admission

    def _check_capacity(self, n: int) -> None:
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if self.free_slots() < n:
            raise RuntimeError(f"need {n} free slots, have "
                               f"{self.free_slots()}")

    def _free_slot_indices(self) -> List[int]:
        """THE slot-allocation policy (lowest index first)."""
        return [i for i in range(self.max_batch) if i not in self.slots]

    def _first_free_slot(self, why: str) -> int:
        free = self._free_slot_indices()
        if not free:
            raise RuntimeError(why)
        return free[0]

    def _check_prompt_fits(self, prompt: List[int]) -> int:
        if not prompt:
            raise ValueError("empty prompt")
        P = self.prefill_len
        n_chunks = -(-len(prompt) // P)
        if n_chunks * P > self.max_len or len(prompt) > self.max_len - 1:
            raise ValueError(f"prompt length {len(prompt)} cannot fit "
                             f"max_len {self.max_len} (chunked at {P})")
        return n_chunks

    @staticmethod
    def _normalize_stop(stop) -> List[List[int]]:
        if not stop:
            return []
        if all(isinstance(t, int) for t in stop):
            stop = [stop]
        out = []
        for seq in stop:
            if (not isinstance(seq, (list, tuple)) or not seq
                    or not all(isinstance(t, int) for t in seq)):
                raise ValueError(
                    "stop must be a token-id sequence or a list of them")
            out.append(list(seq))
        return out

    def _check_adapter(self, adapter: int) -> None:
        if not 0 <= adapter <= self.n_adapters:
            raise ValueError(f"adapter {adapter} out of range (engine has "
                             f"{self.n_adapters} adapter(s); 0 = base)")

    # ------------------------------------------------- radix prefix cache

    def _match_prefix(self, prompt: List[int]) -> Optional[RadixMatch]:
        """Longest radix-cached strict prefix of ``prompt``, granule-
        aligned and capped so at least one chunk still prefills (its
        logits seed the first sampled token). PURE: no LRU touch."""
        g = self.radix_granule
        limit = ((len(prompt) - 1) // g) * g
        if limit <= 0:
            return None
        m = self.radix.match(prompt, limit)
        return m if m.length else None

    def admit_block_cost(self, prompt: List[int], n: int = 1,
                         adapter: int = 0, match=_MATCH_UNSET) -> int:
        """Pool blocks admitting this request will charge: THE shared
        admission cost model. Matched blocks fork at zero pool cost; a
        match ending inside a block pays the one boundary copy-on-write;
        forks pay one boundary block each."""
        if match is _MATCH_UNSET:
            match = self._match_prefix(prompt) if adapter == 0 else None
        shared = self.kv.blocks_for(match.length) if match else 0
        cow = 1 if match and match.length % self.kv.block_size else 0
        return (self.kv.blocks_for(len(prompt) + 1) - shared + cow
                + (n - 1))

    def match_reserve(self, match) -> int:
        """Evictable-supply blocks admitting through ``match`` takes off
        the table: the matched path is locked before reclaim, so its
        pool blocks stop being reclaimable the moment admission starts."""
        if match is None:
            return 0
        return sum(nd.pool_block_count() for nd in match.path)

    def _reclaim_for(self, need_blocks: int) -> None:
        """Free pool blocks by LRU-evicting unreferenced radix nodes."""
        deficit = need_blocks - self.kv.free_blocks()
        if deficit > 0:
            self.radix.reclaim(deficit)

    def _write_match_stripes(self, path: List[RadixNode], length: int,
                             slot: int) -> None:
        """Write the matched path's per-granule KV stripes (target and
        draft) into a slot up to ``length``: the radix-hit replacement
        for re-running that prefix's prefill chunks."""
        g = self.radix_granule
        for node in path:
            for i, stripe in enumerate(node.stripes):
                off = node.start + i * g
                if off >= length:
                    return
                self._write_stripe(stripe, slot, off)
                if (self.draft_cache is not None
                        and node.draft_stripes is not None):
                    self._write_stripe(node.draft_stripes[i], slot, off,
                                       self.draft_cache)

    def _read_granule_stripes(self, slot: int, start_g: int, end_g: int):
        """(stripes, draft_stripes) of granules [start_g, end_g) of a
        slot's cache rows (draft_stripes None without a draft)."""
        g = self.radix_granule
        stripes = [self._read_stripe(slot, gi * g, g)
                   for gi in range(start_g, end_g)]
        dstripes = (None if self.draft_cache is None else
                    [self._read_stripe(slot, gi * g, g, self.draft_cache)
                     for gi in range(start_g, end_g)])
        return stripes, dstripes

    def _radix_insert(self, slot: int, req: _Slot) -> None:
        """Insert a finishing request's prompt (and, with
        ``radix_decoded``, its decoded tokens) into the radix tree.
        Called after the request's own table released. Best-effort:
        never evicts anything, never fails the completion path."""
        if not self.radix_cache:
            return
        if self._slot_adapter_host.get(slot, 0) != 0:
            # adapter KV must never enter the base-model tree (the rule
            # that makes adapter requests skip prefix reuse)
            return
        g = self.radix_granule
        toks = list(req.prompt)
        if self.radix_decoded:
            toks += req.generated
            # generated[-1] is the pending last token, not in the cache
            limit = len(toks) - 1
        else:
            limit = len(req.prompt)
        limit = min(limit, self.max_len - self.prefill_len)
        L = (limit // g) * g
        if L < g:
            return
        granules = self.radix.granules_of(toks, L)
        try:
            parent, matched = self.radix.ensure_path(granules)
            if matched == len(granules):
                self.radix.touch(parent)
                return
            cost = (self.kv.blocks_for(L)
                    - self.kv.blocks_for(matched * g)
                    + (1 if (matched * g) % self.kv.block_size else 0))
            if cost > self.kv.free_blocks():
                return           # full pool: cache only what fits free
            stripes, dstripes = self._read_granule_stripes(
                slot, matched, len(granules))
            node = self.radix.add_child(parent, granules[matched:])
            node.stripes = stripes
            node.draft_stripes = dstripes
            self.prefix_inserted += 1
        except Exception as e:  # noqa: BLE001 - cache fill is optional
            log.warning("radix insert skipped: %s", e)

    def register_prefix(self, prefix: List[int]) -> None:
        """Pre-insert ``prefix`` into the radix cache as a REGISTERED
        path: prefilled once (unless the tree already holds it), pinned
        outside the allocatable pool, exempt from eviction until
        :meth:`drop_prefix`."""
        key = tuple(prefix)
        if key in self.prefixes:
            return
        self._drain_pending()
        self._validate_prefix(prefix)
        if self.fault_hook is not None:
            self.fault_hook("prefill")
        with get_tracer().span("engine.prefix_register",
                               tokens=len(prefix)):
            self._register_prefix_inner(prefix, key)

    def _register_prefix_inner(self, prefix: List[int], key) -> None:
        g = self.radix_granule
        reg_len = (len(prefix) // g) * g
        granules = self.radix.granules_of(prefix, reg_len)
        parent, matched = self.radix.ensure_path(granules)
        if matched == len(granules):
            node = parent
        else:
            slot = self._first_free_slot(
                "no free slots to prefill the prefix")
            if matched:
                self._write_match_stripes(self.radix.path_of(parent),
                                          matched * g, slot)
            self._prefill_chunks(slot, list(prefix[:reg_len]),
                                 start_chunk=matched * g // self.prefill_len)
            stripes, dstripes = self._read_granule_stripes(
                slot, matched, len(granules))
            node = self.radix.add_child(parent, granules[matched:],
                                        pinned=True)
            node.stripes = stripes
            node.draft_stripes = dstripes
        node.registered = True
        self.radix.pin_path(node)
        self.radix.touch(node)
        self.prefixes[key] = node

    def _validate_prefix(self, prefix: List[int]) -> None:
        """Host-side registration checks, raised before any device op."""
        P = self.prefill_len
        if not prefix or len(prefix) % P:
            raise ValueError(f"prefix length {len(prefix)} must be a "
                             f"non-zero multiple of prefill_len {P}")
        if len(prefix) + P > self.max_len:
            raise ValueError(
                f"prefix length {len(prefix)} leaves no room for a longer "
                f"prompt's remainder chunk in max_len {self.max_len} "
                f"(chunked at {P})")
        if len(self.prefixes) >= self.max_prefixes:
            raise RuntimeError(
                f"prefix cache full ({self.max_prefixes}); drop_prefix "
                "one first (each stored stripe pins device memory)")
        g = self.radix_granule
        reg_len = (len(prefix) // g) * g
        if self.radix.match(list(prefix), reg_len).length < reg_len:
            self._first_free_slot("no free slots to prefill the prefix")

    def drop_prefix(self, prefix: List[int]) -> bool:
        """Un-register a prefix: its path loses eviction exemption, and
        whatever of it no live table references is evicted now."""
        key = tuple(prefix)
        node = self.prefixes.pop(key, None)
        if node is None:
            return False
        node.registered = False
        cur = node
        while (cur is not None and cur is not self.radix.root
               and not cur.children and cur.locks == 0
               and not cur.registered):
            parent = cur.parent
            self.radix.evict(cur)
            cur = parent
        return True

    # ------------------------------------------------------ admission paths

    def _alloc_tables(self, prompt_len: int, n: int,
                      pref: Optional[RadixMatch],
                      prelocked: bool = False) -> List[BlockTable]:
        """Block tables for an n-way admission, all-or-nothing. The first
        table forks the matched radix path's table (copy-on-write shared,
        zero pool cost); forks 2..n share the first table's prompt
        blocks. Locks the matched path n times first (one per fork) unless
        the caller already did (``prelocked``, the burst path)."""
        tables: List[BlockTable] = []
        locked = 0
        node = pref.path[-1] if pref is not None else None
        try:
            if node is not None and not prelocked:
                for _ in range(n):
                    self.radix.lock(node)
                locked = n
            shared = self.kv.blocks_for(pref.length) if pref else 0
            cow = 1 if pref and pref.length % self.kv.block_size else 0
            self._reclaim_for(self.kv.blocks_for(prompt_len + 1) - shared
                              + cow + (n - 1))
            t0 = (self.kv.fork(node.table, pref.length)
                  if pref is not None else self.kv.allocate(0))
            tables.append(t0)
            self.kv.ensure(t0, prompt_len + 1)   # +1: the sampled token
            for _ in range(n - 1):
                t = self.kv.fork(t0, prompt_len)
                tables.append(t)
                self.kv.ensure(t, prompt_len + 1)
        except BlockPoolExhausted as e:
            for t in tables:
                self.kv.release(t)
            for _ in range(locked):
                self.radix.unlock(node)
            raise RuntimeError(f"kv block pool cannot admit this request: "
                               f"{e} (shed parked state or wait for a "
                               "release)") from None
        return tables

    def _adopt_radix_locks(self, pref: Optional[RadixMatch],
                           rids: List[int]) -> None:
        """Hand the path locks :meth:`_alloc_tables` took to the admitted
        rids; a rid that finished on admission unwinds its lock here."""
        if pref is None:
            return
        deepest = pref.path[-1]
        for rid in rids:
            if rid in self._tables:
                self._radix_locks[rid] = (deepest, pref.length)
            else:
                self.radix.unlock(deepest)

    def _chunk(self, prompt: List[int], i: int) -> List[int]:
        P = self.prefill_len
        c = prompt[i * P:(i + 1) * P]
        return c + [0] * (P - len(c))

    def _prefill_chunks(self, slot: int, prompt: List[int],
                        start_chunk: int = 0,
                        adapter: int = 0) -> torch.Tensor:
        """Chunks [start_chunk, n) of ``prompt`` into a slot, through
        ``adapter``; the last chunk's logits."""
        n_chunks = -(-len(prompt) // self.prefill_len)
        logits = None
        for i in range(start_chunk, n_chunks):
            logits = self._prefill(self._chunk(prompt, i), slot,
                                   i * self.prefill_len, adapter)
        return logits

    def _fork_stripe(self, first: int, others: List[int],
                     prompt_len: int) -> None:
        """Copy slot ``first``'s prefilled (chunk-padded) stripe to the
        fork slots, in the target and the draft cache."""
        n = -(-prompt_len // self.prefill_len) * self.prefill_len
        with self._cache_write():
            for cache in (self.cache, self.draft_cache or {}):
                for c in cache.values():
                    for s in others:
                        c[:, s, :, :n] = c[:, first, :, :n]

    def _hit(self, pref: Optional[RadixMatch], slot: int,
             adapter: int = 0) -> int:
        """Write a radix hit's stripes into ``slot`` and count it (or
        count a base request's miss: adapter requests never look);
        returns the first chunk left to prefill."""
        if pref is None:
            if adapter == 0:
                self.prefix_misses += 1
            return 0
        self._write_match_stripes(pref.path, pref.length, slot)
        self.radix.touch(pref.path[-1])
        self.prefix_hits += 1
        self.prefix_tokens_saved += pref.length
        return pref.length // self.prefill_len

    def _register(self, slots: List[int], prompt: List[int], stop,
                  tables: List[BlockTable], toks, lps) -> List[int]:
        toks_h = toks.tolist()
        lps_h = lps.tolist()
        idx = torch.tensor(slots, dtype=torch.int64, device=self.device)
        self.last_token[idx] = toks.to(self.last_token.dtype)
        self.lengths[idx] = len(prompt)
        rids = []
        for i, s in enumerate(slots):
            rid = self._next_id
            self._next_id += 1
            self.slots[s] = _Slot(rid, list(prompt), [int(toks_h[i])],
                                  list(stop), logprobs=[float(lps_h[i])])
            self._tables[rid] = tables[i]
            self.tokens_generated += 1
            self._maybe_finish(s)
            rids.append(rid)
        return rids

    def _first_tokens(self, slots: List[int], prompt: List[int],
                      last_logits: torch.Tensor):
        """Reset the slots' seen-token sets, then sample every fork's
        first token from the prompt's last logits."""
        if self.track_seen:
            rows = torch.tensor(slots, device=self.device)
            pt = torch.tensor(prompt, dtype=torch.int64, device=self.device)
            self.seen[rows] = False
            self.seen[rows[:, None], pt[None, :]] = True
        return self._sample(
            last_logits[None].expand(len(slots), -1), rows=slots)

    def add_request(self, prompt: List[int], stop=None,
                    adapter: int = 0) -> int:
        """Admit a prompt; returns the request id. Raises when the batch
        is full or the prompt cannot fit the cache. Prompts longer than
        ``prefill_len`` prefill in chunks; a radix hit skips the matched
        chunks; the first token is sampled here."""
        return self.add_request_n(prompt, 1, stop=stop, adapter=adapter)[0]

    def add_request_n(self, prompt: List[int], n: int, stop=None,
                      adapter: int = 0) -> List[int]:
        """Admit ``n`` samples of one prompt with ONE prefill: the stripe
        is copied to the other n-1 slots, each fork samples its own first
        token. All-or-nothing on capacity."""
        self._drain_pending()
        with get_tracer().span("engine.prefill", tokens=len(prompt),
                               n=n) as sp:
            return self._add_request_n_inner(prompt, n, stop, adapter, sp)

    def _add_request_n_inner(self, prompt: List[int], n: int, stop,
                             adapter: int, sp) -> List[int]:
        stop = self._normalize_stop(stop)
        self._check_adapter(adapter)
        self._check_prompt_fits(prompt)
        self._check_capacity(n)
        t_match = time.perf_counter()
        # radix-cached stripes hold BASE-model KV: an adapter request
        # recomputes its whole prompt through its adapter
        pref = self._match_prefix(prompt) if adapter == 0 else None
        get_tracer().record(
            "engine.radix_match", (time.perf_counter() - t_match) * 1e3,
            matched=pref.length if pref else 0, tokens=len(prompt))
        tables = self._alloc_tables(len(prompt), n, pref)
        try:
            rids = self._admit_with_tables(prompt, n, stop, adapter, sp,
                                           pref, tables)
        except BaseException:
            # a failed admission must not leak the blocks it reserved,
            # nor the path locks _alloc_tables took
            for t in tables:
                self.kv.release(t)
            if pref is not None:
                for _ in range(n):
                    self.radix.unlock(pref.path[-1])
            raise
        self._adopt_radix_locks(pref, rids)
        return rids

    def _admit_with_tables(self, prompt: List[int], n: int, stop,
                           adapter: int, sp, pref,
                           tables: List[BlockTable]) -> List[int]:
        if self.fault_hook is not None:
            self.fault_hook("prefill")
        slots = self._free_slot_indices()[:n]
        self._set_slot_adapters(slots, [adapter] * n)
        if pref is not None:
            sp.attrs["prefix_hit"] = str(pref.length)
        start_chunk = self._hit(pref, slots[0], adapter)
        logits = self._prefill_chunks(slots[0], prompt, start_chunk,
                                      adapter)
        last = logits[(len(prompt) - 1) % self.prefill_len]
        if n > 1:
            self._fork_stripe(slots[0], slots[1:], len(prompt))
        toks, lps = self._first_tokens(slots, prompt, last)
        return self._register(slots, prompt, stop, tables, toks, lps)

    def add_requests(self, reqs: List[AdmissionRequest]) -> List[List[int]]:
        """Admit a BURST: every chunk round prefills one
        ``(P, prefill_len)`` multi-slot batch, P bucketed to powers of
        two, so B admissions cost ``max(chunks)`` rounds instead of
        ``sum(chunks)`` dispatches; radix hits join the rounds at their
        matched depth. Token-identical to admitting the requests one by
        one in order. Returns one rid list per request; all-or-nothing
        on capacity."""
        reqs = [r if isinstance(r, AdmissionRequest)
                else AdmissionRequest(**r) for r in reqs]
        if not self.batched_prefill or len(reqs) <= 1:
            return [self.add_request_n(r.prompt, r.n, stop=r.stop,
                                       adapter=r.adapter) for r in reqs]
        self._drain_pending()
        with get_tracer().span(
                "engine.prefill_batch", reqs=len(reqs),
                tokens=sum(len(r.prompt) for r in reqs)) as sp:
            return self._add_requests_inner(reqs, sp)

    def _add_requests_inner(self, reqs: List[AdmissionRequest], sp) \
            -> List[List[int]]:
        stops = [self._normalize_stop(r.stop) for r in reqs]
        for r in reqs:
            self._check_adapter(r.adapter)
            self._check_prompt_fits(r.prompt)
        self._check_capacity(sum(r.n for r in reqs))
        t_match = time.perf_counter()
        prefs = [self._match_prefix(r.prompt) if r.adapter == 0 else None
                 for r in reqs]
        get_tracer().record(
            "engine.radix_match", (time.perf_counter() - t_match) * 1e3,
            matched=sum(p.length for p in prefs if p),
            tokens=sum(len(r.prompt) for r in reqs), reqs=len(reqs))
        # lock EVERY request's matched path before any allocation: a
        # co-admitted request's reclaim must never evict a node a later
        # request of the burst is about to fork
        for r, pref in zip(reqs, prefs):
            if pref is not None:
                for _ in range(r.n):
                    self.radix.lock(pref.path[-1])
        all_tables: List[List[BlockTable]] = []
        try:
            for r, pref in zip(reqs, prefs):
                all_tables.append(self._alloc_tables(len(r.prompt), r.n,
                                                     pref, prelocked=True))
            out = self._admit_burst(reqs, stops, prefs, all_tables, sp)
        except BaseException:
            for tables in all_tables:
                for t in tables:
                    self.kv.release(t)
            for r, pref in zip(reqs, prefs):
                if pref is not None:
                    for _ in range(r.n):
                        self.radix.unlock(pref.path[-1])
            raise
        for pref, rids in zip(prefs, out):
            self._adopt_radix_locks(pref, rids)
        return out

    def _admit_burst(self, reqs, stops, prefs, all_tables, sp) \
            -> List[List[int]]:
        if self.fault_hook is not None:
            self.fault_hook("prefill")
        P = self.prefill_len
        free = self._free_slot_indices()
        slots_per: List[List[int]] = []
        i = 0
        for r in reqs:
            # contiguous low-first: what sequential admissions would pick
            slots_per.append(free[i:i + r.n])
            i += r.n
        self._set_slot_adapters(
            [s for ss in slots_per for s in ss],
            [r.adapter for r, ss in zip(reqs, slots_per) for _ in ss])
        # radix-matched stripes land before any chunk round touches the
        # slot: each request joins the rounds at its own matched depth
        cursors = [self._hit(pref, ss[0], r.adapter)
                   for r, pref, ss in zip(reqs, prefs, slots_per)]
        n_chunks = [-(-len(r.prompt) // P) for r in reqs]
        last_logits: List[Optional[torch.Tensor]] = [None] * len(reqs)
        max_rows = self._prefill_buckets[-1] if self._prefill_buckets else 1
        rounds = 0
        while True:
            group = [gi for gi in range(len(reqs))
                     if cursors[gi] < n_chunks[gi]]
            if not group:
                break
            rounds += 1
            for gstart in range(0, len(group), max_rows):
                part = group[gstart:gstart + max_rows]
                if len(part) == 1:
                    ri = part[0]
                    logits1 = self._prefill(
                        self._chunk(reqs[ri].prompt, cursors[ri]),
                        slots_per[ri][0], cursors[ri] * P, reqs[ri].adapter)
                    self.prefill_rows += 1
                    if cursors[ri] == n_chunks[ri] - 1:
                        last_logits[ri] = logits1
                    continue
                bucket = next(b for b in self._prefill_buckets
                              if b >= len(part))
                rows = part + [part[-1]] * (bucket - len(part))
                logits = self._prefill_batch(
                    [self._chunk(reqs[ri].prompt, cursors[ri])
                     for ri in rows],
                    [slots_per[ri][0] for ri in rows],
                    [cursors[ri] * P for ri in rows],
                    n_real=len(part),
                    adapters=[reqs[ri].adapter for ri in rows],
                )
                self.prefill_batches += 1
                self.prefill_rows += len(part)
                self.prefill_pad_rows += bucket - len(part)
                self._prefill_occ.append(len(part) / bucket)
                for row_i, ri in enumerate(part):
                    if cursors[ri] == n_chunks[ri] - 1:
                        last_logits[ri] = logits[row_i]
            for ri in group:
                cursors[ri] += 1
        sp.attrs["rounds"] = str(rounds)
        # per request in burst order: fork copies, then first tokens
        sampled = []
        for ri, r in enumerate(reqs):
            ss = slots_per[ri]
            if r.n > 1:
                self._fork_stripe(ss[0], ss[1:], len(r.prompt))
            ll = last_logits[ri][(len(r.prompt) - 1) % P]
            sampled.append(self._first_tokens(ss, r.prompt, ll))
        return [self._register(ss, r.prompt, stop, tables, toks, lps)
                for r, stop, tables, ss, (toks, lps)
                in zip(reqs, stops, all_tables, slots_per, sampled)]

    # ------------------------------------------------------------ decode

    def step(self) -> Dict[int, int]:
        """One decode step for every live slot (the whole cache
        attended); returns request id -> new token. It advances the live
        rows only and reads its tokens back at once, so it runs eagerly
        on every engine (the scheduler takes it only where a block of one
        step would overrun the cache)."""
        self._drain_pending()
        if not self.slots:
            return {}
        with get_tracer().span("engine.decode_step", batch=len(self.slots)):
            return self._step_inner()

    def _step_inner(self) -> Dict[int, int]:
        if self.fault_hook is not None:
            self.fault_hook("decode")
        with self._cache_write():
            if self.draft_model is not None:
                # keep the draft cache position-complete: it consumes
                # every token the target consumes, or later spec rounds
                # would attend zero-holes
                self._draft_forward(self.last_token[:, None],
                                    self.draft_cache, self.lengths)
            aidx, single = self._adapter_args()
            logits = self._decode_logits(self.last_token, self.lengths, 0,
                                         aidx, single)
            self._count_steps(1, 0)
        toks, lps = self._sample(logits)
        toks_h, lps_h = toks.tolist(), lps.tolist()
        self.last_dispatch_landed = time.monotonic()
        out: Dict[int, int] = {}
        for slot, req in list(self.slots.items()):
            t = int(toks_h[slot])
            out[req.request_id] = t
            req.generated.append(t)
            req.logprobs.append(float(lps_h[slot]))
            self.tokens_generated += 1
        self.last_token.copy_(toks)
        live = torch.zeros(self.max_batch, dtype=torch.int32,
                           device=self.device)
        live[list(self.slots)] = 1
        self.lengths.add_(live)
        for slot in list(self.slots):
            self._maybe_finish(slot)
        self._sync_tables()
        return out

    def decode_block(self, n_steps: int) -> Dict[int, List[int]]:
        """Run ``n_steps`` decode steps on the device with one (n_steps,
        B) readback; returns request id -> new tokens. EOS inside the
        block still finishes the slot (later tokens are discarded
        host-side). Raises if a live slot would run past the cache."""
        self.decode_block_start(n_steps)
        return self.decode_block_finish()

    def _drain_pending(self) -> None:
        """Land an in-flight decode block or spec round before any other
        mutation."""
        if self._pending_block is not None:
            self.decode_block_finish()
        if self._pending_spec is not None:
            self.spec_step_finish()

    def decode_block_start(self, n_steps: int) -> bool:
        """Enqueue ``n_steps`` decode steps (a graph engine replays its
        captured step ``n_steps`` times, capturing it first for a new
        key) and start the asynchronous copy of the token block to the
        host; returns without waiting for the device (False, and nothing
        enqueued, on an empty batch)."""
        self._drain_pending()
        if not self.slots:
            return False
        if self.fault_hook is not None:
            self.fault_hook("decode")
        worst = max(len(r.prompt) + len(r.generated)
                    for r in self.slots.values())
        if worst + n_steps > self.max_len - 1:
            raise ValueError(f"decode_block({n_steps}) would overrun "
                             f"max_len {self.max_len} (deepest live slot "
                             f"at {worst})")
        # attend only the live prefix, bucketed to 256-position steps
        need = worst + n_steps + 1
        bucket = min(self.max_len, ((need + 255) // 256) * 256)
        attend = bucket if bucket < self.max_len else 0
        greedy = self.temperature <= 0.0
        aidx, single = self._adapter_args()
        with self._cache_write():
            step = self._program(
                self._decode_key(attend, greedy, aidx, single),
                functools.partial(self._decode_step, attend, greedy, aidx,
                                  single))
            self._blk_first.copy_(self.last_token)
            self._step_ctr.zero_()
            for _ in range(n_steps):
                step()
            self._count_steps(n_steps, attend)
            if self.draft_model is not None:
                self._program(
                    ("draft_catchup", n_steps, attend),
                    functools.partial(self._draft_catchup, n_steps,
                                      attend))()
        host_t, host_lp, landed = self._to_host(self._blk_toks[:n_steps],
                                                self._blk_lps[:n_steps])
        self._pending_block = {"toks": host_t, "lps": host_lp,
                               "landed": landed, "n_steps": n_steps,
                               "batch": len(self.slots),
                               "t0": time.perf_counter()}
        get_profiler().event("dispatch", "decode_block", n_steps=n_steps,
                             batch=len(self.slots))
        return True

    def _to_host(self, *tensors):
        """Start the copies of ``tensors`` to (pinned) host memory without
        waiting; returns the host tensors and the event their copies
        complete at (None on the CPU, where they are the tensors)."""
        if self.device.type != "cuda":
            return (*tensors, None)
        hosts = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            hosts.append(h)
        landed = torch.cuda.Event()
        landed.record()
        return (*hosts, landed)

    def decode_block_finish(self) -> Dict[int, List[int]]:
        """Wait for the in-flight block's tokens and do the host
        bookkeeping; returns request id -> new tokens ({} when no block
        is in flight)."""
        pending = self._pending_block
        if pending is None:
            return {}
        self._pending_block = None
        if pending["landed"] is not None:
            pending["landed"].synchronize()
        block = pending["toks"].tolist()
        block_lp = pending["lps"].tolist()
        self.last_dispatch_landed = time.monotonic()
        get_profiler().event(
            "readback", "decode_block",
            dur_ms=(time.perf_counter() - pending["t0"]) * 1e3,
            n_steps=pending["n_steps"], batch=pending["batch"])
        out: Dict[int, List[int]] = {}
        for slot, req in list(self.slots.items()):
            seq = [int(row[slot]) for row in block]
            if self.eos_id is not None and self.eos_id in seq:
                seq = seq[: seq.index(self.eos_id) + 1]
            req.generated.extend(seq)
            req.logprobs.extend(float(row[slot])
                                for row in block_lp[: len(seq)])
            self.tokens_generated += len(seq)
            out[req.request_id] = seq
            self._maybe_finish(slot)
        self._sync_tables()
        get_tracer().record(
            "engine.decode_block",
            (time.perf_counter() - pending["t0"]) * 1e3,
            n_steps=pending["n_steps"], batch=pending["batch"])
        return out

    # ---- adaptive k: the EMA walks the shape-set ladder one rung per
    # crossing, with a hysteresis band so k does not thrash on
    # round-to-round noise, and a periodic k = 1 probe so a workload
    # that recovered its predictability climbs back out of k = 0
    SPEC_EMA_BETA = 0.25
    SPEC_EMA_HI = 0.7
    SPEC_EMA_LO = 0.35
    SPEC_PROBE_EVERY = 8

    def _kset_floor(self, k: int) -> int:
        """Largest shape-set member <= k (the set holds 0)."""
        out = 0
        for v in self._spec_kset:
            if v <= k:
                out = v
        return out

    def _spec_clamp(self, k: int) -> int:
        """THE k clamp (shared by :meth:`spec_plan_k` and an explicit
        ``spec_step_start(k=...)``): shrink near the cache end instead of
        refusing (k = 0 is a plain, draft-cache-maintaining step, so a
        slot can always be drained to max_len this way), then floor onto
        the shape set."""
        worst = max(len(r.prompt) + len(r.generated)
                    for r in self.slots.values())
        return self._kset_floor(max(0, min(k, self.max_len - 2 - worst)))

    def spec_plan_k(self, budget_cap: Optional[int] = None) -> int:
        """The k the NEXT spec round dispatches: the ladder's rung
        (``spec_k`` flat when ``spec_adaptive`` is off), capped so at most
        ``budget_cap`` tokens are emitted (k <= budget_cap - 1) and by
        the cache headroom, floored onto the shape set. PURE: no state
        changes."""
        if self.draft_model is None or not self.slots:
            return 0
        if self.spec_adaptive:
            k = self._spec_kset[self._spec_idx]
            if (k == 0 and len(self._spec_kset) > 1
                    and self._spec_zero_rounds % self.SPEC_PROBE_EVERY
                    == self.SPEC_PROBE_EVERY - 1):
                k = self._spec_kset[1]     # periodic re-measure probe
        else:
            k = self.spec_k
        if budget_cap is not None:
            k = max(0, min(k, budget_cap - 1))
        return self._spec_clamp(k)

    def spec_step(self, k: Optional[int] = None) -> Dict[int, List[int]]:
        """One speculative round for every live slot: the draft proposes
        ``k`` tokens (k+1 draft forwards), ONE target forward over k+1
        rows verifies them, and the accepted prefix plus one bonus or
        resampled token is emitted: 1 to k+1 tokens per slot. Greedy
        engines emit the plain greedy chain; at temperature > 0 the
        acceptance rule is rejection sampling, so the output is
        distributed as plain sampling's. Rejected positions sit at or
        beyond each slot's new write offset in BOTH caches, so rollback
        costs nothing. ``k=None`` plans the round (:meth:`spec_plan_k`).
        This is :meth:`spec_step_start` + :meth:`spec_step_finish`."""
        self.spec_step_start(k)
        return self.spec_step_finish()

    def _spec_draft(self, k1: int, greedy: bool, temp: float,
                    attend: int):
        """``k1`` draft steps from each slot's last token: (B, k1)
        proposals, and with sampling the (B, k1, V) filtered, tempered
        draft distributions q they were drawn from (None when greedy)."""
        last, lens = self.last_token, self.lengths
        toks_l, q_l = [], []
        for _ in range(k1):
            logits, _ = self._draft_forward(last[:, None], self.draft_cache,
                                            lens, attend)
            logits = logits[:, 0]
            if greedy:
                toks = torch.argmax(logits, dim=-1)
            else:
                logits = filter_logits(logits / temp, self.top_k,
                                       self.top_p, self.min_p)
                toks = sample(logits, self._gen)
                q_l.append(torch.softmax(logits, dim=-1))
            toks_l.append(toks)
            last, lens = toks, lens + 1
        return (torch.stack(toks_l, dim=1),
                torch.stack(q_l, dim=1) if q_l else None)

    def _spec_verify(self, d: torch.Tensor, q: Optional[torch.Tensor],
                     greedy: bool, temp: float, attend: int):
        """One target forward over ``[last, d]`` (B, k+1) fused with the
        acceptance rule: ``(accepted (B,), out (B, k+1), logprobs (B,
        k+1), final (B,))``. Greedy accepts the longest draft prefix that
        agrees with the target's argmax chain; sampling runs
        :func:`speculative_accept`."""
        B, k = d.shape
        inputs = torch.cat([self.last_token[:, None], d], dim=1)
        logits, _ = self._forward(inputs, self.cache, self.lengths, attend)
        if greedy:
            rows = torch.arange(B, device=self.device)
            t = torch.argmax(logits, dim=-1)
            matches = (d == t[:, :k]).to(torch.int64)
            accepted = torch.cumprod(matches, dim=1).sum(dim=1)
            final = t[rows, accepted]
            out = torch.cat([d, torch.zeros((B, 1), dtype=d.dtype,
                                            device=self.device)], dim=1)
            out[rows, accepted] = final
            # the emitted tokens ARE the target's greedy chain, so their
            # logprobs are the verify forward's at those positions
            return accepted, out, token_logprob(logits, t), final
        p = torch.softmax(filter_logits(logits / temp, self.top_k,
                                        self.top_p, self.min_p), dim=-1)
        return speculative_accept(d, q, p, self._gen)

    def _spec_attend(self, k: int) -> int:
        """The attended window of a round of depth ``k``: the live prefix
        plus the round's k+1 positions, bucketed to 256 (0 = the whole
        cache), as :meth:`decode_block_start` buckets its steps."""
        worst = max(len(r.prompt) + len(r.generated)
                    for r in self.slots.values())
        bucket = min(self.max_len, ((worst + k + 2 + 255) // 256) * 256)
        return bucket if bucket < self.max_len else 0

    def _spec_key(self, k: int, attend: int, greedy: bool) -> tuple:
        return ("spec_round", k, attend, self._sampling_key(greedy))

    def spec_step_start(self, k: Optional[int] = None) -> bool:
        """Enqueue one speculative round without waiting for it (a graph
        engine replays the round's captured graph): the draft steps, the
        verify forward and the acceptance, and the on-device advance of
        ``last_token``/``lengths``; then start the asynchronous copy of
        (accepted, tokens, logprobs) to the host.
        Returns False (nothing enqueued) on an empty batch. A greedy
        round consumes no randomness."""
        if self.draft_model is None:
            raise RuntimeError(
                "spec_step needs an engine built with draft_model=")
        self._drain_pending()
        if not self.slots:
            return False
        if self.fault_hook is not None:
            self.fault_hook("spec")
        k = self.spec_plan_k() if k is None else self._spec_clamp(k)
        greedy = self.temperature <= 0.0
        attend = self._spec_attend(k)
        bufs = self._spec_buffers(k)
        with self._cache_write():
            self._program(self._spec_key(k, attend, greedy),
                          functools.partial(self._spec_round, k, greedy,
                                            attend))()
        host_a, host_out, host_lp, landed = self._to_host(*bufs)
        self._pending_spec = {
            "accepted": host_a, "out": host_out, "lps": host_lp,
            "landed": landed, "k": k, "batch": len(self.slots),
            "t0": time.perf_counter(),
        }
        get_profiler().event("dispatch", "spec_round", k=k,
                             batch=len(self.slots))
        return True

    def spec_step_finish(self) -> Dict[int, List[int]]:
        """Wait for the in-flight spec round and do the host bookkeeping:
        extend each slot's chain (EOS/stop cuts included), update the
        acceptance EMA and the k ladder, grow block tables. Returns
        request id -> new tokens ({} when no round is in flight)."""
        pending = self._pending_spec
        if pending is None:
            return {}
        self._pending_spec = None
        if pending["landed"] is not None:
            pending["landed"].synchronize()
        a_h = pending["accepted"].tolist()
        out_h = pending["out"].tolist()
        lp_h = pending["lps"].tolist()
        self.last_dispatch_landed = time.monotonic()
        get_profiler().event(
            "readback", "spec_round",
            dur_ms=(time.perf_counter() - pending["t0"]) * 1e3,
            k=pending["k"], batch=pending["batch"])
        k = pending["k"]
        out: Dict[int, List[int]] = {}
        accepted_sum = 0
        for slot, req in list(self.slots.items()):
            n = int(a_h[slot])
            accepted_sum += n
            seq = [int(x) for x in out_h[slot][: n + 1]]
            if self.eos_id is not None and self.eos_id in seq:
                seq = seq[: seq.index(self.eos_id) + 1]
            req.generated.extend(seq)
            req.logprobs.extend(float(x) for x in lp_h[slot][: len(seq)])
            self.tokens_generated += len(seq)
            out[req.request_id] = seq
            self._maybe_finish(slot)
        self.spec_rounds += 1
        if k > 0:
            proposed = k * pending["batch"]
            self.spec_proposed += proposed
            self.spec_accepted += accepted_sum
            rate = accepted_sum / proposed
            self._spec_rate_samples.append(rate)
            self._spec_zero_rounds = 0
            if self.spec_adaptive:
                self.spec_accept_ema = (
                    (1.0 - self.SPEC_EMA_BETA) * self.spec_accept_ema
                    + self.SPEC_EMA_BETA * rate)
                if (self.spec_accept_ema >= self.SPEC_EMA_HI
                        and self._spec_idx < len(self._spec_kset) - 1):
                    self._spec_idx += 1
                elif (self.spec_accept_ema <= self.SPEC_EMA_LO
                        and self._spec_idx > 0):
                    self._spec_idx -= 1
        else:
            self._spec_zero_rounds += 1
        self._sync_tables()
        get_tracer().record(
            "engine.spec_round", (time.perf_counter() - pending["t0"]) * 1e3,
            k=k, batch=pending["batch"], accepted=accepted_sum)
        return out

    def spec_stats(self) -> dict:
        """The speculative-decoding block of ``/v1/stats`` (``spec``):
        shape-set and ladder gauges plus the rounds/proposed/accepted
        ledger the scheduler delta-exports."""
        if self.draft_model is None:
            return {"enabled": False}
        return {
            "enabled": True,
            "k": self.spec_plan_k() if self.slots
            else (self._spec_kset[self._spec_idx] if self.spec_adaptive
                  else self.spec_k),
            "k_max": self.spec_k,
            "k_set": list(self._spec_kset),
            "adaptive": self.spec_adaptive,
            "acceptance_ema": round(self.spec_accept_ema, 4),
            "rounds": self.spec_rounds,
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
        }

    def warm_spec_programs(self) -> None:
        """Run one draft prefill chunk and one round of every k of the
        shape set NOW, with zero admissions, so kernel builds, library
        loads and the w8a16 launch plans of every round shape happen
        before traffic (the reference compiles its draft/verify programs
        here); a graph engine captures the round of every k at every
        attend bucket at the engine's sampling mode. The dummy rounds
        scribble masked positions of empty slots; the decode state, the
        generator's state and the forward counters are left as they
        were. No-op without a draft."""
        if self.draft_model is None:
            return
        if self.slots:
            raise RuntimeError(
                "warm_spec_programs must run before any admission "
                "(it scribbles on empty slots' masked stripes)")
        greedy = self.temperature <= 0.0
        P = self.prefill_len
        attends = self._attend_buckets() if self.decode_graphs else [0]
        with self._cache_write():
            self._draft_forward(
                torch.zeros((1, P), dtype=torch.int64, device=self.device),
                {k: c[:, 0:1] for k, c in self.draft_cache.items()},
                torch.zeros(1, dtype=torch.int32, device=self.device))
            for k in self._spec_kset:
                self._spec_buffers(k)
                for attend in attends:
                    self._warm(self._spec_key(k, attend, greedy),
                               functools.partial(self._spec_round, k, greedy,
                                                 attend))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _find_stop(generated: List[int], stops: List[List[int]],
                   scanned: int = 0) -> int:
        """Start index of the earliest stop-sequence match, or -1;
        resumes a stop-window before ``scanned``."""
        best = -1
        for seq in stops:
            n = len(seq)
            for i in range(max(0, scanned - n + 1), len(generated) - n + 1):
                if generated[i:i + n] == seq:
                    if best < 0 or i < best:
                        best = i
                    break
        return best

    def _maybe_finish(self, slot: int) -> None:
        req = self.slots[slot]
        total = len(req.prompt) + len(req.generated)
        reason = ""
        if req.stop:
            cut = self._find_stop(req.generated, req.stop, req.stop_scanned)
            if cut >= 0:
                req.generated = req.generated[:cut]
                req.logprobs = req.logprobs[:cut]
                reason = "stop"
            else:
                req.stop_scanned = len(req.generated)
        if not reason:
            if self.eos_id is not None and req.generated[-1] == self.eos_id:
                reason = "eos"
            elif total >= self.max_len - 1:
                reason = "max_len"
        if reason:
            self.finished.append(GenerationResult(
                req.request_id, req.prompt, req.generated, reason,
                logprobs=req.logprobs))
            del self.slots[slot]
            self._release_table(req.request_id)
            # completion feeds the radix cache (after the release: the
            # freed blocks are the room the insert wants)
            self._radix_insert(slot, req)

    # ------------------------------------------------------- convenience

    def generate(self, prompts: List[List[int]], max_new_tokens: int,
                 block_size: int = 32, stop=None) -> List[GenerationResult]:
        """Run all prompts to completion (continuous batching: new
        prompts are admitted as slots free up), decoding in blocks of up
        to ``block_size`` steps capped at the smallest remaining budget
        of this call's requests and at the cache headroom."""
        pending = list(enumerate(prompts))
        want: Dict[int, int] = {}
        results: Dict[int, GenerationResult] = {}
        budget: Dict[int, int] = {}
        while True:
            while pending and self.free_slots():
                idx, p = pending.pop(0)
                rid = self.add_request(p, stop=stop)
                want[rid] = idx
                budget[rid] = max_new_tokens
            for slot, req in list(self.slots.items()):
                if (req.request_id in budget
                        and len(req.generated) >= budget[req.request_id]):
                    self.finish_slot(slot, n_keep=budget[req.request_id])
            remaining: List[GenerationResult] = []
            for r in self.finished:
                if r.request_id in want:
                    results[want.pop(r.request_id)] = r
                else:
                    remaining.append(r)
            self.finished = remaining
            if not pending and not any(
                req.request_id in budget for req in self.slots.values()
            ):
                break
            if self.slots:
                owned = [r for r in self.slots.values()
                         if r.request_id in budget]
                n = block_size
                if owned:
                    n = min(n, min(budget[r.request_id] - len(r.generated)
                                   for r in owned))
                worst = max(len(r.prompt) + len(r.generated)
                            for r in self.slots.values())
                n = min(n, self.max_len - 2 - worst)
                if n >= 1:
                    self.decode_block(n)
                else:
                    self.step()
        return [results[i] for i in sorted(results)]

    def spec_throughput(self, rounds: int = 32, batch: Optional[int] = None,
                        overhead_seconds: float = 0.0,
                        detail: bool = False):
        """(tokens/sec, emitted tokens per slot-round) over ``rounds``
        speculative rounds at the given concurrency, after one warm
        round: the spec counterpart of :meth:`throughput`. Slots that
        drain at ``max_len`` mid-run are refilled every round, so the
        number is steady-state serving throughput (admission included).
        ``overhead_seconds`` is subtracted once per round."""
        if self.draft_model is None:
            raise RuntimeError(
                "spec_throughput needs an engine built with draft_model=")
        batch = batch or self.max_batch
        for _ in range(min(batch, self.free_slots())):
            self.add_request([1, 2, 3])
        self.spec_step()                              # warm
        produced = slot_rounds = 0
        t0 = time.perf_counter()
        for _ in range(rounds):
            for _ in range(min(batch, self.max_batch) - len(self.slots)):
                self.add_request([1, 2, 3])           # refill drained
            slot_rounds += len(self.slots)
            out = self.spec_step()
            produced += sum(len(v) for v in out.values())
        wall = time.perf_counter() - t0
        dt = max(wall - overhead_seconds * rounds, 1e-6)
        if detail:
            return {
                "tokens_per_sec": produced / dt,
                "tokens_per_sec_raw": produced / max(wall, 1e-6),
                "tokens_per_round": produced / max(1, slot_rounds),
                "produced": produced,
                "wall_seconds": round(wall, 3),
            }
        return produced / dt, produced / max(1, slot_rounds)

    def throughput(self, n_steps: int = 50, batch: Optional[int] = None,
                   overhead_seconds: float = 0.0) -> float:
        """Decode tokens/sec at the given concurrency over one timed
        block (after one warm block), readback included."""
        batch = batch or self.max_batch
        for _ in range(min(batch, self.free_slots())):
            self.add_request([1, 2, 3])
        worst = max((len(r.prompt) + len(r.generated)
                     for r in self.slots.values()), default=0)
        n = min(n_steps, max(1, (self.max_len - 2 - worst) // 2))
        self.decode_block(n)
        for _ in range(min(batch, self.free_slots())):
            self.add_request([1, 2, 3])
        t0 = time.perf_counter()
        out = self.decode_block(n)
        dt = time.perf_counter() - t0 - overhead_seconds
        done = sum(len(seq) for seq in out.values())
        return done / dt if dt > 0 else 0.0
