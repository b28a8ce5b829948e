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
  reference's sites, and the tracer/profiler spans and events.

What the JAX engine has and this port does not yet: the mesh (tensor
parallelism), multi-LoRA, speculative decoding and session
export/import (ROADMAP queue A). The scheduler's guards keep those off
(``draft_model`` is None, ``n_adapters`` is 0, ``mesh`` is None).

Where the JAX engine compiles a ``lax.scan`` of decode steps, the port
runs a Python loop of device steps; sampled tokens stay on the device
and feed the next step, and the (n_steps, B) token block is copied to
the host once (asynchronously, between :meth:`decode_block_start` and
:meth:`decode_block_finish`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Dict, List, Optional

import torch

from instaslice_tpu_torch import resolve_device
from instaslice_tpu_torch.models.lm import Params, TpuLM
from instaslice_tpu_torch.obs.profiler import get_profiler
from instaslice_tpu_torch.ops import build
from instaslice_tpu_torch.ops import flash_decode as _fd
from instaslice_tpu_torch.serving.kvcache import (
    BlockPoolExhausted,
    BlockTable,
    KVBlockPool,
    RadixIndex,
    RadixMatch,
    RadixNode,
    radix_granule,
)
from instaslice_tpu_torch.serving.sampling import (
    apply_repetition_penalty,
    filter_logits,
    sample,
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
    """A preempted request: its host state plus its KV stripe, read out
    of the cache (an independent copy) so the slot could go back to the
    batch. The block table stays allocated (``ServingEngine._tables``):
    resume is one stripe write, never a re-prefill."""
    req: _Slot
    stripe: Params
    length: int                        # resident cache positions


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
        device="cuda",
    ) -> None:
        """``kv_quant=True`` stores the KV cache as int8 with per-vector
        scales (decode then runs the int8 decode-attention kernel).
        ``radix_cache``/``radix_decoded``/``max_prefixes`` and
        ``batched_prefill`` are the JAX engine's flags. ``device``
        defaults to the card and raises without one; pass
        ``device="cpu"`` to run the plain versions of the kernels."""
        self.device = resolve_device(device)
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
        # what the JAX engine's scheduler-facing surface reads and the
        # port does not have yet: no mesh, no draft, no adapters
        self.mesh = None
        self.draft_model = None
        self.n_adapters = 0
        self.adapter_names: Dict[str, int] = {}
        self._multiproc = False
        #: slot -> adapter id, read by the scheduler's adapter grouping;
        #: empty (every slot serves the base model)
        self._slot_adapter_host: Dict[int, int] = {}
        self.cache = model.init_cache(max_batch, max_len, quant=kv_quant,
                                      device=self.device)
        self.lengths = torch.zeros(max_batch, dtype=torch.int32,
                                   device=self.device)
        self.last_token = torch.zeros(max_batch, dtype=torch.int64,
                                      device=self.device)
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
        #: an in-flight decode block (dispatched, tokens not yet read)
        self._pending_block: Optional[dict] = None
        #: time.monotonic() stamp of the most recent decode readback
        #: landing (decode_block_finish / step): the scheduler splits
        #: device-bound time from host bookkeeping there
        self.last_dispatch_landed: Optional[float] = None

    @property
    def repetition_penalty(self) -> float:
        return self._repetition_penalty

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
                 lengths: torch.Tensor, attend_len: int = 0):
        return self.model.apply_with_cache(self.params, tokens, cache,
                                           lengths, attend_len=attend_len)

    def _prefill(self, tokens: List[int], slot: int,
                 offset: int) -> torch.Tensor:
        """One (1, prefill_len) chunk into slot ``slot``'s stripe at
        ``offset``; returns the chunk's (prefill_len, vocab) logits. The
        stripe is a view of the cache, so the chunk's K/V land in place;
        stale data of a prior occupant is never attended (the mask
        admits only positions below ``offset + t``)."""
        with self._cache_write():
            stripe = {k: c[:, slot:slot + 1] for k, c in self.cache.items()}
            toks = torch.tensor([tokens], dtype=torch.int64,
                                device=self.device)
            lens = torch.full((1,), offset, dtype=torch.int32,
                              device=self.device)
            logits, _ = self._forward(toks, stripe, lens)
        self.prefill_dispatches += 1
        return logits[0]

    def _prefill_batch(self, tokens: List[List[int]], slots: List[int],
                       offsets: List[int], n_real: int) -> torch.Tensor:
        """P same-shaped chunks into P slots' stripes in one forward:
        gather the stripes, run the (P, prefill_len) batch (each row at
        its own offset), scatter the ``n_real`` real rows back (padding
        rows duplicate a real row). Returns (P, prefill_len, vocab)."""
        with self._cache_write():
            idx = torch.tensor(slots, dtype=torch.int64, device=self.device)
            stripes = {k: c.index_select(1, idx)
                       for k, c in self.cache.items()}
            toks = torch.tensor(tokens, dtype=torch.int64,
                                device=self.device)
            lens = torch.tensor(offsets, dtype=torch.int32,
                                device=self.device)
            logits, stripes = self._forward(toks, stripes, lens)
            for k, c in self.cache.items():
                c.index_copy_(1, idx[:n_real], stripes[k][:, :n_real])
        self.prefill_dispatches += 1
        return logits

    def _read_stripe(self, slot: int, start: int, length: int) -> Params:
        """An independent copy of one slot's cache positions [start,
        start + length): every leaf is (L, B, Hkv, S[, hd]) with the slot
        on axis 1 and the position on axis 3. A copy, never a view: the
        cache is written in place, so a view would change under the
        slot's next occupant."""
        self._check_not_poisoned()
        return {k: c[:, slot:slot + 1, :, start:start + length].clone()
                for k, c in self.cache.items()}

    def _write_stripe(self, stripe: Params, slot: int, start: int) -> None:
        """Write a stored stripe into a slot at position ``start``.
        Stripes are absolute-position entities (RoPE bakes positions
        into K), so a segment only ever writes back at the offset it was
        read from."""
        with self._cache_write():
            for k, c in self.cache.items():
                s = stripe[k]
                c[:, slot:slot + 1, :, start:start + s.shape[3]].copy_(s)

    def _decode_logits(self, last: torch.Tensor, lens: torch.Tensor,
                       attend_len: int) -> torch.Tensor:
        logits, _ = self._forward(last[:, None], self.cache, lens,
                                  attend_len=attend_len)
        self.decode_steps += 1
        return logits[:, 0]

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
        source name: the port's counterpart of the JAX engine's
        per-jit compile-cache sizes (the profiler's compile watch reports
        any that appear mid-traffic)."""
        return {name: 1 for name in build.loaded()}

    def attention_route(self) -> str:
        """What computes a decode step's attention: "B1" where the int8
        decode kernel launches, else "plain" and why. A model at an
        (hd, G) that B1 is not built for serves on the card all the
        same, through the plain formulation; ``/v1/stats`` says so."""
        cfg = self.model.cfg
        hd, G = cfg.head_dim, cfg.n_heads // cfg.kv_heads
        if self.device.type != "cuda":
            return "plain (cpu)"
        if not self.kv_quant:
            return "plain (kv cache not int8)"
        if not _fd.kernel_built(hd, G):
            return f"plain (no B1 built for hd {hd}, G {G})"
        return "B1"

    def warm_prefill_buckets(self) -> None:
        """Run one chunk through every batched-prefill bucket, one
        single-row chunk and one decode step NOW, with zero admissions,
        so the kernel builds, library loads and cuBLAS handles happen
        before traffic. The dummy rows write masked positions of slot
        0's stripe (and one position of every slot): harmless while no
        slot is live. Forward and block counters are left as they were."""
        if self.slots:
            raise RuntimeError(
                "warm_prefill_buckets must run before any admission "
                "(it scribbles on slot 0's masked stripe)")
        counts = (self.prefill_dispatches, self.decode_steps)
        P = self.prefill_len
        if self.batched_prefill:
            for b in self._prefill_buckets:
                self._prefill_batch([[0] * P] * b, [0] * b, [0] * b, b)
        self._prefill([0] * P, 0, 0)
        with self._cache_write():
            self._decode_logits(torch.zeros_like(self.last_token),
                                torch.zeros_like(self.lengths), 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prefill_dispatches, self.decode_steps = counts

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
        """Park a live request off-batch: read its KV stripe out of the
        cache, free the slot, KEEP its block table. Returns the parked
        request id."""
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
        del self.slots[slot]
        self.parked[req.request_id] = _Parked(req, stripe, length)
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
        del self.parked[rid]
        self.lengths[slot] = parked.length
        self.last_token[slot] = req.generated[-1]
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

    def export_session(self, rid: int) -> dict:
        raise NotImplementedError(
            "session export is not ported yet (ROADMAP queue A, "
            "'Session migration')")

    def import_session(self, blob: dict) -> int:
        raise NotImplementedError(
            "session import is not ported yet (ROADMAP queue A, "
            "'Session migration')")

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
        rebuild a zeroed cache and decode state. Delivered ``finished``
        results, parked requests and the radix stripes survive (they
        are independent copies, never views of the cache)."""
        self._pending_block = None
        self.last_dispatch_landed = None
        lost = [r.request_id for r in self.slots.values()]
        for rid in lost:
            self._release_table(rid)
        self.slots.clear()
        self.cache = self.model.init_cache(self.max_batch, self.max_len,
                                           quant=self.kv_quant,
                                           device=self.device)
        self.lengths = torch.zeros_like(self.lengths)
        self.last_token = torch.zeros_like(self.last_token)
        if self.track_seen:
            self.seen = torch.zeros_like(self.seen)
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
        """Write the matched path's per-granule KV stripes into a slot up
        to ``length``: the radix-hit replacement for re-running that
        prefix's prefill chunks."""
        g = self.radix_granule
        for node in path:
            for i, stripe in enumerate(node.stripes):
                off = node.start + i * g
                if off >= length:
                    return
                self._write_stripe(stripe, slot, off)

    def _read_granule_stripes(self, slot: int, start_g: int, end_g: int):
        """Stripes of granules [start_g, end_g) of a slot's cache rows."""
        g = self.radix_granule
        return [self._read_stripe(slot, gi * g, g)
                for gi in range(start_g, end_g)]

    def _radix_insert(self, slot: int, req: _Slot) -> None:
        """Insert a finishing request's prompt (and, with
        ``radix_decoded``, its decoded tokens) into the radix tree.
        Called after the request's own table released. Best-effort:
        never evicts anything, never fails the completion path."""
        if not self.radix_cache:
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
            stripes = self._read_granule_stripes(slot, matched,
                                                 len(granules))
            node = self.radix.add_child(parent, granules[matched:])
            node.stripes = stripes
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
            stripes = self._read_granule_stripes(slot, matched,
                                                 len(granules))
            node = self.radix.add_child(parent, granules[matched:],
                                        pinned=True)
            node.stripes = stripes
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
                        start_chunk: int = 0) -> torch.Tensor:
        """Chunks [start_chunk, n) of ``prompt`` into a slot; the last
        chunk's logits."""
        n_chunks = -(-len(prompt) // self.prefill_len)
        logits = None
        for i in range(start_chunk, n_chunks):
            logits = self._prefill(self._chunk(prompt, i), slot,
                                   i * self.prefill_len)
        return logits

    def _fork_stripe(self, first: int, others: List[int],
                     prompt_len: int) -> None:
        """Copy slot ``first``'s prefilled (chunk-padded) stripe to the
        fork slots."""
        n = -(-prompt_len // self.prefill_len) * self.prefill_len
        with self._cache_write():
            for c in self.cache.values():
                for s in others:
                    c[:, s, :, :n] = c[:, first, :, :n]

    def _hit(self, pref: Optional[RadixMatch], slot: int) -> int:
        """Write a radix hit's stripes into ``slot`` and count it (or
        count the miss); returns the first chunk left to prefill."""
        if pref is None:
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
        pref = self._match_prefix(prompt)
        get_tracer().record(
            "engine.radix_match", (time.perf_counter() - t_match) * 1e3,
            matched=pref.length if pref else 0, tokens=len(prompt))
        tables = self._alloc_tables(len(prompt), n, pref)
        try:
            rids = self._admit_with_tables(prompt, n, stop, sp, pref,
                                           tables)
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

    def _admit_with_tables(self, prompt: List[int], n: int, stop, sp,
                           pref, tables: List[BlockTable]) -> List[int]:
        if self.fault_hook is not None:
            self.fault_hook("prefill")
        slots = self._free_slot_indices()[:n]
        if pref is not None:
            sp.attrs["prefix_hit"] = str(pref.length)
        start_chunk = self._hit(pref, slots[0])
        logits = self._prefill_chunks(slots[0], prompt, start_chunk)
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
        prefs = [self._match_prefix(r.prompt) for r in reqs]
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
        # radix-matched stripes land before any chunk round touches the
        # slot: each request joins the rounds at its own matched depth
        cursors = [self._hit(pref, ss[0])
                   for pref, ss in zip(prefs, slots_per)]
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
                        slots_per[ri][0], cursors[ri] * P)
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
        attended); returns request id -> new token."""
        self._drain_pending()
        if not self.slots:
            return {}
        with get_tracer().span("engine.decode_step", batch=len(self.slots)):
            return self._step_inner()

    def _step_inner(self) -> Dict[int, int]:
        if self.fault_hook is not None:
            self.fault_hook("decode")
        with self._cache_write():
            logits = self._decode_logits(self.last_token, self.lengths, 0)
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
        self.last_token = toks
        live = torch.zeros(self.max_batch, dtype=torch.bool,
                           device=self.device)
        live[list(self.slots)] = True
        self.lengths = torch.where(live, self.lengths + 1, self.lengths)
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
        """Land an in-flight decode block before any other mutation."""
        if self._pending_block is not None:
            self.decode_block_finish()

    def decode_block_start(self, n_steps: int) -> bool:
        """Enqueue ``n_steps`` decode steps and start the asynchronous
        copy of the token block to the host; returns without waiting
        for the device (False, and nothing enqueued, on an empty
        batch)."""
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
        temp = max(self.temperature, 1e-6)
        rows = torch.arange(self.max_batch, device=self.device)
        last, lens = self.last_token, self.lengths
        toks_steps, lps_steps = [], []
        with self._cache_write():
            for _ in range(n_steps):
                logits = self._decode_logits(last, lens, attend)
                if self.track_seen:
                    logits = apply_repetition_penalty(
                        logits, self.seen, self.repetition_penalty)
                if greedy:
                    toks = torch.argmax(logits, dim=-1)
                else:
                    logits = filter_logits(logits / temp, self.top_k,
                                           self.top_p, self.min_p)
                    toks = sample(logits, self._gen)
                if self.track_seen:
                    self.seen[rows, toks] = True
                lps_steps.append(token_logprob(logits, toks))
                toks_steps.append(toks)
                last, lens = toks, lens + 1
        self.last_token, self.lengths = last, lens
        block = torch.stack(toks_steps)
        block_lp = torch.stack(lps_steps)
        if self.device.type == "cuda":
            host_t = torch.empty(block.shape, dtype=block.dtype,
                                 pin_memory=True)
            host_lp = torch.empty(block_lp.shape, dtype=block_lp.dtype,
                                  pin_memory=True)
            host_t.copy_(block, non_blocking=True)
            host_lp.copy_(block_lp, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record()
        else:
            host_t, host_lp, landed = block, block_lp, None
        self._pending_block = {"toks": host_t, "lps": host_lp,
                               "landed": landed, "n_steps": n_steps,
                               "batch": len(self.slots),
                               "t0": time.perf_counter()}
        get_profiler().event("dispatch", "decode_block", n_steps=n_steps,
                             batch=len(self.slots))
        return True

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
