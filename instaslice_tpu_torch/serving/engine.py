"""Slot-based continuous-batching serving engine (port of
``instaslice_tpu/serving/engine.py``).

Requests occupy slots of a fixed ``(max_batch, max_len)`` KV cache;
prompts prefill in ``prefill_len`` chunks into their slot's stripe
(several admissions at once through :meth:`ServingEngine.add_requests`'
bucketed batched prefill), the first token is sampled at admission, and
:meth:`ServingEngine.decode_block` advances every slot ``n_steps`` tokens
with one host readback per block. Paged KV accounting uses the copied
:class:`~instaslice_tpu_torch.serving.kvcache.KVBlockPool`.

What the JAX engine has and this port does not yet: the mesh
(tensor parallelism), multi-LoRA, speculative decoding, the radix prefix
cache, preempt/resume, session export/import and the profiler/tracer
hooks. The JAX engine with ``radix_cache=False`` is the one this port is
held against.

Where the JAX engine compiles a ``lax.scan`` of decode steps, the port
runs a Python loop of device steps; sampled tokens stay on the device
and feed the next step, and the (n_steps, B) token block is copied to
the host once (asynchronously, between :meth:`decode_block_start` and
:meth:`decode_block_finish`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from instaslice_tpu_torch import resolve_device
from instaslice_tpu_torch.models.lm import Params, TpuLM
from instaslice_tpu_torch.serving.kvcache import (
    BlockPoolExhausted,
    BlockTable,
    KVBlockPool,
)
from instaslice_tpu_torch.serving.sampling import (
    apply_repetition_penalty,
    filter_logits,
    sample,
    token_logprob,
)


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


@dataclasses.dataclass
class _Slot:
    request_id: int
    prompt: List[int]
    generated: List[int]
    stop: List[List[int]] = dataclasses.field(default_factory=list)
    # positions before this are already stop-scanned (no match found)
    stop_scanned: int = 0
    logprobs: List[float] = dataclasses.field(default_factory=list)


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
        kv_block_size: int = 16,
        device="cuda",
    ) -> None:
        """``kv_quant=True`` stores the KV cache as int8 with per-vector
        scales (decode then runs the int8 decode-attention kernel).
        ``device`` defaults to the card and raises without one; pass
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
        #: request id -> block table (live slots)
        self._tables: Dict[int, BlockTable] = {}
        #: power-of-two row buckets of the batched prefill (bucket 1 is
        #: absent: a lone row takes the per-slot prefill)
        self._prefill_buckets = [
            1 << i for i in range(1, max_batch.bit_length())
            if (1 << i) <= max_batch
        ]
        self.prefill_batches = 0       # batched chunk dispatches
        #: forward passes run, by kind: prefill chunks (single-slot or
        #: batched) and decode steps (every step of every block)
        self.prefill_dispatches = 0
        self.decode_steps = 0
        #: an in-flight decode block (dispatched, tokens not yet read)
        self._pending_block: Optional[dict] = None

    @property
    def repetition_penalty(self) -> float:
        return self._repetition_penalty

    # ------------------------------------------------------------ device

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
        stripe = {k: c[:, slot:slot + 1] for k, c in self.cache.items()}
        toks = torch.tensor([tokens], dtype=torch.int64, device=self.device)
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
        idx = torch.tensor(slots, dtype=torch.int64, device=self.device)
        stripes = {k: c.index_select(1, idx) for k, c in self.cache.items()}
        toks = torch.tensor(tokens, dtype=torch.int64, device=self.device)
        lens = torch.tensor(offsets, dtype=torch.int32, device=self.device)
        logits, stripes = self._forward(toks, stripes, lens)
        for k, c in self.cache.items():
            c.index_copy_(1, idx[:n_real], stripes[k][:, :n_real])
        self.prefill_dispatches += 1
        return logits

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
        return sum(len(r.prompt) + len(r.generated)
                   for r in list(self.slots.values()))

    def kv_utilization(self) -> float:
        """Block-pool occupancy: resident tokens / capacity of the blocks
        allocated for them."""
        return self.kv.utilization(self._resident_tokens())

    def kv_stats(self) -> dict:
        out = self.kv.stats(dict(self._tables))
        out["utilization"] = self.kv_utilization()
        return out

    # ------------------------------------------------------- slot release

    def _release_table(self, rid: int) -> None:
        t = self._tables.pop(rid, None)
        if t is not None:
            self.kv.release(t)

    def _sync_tables(self) -> None:
        """Grow every live slot's block table to its token count."""
        for req in self.slots.values():
            t = self._tables.get(req.request_id)
            if t is None:
                continue
            total = len(req.prompt) + len(req.generated)
            if not self.kv.bump(t, total):
                self.kv.ensure(t, total)

    def finish_slot(self, slot: int, n_keep: Optional[int] = None,
                    reason: str = "max_new_tokens") -> None:
        """Externally finish a live slot (budget cut, client eviction),
        keeping at most ``n_keep`` tokens."""
        self._drain_pending()
        req = self.slots.pop(slot)
        self._release_table(req.request_id)
        toks = req.generated if n_keep is None else req.generated[:n_keep]
        lps = req.logprobs if n_keep is None else req.logprobs[:n_keep]
        self.finished.append(GenerationResult(
            req.request_id, req.prompt, toks, reason, logprobs=lps))

    def evict_slot(self, slot: int) -> None:
        """Drop a live slot with no result; its blocks free at once."""
        self._drain_pending()
        req = self.slots.pop(slot)
        self._release_table(req.request_id)

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

    def _alloc_tables(self, prompt_len: int, n: int) -> List[BlockTable]:
        """Block tables for an n-way admission, all-or-nothing: forks
        share the prompt's blocks copy-on-write."""
        tables: List[BlockTable] = []
        try:
            t0 = self.kv.allocate(0)
            tables.append(t0)
            self.kv.ensure(t0, prompt_len + 1)   # +1: the sampled token
            for _ in range(n - 1):
                t = self.kv.fork(t0, prompt_len)
                tables.append(t)
                self.kv.ensure(t, prompt_len + 1)
        except BlockPoolExhausted as e:
            for t in tables:
                self.kv.release(t)
            raise RuntimeError(f"kv block pool cannot admit this request: "
                               f"{e}") from None
        return tables

    def _chunk(self, prompt: List[int], i: int) -> List[int]:
        P = self.prefill_len
        c = prompt[i * P:(i + 1) * P]
        return c + [0] * (P - len(c))

    def _prefill_chunks(self, slot: int, prompt: List[int]) -> torch.Tensor:
        """Every chunk of ``prompt`` into a slot; the last chunk's logits."""
        n_chunks = -(-len(prompt) // self.prefill_len)
        logits = None
        for i in range(n_chunks):
            logits = self._prefill(self._chunk(prompt, i), slot,
                                   i * self.prefill_len)
        return logits

    def _fork_stripe(self, first: int, others: List[int],
                     prompt_len: int) -> None:
        """Copy slot ``first``'s prefilled (chunk-padded) stripe to the
        fork slots."""
        n = -(-prompt_len // self.prefill_len) * self.prefill_len
        for c in self.cache.values():
            for s in others:
                c[:, s, :, :n] = c[:, first, :, :n]

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

    def add_request(self, prompt: List[int], stop=None) -> int:
        """Admit a prompt; returns the request id. Raises when the batch
        is full or the prompt cannot fit the cache. Prompts longer than
        ``prefill_len`` prefill in chunks; the first token is sampled
        here."""
        return self.add_request_n(prompt, 1, stop=stop)[0]

    def add_request_n(self, prompt: List[int], n: int,
                      stop=None) -> List[int]:
        """Admit ``n`` samples of one prompt with ONE prefill: the stripe
        is copied to the other n-1 slots, each fork samples its own first
        token. All-or-nothing on capacity."""
        self._drain_pending()
        stop = self._normalize_stop(stop)
        self._check_prompt_fits(prompt)
        self._check_capacity(n)
        tables = self._alloc_tables(len(prompt), n)
        try:
            slots = self._free_slot_indices()[:n]
            logits = self._prefill_chunks(slots[0], prompt)
            last = logits[(len(prompt) - 1) % self.prefill_len]
            if n > 1:
                self._fork_stripe(slots[0], slots[1:], len(prompt))
            toks, lps = self._first_tokens(slots, prompt, last)
        except BaseException:
            for t in tables:
                self.kv.release(t)
            raise
        return self._register(slots, prompt, stop, tables, toks, lps)

    def add_requests(self, reqs: List[AdmissionRequest]) -> List[List[int]]:
        """Admit a BURST: every chunk round prefills one
        ``(P, prefill_len)`` multi-slot batch, P bucketed to powers of
        two, so B admissions cost ``max(chunks)`` rounds instead of
        ``sum(chunks)`` dispatches. Token-identical to admitting the
        requests one by one in order (rows are independent and
        first-token sampling runs per request in burst order). Returns
        one rid list per request; all-or-nothing on capacity."""
        reqs = [r if isinstance(r, AdmissionRequest)
                else AdmissionRequest(**r) for r in reqs]
        if len(reqs) <= 1:
            return [self.add_request_n(r.prompt, r.n, stop=r.stop)
                    for r in reqs]
        self._drain_pending()
        stops = [self._normalize_stop(r.stop) for r in reqs]
        for r in reqs:
            self._check_prompt_fits(r.prompt)
        self._check_capacity(sum(r.n for r in reqs))
        all_tables: List[List[BlockTable]] = []
        try:
            for r in reqs:
                all_tables.append(self._alloc_tables(len(r.prompt), r.n))
            sampled = self._admit_burst(reqs, all_tables)
        except BaseException:
            for tables in all_tables:
                for t in tables:
                    self.kv.release(t)
            raise
        return [self._register(ss, r.prompt, stop, tables, toks, lps)
                for r, stop, tables, (ss, toks, lps)
                in zip(reqs, stops, all_tables, sampled)]

    def _admit_burst(self, reqs: List[AdmissionRequest], all_tables):
        P = self.prefill_len
        free = self._free_slot_indices()
        slots_per: List[List[int]] = []
        i = 0
        for r in reqs:
            # contiguous low-first: what sequential admissions would pick
            slots_per.append(free[i:i + r.n])
            i += r.n
        cursors = [0] * len(reqs)
        n_chunks = [-(-len(r.prompt) // P) for r in reqs]
        last_logits: List[Optional[torch.Tensor]] = [None] * len(reqs)
        max_rows = self._prefill_buckets[-1] if self._prefill_buckets else 1
        while True:
            group = [gi for gi in range(len(reqs))
                     if cursors[gi] < n_chunks[gi]]
            if not group:
                break
            for gstart in range(0, len(group), max_rows):
                part = group[gstart:gstart + max_rows]
                if len(part) == 1:
                    ri = part[0]
                    logits1 = self._prefill(
                        self._chunk(reqs[ri].prompt, cursors[ri]),
                        slots_per[ri][0], cursors[ri] * P)
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
                for row_i, ri in enumerate(part):
                    if cursors[ri] == n_chunks[ri] - 1:
                        last_logits[ri] = logits[row_i]
            for ri in group:
                cursors[ri] += 1
        # per request in burst order: fork copies, then first tokens
        sampled = []
        for ri, r in enumerate(reqs):
            ss = slots_per[ri]
            if r.n > 1:
                self._fork_stripe(ss[0], ss[1:], len(r.prompt))
            ll = last_logits[ri][(len(r.prompt) - 1) % P]
            toks, lps = self._first_tokens(ss, r.prompt, ll)
            sampled.append((ss, toks, lps))
        return sampled

    # ------------------------------------------------------------ decode

    def step(self) -> Dict[int, int]:
        """One decode step for every live slot (the whole cache
        attended); returns request id -> new token."""
        self._drain_pending()
        if not self.slots:
            return {}
        logits = self._decode_logits(self.last_token, self.lengths, 0)
        toks, lps = self._sample(logits)
        toks_h, lps_h = toks.tolist(), lps.tolist()
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
                               "landed": landed}
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
