"""The port's radix prefix cache, admission cost model, preempt/resume and
recovery, held against the JAX package on the CPU.

- The copied ``RadixIndex`` and the reference's run one seeded sequence
  of insert/match/lock/reclaim/register/drop over their own block pools:
  the same matches, evictions and block counts after every operation.
- The port engine and the JAX engine, both with ``radix_cache=True``,
  serve the same bridged int8 weights with an int8 KV cache (fp32
  compute) through one seeded workload of prompts that share heads, with
  more requests than slots: the same greedy tokens, and the same
  ``radix_stats``, ``kv_stats``, ``admit_block_cost`` and ``can_admit``
  answers at every step, no block leaked. The JAX side runs as its own
  tests run it: the w8a16 Pallas kernels in interpret mode (opt-in set
  with ``monkeypatch``), the decode-kernel opt-in off (it raises
  ``UnboundLocalError`` in the reference, ROADMAP queue C).
- A radix hit is token- and logprob-identical to a cold engine;
  preempt -> resume is token-identical to an uninterrupted run and
  ``drop_parked`` gives every block back; a fault raised mid-prefill
  poisons the cache and ``recover()`` returns the live ids and serves
  again.
"""

import jax
import numpy as np
import pytest
import torch

from instaslice_tpu.models.lm import TpuLM as JaxLM
from instaslice_tpu.serving import AdmissionRequest as JaxAdmission
from instaslice_tpu.serving import ServingEngine as JaxEngine
from instaslice_tpu.serving import kvcache as jkv
from instaslice_tpu_torch import faults as tfaults
from instaslice_tpu_torch.models.lm import TpuLM
from instaslice_tpu_torch.serving import AdmissionRequest, ServingEngine
from instaslice_tpu_torch.serving import kvcache as tkv
from torch_port_util import both_params, configs, numpy_params

ENGINE = dict(max_batch=3, max_len=96, prefill_len=16, kv_quant=True,
              kv_block_size=8)


# ------------------------------------------------------------ RadixIndex

def _index_trace(kv, seed: int = 0, n_ops: int = 160) -> list:
    """One seeded op sequence over ``kv``'s RadixIndex; the observable
    state after every op."""
    rng = np.random.default_rng(seed)
    pool = kv.KVBlockPool(40, 4)
    idx = kv.RadixIndex(pool, 4)
    locked, registered, out = [], [], []

    def seq():
        # tokens from {0, 1}: long shared heads, frequent splits
        return [int(t) for t in rng.integers(0, 2, int(rng.integers(4, 29)))]

    for _ in range(n_ops):
        op = int(rng.integers(0, 6))
        if op <= 1:                                  # insert
            grans = idx.granules_of(seq(), 10 ** 6)
            if not grans:
                continue
            parent, matched = idx.ensure_path(grans)
            if matched == len(grans):
                idx.touch(parent)
                rec = ("touch", matched)
            else:
                try:
                    node = idx.add_child(parent, grans[matched:])
                    rec = ("add", matched, node.start, node.end,
                           node.pool_block_count())
                except kv.BlockPoolExhausted:
                    rec = ("full", matched)
        elif op == 2:                                # match (+ lock)
            m = idx.match(seq(), 10 ** 6)
            rec = ("match", m.length, [(n.start, n.end) for n in m.path])
            if m.path and rng.random() < 0.5:
                idx.lock(m.path[-1])
                locked.append(m.path[-1])
        elif op == 3 and locked:                     # unlock
            idx.unlock(locked.pop(int(rng.integers(0, len(locked)))))
            rec = ("unlock",)
        elif op == 4:                                # reclaim
            rec = ("reclaim", idx.reclaim(int(rng.integers(1, 12))))
        else:                                        # register / drop
            if registered and rng.random() < 0.5:
                node = registered.pop(0)
                node.registered = False
                cur = node
                while (cur is not None and cur is not idx.root
                       and not cur.children and cur.locks == 0
                       and not cur.registered):
                    parent = cur.parent
                    idx.evict(cur)
                    cur = parent
                rec = ("drop",)
            else:
                m = idx.match(seq(), 10 ** 6)
                if not m.path or m.length != m.path[-1].end:
                    continue
                node = m.path[-1]
                node.registered = True
                rec = ("register", idx.pin_path(node))
                registered.append(node)
        out.append((rec, idx.node_count(), idx.tokens_cached(),
                    idx.pool_blocks(), idx.evictable_blocks(),
                    idx.evictions, pool.free_blocks(), pool.used_blocks(),
                    pool.pinned_blocks(), len(idx.hot_paths())))
    return out


def test_radix_index_copy_matches_the_reference():
    want = _index_trace(jkv)
    got = _index_trace(tkv)
    assert got == want
    kinds = {rec[0][0] for rec in want}
    assert {"add", "match", "reclaim", "register", "drop"} <= kinds
    assert any(rec[0][0] == "reclaim" and rec[0][1] > 0 for rec in want)
    assert (tkv.granule_hash((3, 1, 4)) == jkv.granule_hash((3, 1, 4)))


# ------------------------------------------------------ engine vs engine

@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = configs("fp32")
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 0), quantize=True)
    return jcfg, tcfg, jtree, ttree


def _prompts(seed: int, n: int):
    """Prompts over two shared heads (2 and 3 granules) with fresh tails."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(1, 256, 32).tolist(),
             rng.integers(1, 256, 48).tolist()]
    return [heads[i % 2][: 16 * int(rng.integers(1, 4))]
            + rng.integers(1, 256, int(rng.integers(3, 30))).tolist()
            for i in range(n)]


def _snapshot(eng) -> dict:
    return {"radix": eng.radix_stats(), "kv": eng.kv_stats(),
            "digest": eng.radix_digest()}


def _drive(eng, prompts, burst, budget: int = 5):
    """Admit sequentially while ``can_admit`` says so, decode in blocks
    capped at the smallest remaining budget, finish at the budget; then
    one burst admission. The trace of every cost-model answer and
    snapshot, and rid -> tokens."""
    trace, pending = [], list(prompts)
    while pending or eng.slots:
        while pending and eng.free_slots():
            p = pending[0]
            ok = eng.can_admit(p)
            trace.append(("cost", eng.admit_block_cost(p), ok,
                          eng.can_admit(len(p))))
            if not ok:
                break
            eng.add_request(pending.pop(0))
            trace.append(("admit", _snapshot(eng)))
        for slot, req in list(eng.slots.items()):
            if len(req.generated) >= budget:
                eng.finish_slot(slot, n_keep=budget)
        if eng.slots:
            eng.decode_block(min(budget - len(r.generated)
                                 for r in eng.slots.values()))
        trace.append(("round", _snapshot(eng)))
    rids = eng.add_requests([AdmissionRequest(p) if isinstance(
        eng, ServingEngine) else JaxAdmission(p) for p in burst])
    trace.append(("burst", rids, _snapshot(eng)))
    eng.decode_block(budget - 1)
    for slot in list(eng.slots):
        eng.finish_slot(slot)
    trace.append(("end", _snapshot(eng)))
    return trace, {r.request_id: r.tokens for r in eng.finished}


def test_radix_engine_matches_jax(weights, monkeypatch):
    monkeypatch.setenv("TPUSLICE_QUANT_KERNEL", "1")
    monkeypatch.delenv("TPUSLICE_DECODE_KERNEL", raising=False)
    jax.clear_caches()
    jcfg, tcfg, jtree, ttree = weights
    prompts = _prompts(0, 7)
    burst = _prompts(1, 3)
    jeng = JaxEngine(JaxLM(jcfg), jtree, radix_cache=True, **ENGINE)
    teng = ServingEngine(TpuLM(tcfg), ttree, device="cpu",
                         radix_cache=True, **ENGINE)
    want, want_toks = _drive(jeng, prompts, burst)
    got, got_toks = _drive(teng, prompts, burst)
    assert got_toks == want_toks
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    end = got[-1][1]
    assert end["radix"]["hits"] >= 3 and end["radix"]["inserted"] >= 3
    assert end["radix"]["evicted"] >= 1        # the pool filled up
    assert end["kv"]["used"] == end["radix"]["blocks"]   # nothing leaked
    jax.clear_caches()


# --------------------------------------------------------- port engine

@pytest.fixture
def port_engine(weights):
    _, tcfg, _, ttree = weights

    def make(**kw):
        cfg = dict(ENGINE, **kw)
        return ServingEngine(TpuLM(tcfg), ttree, device="cpu", **cfg)

    return make


def _finish_all(eng):
    for slot in list(eng.slots):
        eng.finish_slot(slot)


def test_radix_hit_equals_cold(port_engine):
    """A prompt whose head the cache holds, admitted alone and in a
    burst: the same tokens and logprobs as on a cold engine."""
    head = _prompts(2, 1)[0][:32]
    seed_prompt = head + [7, 8, 9]
    prompts = [head + [11, 12, 13, 14], head[:16] + [21, 22]]
    warm, cold = port_engine(), port_engine(radix_cache=False)
    warm.add_request(seed_prompt)
    warm.decode_block(3)
    _finish_all(warm)
    for eng in (warm, cold):
        eng.finished.clear()
        eng.add_request(prompts[0])
        eng.decode_block(6)
        _finish_all(eng)
        eng.add_requests([AdmissionRequest(p) for p in prompts])
        eng.decode_block(6)
        _finish_all(eng)
    assert warm.prefix_hits == 3 and cold.prefix_hits == 0
    assert warm.prefix_tokens_saved == 32 + 32 + 16
    for a, b in zip(warm.finished, cold.finished):
        assert a.tokens == b.tokens
        np.testing.assert_array_equal(a.logprobs, b.logprobs)
    assert warm.kv.used_blocks() == warm.radix.pool_blocks()
    assert cold.kv.used_blocks() == 0


def test_preempt_resume_is_token_identical(port_engine):
    prompts = _prompts(3, 3)
    plain, eng = port_engine(radix_cache=False), port_engine(radix_cache=False)
    want = plain.generate(prompts, max_new_tokens=12, block_size=4)
    rids = [eng.add_request(p) for p in prompts]
    eng.decode_block(4)
    slot = next(s for s, r in eng.slots.items() if r.request_id == rids[1])
    used = eng.kv.used_blocks()
    assert eng.preempt_slot(slot) == rids[1]
    assert rids[1] in eng.parked and eng.kv.used_blocks() == used
    eng.decode_block(3)                  # the others run on without it
    eng.resume_request(rids[1])
    assert eng.preempted_total == eng.resumed_total == 1
    while eng.slots:
        for s, r in list(eng.slots.items()):
            if len(r.generated) >= 12:
                eng.finish_slot(s, n_keep=12)
        if eng.slots:
            eng.decode_block(1)
    got = {r.request_id: r.tokens for r in eng.finished}
    assert [got[r] for r in rids] == [w.tokens for w in want]
    # drop_parked reconciles the pool
    eng.add_request(prompts[0])
    rid = eng.preempt_slot(next(iter(eng.slots)))
    assert eng.kv.used_blocks() > 0
    assert eng.drop_parked(rid) and not eng.drop_parked(rid)
    assert eng.kv.used_blocks() == 0 and not eng.parked


def test_fault_mid_prefill_poisons_and_recover_serves_again(port_engine):
    eng = port_engine()
    plan = tfaults.FaultPlan(0).site("engine.prefill", at_calls=(2,),
                                     kinds=("poison",))
    eng.fault_hook = tfaults.engine_fault_hook(plan, eng)
    live = eng.add_request([5, 6, 7, 8])
    with pytest.raises(tfaults.FaultError):
        eng.add_request([9, 10, 11])
    assert eng.cache_poisoned()
    with pytest.raises(RuntimeError, match="poisoned"):
        eng.decode_block(2)
    assert eng.recover() == [live]
    assert not eng.cache_poisoned() and not eng.slots
    assert eng.kv.used_blocks() == eng.radix.pool_blocks()
    eng.add_request([5, 6, 7, 8])
    assert len(eng.decode_block(3)) == 1
    # a device call that raises mid-prefill (second chunk) poisons too
    calls = []
    forward = eng._forward

    def failing(tokens, *a, **kw):
        calls.append(tokens.shape)
        if len(calls) == 2:
            raise RuntimeError("device fault")
        return forward(tokens, *a, **kw)

    eng._forward = failing
    used = eng.kv.used_blocks()
    with pytest.raises(RuntimeError, match="device fault"):
        eng.add_request(list(range(1, 40)))
    assert eng.cache_poisoned() and eng.kv.used_blocks() == used
    eng._forward = forward
    assert len(eng.recover()) == 1
    eng.add_request(list(range(1, 40)))
    assert len(eng.decode_block(2)) == 1
