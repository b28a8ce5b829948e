"""The port's speculative decoding, held against the JAX package on the CPU.

- ``speculative_accept`` is held by distribution, with the reference's
  statistics (``tests/test_spec_decode.py``): total-variation distance
  of Monte-Carlo marginals from the exact target distribution (< 0.02 at
  40000 draws over 8 tokens, < 0.03 at 20000 with k = 0), never token by
  token; ``log p`` at every emitted position within 1e-5.
- A sampled spec engine with a disagreeing draft emits its first spec
  token with the exact tempered marginal (TV < 0.2 over 600 trials on a
  16-token vocabulary, as the reference; the plain sampled engine is the
  anchor).
- Greedy spec chains equal plain greedy decode of the same engine and the
  JAX spec engine's chain on the same bridged fp32 weights (an int8
  self-draft and a random draft): tokens equal, logprobs within 1e-5.
  The adaptive k ladder walks the same k sequence as the JAX engine's on
  the same greedy traffic (start at ``spec_k``, descent on a garbage
  draft and the periodic probe, adaptive off, budget caps, the cache-end
  shrink).
- The split form, recovery with a parked draft stripe and a pending
  round, preempt/resume and a radix hit under spec, burst admission with
  a draft, the catch-up after plain decode, the ``/v1/stats`` ``spec``
  block, and the CLI flags building a spec engine from a port
  checkpoint.

The JAX side runs as its own tests run it (its quantized matmuls take the
default einsum path, no kernel opt-in).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaslice_tpu.models.lm import TpuLM as JaxLM
from instaslice_tpu.serving import ServingEngine as JaxEngine
from instaslice_tpu_torch import faults as tfaults
from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM
from instaslice_tpu_torch.serving import AdmissionRequest, ServingEngine
from instaslice_tpu_torch.serving.sampling import speculative_accept
from torch_port_util import both_params, configs, numpy_params

ENGINE = dict(max_batch=2, max_len=64, prefill_len=8)
PROMPT = [5, 9, 2, 7]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """The small fp32 model's bridged weights: target, its int8 copy (the
    self-draft), and another seed's weights (a random draft)."""
    jcfg, tcfg = configs("fp32")
    base = numpy_params(jcfg, 0)
    target = both_params(jcfg, base, quantize=False)
    int8 = both_params(jcfg, base, quantize=True)
    other = both_params(jcfg, numpy_params(jcfg, 5), quantize=False)
    return {"cfg": (jcfg, tcfg), "target": target, "int8": int8,
            "other": other}


def _garbage(pair):
    """A uniform-logits draft: the final norm zeroed (the reference's
    garbage draft)."""
    jtree, ttree = pair
    jg = dict(jtree, ln_f={"scale": jnp.zeros_like(jtree["ln_f"]["scale"])})
    tg = dict(ttree, ln_f={"scale": torch.zeros_like(ttree["ln_f"]["scale"])})
    return jg, tg


def _engines(weights, draft="int8", **kw):
    """(JAX engine, port engine) with the same target and draft."""
    jcfg, tcfg = weights["cfg"]
    jt, tt = weights["target"]
    jd, td = draft if isinstance(draft, tuple) else weights[draft]
    opts = dict(ENGINE, **kw)
    jeng = JaxEngine(JaxLM(jcfg), jt, draft_model=JaxLM(jcfg),
                     draft_params=jd, **opts)
    teng = ServingEngine(TpuLM(tcfg), tt, draft_model=TpuLM(tcfg),
                         draft_params=td, device="cpu", **opts)
    return jeng, teng


def _port(weights, draft="int8", **kw):
    _, tcfg = weights["cfg"]
    _, tt = weights["target"]
    td = (draft if isinstance(draft, tuple) else weights[draft])[1]
    return ServingEngine(TpuLM(tcfg), tt, draft_model=TpuLM(tcfg),
                         draft_params=td, device="cpu", **dict(ENGINE, **kw))


def _plain(weights, **kw):
    _, tcfg = weights["cfg"]
    return ServingEngine(TpuLM(tcfg), weights["target"][1], device="cpu",
                         **dict(ENGINE, **kw))


def _spec_chain(eng, rid, n):
    toks, lps = [], []
    while len(toks) < n:
        eng.spec_step()
        req = next(r for r in eng.slots.values() if r.request_id == rid)
        toks, lps = list(req.generated), list(req.logprobs)
    return toks[:n], lps[:n]


def tv_distance(a, b) -> float:
    return 0.5 * float(np.abs(np.asarray(a) - np.asarray(b)).sum())


# ------------------------------------------------------------ the sampler

class TestRejectionSampler:
    """speculative_accept's output is distributed exactly as ancestral
    samples from p, for any proposal distribution q."""

    V, K, N = 8, 3, 40000

    def _dists(self):
        g = torch.Generator().manual_seed(42)
        q = torch.softmax(torch.randn((self.K, self.V), generator=g) * 1.5,
                          dim=-1)
        p = torch.softmax(torch.randn((self.K + 1, self.V), generator=g)
                          * 1.5, dim=-1)
        return q, p

    def test_position0_marginal_is_p0(self):
        q, p = self._dists()
        g = torch.Generator().manual_seed(7)
        d = torch.multinomial(q.repeat(self.N, 1), 1, generator=g).reshape(
            self.N, self.K)
        acc, out, _, _ = speculative_accept(
            d, q.expand(self.N, -1, -1), p.expand(self.N, -1, -1), g)
        emp = np.bincount(out[:, 0].numpy(), minlength=self.V) / self.N
        # expected TV at N=40k, V=8 is ~0.006; a biased sampler (always
        # keeping the draft token) lands far beyond 0.02
        assert tv_distance(emp, p[0].numpy()) < 0.02
        # both branches of the accept-or-resample rule really fire
        assert 0.0 < float(acc.float().mean()) < self.K

    def test_identical_p_q_accepts_everything(self):
        _, p = self._dists()
        d = torch.argmax(p[:self.K], dim=-1)[None]
        acc, out, _, _ = speculative_accept(
            d, p[:self.K][None], p[None], torch.Generator().manual_seed(0))
        assert int(acc[0]) == self.K
        assert out[0, :self.K].tolist() == d[0].tolist()

    def test_k0_samples_plain_p(self):
        """k = 0 (the ladder's floor): the one emitted token is a sample
        from p_0."""
        _, p = self._dists()
        n = 20000
        acc, out, _, _ = speculative_accept(
            torch.zeros((n, 0), dtype=torch.int64),
            torch.zeros((n, 0, self.V)), p[:1].expand(n, -1, -1),
            torch.Generator().manual_seed(9))
        assert int(acc.max()) == 0
        emp = np.bincount(out[:, 0].numpy(), minlength=self.V) / n
        assert tv_distance(emp, p[0].numpy()) < 0.03

    def test_logprobs_are_log_p_at_emitted(self):
        q, p = self._dists()
        d = torch.argmax(q, dim=-1)[None]
        acc, out, lps, final = speculative_accept(
            d, q[None], p[None], torch.Generator().manual_seed(1))
        n = int(acc[0])
        assert int(final[0]) == int(out[0, n])
        for i in range(n + 1):
            want = float(torch.log(p[i, int(out[0, i])]))
            assert float(lps[0, i]) == pytest.approx(want, abs=1e-5)


class TestEngineDistributionIdentity:
    """A sampled spec engine with a DISAGREEING draft emits tokens whose
    marginal is the exact tempered target distribution."""

    TRIALS = 600
    TEMP = 0.9

    @pytest.fixture(scope="class")
    def tiny(self):
        cfg = ModelConfig(vocab_size=16, d_model=16, n_heads=2, n_layers=1,
                          d_ff=32, dtype=torch.float32, remat=False)
        m = TpuLM(cfg)
        params = m.init(3, device="cpu")
        # exact marginal of generated[1]: sum over g0 of p(g0 | prompt)
        # p(g1 | prompt + g0), both tempered
        with torch.no_grad():
            p0 = torch.softmax(m.apply(params, torch.tensor([PROMPT]))[0, -1]
                               / self.TEMP, dim=-1)
            exact = sum(
                float(p0[g0]) * torch.softmax(
                    m.apply(params, torch.tensor([PROMPT + [g0]]))[0, -1]
                    / self.TEMP, dim=-1).numpy()
                for g0 in range(cfg.vocab_size))
        return m, params, exact

    def _marginal(self, eng, round_fn):
        counts = np.zeros(eng.model.cfg.vocab_size)
        for _ in range(self.TRIALS):
            eng.add_request(list(PROMPT))
            round_fn()
            slot, req = next(iter(eng.slots.items()))
            counts[req.generated[1]] += 1
            eng.evict_slot(slot)
        return counts / self.TRIALS

    def test_first_spec_token_marginal(self, tiny):
        m, params, exact = tiny
        eng = ServingEngine(m, params, max_batch=1, max_len=64,
                            prefill_len=8, temperature=self.TEMP,
                            draft_model=m, draft_params=m.init(99,
                                                               device="cpu"),
                            spec_k=3, seed=11, device="cpu")
        emp = self._marginal(eng, eng.spec_step)
        # expected TV at 600 trials over V=16 is ~0.09; greedy acceptance
        # on sampled chains reads ~0.5
        assert tv_distance(emp, exact) < 0.2
        assert 0 < eng.spec_accepted < eng.spec_proposed

    def test_plain_engine_same_marginal_sanity(self, tiny):
        m, params, exact = tiny
        eng = ServingEngine(m, params, max_batch=1, max_len=64,
                            prefill_len=8, temperature=self.TEMP, seed=23,
                            device="cpu")
        assert tv_distance(self._marginal(eng, eng.step), exact) < 0.2


# -------------------------------------------------------- greedy identity

@pytest.mark.parametrize("draft", ["int8", "other"])
def test_greedy_spec_equals_plain_and_the_jax_spec_engine(weights, draft):
    """int8 self-draft (full acceptance) and a random draft (rejections):
    the port's spec chain is the plain greedy chain of the same engine and
    the JAX spec engine's chain, logprobs within 1e-5."""
    n = 14
    plain = _plain(weights)
    rp = plain.add_request(list(PROMPT))
    plain.decode_block(n - 1)
    want = plain.slots[0].generated
    jeng, teng = _engines(weights, draft, spec_k=4)
    jt, jl = _spec_chain(jeng, jeng.add_request(list(PROMPT)), n)
    tt, tl = _spec_chain(teng, teng.add_request(list(PROMPT)), n)
    assert rp == 0 and tt == want[:n]
    assert tt == jt
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert teng.spec_accepted == jeng.spec_accepted
    assert teng.spec_proposed == jeng.spec_proposed
    if draft == "int8":
        assert teng.spec_accepted > 0.8 * teng.spec_proposed
    else:
        assert teng.spec_accepted < teng.spec_proposed


def test_greedy_rounds_consume_no_randomness(weights):
    eng = _port(weights, spec_k=3)
    eng.add_request(list(PROMPT))
    before = eng._gen.get_state().clone()
    eng.spec_step()
    eng.spec_step()
    assert torch.equal(eng._gen.get_state(), before)
    hot = _port(weights, spec_k=3, temperature=0.7)
    hot.add_request(list(PROMPT))
    before = hot._gen.get_state().clone()
    hot.spec_step()
    assert not torch.equal(hot._gen.get_state(), before)


# ----------------------------------------------------------- the k ladder

def _ladder(eng, rounds, caps=()):
    """Drive greedy spec rounds; the k planned before each, the plans at
    each budget cap before the first round, and the emitted chain."""
    rid = eng.add_request(list(PROMPT) if eng.max_len > 16
                          else list(range(1, 11)))
    capped = [eng.spec_plan_k(budget_cap=c) for c in caps]
    ks, chain = [], list(next(iter(eng.slots.values())).generated)
    for _ in range(rounds):
        if not eng.slots:
            break
        k = eng.spec_plan_k()
        ks.append(k)
        chain += eng.spec_step(k=k).get(rid, [])
    return ks, capped, chain


@pytest.mark.parametrize("case", ["full", "garbage", "fixed", "cache_end"])
def test_k_ladder_walks_the_jax_engines_sequence(weights, case):
    kw = dict(spec_k=4)
    draft = "int8"
    rounds, caps = 8, ()
    if case == "full":
        caps = (1, 2, 4, 5, 100)
    if case in ("garbage", "fixed"):
        draft, rounds = _garbage(weights["target"]), 30
        kw.update(max_len=128, spec_adaptive=case == "garbage")
    if case == "cache_end":
        kw.update(max_len=16, spec_k=8)
    jeng, teng = _engines(weights, draft, **kw)
    want = _ladder(jeng, rounds, caps)
    got = _ladder(teng, rounds, caps)
    assert got == want
    ks, capped, chain = got
    assert teng._spec_kset == jeng._spec_kset
    if case == "full":
        assert ks == [4] * rounds and capped == [0, 1, 2, 4, 4]
        assert teng.spec_accept_ema == pytest.approx(1.0)
    if case == "garbage":
        # down to the k = 0 floor, then the k = 1 probe every 8th round
        first0 = ks.index(0)
        assert any(k > 0 for k in ks[first0:])
        assert teng.spec_accept_ema < 0.4
    if case == "fixed":
        assert ks == [4] * rounds
    if case == "cache_end":
        # shrinks to k = 0 and drains to max_len on the greedy chain
        plain = _plain(weights, max_len=16)
        plain.add_request(list(range(1, 11)))
        while plain.slots:
            plain.step()
        assert not teng.slots
        assert teng.finished[-1].finished_reason == "max_len"
        assert chain == plain.finished[-1].tokens
        assert ks[0] == 2 and ks[-1] == 0        # max_len 16 - 2 - 11 = 3


# ------------------------------------------------------------- split form

def test_split_form_matches_unsplit(weights):
    one, two = _port(weights, spec_k=3), _port(weights, spec_k=3)
    r1, r2 = one.add_request(list(PROMPT)), two.add_request(list(PROMPT))
    want, got = [], []
    for _ in range(3):
        want += one.spec_step().get(r1, [])
        assert two.spec_step_start()
        got += two.spec_step_finish().get(r2, [])
    assert got == want
    # a mutating entry point between start and finish lands the round
    assert two.spec_step_start() and two._pending_spec is not None
    n0 = len(two.slots[0].generated)
    two.add_request([11, 4])
    assert two._pending_spec is None and len(two.slots[0].generated) > n0
    empty = _port(weights, spec_k=3)
    assert empty.spec_step_start() is False
    assert empty.spec_step_finish() == {}


# ------------------------------------------------- the paths under spec

@pytest.mark.parametrize("pending", ["spec", "decode"])
def test_recover_with_a_parked_draft_and_a_pending_dispatch(weights,
                                                            pending):
    eng = _port(weights, spec_k=3)
    r1 = eng.add_request(list(PROMPT))
    eng.spec_step()
    eng.preempt_slot(next(iter(eng.slots)))
    assert eng.parked[r1].draft_stripe is not None
    parked_used = eng.kv.used_blocks()
    r2 = eng.add_request([11, 4])
    if pending == "spec":
        assert eng.spec_step_start() and eng._pending_spec is not None
    else:
        assert eng.decode_block_start(4) and eng._pending_block is not None
    tfaults.poison_cache(eng)
    assert eng.cache_poisoned()
    assert eng.recover() == [r2]
    assert eng._pending_spec is None and eng._pending_block is None
    assert not eng.cache_poisoned()
    assert r1 in eng.parked and set(eng._tables) == {r1}
    assert eng.kv.used_blocks() == parked_used
    assert not eng.draft_cache["k"].any()        # a rebuilt draft cache
    eng.resume_request(r1)
    assert eng.spec_step().get(r1)
    for s in list(eng.slots):
        eng.evict_slot(s)
    eng.radix.reclaim(10 ** 6)
    assert eng.kv.used_blocks() == 0


def test_preempt_resume_under_spec_keeps_the_greedy_chain(weights):
    plain = _plain(weights, max_batch=1)
    [want] = plain.generate([list(PROMPT)], max_new_tokens=14)
    eng = _port(weights, spec_k=3)
    eng.add_request(list(PROMPT))
    eng.spec_step()
    rid = eng.preempt_slot(next(iter(eng.slots)))
    eng.add_request([11, 4])             # churns the caches meanwhile
    eng.spec_step()
    eng.resume_request(rid)
    for _ in range(4):
        eng.spec_step()
    req = next(r for r in eng.slots.values() if r.request_id == rid)
    n = min(len(req.generated), 14)
    assert n > 8 and req.generated[:n] == want.tokens[:n]
    # the self-draft's stripe came back too: nothing was rejected
    assert eng.spec_accepted == eng.spec_proposed


def test_radix_hit_under_spec_writes_both_stripes(weights):
    shared = list(range(1, 17))
    prompt = shared + [40, 41]

    def run(eng):
        rid = eng.add_request(list(prompt))
        got = []
        for _ in range(4):
            got += eng.spec_step().get(rid, [])
        return got

    cold = _port(weights, spec_k=3)
    want = run(cold)
    eng = _port(weights, spec_k=3)
    eng.add_request(list(shared))
    eng.finish_slot(next(iter(eng.slots)), n_keep=1)
    assert eng.prefix_inserted >= 1
    node = next(iter(eng.radix.root.children.values()))
    assert node.draft_stripes is not None
    assert len(node.draft_stripes) == len(node.stripes)
    assert run(eng) == want and eng.prefix_hits == 1
    assert eng.spec_accepted == cold.spec_accepted


def test_burst_admission_with_a_draft_matches_sequential(weights):
    prompts = [list(PROMPT), list(range(1, 12)), [6, 6, 1]]
    seq = _port(weights, spec_k=3, max_batch=4, batched_prefill=False)
    for p in prompts:
        seq.add_request(list(p))
    burst = _port(weights, spec_k=3, max_batch=4)
    burst.add_requests([AdmissionRequest(list(p)) for p in prompts])
    assert burst.prefill_batches >= 1
    for _ in range(3):
        seq.spec_step()
        burst.spec_step()
    assert sorted((s, r.generated) for s, r in seq.slots.items()) == \
        sorted((s, r.generated) for s, r in burst.slots.items())
    for key in ("k", "v"):
        assert torch.equal(seq.draft_cache[key], burst.draft_cache[key])


def test_plain_decode_on_a_draft_engine_catches_the_draft_up(weights):
    """step() and decode_block() feed the draft cache every token the
    target consumed: the self-draft's next spec rounds accept in full,
    and its cache equals a draft prefill of the same tokens."""
    eng = _port(weights, spec_k=3)
    rid = eng.add_request(list(PROMPT))
    eng.step()
    eng.decode_block(5)
    for _ in range(2):
        eng.spec_step()
    assert eng.spec_accepted == eng.spec_proposed > 0
    req = next(r for r in eng.slots.values() if r.request_id == rid)
    toks = (req.prompt + req.generated)[:-1]
    _, tcfg = weights["cfg"]
    ref = TpuLM(tcfg).init_cache(1, ENGINE["max_len"], device="cpu")
    TpuLM(tcfg).apply_with_cache(weights["int8"][1], torch.tensor([toks]),
                                 ref, torch.zeros(1, dtype=torch.int32))
    n = len(toks)
    for key in ("k", "v"):
        torch.testing.assert_close(eng.draft_cache[key][:, 0, :, :n],
                                   ref[key][:, 0, :, :n], atol=1e-5,
                                   rtol=1e-5)


# ---------------------------------------------------------- serving plane

def test_stats_spec_block_and_a_sampled_http_completion(weights):
    import json
    import urllib.request

    from instaslice_tpu_torch.serving.api_server import ApiServer

    def post(url, body):
        req = urllib.request.Request(
            url + "/v1/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    eng = _port(weights, spec_k=3, max_batch=4)
    eng.warm_prefill_buckets()
    eng.warm_spec_programs()
    with ApiServer(eng, block_size=8) as srv:
        out = post(srv.url, {"prompt": [9, 3, 1], "max_tokens": 8})
        assert len(out["choices"][0]["token_ids"]) == 8
        with urllib.request.urlopen(srv.url + "/v1/stats", timeout=10) as r:
            stats = json.loads(r.read())
        assert srv.scheduler._spec_exported["rounds"] == \
            stats["spec"]["rounds"]
    spec = stats["spec"]
    assert stats["speculative"] and spec["enabled"] and spec["rounds"] >= 1
    assert spec["k_set"] == [0, 1, 2, 3]
    assert spec["proposed"] >= spec["accepted"] > 0
    assert 0.0 <= spec["acceptance_ema"] <= 1.0
    hot = _port(weights, spec_k=3, max_batch=4, temperature=0.8, seed=2)
    with ApiServer(hot, block_size=8) as srv:
        out = post(srv.url, {"prompt": list(PROMPT), "max_tokens": 9,
                             "logprobs": True})
    choice = out["choices"][0]
    assert len(choice["token_ids"]) == 9 and len(choice["logprobs"]) == 9
    assert hot.spec_rounds >= 1


def test_cli_flags_build_a_spec_engine_from_a_port_checkpoint(tmp_path,
                                                              monkeypatch):
    from instaslice_tpu_torch.cli import train_main
    from instaslice_tpu_torch.models.train import leaves
    from instaslice_tpu_torch.serving import api_server

    dims = ["--d-model", "64", "--n-heads", "2", "--n-layers", "2",
            "--d-ff", "128", "--vocab-size", "256"]
    assert train_main.main(["--device", "cpu", "--synthetic", "5000",
                            "--seq-len", "31", "--global-batch", "2",
                            "--steps", "2", "--checkpoint", str(tmp_path),
                            *dims]) == 0
    argv = ["--device", "cpu", "--max-len", "64", "--prefill-len", "8",
            "--max-batch", "2", "--quantize", "--checkpoint", str(tmp_path),
            "--draft-checkpoint", str(tmp_path), "--draft-n-layers", "2",
            "--spec-k", "3", *dims]
    eng = api_server.build_engine(api_server.build_parser().parse_args(argv))
    assert eng.draft_model is not None and eng.spec_k == 3
    assert eng.draft_model.cfg.n_layers == 2 and eng.kv_quant
    saved = torch.load(sorted(tmp_path.glob("step_*.pt"))[-1],
                       weights_only=True)["params"]
    assert all(torch.equal(g, s.to(g.dtype))
               for g, s in zip(leaves(eng.draft_params), saved))
    plain = api_server.build_engine(
        api_server.build_parser().parse_args(argv + ["--no-spec"]))
    assert plain.draft_model is None
    # the int8 target verifies the bf16 draft of the same weights: the
    # greedy chain is the plain engine's
    rid = eng.add_request([3, 1, 4, 1, 5])
    got, _ = _spec_chain(eng, rid, 10)
    pid = plain.add_request([3, 1, 4, 1, 5])
    plain.decode_block(9)
    assert got == plain.slots[0].generated[:10] and pid == 0
    assert eng.spec_accepted > 0
    monkeypatch.setenv("TPUSLICE_SPEC_K", "6")
    assert api_server.build_parser().parse_args([]).spec_k == 6
    with pytest.raises(ValueError, match="repetition_penalty"):
        ServingEngine(eng.model, eng.params, draft_model=eng.draft_model,
                      repetition_penalty=1.2, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(eng.model, eng.params, draft_model=eng.draft_model,
                      spec_k=0, device="cpu", **ENGINE)
