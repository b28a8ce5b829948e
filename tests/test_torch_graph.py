"""The port's decode state and graph plan, held against the JAX package on
the CPU.

A CUDA engine replays its decode step and spec round as captured CUDA
graphs, which read and write fixed device addresses; the CPU runs the
same steps eagerly (it never captures). Held here: the engine whose
decode state lives in persistent buffers against the JAX engine's
``decode_block`` through a bucket change, preempt/resume, a radix hit,
``import_session`` and ``recover()``, every buffer at the address it
started at; ``compile_budget`` against the reference's; the graph key of
each dispatch (form, attend bucket, adapter variant); a capture seen by
the profiler's compile watch. The graphs themselves run only on the card
(``tests/test_torch_cuda.py``, marker ``cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaslice_tpu.models.lm import ModelConfig as JaxConfig
from instaslice_tpu.models.lm import TpuLM as JaxLM
from instaslice_tpu.models.lora import LoraConfig as JaxLoraConfig
from instaslice_tpu.models.lora import init_lora as jax_init_lora
from instaslice_tpu.serving import AdmissionRequest as JaxAdmission
from instaslice_tpu.serving import ServingEngine as JaxEngine
from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM
from instaslice_tpu_torch.models.lora import LoraConfig, init_lora
from instaslice_tpu_torch.serving import AdmissionRequest, ServingEngine
from instaslice_tpu_torch.serving import engine as tengine
from torch_port_util import both_params, configs, numpy_params

#: a cache of three 256-position buckets (256, 512, the whole 768), a
#: repetition penalty so the ``seen`` buffer is written every step
ENGINE = dict(max_batch=4, max_len=768, prefill_len=32, kv_block_size=16,
              kv_quant=True, repetition_penalty=1.3)


def _buffers(eng) -> dict:
    """Every tensor a captured graph reads or writes by address."""
    out = {n: getattr(eng, n) for n in (
        "last_token", "lengths", "seen", "slot_adapter", "_aidx1",
        "_step_ctr", "_blk_toks", "_blk_lps", "_blk_first")}
    out.update({f"cache.{k}": c for k, c in eng.cache.items()})
    return {n: t.data_ptr() for n, t in out.items()}


def test_state_buffers_hold_jax_decode_block_across_the_lifecycle():
    """Greedy blocks on the engine whose decode state is written in place,
    against the JAX engine's ``decode_block`` on the same int8 weights in
    fp32: equal tokens and per-token logprobs (log-softmax of the fp32
    logits) within 2e-3, through a block whose 256-position bucket
    changes, preempt/resume, a radix hit, a parked session exported by
    each engine and imported by the other, and ``recover()``; every
    buffer keeps its ``data_ptr()`` throughout. The bound: the two
    packages sum a 245-position int8 prefix in fp32 in different orders;
    the engine before its state moved into buffers read 6.8e-4 here on
    the same inputs."""
    jcfg, tcfg = configs("fp32")
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 0), quantize=True)
    jeng = JaxEngine(JaxLM(jcfg), jtree, **ENGINE)
    teng = ServingEngine(TpuLM(tcfg), ttree, device="cpu", **ENGINE)
    ptrs = _buffers(teng)

    def same(jout, tout):
        assert tout == jout
        assert ptrs == _buffers(teng)
        assert sorted(teng.slots) == sorted(jeng.slots)
        for s, r in teng.slots.items():
            jr = jeng.slots[s]
            assert (r.request_id, r.generated) == (jr.request_id,
                                                   jr.generated)
            np.testing.assert_allclose(r.logprobs, jr.logprobs, atol=2e-3)

    rng = np.random.default_rng(1)
    long_p = rng.integers(1, 256, 245).tolist()
    mid_p = rng.integers(1, 256, 70).tolist()
    burst = [long_p, rng.integers(1, 256, 40).tolist(), mid_p]
    assert (teng.add_requests([AdmissionRequest(p) for p in burst])
            == jeng.add_requests([JaxAdmission(p) for p in burst]))
    # worst 246 + 4 steps stays in bucket 256; the next block needs 512
    same(jeng.decode_block(4), teng.decode_block(4))
    same(jeng.decode_block(8), teng.decode_block(8))

    rid = teng.preempt_slot(1)
    assert jeng.preempt_slot(1) == rid
    same(jeng.decode_block(4), teng.decode_block(4))
    assert teng.resume_request(rid) == jeng.resume_request(rid)
    same(jeng.decode_block(4), teng.decode_block(4))

    # the mid prompt's chain teaches both radix caches; a prompt sharing
    # its first 64 tokens then skips those chunks
    teng.finish_slot(2)
    jeng.finish_slot(2)
    hit = mid_p[:64] + [9, 8, 7]
    assert teng.add_request(hit) == jeng.add_request(hit)
    assert teng.prefix_hits == jeng.prefix_hits == 1
    same(jeng.decode_block(4), teng.decode_block(4))

    rid = teng.preempt_slot(0)
    assert jeng.preempt_slot(0) == rid
    tblob, jblob = teng.export_session(rid), jeng.export_session(rid)
    teng.drop_parked(rid)
    jeng.drop_parked(rid)
    rid = teng.import_session(jblob)
    assert jeng.import_session(tblob) == rid
    assert teng.resume_request(rid) == jeng.resume_request(rid)
    same(jeng.decode_block(4), teng.decode_block(4))

    teng.mark_cache_poisoned()
    assert sorted(teng.recover()) == sorted(jeng.recover())
    assert ptrs == _buffers(teng)
    for t in (teng.lengths, teng.last_token, teng.seen,
              *teng.cache.values()):
        assert not t.any()
    p = rng.integers(1, 256, 50).tolist()
    assert teng.add_request(p) == jeng.add_request(p)
    same(jeng.decode_block(8), teng.decode_block(8))
    assert teng._graphs == {}


def _tiny(**kw):
    return dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                remat=False, **kw)


def _ref_engine(adapters: int = 0, draft: bool = False, **kw):
    cfg = JaxConfig(dtype=jnp.float32, max_seq_len=64, **_tiny())
    m = JaxLM(cfg)
    extra = {}
    if adapters:
        extra["lora_adapters"] = [
            jax_init_lora(jax.random.key(i), cfg, JaxLoraConfig(rank=4))
            for i in range(1, adapters + 1)]
    if draft:
        extra.update(draft_model=m, draft_params=m.init(jax.random.key(1)))
    return JaxEngine(m, m.init(jax.random.key(0)), **extra, **kw)


def _port_engine(adapters: int = 0, draft: bool = False, **kw):
    cfg = ModelConfig(dtype=torch.float32, **_tiny())
    m = TpuLM(cfg)
    extra = {}
    if adapters:
        extra["lora_adapters"] = [
            init_lora(i, cfg, LoraConfig(rank=4), device="cpu")
            for i in range(1, adapters + 1)]
    if draft:
        extra["draft_model"] = m
    return ServingEngine(m, m.init(0, device="cpu"), device="cpu", **extra,
                         **kw)


@pytest.mark.parametrize("case", [
    # tests/test_engine_hotpath.py's two configurations
    dict(kw=dict(max_batch=8, max_len=64, prefill_len=8, kv_block_size=16),
         cap=16, adapters=0, draft=False),
    dict(kw=dict(max_batch=4, max_len=64, prefill_len=8, kv_block_size=8),
         cap=8, adapters=2, draft=False),
    # several attend buckets, with adapters, and with a draft
    dict(kw=dict(max_batch=4, max_len=1024, prefill_len=64), cap=32,
         adapters=2, draft=False),
    dict(kw=dict(max_batch=8, max_len=1024, prefill_len=128, spec_k=4),
         cap=16, adapters=0, draft=True),
    dict(kw=dict(max_batch=2, max_len=200, prefill_len=8, spec_k=3),
         cap=0, adapters=0, draft=True),
], ids=["hotpath", "hotpath-lora", "buckets-lora", "spec", "spec-short"])
def test_compile_budget_against_the_reference(case):
    """Form by form against the reference's ``compile_budget``: the
    factors both share (attend buckets, adapter variants, power-of-two
    step counts, the k shape set) are equal, and each form differs as
    the docstring documents: decode_block drops the step-count factor
    (one step is captured) and counts greedy/sampled; draft_catchup
    counts attend buckets and not ``step()``'s program; spec_round is
    the reference's spec_draft and spec_verify as one graph; the forms
    the port runs eagerly have no budget."""
    ref = _ref_engine(case["adapters"], case["draft"], **case["kw"])
    port = _port_engine(case["adapters"], case["draft"], **case["kw"])
    rb, pb = ref.compile_budget(case["cap"]), port.compile_budget(case["cap"])
    max_len = case["kw"]["max_len"]
    n_steps = max(1, case["cap"] or max_len).bit_length()
    attend = max(1, -(-max_len // 256))
    variants = 2 if case["adapters"] else 1
    assert len(port._attend_buckets()) == attend
    assert rb["decode_block"] == n_steps * attend * variants
    assert pb["decode_block"] == rb["decode_block"] // n_steps * 2
    assert {"prefill", "prefill_batch", "decode", "read_stripe",
            "write_stripe"} <= set(rb)
    if case["draft"]:
        assert port._spec_kset == ref._spec_kset
        kset = len(ref._spec_kset)
        assert rb["draft_catchup"] == 1 + n_steps
        assert pb["draft_catchup"] == (rb["draft_catchup"] - 1) * attend
        assert rb["spec_draft"] == rb["spec_verify"] == 2 * kset
        assert pb["spec_round"] == rb["spec_draft"] * attend
        assert set(pb) == set(tengine.GRAPH_FORMS)
    else:
        assert set(pb) == {"decode_block"}


def _record_keys(eng) -> list:
    """Every graph key the engine's dispatches ask for (the CPU runs each
    step eagerly, so the plan is all there is to see)."""
    keys = []
    real = eng._program

    def program(key, fn):
        keys.append(key)
        return real(key, fn)

    eng._program = program
    return keys


def test_graph_key_plan_by_bucket_and_variant():
    """Each dispatch's key: the attend bucket its deepest row needs (256,
    512, then the whole cache), the single-adapter variant while every
    live row shares an id, the gathered one otherwise, the sampling
    mode; within the budget per form."""
    eng = _port_engine(adapters=2, max_batch=4, max_len=768, prefill_len=32)
    keys = _record_keys(eng)
    greedy = ("greedy",)
    eng.add_request(list(range(1, 40)))
    eng.add_request(list(range(5, 20)))
    eng.decode_block(4)                                  # 40 + 5 -> 256
    eng.add_request(list(range(3, 9)), adapter=1)
    eng.decode_block(2)
    long_p = [(7 * i) % 60 + 1 for i in range(300)]
    eng.add_request(long_p, adapter=2)
    eng.decode_block(4)                                  # 301 + 5 -> 512
    for slot in [s for s, r in eng.slots.items() if len(r.prompt) != 300]:
        eng.finish_slot(slot)
    eng.decode_block(8)                                  # adapter 2 alone
    eng.temperature = 0.7
    eng.decode_block(2)
    assert keys == [
        ("decode_block", 256, "single", greedy),
        ("decode_block", 256, "gathered", greedy),
        ("decode_block", 512, "gathered", greedy),
        ("decode_block", 512, "single", greedy),
        ("decode_block", 512, "single", ("sampled", 0.7, 0, 1.0, 0.0)),
    ]
    assert (eng.fastpath_rounds, eng.gathered_rounds) == (3, 2)
    # the deepest row past 512 attends the whole cache (attend 0)
    eng.temperature = 0.0
    eng.decode_block(512 - len(next(iter(eng.slots.values())).prompt) - 1)
    eng.decode_block(4)
    assert keys[-1] == ("decode_block", 0, "single", greedy)
    budget = eng.compile_budget()
    assert len(set(keys)) <= budget["decode_block"]


def test_spec_and_catchup_keys():
    """A draft engine's spec rounds key on (k, bucket, sampling mode), the
    catch-up after a plain block on (n_steps, bucket); every k the ladder
    dispatches is in the shape set."""
    eng = _port_engine(draft=True, max_batch=2, max_len=512, prefill_len=16,
                       spec_k=4)
    keys = _record_keys(eng)
    eng.add_request(list(range(1, 30)))
    eng.spec_step(k=4)
    eng.spec_step(k=3)                      # floors onto the shape set: 2
    eng.decode_block(4)
    eng.add_request([(3 * i) % 60 + 1 for i in range(260)])
    eng.spec_step(k=1)
    greedy = ("greedy",)
    assert keys == [
        ("spec_round", 4, 256, greedy),
        ("spec_round", 2, 256, greedy),
        ("decode_block", 256, "none", greedy),
        ("draft_catchup", 4, 256),
        ("spec_round", 1, 0, greedy),
    ]
    budget = eng.compile_budget(block_cap=4)
    for form in tengine.GRAPH_FORMS:
        assert len({k for k in keys if k[0] == form}) <= budget[form]


def test_cpu_engine_never_captures(monkeypatch):
    """A CPU engine runs every step eagerly: warm-up, blocks, spec rounds
    and a catch-up go by without touching the graph API; asking for
    graphs on the CPU is refused."""
    def refuse(*a, **k):
        raise AssertionError("a CPU engine tried to capture")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", refuse)
    monkeypatch.setattr(ServingEngine, "_capture", refuse)
    eng = _port_engine(draft=True, max_batch=2, max_len=300, prefill_len=16)
    eng.warm_prefill_buckets()
    eng.warm_spec_programs()
    eng.generate([[1, 2, 3], list(range(4, 30))], max_new_tokens=6,
                 block_size=4)
    eng.add_request([5, 6, 7])
    eng.spec_step()
    assert eng._graphs == {} and eng.capture_seconds == 0.0
    assert eng.decode_route() == "eager (cpu)"
    stats = eng.graph_stats()
    assert stats["graphs"] == {f: 0 for f in tengine.GRAPH_FORMS}
    assert stats["replays"] == {f: 0 for f in tengine.GRAPH_FORMS}
    assert not set(eng.compiled_programs()) & set(tengine.GRAPH_FORMS)
    with pytest.raises(ValueError, match="CUDA"):
        _port_engine(max_batch=2, max_len=64, prefill_len=8,
                     decode_graphs=True)


def test_compile_watch_reports_a_capture_mid_traffic():
    """A graph captured after the warm window shows in
    ``compiled_programs()`` under its form, and its seconds in the compile
    accumulator, so the profiler's compile watch reports it as the
    reference reports a mid-traffic compile."""
    from instaslice_tpu_torch.obs import profiler

    eng = _port_engine(max_batch=2, max_len=64, prefill_len=8)
    watch = profiler.CompileWatch(eng, grace=0.0)
    watch.mark_traffic()
    assert watch.check() == []
    key = ("decode_block", 0, "none", ("greedy",))
    eng._graphs[key] = object()        # stands in for a captured graph
    profiler.record_compile(0.25)
    assert eng.compiled_programs()["decode_block"] == 1
    (rep,) = watch.check()
    assert rep["program"] == "decode_block" and rep["count"] == 1
    assert rep["wall_ms"] >= 250.0


def test_decode_steps_are_counted_where_they_are_dispatched():
    """``decode_steps`` counts the steps a block or ``step()`` dispatches
    (on the host, as a replayed graph runs no Python), ``band_steps`` the
    ones attending a sliding window's band; a CPU engine replays
    nothing."""
    eng = _port_engine(max_batch=2, max_len=300, prefill_len=16)
    eng.add_request([1, 2, 3])
    eng.add_request(list(range(4, 40)))
    eng.decode_block(3)
    eng.step()
    eng.decode_block(2)
    assert eng.decode_steps == 6 and eng.band_steps == 0
    assert eng.graph_replays == {}


#: kernel names as a device trace gives them (demangled), with counts
_TRACE = [
    ("void (anonymous namespace)::fd_kernel<128, 4, __nv_bfloat16>"
     "(__nv_bfloat16 const*, signed char const*)", 64),
    ("void (anonymous namespace)::fd_combine_kernel<128, 4>(float const*)",
     64),
    ("void (anonymous namespace)::tc::qmm_tc_kernel<false, 4, 2, 2, 64, 4>"
     "(__nv_bfloat16 const*)", 384),
    ("void (anonymous namespace)::qmm_split_reduce<float>(float const*)",
     100),
    ("void (anonymous namespace)::tc::qmm_tc_kernel<true, 4, 2, 2, 64, 4>"
     "(__nv_bfloat16 const*)", 2),
    ("void (anonymous namespace)::qmm_kn_kernel<float, float>(float const*)",
     6),
    ("void (anonymous namespace)::qmm_nk_kernel<float, float>(float const*)",
     1),
    ("void (anonymous namespace)::wg::fwd_kernel<true>(CUtensorMap_st)", 3),
    ("void (anonymous namespace)::wg::dq_kernel<true>(CUtensorMap_st)", 2),
    ("void (anonymous namespace)::fa_bwd_dkv_kernel(float const*)", 1),
    ("void at::native::elementwise_kernel<128, 2>(int)", 999),
]


@pytest.mark.parametrize("kn", ["quant_matmul_stacked", "quant_matmul"])
def test_trace_launch_counts_name_each_wrappers_kernel(kn):
    """A device trace's kernels count for the wrapper that launches them:
    each call's first kernel once (B1's combine and the K-split
    reduction are not counted again), the (K, N) products for the
    wrapper the path names (B2, or B4 on the mixture-of-experts engine),
    library kernels for none."""
    from instaslice_tpu_torch import ops
    got = ops.trace_launch_counts(_TRACE, kn)
    want = dict.fromkeys(ops.KERNEL_WRAPPERS, 0)
    want.update(quant_decode_attention=64, quant_matmul_t=3, flash_fwd=3,
                flash_bwd_dq=2, flash_bwd_dkv=1)
    want[kn] = 390
    assert got == want
