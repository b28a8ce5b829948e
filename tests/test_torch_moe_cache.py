"""The port's mixture-of-experts cache forward and serving held against
the JAX package's on the CPU: ``apply_with_cache`` (fp32, bf16, int8
weights and KV), the kernel routes it takes, ``quantize_params`` on the
4-D expert stacks, the bridge and a checkpoint round trip, and the
serving engine's greedy chains.

One seeded numpy weight tree goes to both packages (int8-quantized by
the JAX package and bridged, or left in the model dtype; the router
stays fp32). The JAX side runs with its w8a16 kernel opt-in
(``TPUSLICE_QUANT_KERNEL=1``, Pallas in interpret mode): for an MoE
model it gates its decode-attention and stacked-weight kernels off
(``lm.py:859-876``), so its attention projections take the one-weight
kernel ``_qmm_kernel`` (B4) and its logits ``_qmm_t_kernel`` (B3), the
routes the port's wrappers take (their plain versions on CPU tensors).
The decode-attention opt-in stays off, as in ``test_torch_model.py``.

Tolerances (atol, rtol on logits of magnitude ~6) are the dense cache
forward's (``test_torch_model.py``) in fp32: 1e-4, with an int8 KV cache
2e-3 / 1e-3, and the same greedy token at every step. bf16 is held
against fp32 here (below), so its bound is the whole bf16 rounding of
the port's side, not the difference of two bf16 runs: atol 1.2e-1, twice
the dense bf16-against-bf16 bound, over the largest measured excess of
6.4e-2 (nine runs: three seeds, MHA, GQA and int8).

XLA's CPU backend cannot run the JAX MoE in bf16: its batched einsums
with ``preferred_element_type=float32`` stop with "Unsupported element
type for DotThunk::Execute: BF16 x BF16 = F32". So the port's bf16 cache
forward is held against the JAX package's fp32 forward of the same
bf16-valued (or int8) weights, at the bf16 tolerance. Top-k routing is
a discontinuous function of the hidden state: where a token's k-th and
(k+1)-th gates lie within bf16 noise, rounding alone picks the expert,
and no tolerance on logits absorbs that (at top-2 of 4 on random weights
it flipped a choice in two of six measured bf16 runs). So the bf16 cases
come in two kinds. On random weights they route every token to all of
its experts (``expert_top_k`` = ``n_experts``; capacity then drops
nothing), where the MoE is continuous and its dispatch, capacity
positions, expert products and combine all still run. At top-2, with
and without overflow drops, they run on weights whose routing is
separated far above bf16 noise (``_separated_weights``), and the test
checks that separation on both sides' recorded router inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaslice_tpu.models import lm as jlm
from instaslice_tpu.models.lm import TpuLM as JaxLM
from instaslice_tpu.models.quant import quantize_params as jax_quantize
from instaslice_tpu.serving import ServingEngine as JaxEngine
from instaslice_tpu_torch import bridge
from instaslice_tpu_torch.models import lm as tlm
from instaslice_tpu_torch.models import quant as tquant
from instaslice_tpu_torch.models import train as ttrain
from instaslice_tpu_torch.models.checkpoint import TrainCheckpointer
from instaslice_tpu_torch.serving import ServingEngine
from torch_port_util import (
    both_params,
    configs,
    moe_drops,
    numpy_params,
    to_np,
)

MOE = dict(n_experts=4, expert_top_k=2, expert_capacity_factor=1.25)
TOLERANCE = {("fp32", False): (1e-4, 1e-4), ("fp32", True): (2e-3, 1e-3),
             ("bf16", False): (1.2e-1, 3e-2), ("bf16", True): (1.2e-1, 3e-2)}


@pytest.fixture(autouse=True)
def _jax_kernel_opt_in(monkeypatch):
    monkeypatch.setenv("TPUSLICE_QUANT_KERNEL", "1")
    monkeypatch.delenv("TPUSLICE_DECODE_KERNEL", raising=False)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _run_both(dtype, kv_quant, n_kv_heads, quantize, steps=3, seed=0,
              moe=None, weights=numpy_params):
    """A prefill chunk for two rows of different true lengths, then T = 1
    decode steps fed the JAX side's greedy tokens; (JAX, port) logits of
    every forward. In bf16 the JAX side runs in fp32 on the port's
    bf16-valued weights (module docstring), every token routed to every
    expert unless ``moe`` (overrides of ``MOE``) says otherwise;
    ``weights(cfg, seed)`` draws the numpy tree."""
    if moe is None:
        moe = {"expert_top_k": MOE["n_experts"]} if dtype == "bf16" else {}
    jcfg, tcfg = configs(dtype, n_kv_heads=n_kv_heads, **dict(MOE, **moe))
    jtree, ttree = both_params(jcfg, weights(jcfg, seed), quantize)
    if dtype == "bf16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        jtree = jax.tree.map(lambda a: a.astype(jnp.float32), jtree)
    jm = JaxLM(jcfg)
    B, T, S = 2, 8, 64
    true_len = [5, 8]
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(1, jcfg.vocab_size, (B, T)).astype(np.int32)
    toks[0, true_len[0]:] = 0
    jcache = jm.init_cache(B, S, quant=kv_quant)
    tcache = tlm.init_cache(tcfg, B, S, quant=kv_quant, device="cpu")
    lens = np.zeros(B, np.int32)
    japply = jax.jit(jm.apply_with_cache)
    pairs = []
    for step in range(steps + 1):
        jl, jcache = japply(jtree, jnp.asarray(toks), jcache,
                            jnp.asarray(lens))
        tl, tcache = tlm.apply_with_cache(tcfg, ttree, torch.from_numpy(toks),
                                          tcache, torch.from_numpy(lens))
        pairs.append((to_np(jl), to_np(tl)))
        last = [t - 1 for t in true_len] if step == 0 else [0, 0]
        nxt = np.argmax(pairs[-1][0][np.arange(B), last], axis=-1)
        lens = np.asarray(true_len, np.int32) + step if step == 0 else lens + 1
        toks = nxt[:, None].astype(np.int32)
    return pairs


@pytest.mark.parametrize("dtype,kv_quant,quantize,n_kv_heads", [
    ("fp32", False, False, 2), ("fp32", True, True, 2),
    ("fp32", True, True, 0), ("fp32", False, True, 2),
    ("bf16", False, False, 2), ("bf16", False, False, 0),
    ("bf16", True, True, 2),
])
def test_moe_cache_forward_matches_jax(dtype, kv_quant, quantize,
                                       n_kv_heads):
    atol, rtol = TOLERANCE[(dtype, kv_quant)]
    for want, got in _run_both(dtype, kv_quant, n_kv_heads, quantize):
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
        if dtype == "fp32":
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_moe_cache_forward_routes_b4_and_b3_never_b1_or_b2(monkeypatch):
    """An int8 MoE model's cache forward calls the one-weight wrapper
    (B4) for q, k, v and o of every layer and the transposed one (B3)
    for the logits, the stacked wrapper (B2) and decode attention (B1)
    never, at prefill and decode; a dense int8 model takes B2 and B1
    (the gate is the model's, not the shape's)."""
    calls = {}

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    for name in ("quant_matmul", "quant_matmul_t", "quant_matmul_stacked"):
        spy(tquant, name)
    spy(tlm, "quant_decode_attention")
    monkeypatch.setattr(tlm._fd, "kernel_built", lambda hd, G: True)
    for n_experts in (4, 0):
        jcfg, tcfg = configs("fp32", n_experts=n_experts)
        _, tp = both_params(jcfg, numpy_params(jcfg, 1), quantize=True)
        cache = tlm.init_cache(tcfg, 2, 32, quant=True, device="cpu")
        lens = torch.zeros(2, dtype=torch.int32)
        for T in (8, 1):
            calls.clear()
            toks = torch.ones((2, T), dtype=torch.long)
            tlm.apply_with_cache(tcfg, tp, toks, cache, lens)
            lens = lens + T
            L = tcfg.n_layers
            if n_experts:
                assert calls == {"quant_matmul": 4 * L, "quant_matmul_t": 1}
            else:
                want = {"quant_matmul_stacked": 6 * L, "quant_matmul_t": 1}
                if T == 1:
                    want["quant_decode_attention"] = L
                assert calls == want


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_params_expert_stacks_bit_equal(dtype):
    """int8 values and scales of every leaf, the 4-D expert stacks'
    scales (L, E, 1, F) included, equal the JAX package's bit for bit;
    the router stays full precision; ``layer(i)`` is (E, D, F)."""
    jcfg, tcfg = configs(dtype, **MOE)
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 4), quantize=False)
    want = bridge.params_from_jax(jax.device_get(jax_quantize(jtree)),
                                  device="cpu")
    got = tquant.quantize_params(ttree)
    L, E, D, Fd = tcfg.n_layers, 4, tcfg.d_model, tcfg.d_ff
    assert got["blocks"]["w_in"].s.shape == (L, E, 1, Fd)
    assert got["blocks"]["w_out"].s.shape == (L, E, 1, D)
    assert got["blocks"]["w_in"].layer(1).shape == (E, D, Fd)
    assert got["blocks"]["router"] is ttree["blocks"]["router"]
    for name in ("wq", "wo", "w_in", "w_out"):
        g, w = got["blocks"][name], want["blocks"][name]
        assert torch.equal(g.q, w.q) and torch.equal(g.s, w.s), name
    assert torch.equal(got["embed"].q, want["embed"].q)


def test_bridge_and_checkpoint_carry_the_moe_tree(tmp_path):
    """The router and the 4-D leaves (plain and int8) cross JAX -> port
    -> numpy bit for bit, and a checkpoint of an MoE train state saves
    and restores them by leaf path."""
    jcfg, tcfg = configs("bf16", **MOE)
    jtree, _ = both_params(jcfg, numpy_params(jcfg, 5), quantize=False)
    for tree in (jtree, jax_quantize(jtree)):
        src = jax.device_get(tree)
        back = bridge.params_to_numpy(bridge.params_from_jax(src,
                                                             device="cpu"))
        for name in ("router", "w_in", "w_out"):
            a, b = src["blocks"][name], back["blocks"][name]
            if isinstance(b, tuple):
                a, b = (a.q, a.s), b
                assert all(np.array_equal(np.asarray(x), y)
                           for x, y in zip(a, b)), name
            else:
                assert np.asarray(a).dtype == b.dtype
                assert np.array_equal(np.asarray(a), b), name
    assert back["blocks"]["router"][0].dtype == np.float32

    _, tcfg32 = configs("fp32", **MOE)
    init_fn, step_fn = ttrain.make_train_step(tlm.TpuLM(tcfg32),
                                              device="cpu")
    state = init_fn(2)
    state, _ = step_fn(state, torch.ones((2, 9), dtype=torch.long))
    with TrainCheckpointer(str(tmp_path)) as ck:
        assert ck.save(state)
        tree = ck.load_tree()
        fresh = ck.restore(init_fn(7))
    for a, b in zip(ttrain.leaves(state.params), ttrain.leaves(fresh.params)):
        assert torch.equal(a, b)
    assert tree["blocks"]["router"].dtype == torch.float32
    assert torch.equal(tree["blocks"]["w_in"], state.params["blocks"]["w_in"])


def test_moe_engine_greedy_matches_jax():
    """The serving engine on int8 MoE weights with an int8 KV cache
    (fp32 compute) against the JAX engine: the same greedy tokens for
    mixed prompt lengths (one chunked past prefill_len), no leaked
    blocks."""
    jcfg, tcfg = configs("fp32", **MOE)
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 0), quantize=True)
    opts = dict(max_batch=4, max_len=128, prefill_len=16, kv_quant=True,
                radix_cache=False)
    jeng = JaxEngine(JaxLM(jcfg), jtree, **opts)
    teng = ServingEngine(tlm.TpuLM(tcfg), ttree, device="cpu", **opts)
    prompts = [[1, 2, 3], list(range(5, 30)), [7] * 9]
    want = jeng.generate(prompts, max_new_tokens=8, block_size=4)
    got = teng.generate(prompts, max_new_tokens=8, block_size=4)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    np.testing.assert_allclose([r.logprobs for r in got],
                               [r.logprobs for r in want], atol=1e-4)
    assert teng.kv.used_blocks() == 0


def _separated_weights(cfg, seed):
    """``numpy_params`` with routing decided far above bf16 noise: each
    token's embedding adds, along E orthonormal directions U, a
    permutation of the levels (1, 0.4, -0.4, -1) scaled to dominate its
    random part, and every layer's router reads those directions
    (0.3 U). Other tokens reach a token's hidden state only through
    random projections (attention, the experts), which land mostly
    outside U, so its 2nd and 3rd router logits stay tenths apart while
    bf16 moves a logit by thousandths. The permutations spread the
    tokens over the experts, and capacity 0.5 drops pairs."""
    tree = numpy_params(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    V, D, E, L = cfg.vocab_size, cfg.d_model, cfg.n_experts, cfg.n_layers
    U = np.linalg.qr(rng.standard_normal((D, E)))[0]
    levels = np.array([1.0, 0.4, -0.4, -1.0])
    pattern = np.stack([rng.permutation(levels) for _ in range(V)])
    tree["embed"] = (tree["embed"] + 3.0 * pattern @ U.T).astype(np.float32)
    tree["blocks"]["router"] = np.broadcast_to(
        0.3 * U, (L, D, E)).astype(np.float32)
    return tree


@pytest.mark.parametrize("kv_quant,quantize,n_kv_heads,cf", [
    (False, False, 2, 1.25), (False, False, 0, 0.5), (True, True, 2, 0.5),
])
def test_moe_cache_forward_bf16_top2_matches_jax(
        monkeypatch, kv_quant, quantize, n_kv_heads, cf):
    """bf16 at top-2 of 4 against the JAX package's fp32 forward of the
    same bf16-valued weights, at the bf16 tolerance: the discrete choice,
    the renormalised gates and (capacity factor 0.5) the overflow drop
    included. The weights separate the routing (``_separated_weights``),
    and every MoE call's router inputs are recorded on both sides: no
    token's 2nd and 3rd router logits on the port's side lie within
    four times the largest difference between the two sides' logits, so
    rounding chooses no expert; at 0.5 the prefill drops pairs."""
    seen = {"jax": [], "port": []}

    def record(side, x, router_w):
        seen[side].append((np.asarray(x, np.float32),
                           np.asarray(router_w, np.float32)))

    def spy(mod, side, take):
        real = mod._moe_mlp

        def wrapped(x, router_w, *a, **kw):
            take(x, router_w)
            return real(x, router_w, *a, **kw)

        monkeypatch.setattr(mod, "_moe_mlp", wrapped)

    # the JAX side's layers run under jit and lax.scan: its values reach
    # the host through an ordered callback
    spy(jlm, "jax", lambda x, r: jax.debug.callback(
        lambda x, r: record("jax", x, r), x, r, ordered=True))
    spy(tlm, "port", lambda x, r: record("port", to_np(x), to_np(r)))
    atol, rtol = TOLERANCE[("bf16", kv_quant)]
    pairs = _run_both("bf16", kv_quant, n_kv_heads, quantize,
                      moe={"expert_capacity_factor": cf},
                      weights=_separated_weights)
    jax.effects_barrier()
    for want, got in pairs:
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    assert len(seen["jax"]) == len(seen["port"]) == 2 * len(pairs)
    for (xj, r), (xt, _) in zip(seen["jax"], seen["port"]):
        lj, lt = xj.astype(np.float64) @ r, xt.astype(np.float64) @ r
        ranked = -np.sort(-lt, axis=-1)
        gap = (ranked[..., 1] - ranked[..., 2]).min()
        noise = np.abs(lj - lt).max()
        assert gap > 4 * noise, (gap, noise)
    if cf < 1:
        assert moe_drops(*seen["port"][0], 2, cf) > 0
