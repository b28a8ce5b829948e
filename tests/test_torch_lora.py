"""The port's LoRA (``instaslice_tpu_torch.models.lora`` and the adapter
paths of ``apply_with_cache``) held against the JAX package's on the CPU.

Seeded numpy weights and adapters go to both packages (the adapters'
``b`` drawn nonzero so every delta counts), the port's through
``bridge``. The JAX side runs as its own tests run it: the w8a16 Pallas
kernels in interpret mode (``TPUSLICE_QUANT_KERNEL=1``), the
decode-kernel opt-in off (its ``UnboundLocalError``, ROADMAP queue C),
XLA attention in the train step.

Tolerances (logits of magnitude ~6): fp32 weights and KV 1e-4 (summation
order only); int8 weights and KV, fp32 compute, 2e-3 absolute and 1e-3
relative (a fresh K/V element near an int8 rounding boundary, as in
``tests/test_torch_model.py``); bf16 compute 6e-2 absolute and 3e-2
relative (one bf16 ulp on activations that round apart, carried through
two layers). Merges and stacks are exact in fp32 and within one bf16
ulp in bf16. The single-adapter path equals the gathered path bit for
bit. Three fp32 LoRA train steps, within the fp32 train cut's bounds of
``chip_smoke.py``: losses 1e-5 relative, the adapters 2.5e-5 largest
absolute difference (1.7e-7 measured: AdamW's first steps move ``b`` by
about the learning rate whatever the gradient's size) and each leaf's
update over the three steps 1.2e-4 relative L2 (1.1e-6 measured).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from instaslice_tpu.models import lora as jlora
from instaslice_tpu.models.lm import TpuLM as JaxLM
from instaslice_tpu_torch import bridge
from instaslice_tpu_torch.models import lm as tlm
from instaslice_tpu_torch.models import lora as tlora
from instaslice_tpu_torch.models import train as ttrain
from instaslice_tpu_torch.models.quant import QuantizedTensor, quantize_params
from torch_port_util import both_params, configs, numpy_params, to_np

ALL_TARGETS = ("wq", "wk", "wv", "wo", "w_in", "w_out")
TOL = {"fp32": (1e-4, 1e-4), "int8": (2e-3, 1e-3), "bf16": (6e-2, 3e-2)}


@pytest.fixture(autouse=True)
def _jax_kernel_opt_in(monkeypatch):
    monkeypatch.setenv("TPUSLICE_QUANT_KERNEL", "1")
    monkeypatch.delenv("TPUSLICE_DECODE_KERNEL", raising=False)
    jax.clear_caches()
    yield
    jax.clear_caches()


def numpy_adapter(cfg, seed, targets=("wq", "wv"), rank=4, b_scale=0.05):
    """A seeded fp32 adapter tree of the reference's shapes, ``b`` drawn
    N(0, 1) * ``b_scale`` (nonzero: the delta is visible)."""
    rng = np.random.default_rng(seed)
    shapes = tlora._target_shapes(cfg)
    blocks = {}
    for t in sorted(targets):
        L, fin, fout = shapes[t]
        blocks[t] = {
            "a": (rng.standard_normal((L, fin, rank))
                  * fin ** -0.5).astype(np.float32),
            "b": (rng.standard_normal((L, rank, fout))
                  * b_scale).astype(np.float32),
        }
    return {"blocks": blocks}


def both_adapters(cfg, seeds, **kw):
    """(JAX trees, port trees) of the same numpy adapters."""
    nps = [numpy_adapter(cfg, s, **kw) for s in seeds]
    return ([jax.tree.map(jnp.asarray, a) for a in nps],
            [bridge.params_from_jax(a, device="cpu") for a in nps])


# -------------------------------------------------- config, init, stacks

@pytest.mark.parametrize("kw", [dict(rank=0), dict(targets=()),
                                dict(targets=("router",)),
                                dict(targets=("wq", "embed"))])
def test_lora_config_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError) as want:
        jlora.LoraConfig(**kw)
    with pytest.raises(ValueError) as got:
        tlora.LoraConfig(**kw)
    assert str(got.value) == str(want.value)


def test_init_lora_shapes_scale_and_moe_targets():
    """The reference's tree (targets sorted, fp32, b zero, a at
    fan_in**-0.5); MoE models adapt attention only, with its message."""
    jcfg, tcfg = configs("fp32")
    lcfg = dict(rank=8, targets=("wv", "w_in", "wq"))
    want = jlora.init_lora(jax.random.key(0), jcfg, jlora.LoraConfig(**lcfg))
    got = tlora.init_lora(0, tcfg, tlora.LoraConfig(**lcfg), device="cpu")
    assert list(got["blocks"]) == sorted(lcfg["targets"])
    for t, ab in want["blocks"].items():
        for k in ("a", "b"):
            leaf = got["blocks"][t][k]
            assert tuple(leaf.shape) == ab[k].shape
            assert leaf.dtype == torch.float32
        assert not got["blocks"][t]["b"].any()
        fan_in = ab["a"].shape[1]
        std = float(got["blocks"][t]["a"].std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05
    jmoe, tmoe = configs("fp32", n_experts=4)
    bad = jlora.LoraConfig(targets=("w_in",))
    with pytest.raises(ValueError) as w:
        jlora.init_lora(jax.random.key(0), jmoe, bad)
    with pytest.raises(ValueError) as g:
        tlora.init_lora(0, tmoe, tlora.LoraConfig(targets=("w_in",)),
                        device="cpu")
    assert str(g.value) == str(w.value)
    assert list(tlora.init_lora(0, tmoe, tlora.LoraConfig(targets=("wq",)),
                                device="cpu")["blocks"]) == ["wq"]


@pytest.mark.parametrize("base", ["fp32", "bf16", "int8"])
def test_merge_lora_matches_jax(base):
    """weight(w) + scale * a @ b in the model dtype, an int8 base
    dequantized first; untargeted leaves are the base's own objects."""
    dtype = "bf16" if base == "bf16" else "fp32"
    jcfg, tcfg = configs(dtype)
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 1),
                               quantize=base == "int8")
    (jad,), (tad,) = both_adapters(jcfg, [5], targets=("wq", "wo", "w_in"))
    lc = dict(rank=4, alpha=8.0, targets=("wq", "wo", "w_in"))
    want = jlora.merge_lora(jtree, jad, jcfg, jlora.LoraConfig(**lc))
    got = tlora.merge_lora(ttree, tad, tcfg, tlora.LoraConfig(**lc))
    for t in ALL_TARGETS:
        if t in lc["targets"]:
            w = to_np(want["blocks"][t])
            g = got["blocks"][t]
            assert g.dtype == tcfg.dtype
            tol = 2 ** -8 if dtype == "bf16" else 1e-6
            np.testing.assert_allclose(to_np(g), w, rtol=tol,
                                       atol=tol * np.abs(w).max())
        else:
            assert got["blocks"][t] is ttree["blocks"][t]


def test_stack_adapters_matches_jax_and_its_errors():
    jcfg, tcfg = configs("fp32")
    jads, tads = both_adapters(jcfg, [1, 2], targets=ALL_TARGETS)
    want = jlora.stack_adapters(jads, jcfg, alphas=[16.0, 8.0])
    got = tlora.stack_adapters(tads, tcfg, alphas=[16.0, 8.0])
    np.testing.assert_array_equal(to_np(got["scales"]),
                                  np.asarray(want["scales"]))
    assert to_np(got["scales"]).tolist() == [0.0, 4.0, 2.0]
    for t in ALL_TARGETS:
        for k in ("a", "b"):
            np.testing.assert_array_equal(to_np(got["blocks"][t][k]),
                                          np.asarray(want["blocks"][t][k]))
        assert not got["blocks"][t]["a"][:, 0].any()
    # the reference's errors, message for message
    (jr8,), (tr8,) = both_adapters(jcfg, [3], rank=8, targets=ALL_TARGETS)
    (jwq,), (twq,) = both_adapters(jcfg, [4], targets=("wq",))
    for jargs, targs in (([], []), ([jads[0], jr8], [tads[0], tr8]),
                         ([jads[0], jwq], [tads[0], twq])):
        with pytest.raises(ValueError) as w:
            jlora.stack_adapters(jargs, jcfg)
        with pytest.raises(ValueError) as g:
            tlora.stack_adapters(targs, tcfg)
        assert str(g.value) == str(w.value)
    with pytest.raises(ValueError, match="1:1"):
        tlora.stack_adapters(tads, tcfg, alphas=[16.0])


def test_bridge_carries_adapter_trees_and_stacks():
    """A JAX adapter tree and a ``stack_adapters`` result (its
    ``scales`` included) cross into the port and back bit for bit."""
    jcfg, _ = configs("fp32")
    jads, _ = both_adapters(jcfg, [1, 2])
    stack = jax.device_get(jlora.stack_adapters(jads, jcfg,
                                                alphas=[16.0, 4.0]))
    for tree in (jax.device_get(jads[0]), stack):
        port = bridge.params_from_jax(tree, device="cpu")
        back = bridge.params_to_numpy(port)
        flat_t = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_b) == len(flat_t)
        for path, leaf in flat_t:
            np.testing.assert_array_equal(flat_b[path], leaf)
    assert to_np(bridge.params_from_jax(stack, device="cpu")["scales"]
                 ).tolist() == [0.0, 4.0, 1.0]


# ------------------------------------------------------- apply_with_cache

@functools.lru_cache(maxsize=None)
def _stacks(setting):
    """(JAX, port) stacks of two adapters over all six targets."""
    jcfg, tcfg = _weights(setting)[:2]
    jads, tads = both_adapters(jcfg, [1, 2], targets=ALL_TARGETS)
    return (jlora.stack_adapters(jads, jcfg, alphas=[16.0, 8.0]),
            tlora.stack_adapters(tads, tcfg, alphas=[16.0, 8.0]))


@functools.lru_cache(maxsize=None)
def _weights(setting):
    """(jcfg, tcfg, jtree, ttree, kv_quant) of a parity setting, made
    once per module (no test writes to them)."""
    dtype = "bf16" if setting == "bf16" else "fp32"
    jcfg, tcfg = configs(dtype)
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 0),
                               quantize=setting == "int8")
    return jcfg, tcfg, jtree, ttree, setting == "int8"


def _run_port(tcfg, ttree, stack, aidx, kv_quant, toks_seq, single=False):
    """Prefill then decode steps; (logits per step, cache)."""
    B = len(toks_seq[0])
    cache = tlm.init_cache(tcfg, B, 32, quant=kv_quant, device="cpu")
    lens = torch.zeros(B, dtype=torch.int32)
    out = []
    for toks in toks_seq:
        t = torch.from_numpy(np.asarray(toks, np.int64))
        lg, cache = tlm.apply_with_cache(
            tcfg, ttree, t, cache, lens, lora=stack,
            adapter_idx=torch.tensor(aidx), single_adapter=single)
        out.append(lg)
        lens = lens + t.shape[1]
    return out, cache


@pytest.mark.parametrize("setting", ["fp32", "bf16", "int8"])
def test_mixed_adapters_match_jax(setting):
    """Rows on the base (0), adapter 1 and adapter 2 of a stack over all
    six targets: a prefill chunk then two decode steps, logits at every
    step and the cache after, against the JAX package's gathered path."""
    jcfg, tcfg, jtree, ttree, kv_quant = _weights(setting)
    jstack, tstack = _stacks(setting)
    aidx = [0, 1, 2]
    rng = np.random.default_rng(4)
    seq = [rng.integers(1, jcfg.vocab_size, (3, 8)),
           rng.integers(1, jcfg.vocab_size, (3, 1)),
           rng.integers(1, jcfg.vocab_size, (3, 1))]
    jm = JaxLM(jcfg)
    japply = jax.jit(jm.apply_with_cache)
    jcache = jm.init_cache(3, 32, quant=kv_quant)
    lens = np.zeros(3, np.int32)
    want = []
    for toks in seq:
        lg, jcache = japply(jtree, jnp.asarray(toks, jnp.int32), jcache,
                            jnp.asarray(lens), lora=jstack,
                            adapter_idx=jnp.asarray(aidx, jnp.int32))
        want.append(to_np(lg))
        lens = lens + toks.shape[1]
    got, tcache = _run_port(tcfg, ttree, tstack, aidx, kv_quant, seq)
    atol, rtol = TOL[setting]
    for w, g in zip(want, got):
        np.testing.assert_allclose(to_np(g), w, atol=atol, rtol=rtol)
        if setting != "bf16":
            np.testing.assert_array_equal(to_np(g).argmax(-1), w.argmax(-1))
    # the adapters matter: rows 1 and 2 leave the base row's logits
    base, _ = _run_port(tcfg, ttree, tstack, [0, 0, 0], kv_quant, seq)
    for r in (1, 2):
        assert float((got[0][r] - base[0][r]).abs().max()) > 20 * atol
    for k in tcache:
        g, w = to_np(tcache[k]), to_np(jcache[k])
        if k in ("k", "v") and kv_quant:
            assert np.abs(g - w).max() <= 1          # int8 codes, one LSB
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


@pytest.mark.parametrize("setting", ["fp32", "bf16", "int8"])
def test_single_adapter_path_equals_gathered_bitwise(setting):
    """Every row on one adapter (the base included): the single-adapter
    path's logits and cache equal the gathered path's bit for bit."""
    jcfg, tcfg, _, ttree, kv_quant = _weights(setting)
    _, tstack = _stacks(setting)
    rng = np.random.default_rng(9)
    seq = [rng.integers(1, jcfg.vocab_size, (3, 8)),
           rng.integers(1, jcfg.vocab_size, (3, 1))]
    for aid in (0, 1, 2):
        g_out, g_cache = _run_port(tcfg, ttree, tstack, [aid] * 3,
                                   kv_quant, seq)
        s_out, s_cache = _run_port(tcfg, ttree, tstack, [aid], kv_quant,
                                   seq, single=True)
        for a, b in zip(g_out, s_out):
            assert torch.equal(a, b)
        for k in g_cache:
            assert torch.equal(g_cache[k], s_cache[k])


def test_zero_adapter_adds_exactly_nothing():
    """Rows on adapter 0 equal a forward without adapters, bit for bit
    (the stack's all-zero entry)."""
    jcfg, tcfg, _, ttree, _ = _weights("int8")
    _, tstack = _stacks("int8")
    toks = torch.arange(1, 25, dtype=torch.int64).reshape(3, 8)
    lens = torch.zeros(3, dtype=torch.int32)
    c1 = tlm.init_cache(tcfg, 3, 32, quant=True, device="cpu")
    c2 = tlm.init_cache(tcfg, 3, 32, quant=True, device="cpu")
    want, _ = tlm.apply_with_cache(tcfg, ttree, toks, c1, lens)
    got, _ = tlm.apply_with_cache(tcfg, ttree, toks, c2, lens, lora=tstack,
                                  adapter_idx=torch.zeros(3, dtype=torch.int64))
    assert torch.equal(got, want)


# --------------------------------------------------------------- training

def _tiny(**kw):
    return configs("fp32", vocab_size=128, d_model=64, n_heads=4,
                   n_kv_heads=2, n_layers=2, d_ff=128, **kw)


def _toks(shape, vocab, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        1, vocab, shape).astype(np.int64))


def test_first_lora_loss_is_the_base_loss_then_falls():
    _, tcfg = _tiny()
    model = tlm.TpuLM(tcfg)
    base = model.init(0, device="cpu")
    toks = _toks((2, 32), tcfg.vocab_size, 1)
    base_loss = float(ttrain.loss_fn(model, base, toks))
    init_fn, step_fn = tlora.make_lora_train_step(
        model, base, tlora.LoraConfig(rank=4), learning_rate=3e-3,
        device="cpu")
    state = init_fn(2)
    state, first = step_fn(state, toks)
    # b = 0: the merged weights ARE the base weights
    assert float(first) == base_loss
    for _ in range(5):
        state, loss = step_fn(state, toks)
    assert float(loss) < base_loss


def test_only_the_adapters_train_and_the_base_stays_bit_unchanged():
    _, tcfg = _tiny()
    model = tlm.TpuLM(tcfg)
    base = model.init(0, device="cpu")
    before = [t.clone() for t in ttrain.leaves(base)]
    lcfg = tlora.LoraConfig(rank=4, targets=("wq", "wv", "w_out"))
    init_fn, step_fn = tlora.make_lora_train_step(
        model, base, lcfg, learning_rate=3e-3, device="cpu")
    state = init_fn(2)
    assert ttrain.leaf_paths(state.params) == [
        f"blocks/{t}/{k}" for t in ("w_out", "wq", "wv") for k in "ab"]
    n_adapter = sum(p.numel() for p in ttrain.leaves(state.params))
    assert n_adapter < sum(p.numel() for p in before) / 5
    a0 = state.params["blocks"]["wq"]["a"].detach().clone()
    for seed in (1, 2):
        state, _ = step_fn(state, _toks((2, 16), tcfg.vocab_size, seed))
    for t, w in zip(ttrain.leaves(base), before):
        assert torch.equal(t, w) and not t.requires_grad
    assert float(state.params["blocks"]["wq"]["b"].detach().abs().max()) > 0.0
    assert not torch.equal(state.params["blocks"]["wq"]["a"], a0)
    assert state.step == 2


def test_three_lora_steps_match_jax():
    """3 steps with clip and grad_accum=2 against the JAX
    ``make_lora_train_step`` on a one-device CPU mesh, from the same
    base and the same initial adapters: the loss and the adapters after
    every step, and each leaf's update over the three."""
    jcfg, tcfg = _tiny(attention_impl="xla")
    tcfg = dataclasses.replace(tcfg, attention_impl="auto")
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 3), quantize=False)
    opts = dict(learning_rate=1e-2, grad_clip=0.5, grad_accum=2)
    lc = dict(rank=4, alpha=8.0, targets=("wq", "wv", "w_in"))
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("data", "seq", "model"))
    jinit, jstep = jlora.make_lora_train_step(
        JaxLM(jcfg), mesh, jtree, jlora.LoraConfig(**lc), **opts)
    jstate = jinit(jax.random.key(0))
    lora0 = jax.device_get(jstate.params)
    tinit, tstep = tlora.make_lora_train_step(
        tlm.TpuLM(tcfg), ttree, tlora.LoraConfig(**lc), device="cpu",
        **opts)
    tstate = tinit(lora=bridge.params_from_jax(lora0, device="cpu"))
    for step in range(3):
        toks = _toks((4, 17), jcfg.vocab_size, 20 + step)
        jstate, jl = jstep(jstate, jnp.asarray(toks.numpy(), jnp.int32))
        tstate, tl = tstep(tstate, toks)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        want = jax.device_get(jstate.params)
        for t in lc["targets"]:
            for k in ("a", "b"):
                w = np.asarray(want["blocks"][t][k])
                g = to_np(tstate.params["blocks"][t][k])
                assert np.abs(g - w).max() <= 2.5e-5
    for t in lc["targets"]:
        for k in ("a", "b"):
            w0 = np.asarray(lora0["blocks"][t][k])
            du_w = np.asarray(want["blocks"][t][k]) - w0
            du_g = to_np(tstate.params["blocks"][t][k]) - w0
            if np.linalg.norm(du_w) == 0.0:
                assert np.linalg.norm(du_g) == 0.0
            else:
                rel = np.linalg.norm(du_g - du_w) / np.linalg.norm(du_w)
                assert rel <= 1.2e-4, (t, k, rel)


def test_qlora_int8_base_trains_without_dequantizing_the_base_whole(
        monkeypatch):
    """An int8 base (QLoRA): finite, falling loss, the same first loss as
    the JAX package's QLoRA step over the same int8 base, and no
    untargeted block leaf is ever dequantized whole: they split per
    layer inside the forward."""
    jcfg, tcfg = _tiny(attention_impl="xla")
    tcfg = dataclasses.replace(tcfg, attention_impl="auto")
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 5), quantize=True)
    assert isinstance(ttree["blocks"]["wo"], QuantizedTensor)
    lc = dict(rank=4, targets=("wq", "wv"))
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("data", "seq", "model"))
    jinit, jstep = jlora.make_lora_train_step(
        JaxLM(jcfg), mesh, jtree, jlora.LoraConfig(**lc),
        learning_rate=3e-3)
    jstate = jinit(jax.random.key(1))
    lora0 = jax.device_get(jstate.params)      # the step donates its state
    toks = _toks((2, 32), jcfg.vocab_size, 6)
    _, jfirst = jstep(jstate, jnp.asarray(toks.numpy(), jnp.int32))

    shapes = []
    real = QuantizedTensor.dequantize

    def spy(self, dtype=None):
        shapes.append(tuple(self.q.shape))
        return real(self, dtype)

    monkeypatch.setattr(QuantizedTensor, "dequantize", spy)
    init_fn, step_fn = tlora.make_lora_train_step(
        tlm.TpuLM(tcfg), ttree, tlora.LoraConfig(**lc), learning_rate=3e-3,
        device="cpu")
    state = init_fn(lora=bridge.params_from_jax(lora0, device="cpu"))
    state, first = step_fn(state, toks)
    np.testing.assert_allclose(float(first), float(jfirst), rtol=1e-5)
    for _ in range(4):
        state, loss = step_fn(state, toks)
    assert np.isfinite(float(loss)) and float(loss) < float(first)
    L = tcfg.n_layers
    whole = {s for s in shapes if len(s) == 3 and s[0] == L}
    # only the merged targets (wq, wv) dequantize their whole stack
    assert whole == {tuple(ttree["blocks"][t].q.shape) for t in lc["targets"]}
    assert tuple(ttree["blocks"]["wo"].q.shape)[1:] in shapes


def test_train_step_captures_an_int8_base_frozen():
    _, tcfg = _tiny()
    model = tlm.TpuLM(tcfg)
    qbase = quantize_params(model.init(0, device="cpu"))
    q_before = qbase["blocks"]["w_in"].q.clone()
    init_fn, step_fn = tlora.make_lora_train_step(
        model, qbase, tlora.LoraConfig(rank=2), learning_rate=1e-2,
        device="cpu")
    state = init_fn(0)
    state, _ = step_fn(state, _toks((2, 16), tcfg.vocab_size, 3))
    assert torch.equal(qbase["blocks"]["w_in"].q, q_before)
    assert all(p.requires_grad for p in ttrain.leaves(state.params))
