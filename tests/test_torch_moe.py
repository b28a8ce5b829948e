"""The port's mixture-of-experts training path and remat "dots" held
against the JAX package's on the CPU: ``_moe_mlp`` and its grads,
``TpuLM.apply`` with the load-balance term, ``loss_fn`` with its aux
weight, three train steps, LoRA steps over an MoE base, the training
CLI, and remat none / "full" / "dots" bit-equal.

One seeded numpy weight tree goes to both packages (fp32; the router
stays fp32 as ``init_params`` stores it). The JAX side runs its
flash-attention Pallas kernels in interpret mode where a test asks for
``attention_impl="flash"``; the port's "auto" takes its flash wrappers,
whose plain versions run on CPU tensors.

Tolerances (fp32 both sides, the same products summed in another
order): ``_moe_mlp``'s y, aux and grads 1e-5 relative to each tensor's
largest element; logits 1e-4 relative to their scale (as the dense
model's); the loss and aux 1e-5; grads 1e-4 relative to each leaf's
largest element; params after three AdamW steps 4e-6 relative to each
leaf's largest element (the dense train test's bound). Remat is held bit
for bit: rematerialization recomputes the same CPU kernels on the same
inputs.
"""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from instaslice_tpu.models import lm as jlm
from instaslice_tpu.models import lora as jlora
from instaslice_tpu.models import train as jtrain
from instaslice_tpu_torch import bridge
from instaslice_tpu_torch.models import lm as tlm
from instaslice_tpu_torch.models import lora as tlora
from instaslice_tpu_torch.models import train as ttrain
from instaslice_tpu_torch.models.quant import QuantizedTensor
from torch_port_util import (
    both_params,
    configs,
    moe_drops,
    numpy_params,
    to_np,
)

train_main = importlib.import_module("instaslice_tpu_torch.cli.train_main")

MOE = dict(n_experts=4, expert_top_k=2, expert_capacity_factor=1.25)


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(1, vocab, shape).astype(
        np.int32)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("data", "seq", "model"))


def _close(got, want, rel, what=""):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, what
    tol = rel * max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: to_np(tree)}


def _trees_close(got, want, rel):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for path in w:
        _close(g[path], w[path], rel, path)


def _grad_tree(ttree, grads):
    it = iter(grads)
    return jax.tree.map(lambda _: next(it), ttree,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))


# ---------------------------------------------------------------- _moe_mlp

def _moe_inputs(seed, B=2, S=24, D=32, E=4, Fd=48, router_scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, D)).astype(np.float32),
            (rng.standard_normal((D, E)) * router_scale).astype(np.float32),
            (rng.standard_normal((E, D, Fd)) * D ** -0.5).astype(np.float32),
            (rng.standard_normal((E, Fd, D)) * Fd ** -0.5).astype(np.float32),
            rng.standard_normal((B, S, D)).astype(np.float32))


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_mlp_and_its_grads_match_jax(top_k, cf):
    """y, aux and the grads of x, router, w_in and w_out (``jax.grad``
    against autograd) of ``sum(y * dy) + aux``; capacity factor 0.5
    forces overflow drops, which are counted on the host first."""
    x, r, wi, wo, dy = _moe_inputs(3 + top_k)
    if cf < 1:
        assert moe_drops(x, r, top_k, cf) > 0
    kw = dict(top_k=top_k, capacity_factor=cf)

    def jfn(x, r, wi, wo):
        y, aux = jlm._moe_mlp(x, r, wi, wo, **kw)
        return jnp.sum(y * dy) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3), has_aux=True)(x, r, wi, wo)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, r, wi, wo)]
    ty, taux = tlm._moe_mlp(*ts, **kw)
    tg = torch.autograd.grad((ty * torch.from_numpy(dy)).sum() + taux, ts)
    _close(ty, jy, 1e-5, "y")
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-5)
    assert 0.0 < float(taux.detach()) <= 4.0
    for name, g, w in zip(("x", "router", "w_in", "w_out"), tg, jg):
        _close(g, w, 1e-5, name)


def test_moe_mlp_breaks_ties_toward_the_lower_expert():
    """A zero router gives every expert the same gate: ``lax.top_k``
    takes the lowest indices, and so must the port (experts 0 and 1 get
    every token, up to capacity; the other two get none)."""
    x, _, wi, wo, _ = _moe_inputs(9)
    r = np.zeros((x.shape[-1], 4), np.float32)
    jy, jaux = jlm._moe_mlp(x, r, wi, wo, top_k=2, capacity_factor=2.0)
    ty, taux = tlm._moe_mlp(*(torch.from_numpy(a) for a in (x, r, wi, wo)),
                            top_k=2, capacity_factor=2.0)
    _close(ty, jy, 1e-5, "y")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    # experts 2 and 3 never run: zeroing them changes nothing
    wi2, wo2 = wi.copy(), wo.copy()
    wi2[2:], wo2[2:] = 0.0, 0.0
    ty2, _ = tlm._moe_mlp(*(torch.from_numpy(a) for a in (x, r, wi2, wo2)),
                          top_k=2, capacity_factor=2.0)
    assert torch.equal(ty, ty2)


# ------------------------------------------------------------------- apply

@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("n_kv_heads", [0, 2])
def test_apply_and_aux_match_jax(impl, n_kv_heads):
    """Logits and the layer-averaged load-balance term of the MoE
    forward, MHA and GQA, the flash path (B5's plain version against the
    Pallas kernel) and the plain grouped path."""
    jcfg, tcfg = configs("fp32", n_kv_heads=n_kv_heads, attention_impl=impl,
                         **MOE)
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 3), quantize=False)
    toks = _tokens((2, 64), jcfg.vocab_size, 4)
    want, jaux = jlm.TpuLM(jcfg).apply(jtree, jnp.asarray(toks),
                                       return_aux=True)
    got, taux = tlm.TpuLM(tcfg).apply(ttree, torch.from_numpy(toks),
                                      return_aux=True)
    assert got.dtype == torch.float32 and got.shape == (2, 64, 256)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert 0.0 < float(taux) <= MOE["n_experts"]


def test_dense_aux_is_zero():
    _, tcfg = configs("fp32")
    params = tlm.init_params(tcfg, 0, device="cpu")
    toks = torch.ones((1, 8), dtype=torch.long)
    _, aux = tlm.TpuLM(tcfg).apply(params, toks, return_aux=True)
    assert float(aux) == 0.0


def test_init_params_moe_layout():
    """The router stored fp32 whatever ``param_dtype`` is, the expert
    stacks (L, E, D, F) and (L, E, F, D) in the stored dtype."""
    _, tcfg = configs("bf16", param_dtype=torch.float16, **MOE)
    p = tlm.init_params(tcfg, 0, device="cpu")["blocks"]
    L, D, Fd, E = tcfg.n_layers, tcfg.d_model, tcfg.d_ff, tcfg.n_experts
    assert p["router"].shape == (L, D, E)
    assert p["router"].dtype == torch.float32
    assert p["w_in"].shape == (L, E, D, Fd)
    assert p["w_in"].dtype == torch.float16
    assert p["w_out"].shape == (L, E, Fd, D)
    # fan-in scaling over D for the router and the up projection
    assert abs(float(p["router"].std()) - D ** -0.5) < 0.1 * D ** -0.5


# ----------------------------------------------------------- loss and grads

@pytest.mark.parametrize("loss_chunk", [0, 8])
def test_loss_with_aux_and_grads_match_jax(loss_chunk):
    """``loss_fn`` with the aux weight (one-shot, and chunked with a
    padded last chunk: S 33 in chunks of 8) and its grads against
    ``jax.value_and_grad``; the aux term moves the loss by exactly its
    weight times the term."""
    jcfg, tcfg = configs("fp32", attention_impl="xla", **MOE)
    tcfg = dataclasses.replace(tcfg, attention_impl="auto")
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 7), quantize=False)
    toks = _tokens((2, 33), jcfg.vocab_size, 8)
    jm = jlm.TpuLM(jcfg)
    w = 0.05
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtrain.loss_fn(jm, p, jnp.asarray(toks),
                                 loss_chunk=loss_chunk,
                                 moe_aux_weight=w))(jtree)
    for t in ttrain.leaves(ttree):
        t.requires_grad_(True)
    model = tlm.TpuLM(tcfg)
    loss = ttrain.loss_fn(model, ttree, torch.from_numpy(toks),
                          loss_chunk=loss_chunk, moe_aux_weight=w)
    grads = torch.autograd.grad(loss, ttrain.leaves(ttree))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    _trees_close(_grad_tree(ttree, grads), jax.device_get(jgrads), rel=1e-4)
    assert float(jnp.abs(jgrads["blocks"]["router"]).max()) > 0
    with torch.no_grad():
        xent = ttrain.loss_fn(model, ttree, torch.from_numpy(toks),
                              loss_chunk=loss_chunk, moe_aux_weight=0.0)
        _, aux = model.apply(ttree, torch.from_numpy(toks), return_aux=True)
    np.testing.assert_allclose(float(loss.detach()) - float(xent),
                               w * float(aux),
                               rtol=1e-4)


def test_three_moe_train_steps_match_jax():
    """3 steps with clip, warmup-cosine and grad_accum=2 against the JAX
    ``make_train_step`` on a one-device CPU mesh, the default aux weight:
    losses, and params after every step."""
    jcfg, tcfg = configs("fp32", n_kv_heads=2, attention_impl="xla", **MOE)
    tcfg = dataclasses.replace(tcfg, attention_impl="auto")
    assert ttrain.DEFAULT_MOE_AUX_WEIGHT == jtrain.DEFAULT_MOE_AUX_WEIGHT
    opts = dict(learning_rate=1e-3, grad_accum=2, grad_clip=0.5,
                warmup_steps=2, decay_steps=3)
    jinit, jstep = jtrain.make_train_step(jlm.TpuLM(jcfg), _mesh(), **opts)
    jstate = jinit(jax.random.key(0))
    params0 = jax.device_get(jstate.params)
    tinit, tstep = ttrain.make_train_step(tlm.TpuLM(tcfg), device="cpu",
                                          **opts)
    tstate = tinit(params=bridge.params_from_jax(params0, device="cpu"))
    assert tstate.params["blocks"]["router"].dtype == torch.float32
    for step in range(3):
        toks = _tokens((4, 17), jcfg.vocab_size, 20 + step)
        jstate, jl = jstep(jstate, jnp.asarray(toks))
        tstate, tl = tstep(tstate, torch.from_numpy(toks))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        _trees_close(tstate.params, jax.device_get(jstate.params), rel=4e-6)
    assert tstate.step == 3


# -------------------------------------------------------------------- remat

def _loss_and_grads(tcfg, base, toks):
    tree = jax.tree.map(lambda t: t.clone().requires_grad_(True), base)
    loss = ttrain.loss_fn(tlm.TpuLM(tcfg), tree, toks)
    return loss.detach(), torch.autograd.grad(loss, ttrain.leaves(tree))


@pytest.mark.parametrize("n_experts", [0, 4])
@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_remat_none_full_dots_are_bit_equal(n_experts, impl):
    """The loss and every grad under remat none, "full" and "dots", bit
    for bit, dense and MoE, through the flash wrappers and the plain
    grouped attention."""
    jcfg, tcfg = configs("fp32", n_experts=n_experts, attention_impl=impl)
    _, base = both_params(jcfg, numpy_params(jcfg, 11), quantize=False)
    toks = torch.from_numpy(_tokens((2, 32), tcfg.vocab_size, 12))
    runs = {pol: _loss_and_grads(
        dataclasses.replace(tcfg, remat=pol != "none",
                            remat_policy="full" if pol == "none" else pol),
        base, toks) for pol in ("none", "full", "dots")}
    ref_loss, ref_grads = runs["none"]
    for pol in ("full", "dots"):
        loss, grads = runs[pol]
        assert torch.equal(loss, ref_loss), pol
        for a, b in zip(grads, ref_grads):
            assert torch.equal(a, b), pol


def test_dots_policy_saves_mm_and_recomputes_the_rest():
    aten = torch.ops.aten
    assert tlm.dots_policy(None, aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert (tlm.dots_policy(None, aten.addmm.default)
            == CheckpointPolicy.MUST_SAVE)
    for op in (aten.bmm.default, aten.mul.Tensor, aten._softmax.default,
               aten.gelu.default, aten._to_copy.default):
        assert tlm.dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.n:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("n_experts", [0, 4])
def test_dots_keeps_the_unbatched_products_and_recomputes_batched_ones(
        n_experts):
    """Counted in the backward: "dots" recomputes none of the forward
    ``mm`` of the blocks (q, k, v, o, the dense MLP or the MoE router),
    "full" recomputes them; both recompute the same forward ``bmm`` (the
    plain attention and the MoE dispatch, expert and combine einsums),
    which the backward without remat never runs. (The recompute stops
    once the backward has what it needs, so a block's last product is
    not rerun under either policy.)"""
    jcfg, tcfg = configs("fp32", n_experts=n_experts, attention_impl="xla")
    _, base = both_params(jcfg, numpy_params(jcfg, 13), quantize=False)
    toks = torch.from_numpy(_tokens((2, 16), tcfg.vocab_size, 14))
    fwd, bwd = {}, {}
    for pol in ("none", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=pol != "none",
                                  remat_policy="full" if pol == "none"
                                  else pol)
        tree = jax.tree.map(lambda t: t.clone().requires_grad_(True), base)
        with _OpCount() as f:
            out = tlm.apply(cfg, tree, toks, unembed_out=False)
        with _OpCount() as b:
            torch.autograd.grad(out.float().square().sum(),
                                ttrain.leaves(tree), allow_unused=True)
        fwd[pol], bwd[pol] = f.n, b.n
    L = tcfg.n_layers
    # 4 attention projections, then 2 dense MLP products or the router
    mm_per_layer = 4 + (1 if n_experts else 2)
    assert fwd["none"]["mm"] == L * mm_per_layer
    assert bwd["dots"]["mm"] == bwd["none"]["mm"]
    assert bwd["full"]["mm"] - bwd["none"]["mm"] >= L * (mm_per_layer - 1)
    assert fwd["none"]["bmm"] > 0
    assert bwd["dots"]["bmm"] == bwd["full"]["bmm"]
    assert bwd["dots"]["bmm"] - bwd["none"]["bmm"] >= fwd["none"]["bmm"] - L


def test_config_accepts_dots_and_rejects_unknown_policies():
    tlm.ModelConfig(remat_policy="dots")
    with pytest.raises(ValueError):
        tlm.ModelConfig(remat_policy="nope")
    with pytest.raises(ValueError):
        jlm.ModelConfig(remat_policy="nope")


# --------------------------------------------------------------------- LoRA

@pytest.mark.parametrize("quantize", [False, True])
def test_two_lora_steps_over_an_moe_base_match_jax(quantize, monkeypatch):
    """2 steps of attention-only adapters over an MoE base (fp32, and the
    int8 QLoRA base with its 4-D expert stacks quantized) against the
    JAX ``make_lora_train_step``, the aux term in both losses: the loss
    and the adapters after every step. MoE bases adapt attention only."""
    monkeypatch.setenv("TPUSLICE_QUANT_KERNEL", "1")
    jax.clear_caches()
    jcfg, tcfg = configs("fp32", attention_impl="xla", **MOE)
    tcfg = dataclasses.replace(tcfg, attention_impl="auto")
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 3), quantize)
    if quantize:
        assert isinstance(ttree["blocks"]["w_in"], QuantizedTensor)
        assert ttree["blocks"]["w_in"].s.shape == (
            tcfg.n_layers, tcfg.n_experts, 1, tcfg.d_ff)
    with pytest.raises(ValueError, match="MoE"):
        tlora.init_lora(0, tcfg, tlora.LoraConfig(targets=("w_in",)),
                        device="cpu")
    opts = dict(learning_rate=1e-2, grad_clip=0.5)
    lc = dict(rank=4, alpha=8.0, targets=("wq", "wo", "wv"))
    jinit, jstep = jlora.make_lora_train_step(
        jlm.TpuLM(jcfg), _mesh(), jtree, jlora.LoraConfig(**lc), **opts)
    jstate = jinit(jax.random.key(0))
    lora0 = jax.device_get(jstate.params)
    tinit, tstep = tlora.make_lora_train_step(
        tlm.TpuLM(tcfg), ttree, tlora.LoraConfig(**lc), device="cpu",
        **opts)
    tstate = tinit(lora=bridge.params_from_jax(lora0, device="cpu"))
    for step in range(2):
        toks = _tokens((2, 17), jcfg.vocab_size, 30 + step)
        jstate, jl = jstep(jstate, jnp.asarray(toks))
        tstate, tl = tstep(tstate, torch.from_numpy(toks))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        want = jax.device_get(jstate.params)
        for t in lc["targets"]:
            for k in ("a", "b"):
                w = np.asarray(want["blocks"][t][k])
                g = to_np(tstate.params["blocks"][t][k])
                assert np.abs(g - w).max() <= 2.5e-5, (t, k)
    jax.clear_caches()


# ---------------------------------------------------------------------- CLI

_TINY = ["--device", "cpu", "--d-model", "64", "--n-heads", "2",
         "--n-layers", "2", "--d-ff", "64", "--vocab-size", "128",
         "--global-batch", "2", "--seq-len", "31", "--synthetic", "4000"]


@pytest.mark.parametrize("extra", [
    ["--remat", "dots"],
    ["--remat", "full", "--lora-rank", "4", "--quantize-base"],
])
def test_cli_trains_an_moe_model(extra, tmp_path, capsys):
    """``--n-experts 4`` with remat "dots" (full training), and QLoRA
    over an MoE base under remat "full": the reference's JSON line, a
    finite loss, and the checkpoint's leaf paths."""
    ck = str(tmp_path / "ck")
    args = _TINY + ["--n-experts", "4", "--steps", "3", "--checkpoint",
                    ck] + extra
    assert train_main.main(args) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 3 and line["backend"] == "cpu"
    assert np.isfinite(line["final_loss"])
    from instaslice_tpu_torch.models.checkpoint import TrainCheckpointer

    tree = TrainCheckpointer(ck).load_tree()
    if "--lora-rank" in extra:
        assert sorted(tree["blocks"]) == ["wq", "wv"]
    else:
        assert tree["blocks"]["w_in"].shape == (2, 4, 64, 64)
        assert tree["blocks"]["router"].dtype == torch.float32
