"""LoRA and QLoRA under a mesh in the port: ``make_lora_train_step(mesh=)``
(``lora_specs``, the merge on shards) and stacked adapters in the
tensor-parallel engine and over the driver/follower op stream, held
against the JAX package on the CPU.

Training: a gloo world of four processes (``torch_mesh_worker.py``) at
(data 2, model 2), the tiny model of ``test_torch_parallel_train.py``
(vocab 64, d 32, 4 heads, 2 KV heads, 2 layers, d_ff 64, fp32) with
rank-4 adapters on all six projections (column- and row-parallel
targets both; ``b`` drawn nonzero so that ``a`` trains from the first
step), 3 steps (AdamW without decay, clip 1.0, warmup 2, cosine decay
over 3, lr 1e-3, chunked loss 8), over the fp32 base and over its int8
quantization by the JAX package (QLoRA), against the reference's
``make_lora_train_step`` on a (2, 1, 2) virtual CPU mesh
(``tests/test_lora.py:60-135``): losses and final adapters within 1e-5
relative (L2 per leaf). The control hands each model rank the other's
columns of ``b``; it misses the loss bound by more than 10x.

Serving: the two-rank world of ``torch_serve_tp_worker.py`` at tp 2
(``torch_port_util.SMALL``, fp32, two stacked rank-4 adapters on wq, wv,
wo and w_out): the cache forward with a row on each adapter and the
base within 1e-5 (max abs logits) of the JAX mesh engine's, the burst
and decode block with greedy tokens equal to it and to the meshless
port engine and logprobs within 1e-5; then a script of admissions on
adapters 1, 2 and the base through ``DistributedEngine`` with a
follower: the follower's digest equal to the driver's, and the
driver's equal to the JAX mesh engine's after the same script.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from conftest import free_port
from instaslice_tpu.models import lm as jlm
from instaslice_tpu.models import lora as jlora
from instaslice_tpu.models import train as jtrain
from instaslice_tpu.models.quant import quantize_params as jax_quantize
from instaslice_tpu.models.quant import shard_params as jax_shard_params
from instaslice_tpu.serving import AdmissionRequest as JaxAdmission
from instaslice_tpu.serving import ServingEngine as JaxEngine
from instaslice_tpu.serving.dcn_serve_smoke import state_digest as jdigest
from instaslice_tpu_torch import bridge
from instaslice_tpu_torch.models import lora as tlora
from torch_port_util import (
    SMALL,
    configs,
    encode_tree,
    flat_np,
    numpy_params,
    rel_l2,
    spawn_world,
)
from torch_serve_tp_worker import adapter_script

REL = 1e-5
CONTROL = 10
MESH = ("data", "seq", "model")
TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
            n_layers=2, d_ff=64, remat=False)
TARGETS = ("w_in", "w_out", "wk", "wo", "wq", "wv")
LCFG = dict(rank=4, alpha=8.0, targets=TARGETS)
OPTS = dict(learning_rate=1e-3, grad_clip=1.0, warmup_steps=2,
            decay_steps=3, loss_chunk=8)
B, S = 8, 16
TRAIN = {
    # name: (int8 base, control)
    "lora": (False, None),
    "qlora": (True, None),
    "lora_swap_b": (False, "swap_b"),
}
SERVE_TARGETS = ("w_out", "wo", "wq", "wv")
SERVE = dict(max_batch=4, max_len=64, prefill_len=8)
CHUNK = np.random.default_rng(5).integers(1, 256, (3, 8)).tolist()
PROMPTS = [np.random.default_rng(6 + n).integers(1, 256, n).tolist()
           for n in (3, 11, 8)]
ADAPTERS = [1, 0, 2]
STEPS, N_NEW = 3, 8
TOL = 1e-5


def _numpy_adapter(cfg, seed, targets, b_scale=0.05):
    rng = np.random.default_rng(seed)
    shapes = tlora._target_shapes(cfg)
    return {"blocks": {t: {
        "a": (rng.standard_normal(shapes[t][:2] + (4,))
              * shapes[t][1] ** -0.5).astype(np.float32),
        "b": (rng.standard_normal((shapes[t][0], 4, shapes[t][2]))
              * b_scale).astype(np.float32)} for t in sorted(targets)}}


@functools.lru_cache(maxsize=None)
def _train_trees(int8):
    """(JAX base, port base, numpy adapter) of the training cases."""
    jcfg = jlm.ModelConfig(dtype=jnp.float32, **TINY)
    jtree = jax.tree.map(jnp.asarray, numpy_params(jcfg, 3))
    if int8:
        jtree = jax.jit(jax_quantize)(jtree)
    return (jtree, bridge.params_from_jax(jax.device_get(jtree),
                                          device="cpu"),
            _numpy_adapter(jcfg, 4, TARGETS))


def _batches():
    rng = np.random.default_rng(11)
    return [rng.integers(1, TINY["vocab_size"], (B, S)).astype(np.int32)
            for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _serve_setup():
    jcfg, _ = configs("fp32")
    jtree = jax.tree.map(jnp.asarray, numpy_params(jcfg, 0))
    nps = [_numpy_adapter(jcfg, s, SERVE_TARGETS, b) for s, b in
           ((1, 0.05), (2, 0.1))]
    return (jtree, bridge.params_from_jax(jax.device_get(jtree),
                                          device="cpu"),
            [jax.tree.map(jnp.asarray, a) for a in nps],
            [bridge.params_from_jax(a, device="cpu") for a in nps])


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("lora_train")
    cases = []
    for name, (int8, control) in TRAIN.items():
        _, tbase, lora = _train_trees(int8)
        cases.append({"kind": "lora", "name": name, "names": MESH,
                      "shape": (2, 1, 2), "cfg": dict(TINY), "lcfg": LCFG,
                      "opts": OPTS, "base": encode_tree(tbase),
                      "lora": encode_tree(bridge.params_from_jax(
                          lora, device="cpu")),
                      "batches": [torch.from_numpy(b) for b in _batches()],
                      "control": control})
    w = spawn_world(out, cases, "torch_mesh_worker.py", 4)
    try:
        yield w
    finally:
        w.close()


@pytest.fixture(scope="module")
def serve_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("lora_serve")
    _, tree, _, tads = _serve_setup()
    base = {"cfg": SMALL, "params": encode_tree(tree), "kv_quant": False,
            "lora": [encode_tree(a) for a in tads]}
    cases = [dict(base, kind="forward", name="lora_tp2", swap_wq=False,
                  chunk=CHUNK, steps=STEPS, prompts=PROMPTS, n_new=N_NEW,
                  adapters=ADAPTERS),
             dict(base, kind="oplog_lora", name="oplog_lora",
                  port=free_port())]
    w = spawn_world(out, cases)
    try:
        yield w
    finally:
        w.close()


@functools.lru_cache(maxsize=None)
def _jax_lora(name):
    int8 = TRAIN[name][0]
    jbase, _, lora = _train_trees(int8)
    jcfg = jlm.ModelConfig(dtype=jnp.float32, attention_impl="xla", **TINY)
    jax.clear_caches()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 1, 2), MESH)
    base = jax_shard_params(jbase, mesh, jlm.param_specs(jcfg))
    lcfg = jlora.LoraConfig(**LCFG)
    _, jstep = jlora.make_lora_train_step(jlm.TpuLM(jcfg), mesh, base, lcfg,
                                          **OPTS)
    tx = jtrain.make_optimizer(OPTS["learning_rate"], OPTS["grad_clip"],
                               OPTS["warmup_steps"], OPTS["decay_steps"],
                               weight_decay=0.0)
    params = jax.tree.map(jnp.asarray, lora)
    state = jtrain.TrainState(jnp.zeros((), jnp.int32), params,
                              tx.init(params))
    losses = []
    for toks in _batches():
        state, loss = jstep(state, jnp.asarray(toks))
        losses.append(float(loss))
    return losses, flat_np(jax.device_get(state.params))


def test_lora_specs_match_the_reference():
    """``b`` follows the base weight's output axis, ``a`` is replicated."""
    jcfg, tcfg = configs("fp32")
    lcfg = dict(rank=4, targets=TARGETS)
    want = jlora.lora_specs(jcfg, jlora.LoraConfig(**lcfg))
    got = tlora.lora_specs(tcfg, tlora.LoraConfig(**lcfg))
    assert got == jax.tree.map(tuple, want,
                               is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("name", ["lora", "qlora"])
def test_lora_step_on_a_mesh_matches_jax(train_world, name):
    """LoRA over the fp32 base and QLoRA over its int8 shards at (data 2,
    model 2): losses and the gathered adapters within 1e-5 of the
    reference's mesh step; every rank reports the same losses."""
    losses, params = _jax_lora(name)
    res = train_world.result(name, 0)
    np.testing.assert_allclose(res["losses"], losses, rtol=REL)
    assert res["params"].keys() == params.keys()
    for path, want in params.items():
        err = rel_l2(res["params"][path].numpy(), want)
        assert err <= REL, (path, err)
    for r in (1, 2, 3):
        assert train_world.result(name, r)["losses"] == res["losses"]


def test_swapped_b_columns_miss_the_bound(train_world):
    """The control: each model rank holding the other's columns of the
    column-parallel targets' ``b`` moves the losses far outside 1e-5."""
    losses, _ = _jax_lora("lora")
    ctl = train_world.result("lora_swap_b", 0)["losses"]
    err = max(abs(a - b) / abs(b) for a, b in zip(ctl, losses))
    assert err > CONTROL * REL, err


def _jax_engine():
    jtree, _, jads, _ = _serve_setup()
    jcfg, _ = configs("fp32")
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 1, 2), MESH)
    return JaxEngine(jlm.TpuLM(jcfg), jtree, mesh=mesh, lora_adapters=jads,
                     radix_cache=False, **SERVE), mesh


def _jax_serve():
    eng, mesh = _jax_engine()
    model = eng.model
    cache = jax.device_put(model.init_cache(len(CHUNK), SERVE["max_len"]),
                           NamedSharding(mesh, P(None, None, "model")))
    fwd = jax.jit(model.apply_with_cache)
    toks = jnp.asarray(CHUNK, jnp.int32)
    lens = jnp.zeros(len(CHUNK), jnp.int32)
    aidx = jnp.asarray(ADAPTERS, jnp.int32)
    logits = []
    for _ in range(1 + STEPS):
        lg, cache = fwd(eng.params, toks, cache, lens, lora=eng.lora,
                        adapter_idx=aidx)
        logits.append(np.asarray(lg[:, -1], np.float32))
        lens = lens + toks.shape[1]
        toks = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    rids = [r[0] for r in eng.add_requests(
        [JaxAdmission(p, adapter=a) for p, a in zip(PROMPTS, ADAPTERS)])]
    eng.decode_block(N_NEW)
    by_rid = {r.request_id: r for r in eng.slots.values()}
    return {"logits": np.stack(logits),
            "tokens": [by_rid[r].generated for r in rids],
            "logprobs": [by_rid[r].logprobs for r in rids]}


def _max_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def test_stacked_adapters_in_the_tp2_engine_match_jax(serve_world):
    """Rows on adapter 1, the base and adapter 2 at tp 2 (each rank its
    columns of wq/wv's ``b``, its rows of wo/w_out's ``a``): the cache
    forward's logits within 1e-5 of the JAX mesh engine's and of the
    meshless port engine's; the burst and decode block give the JAX mesh
    engine's greedy tokens and logprobs (gathered rounds: the rows'
    adapters differ); the ranks bit-equal."""
    want = _jax_serve()
    r0, r1 = serve_world.result("lora_tp2", 0), \
        serve_world.result("lora_tp2", 1)
    assert _max_err(r0["logits"], want["logits"]) <= TOL
    assert _max_err(r0["meshless_logits"], want["logits"]) <= TOL
    assert torch.equal(r0["logits"], r1["logits"])
    assert r0["tokens"] == want["tokens"] == r0["meshless"]["tokens"]
    assert len({tuple(t) for t in r0["tokens"]}) == len(PROMPTS)
    assert _max_err(r0["logprobs"], want["logprobs"]) <= TOL
    assert r1["tokens"] == r0["tokens"]
    assert r0["rounds"][1] >= 1


def test_adapters_ride_the_op_stream(serve_world):
    """The adapter script through ``DistributedEngine``: the follower's
    digest equals the driver's (its ``finished`` drained, as followers
    drain it) and the driver's equals the JAX mesh engine's after the
    same script."""
    d, f = serve_world.result("oplog_lora", 0), \
        serve_world.result("oplog_lora", 1)
    assert f["applied"] > 0
    assert dict(f["digest"], finished=[]) == dict(d["digest"], finished=[])
    eng, _ = _jax_engine()
    adapter_script(_JaxAdmissions(eng))
    assert d["digest"] == jdigest(eng)


class _JaxAdmissions:
    """The JAX engine behind the port's ``AdmissionRequest`` (the
    script builds the port's)."""

    def __init__(self, eng):
        self._eng = eng

    def __getattr__(self, name):
        return getattr(self._eng, name)

    def add_requests(self, reqs):
        return self._eng.add_requests([JaxAdmission(
            r.prompt, n=r.n, stop=r.stop, adapter=r.adapter) for r in reqs])
