"""MoE experts over the ``model`` axis (expert parallelism) in the port,
training and serving, held against the JAX package's mesh step and mesh
engine on the CPU.

Training: a gloo world of four processes (``torch_mesh_worker.py``)
runs ``make_train_step(mesh=...)`` with 4 experts, top-2, each model
rank holding 2 of them (the router replicated), 3 fp32 steps (AdamW,
clip 1.0, warmup 2, cosine decay over 3, lr 1e-3, aux weight 0.01) at
(dp 1, tp 2), (dp 2, tp 2) and at capacity 0.5 (tokens dropped), against
the JAX mesh step of the same shape on ``tests/conftest.py``'s virtual
devices: losses and final params within 1e-5 relative (L2 per leaf), the
router's gradient at the initial weights (averaged, before the clip)
within 1e-5. The control drops the gates' ``copy_to`` and all-reduces
the router's gradient over ``model`` instead, which counts the
load-balance part twice; it misses the router bound by more than 10x.

Serving: the two-rank world of ``torch_serve_tp_worker.py`` serves the
4-expert model (the ``torch_port_util.SMALL`` widths) at tp 2, its
weights int8-quantized by the JAX package: the cache forward's logits
within 1e-5 (max abs) of the JAX mesh engine's, and the engine over an
int8 KV cache with greedy tokens equal to the JAX mesh engine's and to
the port's meshless engine, logprobs within 2e-3 (the int8 KV rounding
bound of ``test_torch_serve_tp.py``); the ranks bit-equal. The MoE runs
in fp32 on both sides (XLA's CPU backend cannot run the JAX MoE in
bf16).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from instaslice_tpu.models import lm as jlm
from instaslice_tpu.models.quant import quantize_params as jax_quantize
from instaslice_tpu.serving import AdmissionRequest as JaxAdmission
from instaslice_tpu.serving import ServingEngine as JaxEngine
from instaslice_tpu_torch import bridge
from torch_port_util import (
    SMALL,
    configs,
    encode_tree,
    flat_np,
    jax_mesh_run,
    numpy_params,
    rel_l2,
    spawn_world,
    torch_flat,
)

REL = 1e-5
CONTROL = 10
MESH = ("data", "seq", "model")
TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
            n_layers=2, d_ff=64, n_experts=4, expert_top_k=2, remat=False)
OPTS = dict(learning_rate=1e-3, grad_clip=1.0, warmup_steps=2,
            decay_steps=3, loss_chunk=8, moe_aux_weight=0.01)
B, S = 8, 16
TRAIN = {
    # name: (mesh shape, config overrides, control)
    "t2": ((1, 1, 2), {}, None),
    "d2t2": ((2, 1, 2), {}, None),
    "t2_drops": ((1, 1, 2), dict(expert_capacity_factor=0.5), None),
    "t2_naive_router": ((1, 1, 2), {}, "naive_router"),
}
SERVE = dict(max_batch=4, max_len=64, prefill_len=8)
CHUNK = np.random.default_rng(5).integers(1, 256, (2, 8)).tolist()
PROMPTS = [np.random.default_rng(6 + n).integers(1, 256, n).tolist()
           for n in (3, 11, 8)]
STEPS, N_NEW = 3, 8
TOL, KV_LP_TOL = 1e-5, 2e-3


def _cfg(name):
    return dict(TINY, **TRAIN[name][1])


def _np_params(name):
    return numpy_params(jlm.ModelConfig(**_cfg(name)), seed=3)


def _batches():
    rng = np.random.default_rng(11)
    return [rng.integers(1, TINY["vocab_size"], (B, S)).astype(np.int32)
            for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _serve_trees():
    """(JAX tree, port tree) of the 4-expert SMALL model's int8 weights."""
    jcfg, _ = configs("fp32", n_experts=4)
    jtree = jax.jit(jax_quantize)(jax.tree.map(jnp.asarray,
                                               numpy_params(jcfg, 0)))
    return jtree, bridge.params_from_jax(jax.device_get(jtree), device="cpu")


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("ep_train")
    cases = [{"kind": "train", "name": name, "names": MESH, "shape": shape,
              "cfg": _cfg(name), "opts": OPTS,
              "params": torch_flat(flat_np(_np_params(name))),
              "batches": [torch.from_numpy(b) for b in _batches()],
              "control": control}
             for name, (shape, _, control) in TRAIN.items()]
    w = spawn_world(out, cases, "torch_mesh_worker.py", 4)
    try:
        yield w
    finally:
        w.close()


@pytest.fixture(scope="module")
def serve_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("ep_serve")
    cases = [{"kind": "forward", "name": "moe_int8",
              "cfg": dict(SMALL, n_experts=4),
              "params": encode_tree(_serve_trees()[1]), "kv_quant": True,
              "swap_wq": False, "chunk": CHUNK, "steps": STEPS,
              "prompts": PROMPTS, "n_new": N_NEW}]
    w = spawn_world(out, cases)
    try:
        yield w
    finally:
        w.close()


@functools.lru_cache(maxsize=None)
def _jax_train(name):
    jcfg = jlm.ModelConfig(dtype=jnp.float32, attention_impl="xla",
                           **_cfg(name))
    return jax_mesh_run(jcfg, _np_params(name), _batches(), MESH,
                        TRAIN[name][0], OPTS, grads_at_start=True)


@pytest.mark.parametrize("name", ["t2", "d2t2", "t2_drops"])
def test_expert_parallel_step_matches_jax(train_world, name):
    """Experts over model at tp 2 (with and without a data axis, with
    and without capacity drops): losses, final params and the router's
    first gradient within 1e-5 of the JAX mesh step, whose experts are
    sharded over model by the same ``param_specs``."""
    losses, params, grads = _jax_train(name)
    res = train_world.result(name, 0)
    np.testing.assert_allclose(res["losses"], losses, rtol=REL)
    for path, want in params.items():
        err = rel_l2(res["params"][path].numpy(), want)
        assert err <= REL, (path, err)
    err = rel_l2(res["grads0"]["blocks/router"].numpy(),
                 grads["blocks/router"])
    assert err <= REL, err
    other = train_world.result(name, 1)
    assert other["losses"] == res["losses"]


def test_router_gradient_reduced_naively_misses_the_bound(train_world):
    """The control: without the gates' ``copy_to``, all-reducing the
    router's gradient over model sums the combine part right but counts
    the load-balance part (whole on every rank) twice."""
    _, _, grads = _jax_train("t2")
    ctl = train_world.result("t2_naive_router", 0)
    err = rel_l2(ctl["grads0"]["blocks/router"].numpy(),
                 grads["blocks/router"])
    assert err > CONTROL * REL, err


def _jax_serve():
    jcfg, _ = configs("fp32", n_experts=4)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 1, 2), MESH)
    model = jlm.TpuLM(jcfg)
    eng = JaxEngine(model, _serve_trees()[0], mesh=mesh, kv_quant=True,
                    radix_cache=False, **SERVE)
    cache = jax.device_put(model.init_cache(len(CHUNK), SERVE["max_len"]),
                           NamedSharding(mesh, P(None, None, "model")))
    fwd = jax.jit(model.apply_with_cache)
    toks = jnp.asarray(CHUNK, jnp.int32)
    lens = jnp.zeros(len(CHUNK), jnp.int32)
    logits = []
    for _ in range(1 + STEPS):
        lg, cache = fwd(eng.params, toks, cache, lens)
        logits.append(np.asarray(lg[:, -1], np.float32))
        lens = lens + toks.shape[1]
        toks = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    rids = [r[0] for r in eng.add_requests([JaxAdmission(p)
                                            for p in PROMPTS])]
    eng.decode_block(N_NEW)
    by_rid = {r.request_id: r for r in eng.slots.values()}
    return {"logits": np.stack(logits),
            "tokens": [by_rid[r].generated for r in rids],
            "logprobs": [by_rid[r].logprobs for r in rids]}


def _max_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def test_moe_int8_tp2_matches_the_jax_mesh_engine(serve_world):
    """The 4-expert int8 model at tp 2 (each rank 2 experts, 2 query
    heads, 1 KV head): the cache forward's logits within 1e-5 of the JAX
    mesh engine's; the engine over an int8 KV cache gives its greedy
    tokens and the meshless port engine's, logprobs within 2e-3; both
    ranks bit-equal."""
    want = _jax_serve()
    r0, r1 = serve_world.result("moe_int8", 0), \
        serve_world.result("moe_int8", 1)
    assert _max_err(r0["logits"], want["logits"]) <= TOL
    assert _max_err(r0["meshless_logits"], want["logits"]) <= TOL
    assert torch.equal(r0["logits"], r1["logits"])
    assert r0["tokens"] == want["tokens"] == r0["meshless"]["tokens"]
    assert r1["tokens"] == r0["tokens"]
    assert _max_err(r0["logprobs"], want["logprobs"]) <= KV_LP_TOL
    assert r0["logprobs"] == r1["logprobs"]
    assert r0["cache_heads"] == 1
