"""The port's tensor-parallel serving held against the JAX package's mesh
engine on the CPU.

One gloo world of two processes (``torch_serve_tp_worker.py``) is spawned
for the module and runs every case over a (1, 1, 2) ("data", "seq",
"model") mesh; the JAX side is the reference ``ServingEngine`` with
``mesh=`` on two of ``tests/conftest.py``'s virtual CPU devices (its
Pallas kernels off at mesh size > 1, as the reference turns them off),
computed while the world runs. The weights are one seeded numpy tree
(``torch_port_util``: vocab 256, d_model 256, 4 heads, 2 KV heads, 2
layers, d_ff 512, fp32 compute), quantized by the JAX package where a
case quantizes and bridged, and handed WHOLE to both engines, which keep
their shards.

Each rank of the port holds 2 query heads, 1 KV head, half of d_ff and
half of the vocabulary. Bounds, all measured on the CPU: fp32 logits
within 1e-5 of the JAX mesh engine's (max abs over logits of max |logit|
~2), greedy tokens equal to it and to the port's meshless engine; int8
W+KV and int4 weights: the cache forward's logits (over an fp32 cache)
within the same 1e-5 (the dequantized products are the same fp32 sums in
another order), and the engine over an int8 KV cache with greedy tokens
equal and logprobs within 2e-3: an int8 KV entry whose fp32 input moves
by an ulp can round to its neighbouring step (1/127 of its vector's
amax), and later tokens read it (measured: 4.6e-4 in the cache
forward's logits over an int8 cache, 3e-4 to 7.2e-4 in the engine's
logprobs, also between the port's MESHLESS int8 engine and the JAX one,
so the gap is the KV rounding's, not the mesh's). The control, rank 1 holding
rank 0's ``wq`` shard, misses the logits bound by far more than 10x.
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
from instaslice_tpu.models.quant import shard_params as jax_shard_params
from instaslice_tpu.serving import AdmissionRequest as JaxAdmission
from instaslice_tpu.serving import ServingEngine as JaxEngine
from conftest import free_port
from instaslice_tpu_torch import bridge
from instaslice_tpu_torch.models import lm as tlm
from instaslice_tpu_torch.models.quant import (
    Int4Tensor,
    QuantizedTensor,
    shard_params,
)
from instaslice_tpu_torch.parallel.collectives import Axis, MeshAxes
from torch_port_util import (
    SMALL,
    configs,
    encode_tree,
    numpy_params,
    spawn_world,
)

WORLD = 2
ENGINE = dict(max_batch=4, max_len=64, prefill_len=8)
TOL = 1e-5
#: the engine's logprobs over an int8 KV cache (see the module docstring)
KV_LP_TOL = 2e-3
CONTROL = 10
#: int4 group: wo's packed axis (256) splits into 128-row shards of whole
#: 64-groups; the shard test also takes 256, where it cannot split
GROUP = 64

CHUNK = np.random.default_rng(5).integers(1, 256, (2, 8)).tolist()
PROMPTS = [np.random.default_rng(6 + n).integers(1, 256, n).tolist()
           for n in (3, 11, 8)]
N_NEW = 8
STEPS = 3

CASES = {
    # name: (quantize bits or None, int8 KV cache, swap wq on rank 1)
    "fp32": (None, False, False),
    "int8": (8, True, False),
    "int4": (4, True, False),
    "fp32_swapped_wq": (None, False, True),
}


@functools.lru_cache(maxsize=None)
def _trees(bits, group=GROUP):
    """(JAX tree, port tree) of the shared weights, fp32, optionally
    quantized by the JAX package (jitted: op by op it takes seconds) and
    bridged bit for bit."""
    jcfg, _ = configs("fp32")
    jtree = jax.tree.map(jnp.asarray, numpy_params(jcfg, 0))
    if bits:
        jtree = jax.jit(functools.partial(jax_quantize, bits=bits,
                                          group=group))(jtree)
    return jtree, bridge.params_from_jax(jax.device_get(jtree), device="cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_tp")
    cases = []
    for name, (bits, kvq, swap) in CASES.items():
        cases.append({"kind": "forward", "name": name, "cfg": SMALL,
                      "params": encode_tree(_trees(bits)[1]), "kv_quant": kvq,
                      "swap_wq": swap, "chunk": CHUNK, "steps": STEPS,
                      "prompts": PROMPTS, "n_new": N_NEW})
    cases.append({"kind": "refusals", "name": "refusals", "cfg": SMALL,
                  "params": encode_tree(_trees(None)[1]), "kv_quant": False})
    for name, control in (("recover", False), ("recover_control", True)):
        cases.append({"kind": "recover", "name": name, "cfg": SMALL,
                      "params": encode_tree(_trees(None)[1]),
                      "kv_quant": False, "control": control,
                      "port": free_port()})
    w = spawn_world(out, cases)
    try:
        yield w
    finally:
        w.close()


def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]).reshape(1, 1, WORLD),
                ("data", "seq", "model"))


@functools.lru_cache(maxsize=None)
def _jax_side(bits, kvq):
    """The JAX mesh engine's cache-forward logits (its params and an fp32
    cache laid out as it lays its own) and its burst + decode block."""
    jcfg, _ = configs("fp32")
    mesh = _mesh()
    model = jlm.TpuLM(jcfg)
    eng = JaxEngine(model, _trees(bits)[0], mesh=mesh, kv_quant=kvq,
                    radix_cache=False, **ENGINE)
    cache = jax.device_put(model.init_cache(len(CHUNK), ENGINE["max_len"]),
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
    out = {"logits": np.stack(logits),
           "tokens": [by_rid[r].generated for r in rids],
           "logprobs": [by_rid[r].logprobs for r in rids]}
    return out


def _max_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


@pytest.mark.parametrize("bits,group", [(8, GROUP), (4, GROUP), (4, 256)])
def test_shard_params_match_the_reference_shards(bits, group):
    """Each rank's leaves equal the reference ``shard_params``'s
    ``addressable_shards`` on a 2-device model axis, shape and bytes: int8
    values on the weight's spec and scales whole on their reduced axis;
    int4 packed values and group scales with the packed axis of ``wo``
    and ``w_out`` split at group 64 and, at group 256, ``wo``'s kept whole
    (128-row shards would cut a group) while ``w_out``'s (512 rows)
    splits: the rule of the reference's ``test_engine_tp_int4``."""
    jcfg, tcfg = configs("fp32")
    jtree, ttree = _trees(bits, group)
    ref = jax_shard_params(jtree, _mesh(), jlm.param_specs(jcfg))
    mine = [shard_params(ttree, tlm.param_specs(tcfg),
                         MeshAxes(model=Axis(None, WORLD, r)))
            for r in range(WORLD)]

    def parts(node):
        if isinstance(node, QuantizedTensor):
            return {"q": node.q, "s": node.s}
        if isinstance(node, Int4Tensor):
            return {"p": node.p, "s": node.s}
        if type(node).__name__ in ("QuantizedTensor", "Int4Tensor"):
            return {k: getattr(node, k) for k in ("q", "p", "s")
                    if hasattr(node, k)}
        return {"": node}

    def walk(ref_node, mine_nodes, path):
        if isinstance(ref_node, dict):
            for k in ref_node:
                walk(ref_node[k], [m[k] for m in mine_nodes], f"{path}/{k}")
            return
        for part, arr in parts(ref_node).items():
            shards = sorted(arr.addressable_shards, key=lambda s: s.device.id)
            for r, sh in enumerate(shards):
                got = parts(mine_nodes[r])[part]
                want = np.asarray(sh.data)
                assert tuple(got.shape) == want.shape, (path, part, r)
                assert got.is_contiguous()
                np.testing.assert_array_equal(
                    bridge.params_to_numpy(got), want, err_msg=path)

    walk(ref, mine, "")
    wo, w_out = mine[0]["blocks"]["wo"], mine[0]["blocks"]["w_out"]
    if bits == 4:
        assert wo.p.shape[1] == (64 if group == GROUP else 128)
        assert w_out.p.shape[1] == 128
        assert mine[0]["blocks"]["wq"].p.shape[-1] == 128


def test_fp32_tp2_matches_the_jax_mesh_engine(world):
    """fp32 at tp 2: the cache forward's logits (a prefill chunk, then
    greedy decode steps) within 1e-5 of the JAX mesh engine's, the same
    on both ranks bit for bit; the engine's burst admission and decode
    block give the JAX mesh engine's greedy tokens and the port's
    meshless engine's, logprobs within the bound; each rank's cache holds
    one of the two KV heads, and the decode route is eager."""
    want = _jax_side(None, False)
    r0, r1 = world.result("fp32", 0), world.result("fp32", 1)
    assert _max_err(r0["logits"], want["logits"]) <= TOL
    assert _max_err(r0["meshless_logits"], want["logits"]) <= TOL
    assert torch.equal(r0["logits"], r1["logits"])
    assert r0["tokens"] == want["tokens"] == r0["meshless"]["tokens"]
    assert r1["tokens"] == r0["tokens"]
    assert len({tuple(t) for t in r0["tokens"]}) == len(PROMPTS)
    assert _max_err(r0["logprobs"], want["logprobs"]) <= TOL
    assert r0["cache_heads"] == r1["cache_heads"] == 1
    assert r0["route"].startswith("eager (tensor parallel")


@pytest.mark.parametrize("name,bits", [("int8", 8), ("int4", 4)])
def test_quantized_tp2_matches_the_jax_mesh_engine(world, name, bits):
    """int8 and int4 weights at tp 2: the cache forward's logits within
    1e-5 of the JAX mesh engine's; over an int8 KV cache the engine's
    greedy tokens equal to it and to the meshless port engine, logprobs
    within the int8 KV bound, ranks bit-equal."""
    want = _jax_side(bits, True)
    r0, r1 = world.result(name, 0), world.result(name, 1)
    assert _max_err(r0["logits"], want["logits"]) <= TOL
    assert torch.equal(r0["logits"], r1["logits"])
    assert r0["tokens"] == want["tokens"] == r0["meshless"]["tokens"]
    assert r1["tokens"] == r0["tokens"]
    assert _max_err(r0["logprobs"], want["logprobs"]) <= KV_LP_TOL
    assert r0["logprobs"] == r1["logprobs"]


def test_swapped_wq_shard_misses_the_bound(world):
    """The control: rank 1 holding rank 0's ``wq`` columns puts rank 0's
    query heads where its own belong; the logits miss the fp32 bound by
    more than 10x."""
    want = _jax_side(None, False)
    ctl = world.result("fp32_swapped_wq", 0)
    assert _max_err(ctl["logits"], want["logits"]) > CONTROL * TOL


def test_tp2_refusals(world):
    """At tp 2: ``decode_graphs=True`` raises (graphs under tp are queue
    A item 1a) and ``export_session`` refuses (each process holds only
    its heads of a stripe), as the reference refuses it on a
    multi-process mesh; stacked adapters and an MoE model (experts over
    model) build, as the reference's do."""
    res = world.result("refusals", 0)
    errs = res["errors"]
    assert errs["decode_graphs"].startswith("ValueError: decode_graphs")
    assert "item 1a" in errs["decode_graphs"]
    assert errs["lora"] == "" and errs["moe"] == ""
    assert errs["export"].startswith("RuntimeError: session export over a "
                                     "multi-process mesh")
    assert res["multiproc"] is True
    assert world.result("refusals", 1)["errors"] == errs


def test_recovery_rides_the_op_stream(world):
    """A chip failure injected into the driver mid-decode: the scheduler
    over ``DistributedEngine`` recovers (both requests fail with the
    recovery's error), ``recover`` rides the op stream, and the follower
    lands in the driver's state: digests equal, and the next two
    admissions take the same slots, 0 and 1, on both ranks."""
    d, f = world.result("recover", 0), world.result("recover", 1)
    assert len(d["fired"]) == 1 and f["applied"] > 0
    assert all(e.startswith("engine recovered after device failure")
               for e in d["errors"])
    assert dict(f["digest"], finished=[]) == dict(d["digest"], finished=[])
    assert d["slots"] == f["slots"] == dict(zip((0, 1), d["new"]))


def test_recovery_by_the_driver_alone_diverges(world):
    """The control: the driver recovers alone (no ``recover`` op). The
    follower keeps the failed requests' slots, the next admissions land
    in slots 2 and 3 there, and the digests differ."""
    d, f = (world.result("recover_control", r) for r in (0, 1))
    assert len(d["fired"]) == 1
    assert d["slots"] == dict(zip((0, 1), d["new"]))
    assert f["slots"] != d["slots"] and len(f["slots"]) == 4
    assert f["digest"]["live"] != d["digest"]["live"]
