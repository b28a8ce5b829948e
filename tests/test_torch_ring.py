"""Ring attention over the ``seq`` axis in the port
(``parallel/ring.py``, the ring branch of ``lm.apply``, the ring path of
the train step) held against the JAX package on the CPU.

One gloo world of eight processes (``torch_mesh_worker.py``) runs every
case; the JAX side runs as the reference's own tests run it, on
``tests/conftest.py``'s virtual CPU devices, meanwhile:

- ``ring_attention`` alone over 4 seq ranks, forward and the gradients
  of ``sum(out * dy)``, against the reference's ``ring_attention`` under
  ``shard_map`` (``tests/test_workload.py:82-112``), within 1e-5
  relative L2 (fp32; the online softmax adds its blocks in another
  order);
- the reference's (data 2, seq 2, model 2) ring + experts train step
  (``tests/test_workload.py:294-307``: 2 experts, tiny model, batch 4 x
  64, lr 3e-4), two steps, losses and params within 1e-5 relative;
- (seq 2, model 2) with 4 experts at capacity 0.5, where tokens are
  dropped and a block's place in its expert's buffer counts the pairs
  the earlier block of the row sent there: three steps with clip and
  warmup, within the same bound;
- the control: every rank's RoPE positions starting at 0 misses the
  loss bound by more than 10x.

The MoE runs in fp32 on both sides (XLA's CPU backend cannot run the
JAX MoE in bf16).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from instaslice_tpu.models import lm as jlm
from instaslice_tpu.parallel.compat import shard_map
from instaslice_tpu.parallel.ring import ring_attention as jax_ring
from torch_port_util import (
    jax_mesh_run,
    numpy_params,
    rel_l2,
    spawn_world,
    torch_flat,
    flat_np,
)

REL = 1e-5
CONTROL = 10
MESH = ("data", "seq", "model")
#: the reference's tiny(ring=True, experts=2) of tests/test_workload.py
TINY = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            ring_attention=True, remat=False)
CASES = {
    # name: (mesh shape, config overrides, batch (B, S), steps, opts,
    #        control)
    "d2s2t2": ((2, 2, 2), dict(n_experts=2), (4, 64), 2, {}, None),
    "s2t2_drops": ((1, 2, 2), dict(n_experts=4, n_kv_heads=2,
                                   expert_capacity_factor=0.5),
                   (4, 32), 3, dict(grad_clip=1.0, warmup_steps=2,
                                    decay_steps=3, learning_rate=1e-3),
                   None),
    "d2s2t2_pos0": ((2, 2, 2), dict(n_experts=2), (4, 64), 2, {},
                    "ring_pos0"),
}
RING = dict(B=2, S=32, H=2, hd=8, n=4)


def _cfg(name):
    return dict(TINY, **CASES[name][1])


def _np_params(name):
    return numpy_params(jlm.ModelConfig(**_cfg(name)), seed=7)


def _batches(name):
    (B, S), steps = CASES[name][2], CASES[name][3]
    rng = np.random.default_rng(13)
    return [rng.integers(0, 128, (B, S)).astype(np.int32)
            for _ in range(steps)]


def _qkvdy():
    rng = np.random.default_rng(3)
    shape = (RING["B"], RING["S"], RING["H"], RING["hd"])
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    q, k, v, dy = _qkvdy()
    cases = [{"kind": "ring", "name": "ring", "names": ("seq",),
              "shape": (RING["n"],), "q": torch.from_numpy(q),
              "k": torch.from_numpy(k), "v": torch.from_numpy(v),
              "dy": torch.from_numpy(dy)}]
    for name, (shape, _, _, _, opts, control) in CASES.items():
        cases.append({"kind": "train", "name": name, "names": MESH,
                      "shape": shape, "cfg": _cfg(name), "opts": opts,
                      "params": torch_flat(flat_np(_np_params(name))),
                      "batches": [torch.from_numpy(b)
                                  for b in _batches(name)],
                      "control": control})
    w = spawn_world(out, cases, "torch_mesh_worker.py", 8)
    try:
        yield w
    finally:
        w.close()


def _jax_ring():
    q, k, v, dy = (jnp.asarray(a) for a in _qkvdy())
    mesh = Mesh(np.array(jax.devices()[:RING["n"]]).reshape(1, RING["n"]),
                ("data", "seq"))
    ring = shard_map(functools.partial(jax_ring, axis_name="seq"),
                     mesh=mesh, in_specs=(P(None, "seq", None, None),) * 3,
                     out_specs=P(None, "seq", None, None))
    out = ring(q, k, v)
    grads = jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v) * dy),
                     argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(t) for t in (out, *grads)]


def test_ring_attention_alone_matches_the_reference_ring(world):
    """Each rank's block of the output and of dq, dk, dv (the gradient of
    ``sum(out * dy)``, whose K/V parts come back round the ring) within
    1e-5 of the reference's ring under ``shard_map`` on 4 devices."""
    want = _jax_ring()
    n, S = RING["n"], RING["S"] // RING["n"]
    for r in range(n):
        got = world.result("ring", r)
        for key, w in zip(("out", "dq", "dk", "dv"), want):
            err = rel_l2(got[key].numpy(), w[:, r * S:(r + 1) * S])
            assert err <= REL, (r, key, err)


def _jax_side(name):
    shape, _, _, _, opts, _ = CASES[name]
    jcfg = jlm.ModelConfig(dtype=jnp.float32, attention_impl="xla",
                           **_cfg(name))
    return jax_mesh_run(jcfg, _np_params(name), _batches(name), MESH, shape,
                        opts)


@pytest.mark.parametrize("name", ["d2s2t2", "s2t2_drops"])
def test_ring_experts_train_step_matches_jax(world, name):
    """The reference's (2, 2, 2) ring + experts step and a (1, 2, 2)
    step with capacity drops: losses and final params (gathered over
    ``model``) within 1e-5 relative of the JAX mesh step; every rank of
    the mesh reports the same losses."""
    losses, params, _ = _jax_side(name)
    res = world.result(name, 0)
    np.testing.assert_allclose(res["losses"], losses, rtol=REL)
    assert res["params"].keys() == params.keys()
    for path, want in params.items():
        err = rel_l2(res["params"][path].numpy(), want)
        assert err <= REL, (path, err)
    n = int(np.prod(CASES[name][0]))
    for r in range(1, n):
        assert world.result(name, r)["losses"] == res["losses"]


def test_ring_positions_from_zero_miss_the_bound(world):
    """The control: each seq rank's RoPE positions starting at 0 instead
    of at ``rank * S_local`` moves the losses by more than 10x the
    bound."""
    losses, _, _ = _jax_side("d2s2t2")
    ctl = world.result("d2s2t2_pos0", 0)["losses"]
    err = max(abs(a - b) / abs(b) for a, b in zip(ctl, losses))
    assert err > CONTROL * REL, err
