"""The port's parallel train step held against the JAX package's mesh
step on the CPU.

One gloo world of four processes (``torch_parallel_worker.py``) is
spawned for the module and runs every case; each case builds its
("data", "seq", "model") mesh over the first ``dp * tp`` ranks and runs 3
fp32 steps of ``make_train_step(mesh=...)`` (AdamW, clip 1.0, warmup 2,
cosine decay over 3, lr 1e-3) on a tiny model (vocab 64, d 32, 4 heads,
2 KV heads, 2 layers, d_ff 64) at S 16 and global batch 8. The JAX side
is ``make_train_step`` on a virtual CPU mesh of the same shape
(``tests/conftest.py``'s 8 host devices), from the same seeded numpy
weights.

Bounds: losses relative error <= 1e-5 at every step; final params
relative L2 error <= 1e-5 per leaf (fp32 both sides; the partitioned sums
run in other orders). ZeRO-1 against the replicated optimizer on the
same world, and a one-rank mesh against the meshless step: bit-equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaslice_tpu.models import lm as jlm
from instaslice_tpu_torch.models import lm as tlm
from instaslice_tpu_torch.models import train as ttrain
from instaslice_tpu_torch.models.checkpoint import TrainCheckpointer
from torch_port_util import flat_np, jax_mesh_run, numpy_params, rel_l2

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
WORLD = 4
B, S = 8, 16
TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2,
            n_layers=2, d_ff=64, remat=False)
OPTS = dict(learning_rate=1e-3, grad_clip=1.0, warmup_steps=2,
            decay_steps=3)
REL = 1e-5

CASES = [
    # name, dp, tp, config overrides, step options, extras
    ("d2t1_chunk", 2, 1, {}, dict(loss_chunk=8), {}),
    ("d2t1_oneshot", 2, 1, {}, dict(loss_chunk=0), {}),
    ("d1t2_chunk", 1, 2, {}, dict(loss_chunk=8), dict(meshless=True)),
    ("d1t2_oneshot_dots", 1, 2, dict(remat=True, remat_policy="dots"),
     dict(loss_chunk=0), {}),
    ("d2t2_chunk", 2, 2, {}, dict(loss_chunk=8), {}),
    ("d2t2_oneshot", 2, 2, {}, dict(loss_chunk=0), {}),
    ("d2t2_accum", 2, 2, {}, dict(loss_chunk=8, grad_accum=2), {}),
    ("d2t2_zero1", 2, 2, {}, dict(loss_chunk=8, zero1=True), {}),
    ("gqa", 2, 2, dict(d_model=64, n_heads=8, n_kv_heads=2),
     dict(loss_chunk=8), {}),
    ("moe", 2, 1, dict(n_experts=4, expert_top_k=2),
     dict(loss_chunk=8, moe_aux_weight=0.01), {}),
    ("moe_per_rank_aux", 2, 1, dict(n_experts=4, expert_top_k=2),
     dict(loss_chunk=8, moe_aux_weight=0.01), dict(per_rank_aux=True)),
    ("ws1", 1, 1, {}, dict(loss_chunk=8), dict(meshless=True)),
    ("ckpt_out", 2, 2, {}, dict(loss_chunk=8, zero1=True),
     dict(ckpt="save")),
    ("ckpt_in", 2, 2, {}, dict(loss_chunk=8, zero1=True),
     dict(ckpt="restore")),
]
SPEC = {c[0]: c for c in CASES}


def _cfg(name):
    return dict(TINY, **SPEC[name][3])


def _np_params(name):
    return numpy_params(jlm.ModelConfig(**_cfg(name)), seed=3)


def _batches(name):
    rng = np.random.default_rng(11)
    return [rng.integers(1, _cfg(name)["vocab_size"], (B, S)).astype(
        np.int32) for _ in range(3)]


def _meshless_run(name, steps, ckpt_dir=None):
    """The port's meshless step over ``name``'s weights and batches
    (optionally restored from ``ckpt_dir`` first); (losses, params)."""
    cfg = tlm.ModelConfig(dtype=torch.float32, **_cfg(name))
    opts = {k: v for k, v in SPEC[name][4].items() if k != "zero1"}
    init_fn, step_fn = ttrain.make_train_step(
        tlm.TpuLM(cfg), device="cpu", **OPTS, **opts)
    state = init_fn(params=_tree(flat_np(_np_params(name))))
    if ckpt_dir is not None:
        assert TrainCheckpointer(ckpt_dir).restore(state) is not None
    losses = []
    for toks in _batches(name)[state.step:steps]:
        state, loss = step_fn(state, torch.from_numpy(toks))
        losses.append(float(loss))
    return state, losses


def _tree(flat):
    tree = {}
    for path, a in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = torch.from_numpy(np.array(a))
    return tree


class World:
    """The spawned gloo world: its ranks run in the background while the
    tests compute their JAX side; :meth:`result` waits for them once."""

    def __init__(self, out: Path):
        self.out = out
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(REPO), str(TESTS)]))
        self.logs = [open(out / f"rank{r}.log", "w") for r in range(WORLD)]
        self.procs = [subprocess.Popen(
            [sys.executable, str(TESTS / "torch_parallel_worker.py"),
             str(r), str(WORLD), str(out)], env=env, stdout=self.logs[r],
            stderr=subprocess.STDOUT) for r in range(WORLD)]
        self.joined = False

    def join(self) -> None:
        if self.joined:
            return
        try:
            for p in self.procs:
                p.wait(timeout=300)
        finally:
            self.close()
        tails = "\n".join((self.out / f"rank{r}.log").read_text()[-3000:]
                          for r in range(WORLD))
        assert all(p.returncode == 0 for p in self.procs), tails

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()
        self.joined = True

    def result(self, name: str, kind: str = "") -> dict:
        self.join()
        return torch.load(self.out / f"{name}{kind}.pt", weights_only=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the gloo world once; it runs every case."""
    out = tmp_path_factory.mktemp("gloo_world")
    # the one-process checkpoint ckpt_in restores: one meshless step
    state, _ = _meshless_run("ckpt_in", 1)
    TrainCheckpointer(out / "ckpt_in").save(state)
    cases = []
    for name, dp, tp, _, opts, extra in CASES:
        case = {"name": name, "dp": dp, "tp": tp, "cfg": _cfg(name),
                "opts": dict(OPTS, **opts),
                "params": {p: torch.from_numpy(a) for p, a in
                           flat_np(_np_params(name)).items()},
                "batches": [torch.from_numpy(t) for t in _batches(name)],
                "meshless": extra.get("meshless", False),
                "per_rank_aux": extra.get("per_rank_aux", False)}
        if "ckpt" in extra:
            case["ckpt"] = {"mode": extra["ckpt"], "at": 1,
                            "dir": str(out / name)}
        cases.append(case)
    torch.save(cases, out / "cases.pt")
    w = World(out)
    try:
        yield w
    finally:
        w.close()


def _jax_run(name, grads_at_start=False):
    """(losses, final params, grads at the initial weights) of the JAX
    mesh step over ``name``'s weights and batches."""
    _, dp, tp, _, opts, _ = SPEC[name]
    jcfg = jlm.ModelConfig(dtype=jnp.float32, attention_impl="xla",
                           **_cfg(name))
    return jax_mesh_run(jcfg, _np_params(name), _batches(name),
                        ("data", "seq", "model"), (dp, 1, tp),
                        dict(OPTS, **opts), grads_at_start)


def _assert_matches(res, losses, params):
    np.testing.assert_allclose(res["losses"], losses, rtol=REL)
    assert res["params"].keys() == params.keys()
    for path, want in params.items():
        err = rel_l2(res["params"][path].numpy(), want)
        assert err <= REL, (path, err)


@pytest.mark.parametrize("name", ["d2t1_chunk", "d2t1_oneshot",
                                  "d1t2_chunk", "d1t2_oneshot_dots",
                                  "d2t2_chunk", "d2t2_oneshot",
                                  "d2t2_accum", "gqa"])
def test_mesh_step_matches_jax(world, name):
    """3 steps at (dp, tp) against the JAX mesh step of the same shape:
    data parallelism, tensor parallelism (vocab-parallel embedding and
    loss, column/row-parallel blocks) and both, with the chunked and the
    one-shot loss, remat "dots" under tp (its recompute issues the
    block's collectives again), grad_accum 2 over the data rows, and GQA
    with 4 query heads per KV head split contiguously over tp 2."""
    losses, params, _ = _jax_run(name)
    _assert_matches(world.result(name), losses, params)


def test_zero1_is_bit_equal_and_shards_the_moments(world):
    """ZeRO-1 at (dp 2, tp 2): the same losses and params bit for bit as
    the replicated optimizer on the same world; every moment leaf the
    rule slices holds numel / dp of the rank's block, and at least the
    stacked leaves are sliced."""
    z, r = world.result("d2t2_zero1"), world.result("d2t2_chunk")
    assert z["losses"] == r["losses"]
    for path in r["params"]:
        assert torch.equal(z["params"][path], r["params"][path]), path
    sliced = 0
    for zdim, numel, mu, nu in z["moments"]:
        want = numel // 2 if zdim is not None else numel
        assert mu == nu == want
        sliced += zdim is not None
    assert sliced >= len(z["moments"]) - 1
    assert all(zdim is None for zdim, *_ in r["moments"])


def test_moe_load_balance_over_data_matches_jax(world):
    """The MoE at (dp 2, tp 1) with the load-balance term at 0.01: the
    losses and the router's gradient (data-averaged, before the clip)
    against the JAX mesh step, whose f_e and P_e are means over the whole
    batch. The control, each rank's term alone, misses the router bound
    by more than 10x."""
    losses, params, grads = _jax_run("moe", grads_at_start=True)
    res = world.result("moe")
    _assert_matches(res, losses, params)
    router = "blocks/router"
    err = rel_l2(res["grads0"][router].numpy(), grads[router])
    assert err <= REL, err
    ctl = world.result("moe_per_rank_aux")
    ctl_err = rel_l2(ctl["grads0"][router].numpy(), grads[router])
    assert ctl_err > 10 * REL, ctl_err


def test_clip_engages_and_its_norm_is_the_one_process_norm(world):
    """At tp 2 the clip's norm (model-sharded leaves summed over model,
    replicated ones once) is above the clip at step 1 and equals the
    meshless step's norm at the last step."""
    tp2 = world.result("d1t2_chunk")
    one = world.result("d1t2_chunk", ".meshless")
    assert tp2["norms"][0] > OPTS["grad_clip"]
    np.testing.assert_allclose(tp2["norms"][-1], one["norm"], rtol=REL)
    np.testing.assert_allclose(tp2["losses"], one["losses"], rtol=REL)


def test_one_rank_mesh_is_bit_equal_to_the_meshless_step(world):
    mesh, one = world.result("ws1"), world.result("ws1", ".meshless")
    assert mesh["losses"] == one["losses"]
    for path in one["params"]:
        assert torch.equal(mesh["params"][path], one["params"][path]), path


def test_checkpoints_cross_mesh_shapes(world):
    """A checkpoint written at (dp 2, tp 2) with ZeRO-1 after step 1
    resumes on one process, and a one-process checkpoint resumes at
    (dp 2, tp 2): both finish as the uninterrupted meshless run."""
    world.join()
    _, want = _meshless_run("ckpt_out", 3)
    state, got = _meshless_run("ckpt_out", 3, world.out / "ckpt_out")
    np.testing.assert_allclose(got, want[1:], rtol=REL)
    ref_state, _ = _meshless_run("ckpt_in", 3)
    res = world.result("ckpt_in")
    np.testing.assert_allclose(res["losses"], want[1:], rtol=REL)
    ref = ttrain.leaves(ref_state.params)
    for path, t in zip(ttrain.leaf_paths(ref_state.params), ref):
        assert rel_l2(res["params"][path].numpy(),
                       t.detach().numpy()) <= REL, path
        assert rel_l2(ttrain.leaves(state.params)[
            ttrain.leaf_paths(state.params).index(path)].detach().numpy(),
            t.detach().numpy()) <= REL, path
