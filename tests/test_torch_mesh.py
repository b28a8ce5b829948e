"""The port's mesh layer held against the JAX package's, in one process:
the handoff-env topology and the axis factoring (copies of the
reference's), ``slice_mesh`` and ``initialize_distributed`` on a world of
one, the parameter and batch layouts (``param_specs``/``batch_spec``),
and the ZeRO-1 rule's choice of dim per leaf against ``state_shardings``
on the virtual CPU mesh of ``tests/conftest.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from instaslice_tpu.models import lm as jlm
from instaslice_tpu.models import train as jtrain
from instaslice_tpu.parallel import meshenv as jmesh
from instaslice_tpu_torch.models import lm as tlm
from instaslice_tpu_torch.models import train as ttrain
from instaslice_tpu_torch.parallel import collectives as coll
from instaslice_tpu_torch.parallel import meshenv as tmesh

ENVS = [
    {},
    {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "a,b",
     "TPU_CHIPS_PER_HOST_BOUNDS": "2,2,1", "TPU_HOST_BOUNDS": "1,2,1",
     "TPU_SLICE_PROFILE": "v5e-8"},
    {"TPU_CHIPS_PER_HOST_BOUNDS": "2,2", "TPU_HOST_BOUNDS": "2,1,1"},
    {"TPU_CHIPS_PER_HOST_BOUNDS": "4", "TPU_WORKER_HOSTNAMES": "h0"},
]


@pytest.mark.parametrize("env", ENVS)
def test_topology_from_env_matches_the_reference(env):
    got, want = tmesh.SliceTopology.from_env(env), \
        jmesh.SliceTopology.from_env(env)
    for field in ("worker_id", "num_workers", "chips_per_host",
                  "host_bounds", "hostnames", "profile", "slice_shape",
                  "num_chips", "chips_per_worker"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("n,want", [
    (8, (-1, 1, 2)), (8, (2, -1, 2)), (8, (2, 2, 2)), (4, (-1, -1, 1)),
    (1, (-1, 1, 1)), (6, (-1, 1, 4)), (8, (2, 2, 1)), (8, (3, -1, 1)),
])
def test_factor_matches_the_reference(n, want):
    try:
        expect = jmesh._factor(n, want)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split("(")[0][:20]):
            tmesh._factor(n, want)
        return
    assert tmesh._factor(n, want) == expect


@pytest.fixture
def one_rank_world(tmp_path, monkeypatch):
    """A gloo process group of one rank in this process, torn down after."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.initialize_distributed(
        backend=None, init_method=f"file://{tmp_path / 'store'}",
        device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_slice_mesh_on_a_world_of_one(one_rank_world):
    assert dist.get_backend() == "gloo"       # the CPU's default
    assert not tmesh.initialize_distributed(device="cpu")   # already up
    mesh = tmesh.slice_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "seq", "model")
    assert tuple(mesh.shape) == (1, 1, 1)
    assert coll.mesh_axes(mesh) == coll.NO_MESH
    assert tuple(tmesh.slice_mesh(axis_sizes=(1, -1, 1),
                                  device="cpu").shape) == (1, 1, 1)
    with pytest.raises(ValueError):
        tmesh.slice_mesh(axis_sizes=(2, 1, 1), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            tmesh.slice_mesh()


def test_slice_mesh_needs_a_process_group():
    if dist.is_initialized():
        pytest.skip("a process group is up in this process")
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tmesh.slice_mesh(device="cpu")


def test_unported_parallel_names_and_bad_meshes_raise():
    """GPipe and ring attention are exported by the parallel package;
    what the reference refuses still raises: a mesh that is not a torch
    ``DeviceMesh``, a model axis that does not divide the experts or the
    heads. A seq axis and MoE experts over model are accepted."""
    import instaslice_tpu_torch.parallel as par
    from instaslice_tpu_torch.parallel import pipeline, ring

    assert par.pipeline_blocks is pipeline.pipeline_blocks
    assert par.ring_attention is ring.ring_attention
    with pytest.raises(TypeError, match="DeviceMesh"):
        coll.mesh_axes(object())
    tp2 = coll.MeshAxes(model=coll.Axis(size=2))
    tlm.check_mesh(tlm.ModelConfig(n_experts=4), tp2)
    tlm.check_mesh(tlm.ModelConfig(), coll.MeshAxes(seq=coll.Axis(size=2)))
    with pytest.raises(ValueError, match="n_experts"):
        tlm.check_mesh(tlm.ModelConfig(n_experts=3), tp2)
    with pytest.raises(ValueError, match="n_heads"):
        tlm.check_mesh(tlm.ModelConfig(n_heads=6, d_model=384),
                       coll.MeshAxes(model=coll.Axis(size=4)))


def test_collectives_on_an_axis_of_one_issue_nothing():
    x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    ax = coll.NO_AXIS
    for op in (coll.copy_to, coll.reduce_from, coll.mean_over):
        assert op(x, ax) is x
    assert coll.gather_from(x, ax) is x
    assert coll.all_reduce_(x, ax) is x
    assert coll.all_gather(x, ax, 1) is x and coll.shard(x, ax, 0) is x
    full = torch.arange(24.0).reshape(2, 4, 3)
    half = coll.Axis(size=2, rank=1)
    assert torch.equal(coll.shard_leaf(full, (None, "model", None),
                                       coll.MeshAxes(model=half)),
                       full[:, 2:])
    with pytest.raises(ValueError, match="divide"):
        coll.shard(full, coll.Axis(size=5), 1)


CFGS = {
    "dense": dict(),
    "gqa": dict(n_kv_heads=2),
    "moe": dict(n_experts=4),
}


def _jcfg(kind):
    return jlm.ModelConfig(vocab_size=64, d_model=32, n_heads=4,
                           n_layers=2, d_ff=64, **CFGS[kind])


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_param_specs_match_the_reference(kind):
    """Every leaf of ``init_params`` has a spec of its rank, and the spec
    tree is the reference's entry by entry."""
    jcfg = _jcfg(kind)
    tcfg = tlm.ModelConfig(vocab_size=64, d_model=32, n_heads=4,
                           n_layers=2, d_ff=64, **CFGS[kind])
    specs = tlm.param_specs(tcfg)
    params = tlm.init_params(tcfg, 0, device="cpu")
    for path, t in zip(ttrain.leaf_paths(params), ttrain.leaves(params)):
        assert len(ttrain.spec_at(specs, path)) == t.dim(), path
    want = jax.tree_util.tree_flatten_with_path(
        jlm.param_specs(jcfg),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert len(want) == len(ttrain.leaves(params))
    for kp, spec in want:
        path = "/".join(k.key for k in kp)
        assert ttrain.spec_at(specs, path) == tuple(spec), path
    assert tlm.batch_spec(tcfg) == tuple(jlm.batch_spec(jcfg))


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("kind", sorted(CFGS))
def test_zero1_rule_matches_the_reference_moment_spec(kind, dp):
    """``zero1_dim`` names, for each leaf, the dim the reference's
    ``state_shardings(zero1=True)`` puts "data" on for its Adam moments
    (None where it leaves them replicated), at tp 2."""
    jcfg = _jcfg(kind)
    mesh = Mesh(np.array(jax.devices()[:2 * dp]).reshape(dp, 1, 2),
                ("data", "seq", "model"))
    params = jax.eval_shape(lambda: jlm.init_params(jax.random.key(0),
                                                    jcfg))
    tx = jtrain.make_optimizer(1e-3)
    opt = jax.eval_shape(tx.init, params)
    sh = jtrain.state_shardings(mesh, jcfg, opt, zero1=True)
    mu = sh.opt_state[0].mu
    specs = tlm.param_specs(tlm.ModelConfig(
        vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
        **CFGS[kind]))
    shapes = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    checked = 0
    for kp, ns in jax.tree_util.tree_flatten_with_path(mu)[0]:
        path = "/".join(k.key for k in kp)
        spec = tuple(ns.spec)
        want = spec.index("data") if "data" in spec else None
        shape = shapes[kp].shape
        assert ttrain.zero1_dim(ttrain.spec_at(specs, path), shape,
                                dp) == want, (path, spec)
        checked += 1
    assert checked == len(ttrain.leaves(tlm.init_params(
        tlm.ModelConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                        d_ff=64, **CFGS[kind]), 0, device="cpu")))
    assert ttrain.zero1_dim((None, "model"), (4, 8), 1) is None


def test_initialize_distributed_reads_torchrun_env(monkeypatch, tmp_path):
    """RANK/WORLD_SIZE win over the topology; gloo is the CPU default."""
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert tmesh.initialize_distributed(device="cpu")
    assert calls[-1] == dict(backend="gloo", init_method="env://", rank=3,
                             world_size=4)
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var)
    topo = tmesh.SliceTopology.from_env(ENVS[1])
    tmesh.initialize_distributed(topo, device="cpu", backend="gloo",
                                 init_method="tcp://localhost:1")
    assert calls[-1]["rank"] == 1 and calls[-1]["world_size"] == 2
    assert os.environ.get("RANK") is None


@pytest.mark.parametrize("dp,accum", [(1, 1), (2, 1), (4, 1), (2, 2)])
def test_host_sharded_rows_union_is_the_one_process_batch(tmp_path, dp,
                                                          accum):
    """Each data rank reads only its rows (``data_rows``); over the ranks
    they are the step's global batch, which is the reference dataset's
    (``instaslice_tpu/models/data.py``) on the same file. With micro-
    batches each rank owns its block of every micro-batch."""
    from instaslice_tpu.models import data as jdata
    from instaslice_tpu_torch.models import data as tdata

    path = str(tmp_path / "toks.u16")
    tdata.write_token_file(path, np.arange(1, 8 * 17 * 3 + 5) % 60000)
    ds, ref = tdata.TokenDataset(path, 16, seed=2), jdata.TokenDataset(
        path, 16, seed=2)
    for step in (0, 1, 5):
        want = ref.batch(step, 8)
        parts = {}
        for r in range(dp):
            loader = tdata.HostShardedTokens(ds, 8, dp, r, accum)
            rows = tdata.data_rows(8, dp, r, accum)
            got = loader.local_batch(step)
            assert got.shape == (8 // dp, 17)
            np.testing.assert_array_equal(got, want[rows])
            parts.update(zip(rows, got))
        assert sorted(parts) == list(range(8))
        if accum == 2:
            # rank r's micro-batch j is its block of global micro-batch j
            assert tdata.data_rows(8, 2, 1, 2) == [2, 3, 6, 7]
    with pytest.raises(ValueError, match="divide"):
        tdata.data_rows(6, 4, 0)
