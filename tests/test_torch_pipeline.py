"""GPipe over the ``pipe`` axis in the port (``parallel/pipeline.py``,
``TpuLM.apply_pipelined``, ``make_train_step(n_micro=)``) held against
the JAX package on the CPU (``tests/test_pipeline.py:46-146``).

One gloo world of eight processes (``torch_mesh_worker.py``) runs every
case; the JAX side runs meanwhile on ``tests/conftest.py``'s virtual CPU
devices:

- pipe 4 (one stage a rank, 4 layers: one each), 8 rows at n_micro 2, 4
  and 8: the output and the gradients of ``sum(out ** 2) / 1e4`` (the
  stages' layers gathered, the embedding and final norm whole on every
  stage) within 1e-5 relative L2 of the JAX package's unpipelined
  ``apply`` and its gradients, so the micro-batch count does not change
  the result; remat "dots" per stage likewise;
- the (pipe 2, data 2, model 2) train step at n_micro 2 (3 steps, AdamW,
  clip 1.0, warmup 2, cosine decay over 3, lr 1e-3): losses and final
  params within 1e-5 relative of the reference's pipelined mesh step,
  dense and with 4 experts over model (fp32 both sides);
- the control: stage ``s`` holding the layers of stage ``P - 1 - s``
  misses the loss bound by more than 10x.

The errors are the reference's: layers not divisible by the pipe axis,
a batch not divisible by ``n_micro``, ``n_micro`` without a pipe axis,
``grad_accum`` with ``n_micro``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from instaslice_tpu.models import lm as jlm
from instaslice_tpu_torch.models import lm as tlm
from instaslice_tpu_torch.models import train as ttrain
from instaslice_tpu_torch.parallel import meshenv as tmesh
from instaslice_tpu_torch.parallel.collectives import Axis, MeshAxes
from torch_port_util import (
    flat_np,
    jax_mesh_run,
    numpy_params,
    rel_l2,
    spawn_world,
    torch_flat,
)

REL = 1e-5
CONTROL = 10
#: the reference's test model (tests/test_pipeline.py:35-42)
CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4, d_ff=64,
           remat=False)
DOTS = dict(CFG, remat=True, remat_policy="dots")
FORWARD = {
    # name: (config, batch rows, n_micro)
    "m2": (CFG, 8, 2), "m4": (CFG, 8, 4), "m8": (CFG, 8, 8),
    "dots": (DOTS, 4, 2),
}
PDM = ("pipe", "data", "model")
OPTS = dict(learning_rate=1e-3, grad_clip=1.0, warmup_steps=2,
            decay_steps=3, n_micro=2)
#: name: (config, control)
TRAIN = {"pdm": (CFG, None), "pdm_reversed": (CFG, "reversed_stages"),
         "pdm_moe": (dict(CFG, n_experts=4), None)}


def _np_params(cfg):
    return numpy_params(jlm.ModelConfig(**cfg), seed=9)


def _tokens(rows):
    return np.random.default_rng(rows).integers(0, 64, (rows, 16)).astype(
        np.int32)


def _batches():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 64, (4, 16)).astype(np.int32) for _ in range(3)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipe")
    cases = [{"kind": "pipe", "name": name, "names": ("pipe",),
              "shape": (4,), "cfg": cfg, "n_micro": m,
              "params": torch_flat(flat_np(_np_params(cfg))),
              "tokens": torch.from_numpy(_tokens(rows))}
             for name, (cfg, rows, m) in FORWARD.items()]
    for name, (cfg, control) in TRAIN.items():
        cases.append({"kind": "train", "name": name, "names": PDM,
                      "shape": (2, 2, 2), "cfg": cfg, "opts": OPTS,
                      "params": torch_flat(flat_np(_np_params(cfg))),
                      "batches": [torch.from_numpy(b) for b in _batches()],
                      "control": control})
    w = spawn_world(out, cases, "torch_mesh_worker.py", 8)
    try:
        yield w
    finally:
        w.close()


def _jax_unpipelined(cfg, rows):
    jcfg = jlm.ModelConfig(dtype=jnp.float32, attention_impl="xla", **cfg)
    model = jlm.TpuLM(jcfg)
    params = jax.tree.map(jnp.asarray, _np_params(cfg))
    toks = jnp.asarray(_tokens(rows))
    out = model.apply(params, toks)
    grads = jax.grad(lambda p: jnp.sum(model.apply(p, toks) ** 2) / 1e4)(
        params)
    return np.asarray(out), flat_np(jax.device_get(grads))


@pytest.mark.parametrize("name", list(FORWARD))
def test_gpipe_matches_the_unpipelined_apply(world, name):
    """Pipe 4 at n_micro 2, 4, 8 (and remat "dots" per stage): every
    stage's output and the gradients within 1e-5 of the unpipelined
    forward and its gradients."""
    cfg, rows, _ = FORWARD[name]
    want_out, want_grads = _jax_unpipelined(cfg, rows)
    for r in range(4):
        res = world.result(name, r)
        assert rel_l2(res["out"].numpy(), want_out) <= REL, r
    res = world.result(name, 0)
    assert res["grads"].keys() == want_grads.keys()
    for path, want in want_grads.items():
        err = rel_l2(res["grads"][path].numpy(), want)
        assert err <= REL, (path, err)


@pytest.mark.parametrize("name", ["pdm", "pdm_moe"])
def test_pipe_data_model_train_step_matches_jax(world, name):
    """The (pipe 2, data 2, model 2) step at n_micro 2: losses and params
    within 1e-5 of the reference's pipelined mesh step (stacked layer
    weights sharded one stage per pipe rank on both sides); with 4
    experts too (2 a model rank), whose load-balance term is the mean of
    per-micro-batch terms, each over the data ranks' shares of the
    global micro-batch."""
    cfg = TRAIN[name][0]
    jcfg = jlm.ModelConfig(dtype=jnp.float32, attention_impl="xla", **cfg)
    losses, params, _ = jax_mesh_run(jcfg, _np_params(cfg), _batches(), PDM,
                                     (2, 2, 2), OPTS)
    res = world.result(name, 0)
    np.testing.assert_allclose(res["losses"], losses, rtol=REL)
    for path, want in params.items():
        err = rel_l2(res["params"][path].numpy(), want)
        assert err <= REL, (path, err)
    for r in range(1, 8):
        assert world.result(name, r)["losses"] == res["losses"]


def test_reversed_stage_order_misses_the_bound(world):
    """The control: stage ``s`` running the layers of stage ``P - 1 - s``
    moves the losses far outside 1e-5 of the unreversed run."""
    want = world.result("pdm", 0)["losses"]
    ctl = world.result("pdm_reversed", 0)["losses"]
    err = max(abs(a - b) / abs(b) for a, b in zip(ctl, want))
    assert err > CONTROL * REL, err


def test_gpipe_errors_are_the_reference_errors(tmp_path, monkeypatch):
    """Layers not divisible by the pipe axis; a batch not divisible by
    n_micro; n_micro without a pipe axis; grad_accum with n_micro."""
    cfg = tlm.ModelConfig(dtype=torch.float32, **CFG)
    params = tlm.init_params(cfg, 0, device="cpu")
    toks = torch.zeros((4, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="divisible"):
        tlm.apply_pipelined(cfg, params, toks, n_micro=2,
                            axes=MeshAxes(pipe=Axis(size=3)))
    stage = dict(params, blocks={k: (v[:2] if not isinstance(v, dict) else
                                     {"scale": v["scale"][:2]})
                                 for k, v in params["blocks"].items()})
    with pytest.raises(ValueError, match="n_micro"):
        tlm.apply_pipelined(cfg, stage, torch.zeros((5, 8), dtype=torch.long),
                            n_micro=4, axes=MeshAxes(pipe=Axis(size=2)))
    model = tlm.TpuLM(cfg)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    tmesh.initialize_distributed(init_method=f"file://{tmp_path / 's'}",
                                 device="cpu")
    try:
        flat = DeviceMesh("cpu", torch.arange(1).reshape(1, 1, 1),
                          mesh_dim_names=("data", "seq", "model"))
        with pytest.raises(ValueError, match="pipe"):
            ttrain.make_train_step(model, device="cpu", mesh=flat, n_micro=2)
        pipe = DeviceMesh("cpu", torch.arange(1).reshape(1, 1, 1),
                          mesh_dim_names=PDM)
        with pytest.raises(ValueError, match="grad_accum"):
            ttrain.make_train_step(model, device="cpu", mesh=pipe,
                                   n_micro=2, grad_accum=2)
        # a pipe axis of one rank runs the whole stack: the unpipelined
        # forward, micro-batched
        p = {k: v for k, v in params.items()}
        got = model.apply_pipelined(p, _t(_tokens(8)), mesh=pipe, n_micro=4)
        want = model.apply(p, _t(_tokens(8)))
        assert rel_l2(got.detach().numpy(), want.detach().numpy()) <= REL
    finally:
        dist.destroy_process_group()


def _t(a):
    return torch.from_numpy(a)


def test_param_specs_with_a_pipe_axis_match_the_reference():
    jcfg = jlm.ModelConfig(**CFG)
    tcfg = tlm.ModelConfig(**CFG)
    want = jax.tree.map(tuple, jlm.param_specs(jcfg, pipe_axis="pipe"),
                        is_leaf=lambda x: isinstance(x,
                                                     jax.sharding.PartitionSpec))
    assert tlm.param_specs(tcfg, pipe_axis="pipe") == want
    assert dataclasses.replace(tcfg, n_experts=4) and tlm.param_specs(
        dataclasses.replace(tcfg, n_experts=4), "pipe")["blocks"]["w_in"] \
        == ("pipe", "model", None, None)
