"""The port's training path held against the JAX package's on the CPU:
``TpuLM.apply``, ``loss_fn`` and its grads, three train steps, the token
dataset, checkpoint resume, the CLI and the two ``ModelConfig`` checks.

One seeded numpy weight tree goes to both packages (fp32). The JAX side
runs its flash-attention Pallas kernels in interpret mode where a test
asks for ``attention_impl="flash"``; the port's "auto" takes its flash
wrappers, whose plain versions run on CPU tensors.

Tolerances (fp32 both sides, the same products summed in another
order): logits 1e-4 relative to their scale; the loss 1e-5; grads 1e-4
relative to each leaf's largest element; params after three AdamW steps
(lr 1e-3, the first at lr 0 under warmup) 4e-6 relative to each leaf's
largest element, 10x the measured gap (a few fp32 ulps: 1.8e-6 on
embedding values of 4.4).
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

from instaslice_tpu.models import data as jdata
from instaslice_tpu.models import lm as jlm
from instaslice_tpu.models import train as jtrain
from instaslice_tpu_torch import bridge
from instaslice_tpu_torch.models import data as tdata
from instaslice_tpu_torch.models import lm as tlm
from instaslice_tpu_torch.models import train as ttrain
from instaslice_tpu_torch.models.checkpoint import TrainCheckpointer
from torch_port_util import both_params, configs, numpy_params, to_np

train_main = importlib.import_module("instaslice_tpu_torch.cli.train_main")


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(1, vocab, shape).astype(
        np.int32)


def _flat(tree, prefix=""):
    """{path: float32 numpy} for a JAX or port params tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: to_np(tree)}


def _assert_trees_close(got, want, rel):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for path in w:
        tol = rel * max(float(np.abs(w[path]).max()), 1e-6)
        err = float(np.abs(g[path] - w[path]).max())
        assert err <= tol, (path, err, tol)


# ------------------------------------------------------- ModelConfig checks

@pytest.mark.parametrize("kw", [dict(window=8, ring_attention=True),
                                dict(window=8, attention_impl="flash")])
def test_config_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        jlm.ModelConfig(**kw)
    with pytest.raises(ValueError):
        tlm.ModelConfig(**kw)


# ------------------------------------------------------------------- apply

@pytest.mark.parametrize("impl,n_kv_heads,remat", [
    ("flash", 0, False), ("flash", 2, False), ("flash", 2, True),
    ("xla", 0, False), ("xla", 2, False),
])
def test_apply_matches_jax(impl, n_kv_heads, remat):
    """Logits of the full forward, MHA and GQA, the flash path (B5's
    plain version against the Pallas kernel) and the plain grouped
    path, with and without block remat."""
    jcfg, tcfg = configs("fp32", n_kv_heads=n_kv_heads, attention_impl=impl,
                         remat=remat)
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 3), quantize=False)
    toks = _tokens((2, 64), jcfg.vocab_size, 4)
    want = jlm.TpuLM(jcfg).apply(jtree, jnp.asarray(toks))
    got = tlm.TpuLM(tcfg).apply(ttree, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 64, 256)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_apply_hidden_states_and_window():
    """``unembed=False`` returns the final hidden states; a windowed
    model takes the plain grouped path on both sides."""
    jcfg, tcfg = configs("fp32", window=16)
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 5), quantize=False)
    toks = _tokens((2, 48), jcfg.vocab_size, 6)
    want = jlm.TpuLM(jcfg).apply(jtree, jnp.asarray(toks), unembed=False)
    got = tlm.TpuLM(tcfg).apply(ttree, torch.from_numpy(toks), unembed=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_apply_refuses_what_is_not_ported():
    """What the reference refuses: ring attention with a window (at
    construction) and inside a pipeline stage; a mesh that is not a torch
    ``DeviceMesh``."""
    toks = torch.zeros((1, 4), dtype=torch.long)
    _, tcfg = configs("fp32")
    with pytest.raises(ValueError, match="ring"):
        dataclasses.replace(tcfg, ring_attention=True, window=4)
    with pytest.raises(TypeError, match="mesh"):
        tlm.TpuLM(tcfg).apply({}, toks, mesh=object())
    with pytest.raises(ValueError, match="pipeline stage"):
        tlm.TpuLM(dataclasses.replace(tcfg, ring_attention=True)
                  ).apply_pipelined({}, toks, mesh=None, n_micro=2)


@pytest.mark.parametrize("kw", [dict(zero1=True, n_micro=2),
                                dict(n_micro=2), dict(mesh=object())])
def test_train_step_refuses_what_is_not_ported(kw):
    """``n_micro`` without a mesh carrying the pipe axis is refused with
    the reference's message; a mesh must be a torch ``DeviceMesh`` (the
    parallel step's own tests are ``tests/test_torch_parallel_*.py`` and
    ``tests/test_torch_pipeline.py``)."""
    _, tcfg = configs("fp32")
    with pytest.raises(TypeError if "mesh" in kw else ValueError,
                       match="DeviceMesh" if "mesh" in kw else "pipe"):
        ttrain.make_train_step(tlm.TpuLM(tcfg), device="cpu", **kw)


# ------------------------------------------------------------ loss and grads

@pytest.mark.parametrize("loss_chunk", [0, 8])
def test_loss_and_grads_match_jax(loss_chunk):
    """``loss_fn`` (one-shot, and chunked with a padded last chunk: S 33
    in chunks of 8) and its grads against ``jax.value_and_grad``. The
    port takes its flash path ("auto"), the JAX side its plain one."""
    jcfg, tcfg = configs("fp32", attention_impl="xla")
    tcfg = dataclasses.replace(tcfg, attention_impl="auto")
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 7), quantize=False)
    toks = _tokens((2, 33), jcfg.vocab_size, 8)
    jm = jlm.TpuLM(jcfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jtrain.loss_fn(jm, p, jnp.asarray(toks),
                                 loss_chunk=loss_chunk))(jtree)
    for t in ttrain.leaves(ttree):
        t.requires_grad_(True)
    loss = ttrain.loss_fn(tlm.TpuLM(tcfg), ttree, torch.from_numpy(toks),
                          loss_chunk=loss_chunk)
    grads = torch.autograd.grad(loss, ttrain.leaves(ttree))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    it = iter(grads)
    gtree = jax.tree.map(lambda _: next(it), ttree,
                         is_leaf=lambda x: isinstance(x, torch.Tensor))
    _assert_trees_close(gtree, jax.device_get(jgrads), rel=1e-4)


# ----------------------------------------------------------- train steps

def test_three_train_steps_match_jax():
    """3 steps with clip, warmup-cosine and grad_accum=2 against the JAX
    ``make_train_step`` on a one-device CPU mesh: losses, and params
    after every step."""
    jcfg, tcfg = configs("fp32", n_kv_heads=2, attention_impl="xla")
    tcfg = dataclasses.replace(tcfg, attention_impl="auto")
    opts = dict(learning_rate=1e-3, grad_accum=2, grad_clip=0.5,
                warmup_steps=2, decay_steps=3)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("data", "seq", "model"))
    jinit, jstep = jtrain.make_train_step(jlm.TpuLM(jcfg), mesh, **opts)
    jstate = jinit(jax.random.key(0))
    params0 = jax.device_get(jstate.params)
    tinit, tstep = ttrain.make_train_step(tlm.TpuLM(tcfg), device="cpu",
                                          **opts)
    tstate = tinit(params=bridge.params_from_jax(params0, device="cpu"))
    for step in range(3):
        toks = _tokens((4, 17), jcfg.vocab_size, 20 + step)
        jstate, jl = jstep(jstate, jnp.asarray(toks))
        tstate, tl = tstep(tstate, torch.from_numpy(toks))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        _assert_trees_close(tstate.params, jax.device_get(jstate.params),
                            rel=4e-6)
    assert tstate.step == 3


def test_optimizer_matches_optax_schedule_and_clip():
    """The warmup-cosine rates (optax's count: 0 at the first update) and
    the clip rule, alone."""
    import optax

    sched = optax.warmup_cosine_decay_schedule(0.0, 2e-3, 3, 10, 2e-4)
    lr = ttrain.warmup_cosine(2e-3, 3, 10)
    for c in range(14):
        assert abs(lr(c) - float(sched(c))) <= 1e-9
    g = [torch.full((3,), 3.0), torch.full((4,), -4.0)]
    for max_norm in (100.0, 2.0):
        ps = [torch.zeros_like(t, requires_grad=True) for t in g]
        for p, t in zip(ps, g):
            p.grad = t.clone()
        opt = ttrain.Optimizer(ps, 1e-3, grad_clip=max_norm)
        opt.clip_()
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(t.numpy()) for t in g], None)
        for p, w in zip(ps, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                       rtol=1e-6)


# ------------------------------------------------------------------- data

def test_token_dataset_rows_equal_the_jax_packages(tmp_path):
    path = str(tmp_path / "toks.u16")
    tdata.write_token_file(path, _tokens((5000,), 1000, 1))
    jd = jdata.TokenDataset(path, 31, seed=3)
    td = tdata.TokenDataset(path, 31, seed=3)
    for step in (0, 1, 7, 40):      # 40 wraps into the second epoch
        np.testing.assert_array_equal(td.batch(step, 4), jd.batch(step, 4))
    b = tdata.batch_for_step(td, 7, 4, "cpu")
    assert b.shape == (4, 32) and b.dtype == torch.int32
    np.testing.assert_array_equal(b.numpy(), jd.batch(7, 4))


# ------------------------------------------------------------- checkpoint

def test_checkpoint_resume_is_bit_identical(tmp_path):
    """2 steps, save, restore into a fresh state, 2 more steps == 4
    uninterrupted steps, bit for bit (params and optimizer moments)."""
    cfg = tlm.ModelConfig(vocab_size=64, d_model=64, n_heads=2,
                          n_layers=2, d_ff=128, dtype=torch.float32,
                          remat=False)
    path = str(tmp_path / "toks.u16")
    tdata.write_token_file(path, _tokens((4000,), 64, 2))
    ds = tdata.TokenDataset(path, 15, seed=1)
    opts = dict(learning_rate=1e-3, grad_clip=1.0, warmup_steps=2,
                decay_steps=4, device="cpu")

    def run(state, step_fn, start, stop):
        for s in range(start, stop):
            state, _ = step_fn(state, tdata.batch_for_step(ds, s, 4, "cpu"))
        return state

    init_fn, step_fn = ttrain.make_train_step(tlm.TpuLM(cfg), **opts)
    straight = run(init_fn(5), step_fn, 0, 4)
    with TrainCheckpointer(str(tmp_path / "ck"), max_to_keep=2) as ck:
        first = run(init_fn(5), step_fn, 0, 2)
        assert ck.save(first) and not ck.save(first)
        assert ck.latest_step() == 2
        init_b, step_b = ttrain.make_train_step(tlm.TpuLM(cfg), **opts)
        resumed = ck.restore(init_b(99))
    assert resumed.step == 2
    resumed = run(resumed, step_b, 2, 4)
    for a, b in zip(ttrain.leaves(straight.params),
                    ttrain.leaves(resumed.params)):
        assert torch.equal(a, b)
    sa = straight.opt_state.adamw.state
    sb = resumed.opt_state.adamw.state
    for pa, pb in zip(ttrain.leaves(straight.params),
                      ttrain.leaves(resumed.params)):
        assert torch.equal(sa[pa]["exp_avg_sq"], sb[pb]["exp_avg_sq"])


def test_checkpointer_keeps_the_newest(tmp_path):
    cfg = tlm.ModelConfig(vocab_size=32, d_model=32, n_heads=2,
                          n_layers=1, d_ff=64, dtype=torch.float32)
    init_fn, _ = ttrain.make_train_step(tlm.TpuLM(cfg), device="cpu")
    state = init_fn(0)
    ck = TrainCheckpointer(str(tmp_path), max_to_keep=2,
                           save_interval_steps=2)
    saved = []
    for s in range(1, 7):
        state.step = s
        saved.append(ck.save(state))
    assert saved == [False, True, False, True, False, True]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000004.pt", "step_000000006.pt"]
    assert TrainCheckpointer(str(tmp_path / "empty")).restore(state) is None


# -------------------------------------------------------------------- CLI

_TINY = ["--device", "cpu", "--d-model", "64", "--n-heads", "2",
         "--n-layers", "2", "--d-ff", "128", "--vocab-size", "128",
         "--global-batch", "2", "--seq-len", "31"]


def test_cli_trains_and_resumes_on_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = _TINY + ["--synthetic", "4000", "--steps", "3",
                    "--checkpoint", ck, "--warmup-steps", "1"]
    assert train_main.main(args) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 3 and line["backend"] == "cpu"
    assert np.isfinite(line["final_loss"]) and line["value"] > 0
    assert line["params_m"] == 0.1
    assert TrainCheckpointer(ck).latest_step() == 3
    assert train_main.main(args[:-6] + ["--steps", "4", "--checkpoint",
                                         ck]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 4
