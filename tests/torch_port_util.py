"""Shared set-up for the tests that hold the PyTorch port
(``instaslice_tpu_torch``) against the JAX package: one seeded numpy
weight tree, handed to both packages (the JAX side quantizes it, the
bridge carries the exact int8 weights across).

Widths are multiples of 128 so the JAX side takes its Pallas kernels
(interpret mode on the CPU) rather than its tiling fallbacks.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from instaslice_tpu.models.lm import ModelConfig as JaxConfig
from instaslice_tpu.models.quant import quantize_params as jax_quantize
from instaslice_tpu_torch import bridge
from instaslice_tpu_torch.models.lm import ModelConfig as TorchConfig
from instaslice_tpu_torch.models.quant import Int4Tensor, QuantizedTensor

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
#: ranks of the worlds ``torch_serve_tp_worker.py`` runs
WORLD = 2

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

SMALL = dict(vocab_size=256, d_model=256, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=512)


def configs(dtype: str = "fp32", **overrides):
    """(JAX config, port config) of the same small model."""
    kw = dict(SMALL, remat=False)
    kw.update(overrides)
    jdt, tdt = DTYPES[dtype]
    return JaxConfig(dtype=jdt, **kw), TorchConfig(dtype=tdt, **kw)


def numpy_params(cfg, seed: int = 0, embed_scale: float = 0.1) -> dict:
    """Seeded fp32 weights in the shared layout; with ``cfg.n_experts``
    the router (L, D, E) and the expert stacks (L, E, D, F) and
    (L, E, F, D). The small embedding scale keeps greedy chains from
    collapsing onto the input token."""
    rng = np.random.default_rng(seed)
    L, D, Fd, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    E = cfg.n_experts

    def dense(*shape):
        return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(
            np.float32)

    embed = (rng.standard_normal((V, D)) * embed_scale).astype(np.float32)
    blocks = {
        "ln1": {"scale": (1 + 0.1 * rng.standard_normal((L, D))).astype(
            np.float32)},
        "ln2": {"scale": (1 + 0.1 * rng.standard_normal((L, D))).astype(
            np.float32)},
        "wq": dense(L, D, qd), "wk": dense(L, D, kvd),
        "wv": dense(L, D, kvd), "wo": dense(L, qd, D),
    }
    if E:
        blocks.update(router=dense(L, D, E), w_in=dense(L, E, D, Fd),
                      w_out=dense(L, E, Fd, D))
    else:
        blocks.update(w_in=dense(L, D, Fd), w_out=dense(L, Fd, D))
    return {
        "embed": embed,
        "blocks": blocks,
        "ln_f": {"scale": np.ones((D,), np.float32)},
    }


def both_params(jcfg, np_tree: dict, quantize: bool):
    """(JAX tree, port tree) holding bit-identical weights: matmul
    weights cast to the model dtype (norm scales and the MoE router stay
    fp32, as ``init_params`` stores them), optionally int8-quantized by
    the JAX package and bridged."""
    def cast(path, a):
        keep = any(getattr(p, "key", None) in ("ln1", "ln2", "ln_f",
                                                 "router")
                   for p in path)
        return jnp.asarray(a, jnp.float32 if keep else jcfg.dtype)

    jtree = jax.tree_util.tree_map_with_path(cast, np_tree)
    if quantize:
        jtree = jax_quantize(jtree)
    return jtree, bridge.params_from_jax(jax.device_get(jtree), device="cpu")


def to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def moe_drops(x, router, k, cf):
    """(token, choice) pairs past their expert's capacity, counted on the
    host from the same routing (numpy, independent of both packages)."""
    B, S, _ = x.shape
    E = router.shape[1]
    C = max(1, int(np.ceil(cf * k * S / E)))
    logits = x.astype(np.float64) @ router
    top = np.argsort(-logits, axis=-1, kind="stable")[..., :k]
    drops = 0
    for b in range(B):
        seen = np.zeros(E, int)
        for e in top[b].reshape(-1):
            drops += seen[e] >= C
            seen[e] += 1
    return drops


def encode_tree(tree, prefix=""):
    """A port tree as flat {path: tagged leaf} for torch.save."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(encode_tree(v, path + "/"))
        elif isinstance(v, QuantizedTensor):
            out[path] = ("q8", v.q, v.s)
        elif isinstance(v, Int4Tensor):
            out[path] = ("q4", v.p, v.s, v.group, v.pack_axis)
        else:
            out[path] = ("t", v)
    return out


class World:
    """A spawned gloo world of ``worker`` (two ranks of
    ``torch_serve_tp_worker.py`` by default): its ranks run in the
    background while the tests compute their JAX side; :meth:`result`
    waits for them once."""

    def __init__(self, out: Path, worker: str = "torch_serve_tp_worker.py",
                 world: int = WORLD):
        self.out = out
        self.world = world
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(REPO), str(TESTS)]))
        self.logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, str(TESTS / worker), str(r), str(world),
             str(out)], env=env, stdout=self.logs[r],
            stderr=subprocess.STDOUT) for r in range(world)]
        self.joined = False

    def join(self) -> None:
        if self.joined:
            return
        try:
            for p in self.procs:
                p.wait(timeout=240)
        finally:
            self.close()
        tails = "\n".join((self.out / f"rank{r}.log").read_text()[-3000:]
                          for r in range(self.world))
        assert all(p.returncode == 0 for p in self.procs), tails

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()
        self.joined = True

    def result(self, name: str, rank: int = 0) -> dict:
        self.join()
        return torch.load(self.out / f"{name}.rank{rank}.pt",
                          weights_only=True)


def spawn_world(out: Path, cases: list,
                worker: str = "torch_serve_tp_worker.py",
                world: int = WORLD) -> World:
    """Write ``cases`` for the worker and start its world."""
    torch.save(cases, out / "cases.pt")
    return World(out, worker, world)


def flat_np(tree, prefix: str = "") -> dict:
    """A numpy (or JAX) tree as flat {path: fp32 array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_np(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                 1e-30))


def jax_mesh_run(jcfg, np_params, batches, names, shape, opts,
                 grads_at_start=False):
    """(losses, final params flat, grads at the initial weights or None)
    of the JAX package's ``make_train_step`` over a virtual CPU mesh of
    ``shape`` with axis ``names``, from ``np_params`` (the state laid out
    as its ``init_fn`` lays it, without compiling ``init_fn``)."""
    from jax.sharding import Mesh

    from instaslice_tpu.models import lm as jlm
    from instaslice_tpu.models import train as jtrain

    jax.clear_caches()
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(names))
    model = jlm.TpuLM(jcfg)
    step_opts = {k: v for k, v in opts.items()
                 if k not in ("grad_clip", "warmup_steps", "decay_steps",
                              "learning_rate")}
    sched = dict(learning_rate=opts.get("learning_rate", 3e-4),
                 grad_clip=opts.get("grad_clip", 0.0),
                 warmup_steps=opts.get("warmup_steps", 0),
                 decay_steps=opts.get("decay_steps", 0))
    _, jstep = jtrain.make_train_step(model, mesh, **sched, **step_opts)
    params = jax.tree.map(jnp.asarray, np_params)
    tx = jtrain.make_optimizer(sched["learning_rate"], sched["grad_clip"],
                               sched["warmup_steps"], sched["decay_steps"])
    state = jtrain.TrainState(jnp.zeros((), jnp.int32), params,
                              tx.init(params))
    n_micro = opts.get("n_micro", 0)
    state = jax.device_put(state, jtrain.state_shardings(
        mesh, jcfg, state.opt_state,
        pipe_axis="pipe" if n_micro else "",
        zero1=opts.get("zero1", False)))
    grads = None
    if grads_at_start:
        keep = {k: v for k, v in opts.items()
                if k in ("loss_chunk", "moe_aux_weight", "n_micro")}
        grads = flat_np(jax.device_get(jax.grad(
            lambda p: jtrain.loss_fn(model, p, jnp.asarray(batches[0]),
                                     mesh, **keep))(state.params)))
    losses = []
    for toks in batches:
        state, loss = jstep(state, jnp.asarray(toks))
        losses.append(float(loss))
    return losses, flat_np(jax.device_get(state.params)), grads


def torch_flat(flat: dict) -> dict:
    """{path: numpy array} -> the worker's {path: ("t", tensor)}."""
    return {p: ("t", torch.from_numpy(np.array(a))) for p, a in flat.items()}
