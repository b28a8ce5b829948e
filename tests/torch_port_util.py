"""Shared set-up for the tests that hold the PyTorch port
(``instaslice_tpu_torch``) against the JAX package: one seeded numpy
weight tree, handed to both packages (the JAX side quantizes it, the
bridge carries the exact int8 weights across).

Widths are multiples of 128 so the JAX side takes its Pallas kernels
(interpret mode on the CPU) rather than its tiling fallbacks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from instaslice_tpu.models.lm import ModelConfig as JaxConfig
from instaslice_tpu.models.quant import quantize_params as jax_quantize
from instaslice_tpu_torch import bridge
from instaslice_tpu_torch.models.lm import ModelConfig as TorchConfig

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

SMALL = dict(vocab_size=256, d_model=256, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=512)


def configs(dtype: str = "fp32", **overrides):
    """(JAX config, port config) of the same small model."""
    kw = dict(SMALL, **overrides)
    jdt, tdt = DTYPES[dtype]
    return (JaxConfig(dtype=jdt, remat=False, **kw),
            TorchConfig(dtype=tdt, remat=False, **kw))


def numpy_params(cfg, seed: int = 0, embed_scale: float = 0.1) -> dict:
    """Seeded fp32 weights in the shared layout. The small embedding
    scale keeps greedy chains from collapsing onto the input token."""
    rng = np.random.default_rng(seed)
    L, D, Fd, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim

    def dense(*shape):
        return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(
            np.float32)

    return {
        "embed": (rng.standard_normal((V, D)) * embed_scale).astype(
            np.float32),
        "blocks": {
            "ln1": {"scale": (1 + 0.1 * rng.standard_normal((L, D))).astype(
                np.float32)},
            "ln2": {"scale": (1 + 0.1 * rng.standard_normal((L, D))).astype(
                np.float32)},
            "wq": dense(L, D, qd), "wk": dense(L, D, kvd),
            "wv": dense(L, D, kvd), "wo": dense(L, qd, D),
            "w_in": dense(L, D, Fd), "w_out": dense(L, Fd, D),
        },
        "ln_f": {"scale": np.ones((D,), np.float32)},
    }


def both_params(jcfg, np_tree: dict, quantize: bool):
    """(JAX tree, port tree) holding bit-identical weights: matmul
    weights cast to the model dtype (norm scales stay fp32), optionally
    int8-quantized by the JAX package and bridged."""
    def cast(path, a):
        keep = any(getattr(p, "key", None) in ("ln1", "ln2", "ln_f")
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
