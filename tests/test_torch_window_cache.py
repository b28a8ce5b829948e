"""Sliding-window attention in the port's cache forward against the JAX
package on the CPU, continued: bf16 compute, prefill chunks wider than
the window, and the order of the band read and the in-place write
(split from ``tests/test_torch_window.py``, which has the set-up and the
stated tolerances, to keep each file's run short)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaslice_tpu.models.lm import TpuLM as JaxLM
from instaslice_tpu_torch.models import lm as tlm
from test_torch_window import _jax_kernel_opt_in  # noqa: F401  (autouse)
from test_torch_window import _close, _mixed_depth, _same_cache, _serving_pair


@pytest.mark.parametrize("kv_quant", [False, True])
def test_mixed_depth_window_decode_matches_jax_bf16(kv_quant):
    """bf16 compute, window 5, GQA: within the bf16 tolerance."""
    _mixed_depth("bf16", kv_quant, 5, 2)

@pytest.mark.parametrize("kv_quant", [False, True])
def test_chunks_wider_than_the_window_then_decode_through_the_band(kv_quant):
    """int8 weights (the serving path), window 8: two 12-token prefill
    chunks, then decode with the row inside the band (start 0) and past
    it, at the whole cache and at an attend bucket; against JAX at every
    forward and against the port's own windowed full forward."""
    jcfg, tcfg, jt, tt = _serving_pair(8)
    jm = JaxLM(jcfg)
    B, S = 2, 64
    rng = np.random.default_rng(2)
    seqs = rng.integers(1, jcfg.vocab_size, (B, 40)).astype(np.int64)
    tfull = tlm.apply(tcfg, tt, torch.from_numpy(seqs))
    jcache = jm.init_cache(B, S, quant=kv_quant)
    tcache = tlm.init_cache(tcfg, B, S, quant=kv_quant, device="cpu")
    japply = jax.jit(jm.apply_with_cache, static_argnums=(4,))
    got, want = [], []
    pos = 0
    for T, attend in [(12, 0), (12, 0)] + [(1, 0)] * 4 + [(1, 48)] * 4:
        lens = np.full(B, pos, np.int32)
        toks = seqs[:, pos:pos + T]
        jl, jcache = japply(jt, jnp.asarray(toks, jnp.int32), jcache,
                            jnp.asarray(lens), attend)
        tl, tcache = tlm.apply_with_cache(tcfg, tt, torch.from_numpy(toks),
                                          tcache, torch.from_numpy(lens),
                                          attend_len=attend)
        _close(tl, jl, "fp32", kv_quant)
        got.append(tl)
        want.append(tfull[:, pos:pos + T])
        pos += T
    assert tlm.window_band(tcfg, S, 48) == 7
    got, want = torch.cat(got, 1), torch.cat(want, 1)
    tol = 2e-2 if kv_quant else 1e-4
    assert float((got - want).norm() / want.norm()) < tol
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))

@pytest.mark.parametrize("kv_quant", [False, True])
def test_band_is_read_before_the_layer_writes_its_fresh_entries(kv_quant):
    """Row 0's 4 fresh entries at length 14 of a 16-position cache clamp
    to positions 12-15, overwriting positions 12 and 13 of its own band
    (which it must read as they were); row 1's band [0, 4) holds its own
    write positions 2-3 (masked). The port writes per layer, the JAX
    package after the whole stack: same logits, same cache."""
    jcfg, tcfg, jt, tt = _serving_pair(5, quantize=False)
    jm = JaxLM(jcfg)
    rng = np.random.default_rng(4)
    B, S = 2, 16
    prefill = rng.integers(1, 256, (B, S)).astype(np.int32)
    fresh = rng.integers(1, 256, (B, 4)).astype(np.int32)
    jcache = jm.init_cache(B, S, quant=kv_quant)
    tcache = tlm.init_cache(tcfg, B, S, quant=kv_quant, device="cpu")
    _, jcache = jm.apply_with_cache(jt, jnp.asarray(prefill), jcache,
                                    jnp.zeros(B, jnp.int32))
    tlm.apply_with_cache(tcfg, tt, torch.from_numpy(prefill).long(), tcache,
                         torch.zeros(B, dtype=torch.int32))
    lens = np.array([14, 2], np.int32)
    jl, jcache = jm.apply_with_cache(jt, jnp.asarray(fresh), jcache,
                                     jnp.asarray(lens))
    tl, tcache = tlm.apply_with_cache(tcfg, tt, torch.from_numpy(fresh).long(),
                                      tcache, torch.from_numpy(lens))
    _close(tl, jl, "fp32", kv_quant)
    _same_cache(tcache, jcache, "fp32", kv_quant)
