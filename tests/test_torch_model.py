"""The port's ``apply_with_cache`` held against the JAX package's on the CPU.

One seeded numpy weight tree goes to both packages (int8-quantized by
the JAX package and bridged, or left in the model dtype); both run a
prefill chunk for two rows of different true lengths, then T = 1 decode
steps fed the same tokens, and the logits are compared at every step.

The JAX side runs with its w8a16 kernel opt-in (``TPUSLICE_QUANT_KERNEL=1``,
Pallas in interpret mode). Its decode-attention opt-in stays off: with
``TPUSLICE_DECODE_KERNEL=1`` the JAX ``apply_with_cache`` raises
``UnboundLocalError`` (``k_read``, ``lm.py:986-987``; see ROADMAP queue
C), so the JAX decode reads the int8 cache through XLA while the port
runs its decode-attention kernel's plain version. The two compute the
same softmax; the bf16 tolerance below covers that XLA rounds the
dequantized prefix to bf16 and the port keeps it fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaslice_tpu.models.lm import TpuLM as JaxLM
from instaslice_tpu_torch.models import lm as tlm
from torch_port_util import both_params, configs, numpy_params, to_np

#: (atol, rtol) on logits of magnitude ~6.
#: fp32 + fp32 KV: summation order only.
#: fp32 + int8 KV: a fresh K/V element within an fp32 ulp of an int8
#:   rounding boundary may round the other way on one side (one LSB of
#:   a per-vector scale, amax/127).
#: bf16: one bf16 ulp (2**-8 relative) on activations that round
#:   differently, carried through two layers, plus the bf16 rounding of
#:   the dequantized prefix on the JAX side.
TOLERANCE = {("fp32", False): (1e-4, 1e-4), ("fp32", True): (2e-3, 1e-3),
             ("bf16", False): (6e-2, 3e-2), ("bf16", True): (6e-2, 3e-2)}


@pytest.fixture(autouse=True)
def _jax_kernel_opt_in(monkeypatch):
    monkeypatch.setenv("TPUSLICE_QUANT_KERNEL", "1")
    monkeypatch.delenv("TPUSLICE_DECODE_KERNEL", raising=False)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _run_both(dtype, kv_quant, n_kv_heads, quantize, steps=3, seed=0):
    jcfg, tcfg = configs(dtype, n_kv_heads=n_kv_heads)
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, seed), quantize)
    jm = JaxLM(jcfg)
    B, T, S = 2, 8, 64
    true_len = [5, 8]
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(1, jcfg.vocab_size, (B, T)).astype(np.int32)
    toks[0, true_len[0]:] = 0                  # padded tail of row 0
    jcache = jm.init_cache(B, S, quant=kv_quant)
    tcache = tlm.init_cache(tcfg, B, S, quant=kv_quant, device="cpu")
    lens = np.zeros(B, np.int32)
    japply = jax.jit(jm.apply_with_cache)    # one compile per T
    pairs = []
    for step in range(steps + 1):
        jl, jcache = japply(jtree, jnp.asarray(toks), jcache,
                            jnp.asarray(lens))
        tl, tcache = tlm.apply_with_cache(tcfg, ttree, torch.from_numpy(toks),
                                          tcache, torch.from_numpy(lens))
        pairs.append((to_np(jl), to_np(tl)))
        # next input: the JAX side's greedy token at each row's last real
        # position, fed to BOTH (a near-tie cannot fork the inputs)
        last = [t - 1 for t in true_len] if step == 0 else [0, 0]
        nxt = np.argmax(pairs[-1][0][np.arange(B), last], axis=-1)
        lens = np.asarray(true_len, np.int32) + step if step == 0 else lens + 1
        toks = nxt[:, None].astype(np.int32)
    return pairs


def check_prefill_then_decode(dtype, kv_quant, n_kv_heads):
    """int8 weights (the serving path); fp32 also agrees on every greedy
    token."""
    atol, rtol = TOLERANCE[(dtype, kv_quant)]
    pairs = _run_both(dtype, kv_quant, n_kv_heads, quantize=True)
    for want, got in pairs:
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
        if dtype == "fp32":
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("n_kv_heads", [0, 2])
def test_prefill_then_decode_matches_jax(kv_quant, n_kv_heads):
    """fp32 compute, GQA and MHA, bf16 and int8 KV (the bf16-compute
    cases are in test_torch_model_bf16.py)."""
    check_prefill_then_decode("fp32", kv_quant, n_kv_heads)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_unquantized_weights_match_jax(kv_quant):
    """fp32 weights take the plain matmul path on both sides."""
    atol, rtol = TOLERANCE[("fp32", kv_quant)]
    for want, got in _run_both("fp32", kv_quant, 2, quantize=False):
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_attend_len_bucket_is_result_identical(kv_quant):
    """Bounding the attended window to a bucket above every row's depth
    changes nothing (positions past a row's length are masked)."""
    _, tcfg = configs("fp32")
    jcfg, _ = configs("fp32")
    _, ttree = both_params(jcfg, numpy_params(jcfg, 3), quantize=True)
    B, S = 2, 96
    out = []
    for attend in (0, 32):
        cache = tlm.init_cache(tcfg, B, S, quant=kv_quant, device="cpu")
        toks = torch.arange(1, 17, dtype=torch.int64).reshape(B, 8)
        tlm.apply_with_cache(tcfg, ttree, toks, cache,
                             torch.zeros(B, dtype=torch.int32))
        lg, _ = tlm.apply_with_cache(tcfg, ttree, toks[:, :1], cache,
                                     torch.tensor([8, 5], dtype=torch.int32),
                                     attend_len=attend)
        out.append(lg)
    torch.testing.assert_close(out[0], out[1], atol=1e-6, rtol=1e-6)


def test_unported_paths_raise():
    _, tcfg = configs("fp32")
    cache = tlm.init_cache(tcfg, 1, 16, device="cpu")
    toks = torch.ones(1, 1, dtype=torch.int64)
    lens = torch.zeros(1, dtype=torch.int32)
    for bad in (dataclasses.replace(tcfg, window=4),
                dataclasses.replace(tcfg, n_experts=2)):
        with pytest.raises(NotImplementedError):
            tlm.apply_with_cache(bad, {"blocks": {}}, toks, cache, lens)
    with pytest.raises(NotImplementedError):
        tlm.TpuLM(tcfg).apply({}, toks)
