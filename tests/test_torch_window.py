"""Sliding-window attention in the port's cache forward, held against the
JAX package on the CPU (the engine in ``tests/test_torch_window_serve.py``,
bf16, wide chunks and the write order in
``tests/test_torch_window_cache.py``).

The same seeded weights go to both packages through
:mod:`instaslice_tpu_torch.bridge`. The JAX side runs as its own tests
run it (``tests/test_window.py``, ``tests/test_decode_equivalence.py``):
its w8a16 kernel opt-in on (``TPUSLICE_QUANT_KERNEL=1``, Pallas in
interpret mode), its decode-attention opt-in off (ROADMAP queue C).

Tolerances on logits, fp32 compute (``TOLERANCE`` of
``tests/test_torch_model.py``): fp32 KV cache, summation order only
(1e-4); int8 KV cache, a fresh K/V element within an fp32 ulp of an int8
rounding boundary may round the other way on one side (2e-3 absolute,
1e-3 relative). bf16 compute on the JAX-initialized model of
``test_decode_equivalence.py`` (logits up to ~28): relative L2 at most
``BF16_REL`` and each logit within ``BF16_REL`` x max|logit| (one bf16
ulp on activations that round differently, carried through two layers:
at most 6.8e-3 measured, windowed or not); its caches within
``BF16_REL`` relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaslice_tpu.models.lm import ModelConfig as JaxConfig
from instaslice_tpu.models.lm import TpuLM as JaxLM
from instaslice_tpu_torch import bridge
from instaslice_tpu_torch.models import lm as tlm
from test_torch_model import TOLERANCE
from torch_port_util import both_params, configs, numpy_params, to_np

BF16_REL = 1e-2


@pytest.fixture(autouse=True)
def _jax_kernel_opt_in(monkeypatch):
    monkeypatch.setenv("TPUSLICE_QUANT_KERNEL", "1")
    monkeypatch.delenv("TPUSLICE_DECODE_KERNEL", raising=False)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _tiny(window, n_kv, dtype="fp32"):
    """``test_decode_equivalence.py``'s model (JAX-initialized weights)
    on both sides."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    kw = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=n_kv,
              n_layers=2, d_ff=64, window=window, max_seq_len=32,
              remat=False)
    jcfg = JaxConfig(dtype=jdt, **kw)
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = bridge.params_from_jax(jax.device_get(jp), device="cpu")
    return jm, jp, tlm.ModelConfig(dtype=tdt, **kw), tp


def _close(got, want, dtype, kv_quant):
    got, want = to_np(got), to_np(want)
    if dtype == "bf16":
        assert np.linalg.norm(got - want) <= BF16_REL * np.linalg.norm(want)
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()
        return
    atol, rtol = TOLERANCE[(dtype, kv_quant)]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _same_cache(tcache, jcache, dtype, kv_quant):
    """fp32: int8 values within one step, everything else to 1e-4; bf16:
    each leaf within BF16_REL relative L2."""
    for name in tcache:
        got, want = to_np(tcache[name]), to_np(jcache[name])
        if dtype == "bf16":
            assert (np.linalg.norm(got - want)
                    <= BF16_REL * np.linalg.norm(want)), name
        else:
            np.testing.assert_allclose(
                got, want, atol=1.0 if name in ("k", "v") and kv_quant
                else 1e-4)


def _mixed_depth(dtype, kv_quant, window, n_kv):
    """``test_mixed_depth_decode_matches_full_forward`` on both sides: a
    6-token prefill of 3 rows, the rows rolled back to depths 4, 2, 6
    (stale K/V past them must be invisible and overwritable), 3 decode
    steps; the port against JAX at every step and against its own full
    forward."""
    jm, jp, tcfg, tp = _tiny(window, n_kv, dtype)
    B = 3
    seqs = np.asarray(jax.random.randint(jax.random.key(1), (B, 10), 0, 64),
                      np.int64)
    tfull = tlm.apply(tcfg, tp, torch.from_numpy(seqs))
    jcache = jm.init_cache(B, 24, quant=kv_quant)
    tcache = tlm.init_cache(tcfg, B, 24, quant=kv_quant, device="cpu")
    japply = jax.jit(jm.apply_with_cache)
    jl, jcache = japply(jp, jnp.asarray(seqs[:, :6], jnp.int32), jcache,
                        jnp.zeros(B, jnp.int32))
    tl, tcache = tlm.apply_with_cache(
        tcfg, tp, torch.from_numpy(seqs[:, :6]), tcache,
        torch.zeros(B, dtype=torch.int32))
    _close(tl, jl, dtype, kv_quant)
    depths = np.array([4, 2, 6], np.int32)
    for step in range(3):
        lens = depths + step
        tok = seqs[np.arange(B), lens][:, None]
        jl, jcache = japply(jp, jnp.asarray(tok, jnp.int32), jcache,
                            jnp.asarray(lens))
        tl, tcache = tlm.apply_with_cache(tcfg, tp, torch.from_numpy(tok),
                                          tcache, torch.from_numpy(lens))
        _close(tl, jl, dtype, kv_quant)
        if dtype == "fp32":
            np.testing.assert_array_equal(to_np(tl).argmax(-1),
                                          to_np(jl).argmax(-1))
            want = tfull[np.arange(B), lens][:, None]
            tol = 0.05 if kv_quant else 1e-4      # the reference's bound
            rel = float((tl - want).norm() / want.norm())
            assert rel < tol, (step, rel)
    _same_cache(tcache, jcache, dtype, kv_quant)

@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("n_kv", [0, 2])
def test_mixed_depth_decode_matches_jax(kv_quant, window, n_kv):
    """fp32, the whole parametrization of test_decode_equivalence.py:
    full-precision and int8 KV, no window and window 5 (the band), MHA
    and GQA."""
    _mixed_depth("fp32", kv_quant, window, n_kv)


def _serving_pair(window, quantize=True, dtype="fp32"):
    jcfg, tcfg = configs(dtype, window=window)
    jt, tt = both_params(jcfg, numpy_params(jcfg, 0), quantize=quantize)
    return jcfg, tcfg, jt, tt

@pytest.mark.parametrize("kv_quant", [False, True])
def test_band_read_equals_a_mask_only_prefix_read(kv_quant, monkeypatch):
    """The band is a read optimization: with ``window_band`` forced to 0
    (and B1's plain version, which knows no window, kept out of decode)
    the same forwards read the whole prefix with the window in the mask,
    and the logits agree to fp32 rounding (the band drops only masked
    positions, whose probabilities are exactly 0)."""
    _, tcfg, _, tt = _serving_pair(5)
    rng = np.random.default_rng(3)
    seqs = torch.from_numpy(rng.integers(1, 256, (2, 30)).astype(np.int64))

    def run():
        cache = tlm.init_cache(tcfg, 2, 48, quant=kv_quant, device="cpu")
        outs = []
        for pos, T in [(0, 9), (9, 9), (18, 1), (19, 1), (20, 3)]:
            lens = torch.tensor([pos, pos], dtype=torch.int32)
            lg, cache = tlm.apply_with_cache(tcfg, tt, seqs[:, pos:pos + T],
                                             cache, lens)
            outs.append(lg)
        return torch.cat(outs, 1)

    band = run()
    monkeypatch.setattr(tlm, "window_band", lambda *a: 0)
    monkeypatch.setattr(tlm._fd, "kernel_built", lambda *a: False)
    prefix = run()
    torch.testing.assert_close(band, prefix, atol=1e-5, rtol=1e-5)
