"""The port's flash attention (B5-B7) held against the JAX package's on
the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_ops.py`` does; the port side runs the plain versions its
wrappers take for CPU tensors (the CUDA kernels are held against those
same plain versions on the card, ``tests/test_torch_cuda.py`` and
``chip_smoke.py``). Inputs come from seeded numpy and go to both.

Tolerances: fp32 both sides, the same products summed in another order
and exp/log from different libraries, 2e-5 on outputs of magnitude ~1
(1e-4 on gradients, which sum more terms); bf16: both sides round the
output once, so one bf16 ulp of the largest element, 2**-7 of it.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaslice_tpu_torch import bridge
from instaslice_tpu_torch.ops import flash_attention as tfa
from instaslice_tpu_torch.ops import launch_counts, reset_launch_counts

jfa = importlib.import_module("instaslice_tpu.ops.flash_attention")

DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _arrays(shape, n, seed, dtype="fp32"):
    """n seeded arrays, as (JAX arrays, port tensors) of one dtype."""
    rng = np.random.default_rng(seed)
    jdt = DT[dtype][0]
    js = [jnp.asarray(rng.standard_normal(shape).astype(np.float32), jdt)
          for _ in range(n)]
    host = jax.device_get({str(i): a for i, a in enumerate(js)})
    ts = bridge.params_from_jax(host, device="cpu")
    return js, [ts[str(i)] for i in range(n)]


def _close(got, want, dtype="fp32", rel=2e-5):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "bf16":
        tol = 2 ** -7 * float(np.abs(want).max())
    else:
        tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("causal,S,block,dtype", [
    (True, 128, 64, "fp32"),
    (False, 128, 64, "fp32"),
    (True, 512, 128, "fp32"),     # several key blocks per query block
    (True, 128, 64, "bf16"),
])
def test_plain_kernels_match_pallas_kernels(causal, S, block, dtype):
    """B5 (o, lse lane 0), B6 (dq) and B7 (dk, dv): each plain version
    against its Pallas kernel, fed the same inputs (the backward both
    get the JAX forward's o and lse)."""
    BH, hd = 2, 32
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _arrays((BH, S, hd), 4, S + block,
                                                  dtype)
    jo, jlse = jfa._flash_call(jq, jk, jv, causal, block, block, True)
    to, tlse = tfa.flash_fwd(tq, tk, tv, causal)
    _close(to, jo, dtype)
    _close(tlse, jlse[..., 0])
    jdq, jdk, jdv = jfa._flash_bwd_call(jq, jk, jv, jo, jlse, jg, causal,
                                        block, block, True)
    o_t = bridge.params_from_jax({"o": jax.device_get(jo)}, device="cpu")["o"]
    lse_t = torch.tensor(np.asarray(jlse[..., 0]))
    delta = (tg.float() * o_t.float()).sum(-1)
    dq = tfa.flash_bwd_dq(tq, tk, tv, tg, lse_t, delta, causal)
    dk, dv = tfa.flash_bwd_dkv(tq, tk, tv, tg, lse_t, delta, causal)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(got, want, dtype, rel=1e-4)


@pytest.mark.parametrize("causal,S,dtype", [
    (True, 256, "fp32"), (False, 256, "fp32"),
    (True, 100, "fp32"),          # ragged: no power-of-two tiling
    (False, 129, "fp32"),
    (True, 128, "bf16"),
])
def test_flash_attention_and_grads_match_jax(causal, S, dtype):
    """The public (B, S, H, hd) entry and its autograd backward against
    ``jax.grad`` through the JAX package's ``flash_attention`` (interpret
    mode, or its own plain fallback where its blocks do not tile S)."""
    shape = (2, S, 2, 16)
    (jq, jk, jv), (tq, tk, tv) = _arrays(shape, 3, S, dtype)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, interpret=True)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(jq, jk, jv)
    for t in (tq, tk, tv):
        t.requires_grad_(True)
    tout = tfa.flash_attention(tq, tk, tv, causal=causal)
    tgrads = torch.autograd.grad((tout.float() ** 2).sum(), (tq, tk, tv))
    _close(tout, jout, dtype)
    for got, want in zip(tgrads, jgrads):
        _close(got, want, dtype, rel=1e-4)


@pytest.mark.parametrize("S,KV,causal", [(64, 64, True), (8, 64, True),
                                         (24, 40, False)])
def test_xla_attention_matches_jax(S, KV, causal):
    """The plain formulation, cropped-query causal mask included (query
    row i at absolute position i + KV - S)."""
    (jq,), (tq,) = _arrays((2, S, 2, 16), 1, S)
    (jk, jv), (tk, tv) = _arrays((2, KV, 2, 16), 2, KV + 1)
    _close(tfa._xla_attention(tq, tk, tv, causal),
           jfa._xla_attention(jq, jk, jv, causal))


def test_wrappers_take_plain_versions_on_cpu_and_count_nothing():
    reset_launch_counts()
    (_, ts) = _arrays((2, 64, 2, 16), 3, 9)
    for t in ts:
        t.requires_grad_(True)
    out = tfa.flash_attention(*ts, causal=True)
    out.sum().backward()
    counts = launch_counts()
    assert {counts[n] for n in ("flash_fwd", "flash_bwd_dq",
                                "flash_bwd_dkv")} == {0}


def test_causal_needs_equal_lengths():
    (_, (q,)) = _arrays((2, 8, 16), 1, 3)
    (_, (k, v)) = _arrays((2, 16, 16), 2, 4)
    with pytest.raises(ValueError, match="S == kv_len"):
        tfa.flash_fwd(q, k, v, causal=True)
    o, lse = tfa.flash_fwd(q, k, v, causal=False)
    assert o.shape == q.shape and lse.shape == (2, 8)
