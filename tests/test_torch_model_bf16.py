"""The port's ``apply_with_cache`` against the JAX package's in bf16
compute (split from test_torch_model.py, which has the set-up and the
stated tolerances, to keep each file's run short)."""

import pytest

from test_torch_model import _jax_kernel_opt_in  # noqa: F401  (autouse)
from test_torch_model import check_prefill_then_decode


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("n_kv_heads", [0, 2])
def test_prefill_then_decode_matches_jax_bf16(kv_quant, n_kv_heads):
    """bf16 compute, GQA and MHA, bf16 and int8 KV: logits within the
    bf16 tolerance at every step (greedy tokens are compared in fp32
    and in the engine's short runs)."""
    check_prefill_then_decode("bf16", kv_quant, n_kv_heads)
