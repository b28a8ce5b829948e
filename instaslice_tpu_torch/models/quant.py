"""Per-channel int8 weight quantization (the int8 part of
``instaslice_tpu/models/quant.py``).

Routing follows the JAX package with its kernel opt-in on
(``TPUSLICE_QUANT_KERNEL=1``): a quantized leaf contracted at
``M <= 256`` rows (``_QDOT_MAX_M``) goes to the w8a16 kernel wrappers of
:mod:`instaslice_tpu_torch.ops.quant_matmul`, so only int8 bytes cross
device memory (bf16 activations on 16-byte-aligned rows take the
tensor-core kernel there, fp32 activations the CUDA-core one); larger M
(batched prefill) dequantizes and runs ``torch.matmul``, as XLA does at
``quant.py:356-366``. That split is by shape, not a fallback. Group-wise
int4 is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from instaslice_tpu_torch.ops.quant_matmul import (
    quant_matmul,
    quant_matmul_stacked,
    quant_matmul_t,
)

Params = Dict[str, Any]

#: params tree keys that stay full precision: norms and the MoE router
_SKIP_KEYS = frozenset({"ln1", "ln2", "ln_f", "router"})

#: row-count ceiling for routing a contraction through the w8a16 kernels
_QDOT_MAX_M = 256


class QuantizedTensor:
    """int8 values ``q`` + per-output-channel scale ``s`` (kept with the
    weight's rank and stored in the weight's dtype)."""

    __slots__ = ("q", "s")

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        self.q = q
        self.s = s

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.s.dtype

    @property
    def device(self):
        return self.q.device

    def dequantize(self, dtype=None) -> torch.Tensor:
        out = self.q.float() * self.s.float()
        return out.to(dtype or self.s.dtype)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.s.to(device))

    def layer(self, li: int) -> "QuantizedTensor":
        """One layer of a stacked (L, ...) leaf (views, no copy)."""
        return QuantizedTensor(self.q[li], self.s[li])

    def __repr__(self):
        return (f"QuantizedTensor(shape={tuple(self.q.shape)}, "
                f"s={tuple(self.s.shape)})")


def quantize_tensor(w: torch.Tensor, reduce_axis: int = -2) -> QuantizedTensor:
    """Symmetric per-output-channel int8: the amax reduces over the axis
    the matmul contracts. The scale is rounded to the weight's dtype
    BEFORE q is computed (``quant.py:95-99``), so dequantization uses
    exactly the scale q was computed against."""
    w32 = w.float()
    amax = w32.abs().amax(dim=reduce_axis, keepdim=True)
    scale = (torch.clamp(amax, min=1e-8) / 127.0).to(w.dtype).float()
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale.to(w.dtype))


def quantize_params(params: Params, bits: int = 8) -> Params:
    """Quantize every matmul weight of an :func:`init_params` tree to
    int8; norms stay full precision, the embedding reduces over its last
    axis (``(vocab, d)`` layout). Idempotent on quantized leaves."""
    if bits != 8:
        raise NotImplementedError(f"bits={bits}: only int8 is ported")

    def walk(tree, key=""):
        if isinstance(tree, QuantizedTensor):
            return tree
        if isinstance(tree, dict):
            return {k: (tree[k] if k in _SKIP_KEYS else walk(tree[k], k))
                    for k in tree}
        return quantize_tensor(tree, reduce_axis=-1 if key == "embed" else -2)

    return walk(params)


def weight(leaf, dtype=None) -> torch.Tensor:
    """A usable weight from a params leaf: dequantize a
    :class:`QuantizedTensor`, pass tensors through (cast)."""
    if isinstance(leaf, QuantizedTensor):
        return leaf.dequantize(dtype)
    return leaf if dtype is None else leaf.to(dtype)


def _dot_f32(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with fp32 products and sums (the JAX package's
    ``preferred_element_type=jnp.float32``)."""
    return torch.matmul(x2.float(), w.float())


def qdot(x2: torch.Tensor, leaf, *, compute_dtype=None,
         transpose_w: bool = False) -> torch.Tensor:
    """(M, K) contraction against a params leaf -> fp32 (M, N); a
    quantized leaf at ``M <= 256`` takes the w8a16 kernel."""
    if isinstance(leaf, QuantizedTensor) and x2.shape[0] <= _QDOT_MAX_M:
        if transpose_w:
            return quant_matmul_t(x2, leaf.q, leaf.s)
        return quant_matmul(x2, leaf.q, leaf.s)
    w = weight(leaf, compute_dtype)
    return _dot_f32(x2, w.t() if transpose_w else w)


def qdot_stacked(x2: torch.Tensor, leaf, layer: int, *,
                 compute_dtype=None) -> torch.Tensor:
    """Layer-indexed (M, K) contraction against a STACKED (L, K, N) leaf
    -> fp32 (M, N); the kernel reads layer ``layer`` in place."""
    if (isinstance(leaf, QuantizedTensor) and x2.shape[0] <= _QDOT_MAX_M
            and leaf.q.dim() == 3):
        return quant_matmul_stacked(x2, leaf.q, leaf.s, layer)
    if isinstance(leaf, QuantizedTensor):
        N = leaf.q.shape[-1]
        w = (leaf.q[layer].float()
             * leaf.s[layer].float().reshape(1, N))
        w = w.to(compute_dtype or leaf.s.dtype)
    else:
        w = leaf[layer]
        if compute_dtype is not None:
            w = w.to(compute_dtype)
    return _dot_f32(x2, w)


def embed_lookup(leaf, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding gather that dequantizes AFTER the gather (a full-table
    dequantize would materialize the V x D matrix int8 exists to
    avoid)."""
    tokens = tokens.long()
    if isinstance(leaf, QuantizedTensor):
        rows = leaf.q[tokens].float()
        scales = leaf.s[tokens].float()            # (..., 1) per row
        return (rows * scales).to(leaf.s.dtype)
    return leaf[tokens]
