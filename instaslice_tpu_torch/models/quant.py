"""Weight-only quantization: per-channel int8 and group-wise packed int4
(port of ``instaslice_tpu/models/quant.py``).

Routing follows the JAX package with its kernel opt-in on
(``TPUSLICE_QUANT_KERNEL=1``): a quantized leaf contracted at
``M <= 256`` rows (``_QDOT_MAX_M``) goes to the w8a16 kernel wrappers of
:mod:`instaslice_tpu_torch.ops.quant_matmul`, so only int8 bytes cross
device memory (bf16 activations on 16-byte-aligned rows take the
tensor-core kernel there, fp32 activations the CUDA-core one); larger M
(batched prefill) dequantizes and runs ``torch.matmul``, as XLA does at
``quant.py:356-366``. That split is by shape, not a fallback.

Group-wise int4 (:class:`Int4Tensor`, ``quant.py:104-231``) is the
capacity tier: its weights dequantize into ``torch.matmul`` at every
use, as the JAX package dequantizes them into ``einsum`` outside any
Pallas kernel, so int4 buys model size, not tokens per second.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from instaslice_tpu_torch.ops.quant_matmul import (
    quant_matmul,
    quant_matmul_stacked,
    quant_matmul_t,
)
from instaslice_tpu_torch.parallel.collectives import shard_leaf

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


class Int4Tensor:
    """Group-wise int4 weights (``quant.py:104-176``): two values packed
    per uint8 byte along the contraction axis, one fp32 scale per
    (group, output channel).

    ``p``: packed uint8; along ``pack_axis`` byte ``i`` holds values
    ``2i`` (low nibble) and ``2i+1`` (high nibble). ``s``: fp32 scales
    with the weight's rank, the packed axis reduced to its groups.
    ``pack_axis`` is -2 for ``(..., in, out)`` projections and -1 for the
    ``(vocab, d)`` embedding; negative, so it names the same axis in one
    layer of a stacked leaf. ``dtype`` is the scales' (float32), unlike
    :class:`QuantizedTensor`'s."""

    __slots__ = ("p", "s", "group", "pack_axis")

    def __init__(self, p: torch.Tensor, s: torch.Tensor, group: int,
                 pack_axis: int):
        self.p = p
        self.s = s
        self.group = group
        self.pack_axis = pack_axis

    @property
    def shape(self):
        shp = list(self.p.shape)
        shp[self.pack_axis] *= 2
        return tuple(shp)

    @property
    def dtype(self):
        return self.s.dtype

    @property
    def device(self):
        return self.p.device

    def _unpack(self) -> torch.Tensor:
        """The int values in [-7, 7] in the weight's shape (int8: the
        JAX package's int32 values, in a narrower type)."""
        ax = self.pack_axis % self.p.dim()
        # sign-extend each nibble: (n ^ 8) - 8
        lo = ((self.p & 0xF) ^ 8).to(torch.int8) - 8
        hi = ((self.p >> 4) ^ 8).to(torch.int8) - 8
        return torch.stack([lo, hi], dim=ax + 1).reshape(self.shape)

    def dequantize(self, dtype=None) -> torch.Tensor:
        """fp32 products of the values and their group's scale, then one
        cast (to ``dtype``, else the scales' float32)."""
        ax = self.pack_axis % self.p.dim()
        u = self._unpack()
        K = u.shape[ax]
        grouped = list(u.shape)
        grouped[ax:ax + 1] = [K // self.group, self.group]
        out = u.reshape(grouped).float() * self.s.float().unsqueeze(ax + 1)
        return out.reshape(self.shape).to(dtype or self.s.dtype)

    def to(self, device) -> "Int4Tensor":
        return Int4Tensor(self.p.to(device), self.s.to(device), self.group,
                          self.pack_axis)

    def layer(self, li: int) -> "Int4Tensor":
        """One layer of a stacked (L, ...) leaf (views, no copy)."""
        return Int4Tensor(self.p[li], self.s[li], self.group, self.pack_axis)

    def __repr__(self):
        return (f"Int4Tensor(shape={self.shape}, group={self.group}, "
                f"pack_axis={self.pack_axis})")


#: the quantized leaf types of a params tree
QUANT_TYPES = (QuantizedTensor, Int4Tensor)


def quantize_tensor_int4(w: torch.Tensor, reduce_axis: int = -2,
                         group: int = 128) -> Int4Tensor:
    """Symmetric group-wise int4 (``quant.py:179-205``): the contraction
    axis splits into runs of ``min(group, K)``, each with one fp32 scale
    ``amax / 7`` per output channel; values are rounded half to even and
    clipped to [-7, 7], then packed two per byte along the same axis."""
    ax = reduce_axis % w.dim()
    K = w.shape[ax]
    g = min(group, K)
    if K % g or K % 2:
        raise ValueError(f"contraction dim {K} must be even and "
                         f"divisible by group={g}")
    grouped = list(w.shape)
    grouped[ax:ax + 1] = [K // g, g]
    wg = w.float().reshape(grouped)
    amax = torch.clamp(wg.abs().amax(dim=ax + 1, keepdim=True), min=1e-8)
    # a tensor divisor: CUDA divides by a scalar as a product with its
    # reciprocal, one ulp away from the JAX package's quotient
    scale = amax / torch.full_like(amax, 7.0)
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int16)
    q = q.reshape(w.shape)
    even = [slice(None)] * q.dim()
    odd = list(even)
    even[ax], odd[ax] = slice(0, None, 2), slice(1, None, 2)
    lo, hi = q[tuple(even)], q[tuple(odd)]
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8)
    return Int4Tensor(packed, scale.squeeze(ax + 1), g, reduce_axis)


def _quantize_leaf(w: torch.Tensor, reduce_axis: int, bits: int,
                   group: int):
    """One weight leaf; a stacked (L, ...) leaf quantizes one layer at a
    time (groups and channels never span layers, so the result is the
    whole leaf's), so a 7B-class stack never needs its fp32 copy whole.
    An MoE expert stack (L, E, D, F) reduces over D per layer: int8
    scales (L, E, 1, F), and ``layer(i)`` is that layer's (E, D, F)."""
    def one(t):
        if bits == 4:
            return quantize_tensor_int4(t, reduce_axis, group)
        return quantize_tensor(t, reduce_axis)

    if w.dim() < 3:
        return one(w)
    parts = [one(w[i]) for i in range(w.shape[0])]
    if bits == 4:
        return Int4Tensor(torch.stack([t.p for t in parts]),
                          torch.stack([t.s for t in parts]),
                          parts[0].group, reduce_axis)
    return QuantizedTensor(torch.stack([t.q for t in parts]),
                           torch.stack([t.s for t in parts]))


def quantize_params(params: Params, bits: int = 8,
                    group: int = 128) -> Params:
    """Quantize every matmul weight of an :func:`init_params` tree:
    ``bits=8`` per-channel int8 (:class:`QuantizedTensor`), ``bits=4``
    group-wise packed int4 (:class:`Int4Tensor`, groups of ``group``
    along the contraction axis). Norms stay full precision, the
    embedding reduces over its last axis (``(vocab, d)`` layout).
    Idempotent on quantized leaves of either type."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")

    def walk(tree, key=""):
        if isinstance(tree, QUANT_TYPES):
            return tree
        if isinstance(tree, dict):
            return {k: (tree[k] if k in _SKIP_KEYS else walk(tree[k], k))
                    for k in tree}
        return _quantize_leaf(tree, -1 if key == "embed" else -2, bits,
                              group)

    return walk(params)


def shard_params(params: Params, specs: Params, axes) -> Params:
    """This rank's leaves of a whole (possibly quantized) params tree laid
    out by the :func:`~instaslice_tpu_torch.models.lm.param_specs`-shaped
    ``specs`` over mesh ``axes`` (a ``MeshAxes``): the port's
    ``shard_params`` (``quant.py:236-280``), where placing a leaf means
    taking this rank's contiguous block of it. The reference's three rules:

    - a :class:`QuantizedTensor`'s int8 values take the weight's spec;
    - its scales take the same spec with every size-1 (reduced) axis left
      whole;
    - an :class:`Int4Tensor`'s packed values and group scales take the
      weight's spec, its packed axis sharded only where each shard keeps
      whole byte pairs and whole groups (else that axis stays whole).

    Every slice is a contiguous copy (the w8a16 kernels read rows at
    16-byte strides); a leaf no axis of its spec splits is returned as it
    is."""
    def size(names) -> int:
        n = 1
        for nm in ([names] if isinstance(names, str) else names or ()):
            n *= axes.of(nm).size
        return n

    def place(leaf, spec):
        spec = tuple(spec)
        if isinstance(leaf, QuantizedTensor):
            sspec = tuple(spec[d] if d < len(spec) and leaf.s.shape[d] != 1
                          else None for d in range(leaf.s.dim()))
            return QuantizedTensor(shard_leaf(leaf.q, spec, axes),
                                   shard_leaf(leaf.s, sspec, axes))
        if isinstance(leaf, Int4Tensor):
            ax = leaf.pack_axis % leaf.p.dim()
            names = spec[ax] if ax < len(spec) else None
            D = size(names)
            ok = names is None or (leaf.p.shape[ax] % D == 0
                                   and (leaf.p.shape[ax] * 2 // D)
                                   % leaf.group == 0)
            pspec = tuple(spec[d] if d < len(spec) and (d != ax or ok)
                          else None for d in range(leaf.p.dim()))
            return Int4Tensor(shard_leaf(leaf.p, pspec, axes),
                              shard_leaf(leaf.s, pspec, axes), leaf.group,
                              leaf.pack_axis)
        return shard_leaf(leaf, spec, axes)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(tree[k], spec[k]) for k in tree}
        return place(tree, spec)

    return walk(params, specs)


def weight(leaf, dtype=None) -> torch.Tensor:
    """A usable weight from a params leaf: dequantize a
    :class:`QuantizedTensor` or :class:`Int4Tensor`, pass tensors
    through (cast)."""
    if isinstance(leaf, QUANT_TYPES):
        return leaf.dequantize(dtype)
    return leaf if dtype is None else leaf.to(dtype)


def _dot_f32(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) with fp32 products and sums (the JAX package's
    ``preferred_element_type=jnp.float32``)."""
    return torch.matmul(x2.float(), w.float())


def qdot(x2: torch.Tensor, leaf, *, compute_dtype=None,
         transpose_w: bool = False) -> torch.Tensor:
    """(M, K) contraction against a params leaf -> fp32 (M, N); an int8
    leaf at ``M <= 256`` takes the w8a16 kernel, an :class:`Int4Tensor`
    dequantizes to ``compute_dtype`` at any M (``quant.py:339-366``)."""
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
    elif isinstance(leaf, Int4Tensor):
        w = leaf.layer(layer).dequantize(compute_dtype)
    else:
        w = leaf[layer]
        if compute_dtype is not None:
            w = w.to(compute_dtype)
    return _dot_f32(x2, w)


def embed_lookup(leaf, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding gather that dequantizes AFTER the gather (a full-table
    dequantize would materialize the V x D matrix quantization exists to
    avoid): an :class:`Int4Tensor` table gathers its packed rows and
    their group scales, so it stays packed."""
    tokens = tokens.long()
    if isinstance(leaf, QuantizedTensor):
        rows = leaf.q[tokens].float()
        scales = leaf.s[tokens].float()            # (..., 1) per row
        return (rows * scales).to(leaf.s.dtype)
    if isinstance(leaf, Int4Tensor):
        return Int4Tensor(leaf.p[tokens], leaf.s[tokens], leaf.group,
                          leaf.pack_axis).dequantize()
    return leaf[tokens]
