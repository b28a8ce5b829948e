"""The TpuLM model family in PyTorch (port of
``instaslice_tpu/models/lm.py``).

Parameters are plain dicts of tensors in the JAX package's layout
(per-layer leaves stacked ``(L, ...)``, projections ``(in, out)``, the
``(vocab, d)`` embedding doubling as the unembedding, fp32 norm scales),
so :mod:`instaslice_tpu_torch.bridge` moves weights across with no
transpose. Ported here: :class:`ModelConfig`, :func:`init_params`, the
full forward :func:`apply` (:meth:`TpuLM.apply`: dense MLP, GQA, causal
attention through the flash-attention kernels at the head dims they are
built for and the plain grouped formulation at others, block remat
"full" as ``torch.utils.checkpoint``), :func:`init_cache` and
:func:`apply_with_cache` (dense MLP, bf16 or int8 KV cache). Not yet
ported, and raising ``NotImplementedError``: mixture-of-experts, ring
and pipeline attention, remat "dots", LoRA, int4, and sliding windows in
the cache forward (the full forward takes windows through the plain
grouped formulation, as the reference routes them).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from instaslice_tpu_torch import resolve_device
from instaslice_tpu_torch.models.quant import (
    QuantizedTensor,
    embed_lookup,
    qdot,
    qdot_stacked,
    weight,
)
from instaslice_tpu_torch.ops import flash_attention as _fa
from instaslice_tpu_torch.ops import flash_decode as _fd
from instaslice_tpu_torch.ops.flash_attention import flash_attention
from instaslice_tpu_torch.ops.flash_decode import (
    merge_local,
    quant_decode_attention,
)

Params = Dict[str, Any]

log = logging.getLogger("instaslice_tpu_torch.models.lm")

#: (path, shape) pairs whose plain route on the card was already logged
_plain_logged: set = set()


def _log_plain_route(path: str, shape: Tuple) -> None:
    """Say once per shape that a call on the card takes the plain
    PyTorch formulation because no kernel is built for that shape."""
    if (path, shape) not in _plain_logged:
        _plain_logged.add((path, shape))
        log.warning("%s %s: no kernel is built for this shape; the plain "
                    "PyTorch formulation runs on the card", path, shape)

#: block-level rematerialization policies (a copy of
#: ``instaslice_tpu/parallel/pipeline.py: REMAT_POLICIES``); :func:`apply`
#: runs "full" and raises on "dots", the cache forward never
#: rematerializes
REMAT_POLICIES = ("full", "dots")

#: per-layer projections the stacked w8a16 kernel serves
BIG_NAMES = ("wq", "wk", "wv", "wo", "w_in", "w_out")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq_len: int = 2048
    dtype: Any = torch.bfloat16
    param_dtype: Any = None
    n_kv_heads: int = 0
    window: int = 0
    ring_attention: bool = False
    n_experts: int = 0
    expert_top_k: int = 2
    expert_capacity_factor: float = 1.25
    remat: bool = True
    remat_policy: str = "full"
    attention_impl: str = "auto"

    def __post_init__(self) -> None:
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r} "
                             f"(want one of {REMAT_POLICIES})")
        if self.n_kv_heads < 0 or (
            self.n_kv_heads and self.n_heads % self.n_kv_heads
        ):
            raise ValueError(
                f"n_kv_heads={self.n_kv_heads} must be 0 (MHA) or a "
                f"positive divisor of n_heads={self.n_heads}"
            )
        if self.window < 0:
            raise ValueError(f"window={self.window} must be 0 (full "
                             "causal) or positive")
        if self.window and self.ring_attention:
            raise ValueError(
                "sliding-window attention cannot combine with ring "
                "attention (the ring's flash inner loop is full-causal)")
        if self.window and self.attention_impl == "flash":
            raise ValueError(
                "attention_impl='flash' cannot honor window="
                f"{self.window} (the flash kernels are full-causal); use "
                "'auto' or 'xla' for windowed models")

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be a multiple of n_heads")
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def stored_dtype(self):
        return self.param_dtype if self.param_dtype is not None \
            else self.dtype


def _generator(seed_or_gen: Union[int, torch.Generator],
               device: torch.device) -> torch.Generator:
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    return torch.Generator(device=device).manual_seed(int(seed_or_gen))


def _dense_init(gen, shape, dtype, device, scale=None, stacked=False):
    """N(0, 1) * fan_in**-0.5 (or ``scale``), drawn in fp32 and stored in
    ``dtype``; a stacked leaf is drawn one layer at a time so a 7B-class
    stack never needs its fp32 copy whole."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    parts = range(shape[0]) if stacked else [None]
    for i in parts:
        sub = shape[1:] if stacked else shape
        draw = torch.randn(sub, generator=gen, dtype=torch.float32,
                           device=device) * scale
        if stacked:
            out[i] = draw.to(dtype)
        else:
            out.copy_(draw.to(dtype))
    return out


def init_params(cfg: ModelConfig, seed: Union[int, torch.Generator] = 0, *,
                device="cuda") -> Params:
    """Random weights in the JAX package's layout, from a torch
    generator (the draws differ from ``jax.random``'s; move the JAX
    package's own weights with :mod:`instaslice_tpu_torch.bridge` where
    the two must agree)."""
    if cfg.n_experts:
        raise NotImplementedError("mixture-of-experts is not ported yet")
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    dt = cfg.stored_dtype
    L, D, H, Fd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff
    hd, Hkv = cfg.head_dim, cfg.kv_heads
    ones = dict(dtype=torch.float32, device=dev)
    block: Params = {
        "ln1": {"scale": torch.ones((L, D), **ones)},
        "ln2": {"scale": torch.ones((L, D), **ones)},
    }
    for name, shape in (("wq", (L, D, H * hd)), ("wk", (L, D, Hkv * hd)),
                        ("wv", (L, D, Hkv * hd)), ("wo", (L, H * hd, D)),
                        ("w_in", (L, D, Fd)), ("w_out", (L, Fd, D))):
        block[name] = _dense_init(gen, shape, dt, dev, stacked=True)
    return {
        "embed": _dense_init(gen, (cfg.vocab_size, D), dt, dev, scale=1.0),
        "blocks": block,
        "ln_f": {"scale": torch.ones((D,), **ones)},
    }


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * rms * scale).to(x.dtype)


def _rope_tables(positions: torch.Tensor, hd: int):
    """(cos, sin) of the rotary angles, (B, S, 1, hd/2) fp32, for
    positions (S,) shared or (B, S) per row (base 10000)."""
    freqs = 10000.0 ** (
        -torch.arange(0, hd, 2, dtype=torch.float32,
                      device=positions.device) / hd
    )
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs           # (B, S, hd/2)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _apply_rope(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embeddings (half-split, base 10000); x: (B, S, H, hd),
    positions: (S,) shared or (B, S) per row."""
    return _apply_rope(x, *_rope_tables(positions, x.shape[-1]))


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = True, impl: str = "auto",
               window: int = 0) -> torch.Tensor:
    """Softmax attention (``lm.py:292-345``); q: (B, S, H, hd), k/v:
    (B, S, Hkv, hd) with Hkv dividing H.

    ``impl`` "flash" takes the flash-attention kernels (B5 on the
    forward, B6 and B7 on the backward) after repeating K/V up to H
    (``jnp.repeat`` semantics: each KV head serves G consecutive query
    heads), and raises on the card at a head dim they are not built for;
    "auto" does the same where they are built
    (:func:`~instaslice_tpu_torch.ops.flash_attention.kernel_built`).
    "xla", "auto" at any other head dim, or any ``window`` > 0 takes the
    grouped plain formulation with its -1e9 mask, as the reference routes
    shapes its kernel does not take."""
    if window or (impl == "auto" and not _fa.kernel_built(q.shape[-1])):
        if impl == "auto" and q.is_cuda:
            _log_plain_route("attention (B5-B7)",
                             (("hd", q.shape[-1]), ("window", window)))
        impl = "xla"
    H, Hkv = q.shape[2], k.shape[2]
    if impl in ("auto", "flash"):
        if Hkv != H:
            k = k.repeat_interleave(H // Hkv, dim=2)
            v = v.repeat_interleave(H // Hkv, dim=2)
        return flash_attention(q, k, v, causal=causal)
    if impl != "xla":
        raise ValueError(f"unknown attention_impl {impl!r}")
    B, S, _, hd = q.shape
    G = H // Hkv
    q5 = q.reshape(B, S, Hkv, G, hd)
    # fp32 products of the compute-dtype values, fp32 sums
    logits = torch.einsum("bqkgd,bskd->bkgqs", q5.float(), k.float()) * (
        hd ** -0.5)
    if causal or window:
        i = torch.arange(S, device=q.device)
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= i[None, :] <= i[:, None]
        if window:
            mask &= i[:, None] - i[None, :] < window
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.float(), v.float())
    return out.to(v.dtype).reshape(B, S, H, hd)


def _transformer_block(cfg: ModelConfig, layer: Params, x: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """One pre-norm dense block (``lm.py:348-391``); x: (B, S, D).

    Weights are cast to ``cfg.dtype`` at each use, so fp32 master weights
    get fp32 grads through autograd. A ``cfg.dtype`` matmul returns its
    fp32 sums rounded once to ``cfg.dtype``: exactly the reference's
    ``preferred_element_type=float32`` product followed by
    ``.astype(cfg.dtype)``, which is how q, k, v, the attention output
    projection and the MLP down projection come out there too. The MLP up
    projection differs by one rounding in bf16: the reference applies the
    GELU to its fp32 sums, here they are rounded to ``cfg.dtype`` first."""
    dt = cfg.dtype
    B, S = x.shape[:2]
    H, Hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    h = _rmsnorm(x, layer["ln1"]["scale"])
    q = torch.matmul(h, weight(layer["wq"], dt)).reshape(B, S, H, hd)
    k = torch.matmul(h, weight(layer["wk"], dt)).reshape(B, S, Hkv, hd)
    v = torch.matmul(h, weight(layer["wv"], dt)).reshape(B, S, Hkv, hd)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)
    attn = _attention(q, k, v, impl=cfg.attention_impl, window=cfg.window)
    attn = attn.reshape(B, S, H * hd)
    x = x + torch.matmul(attn, weight(layer["wo"], dt))
    h = _rmsnorm(x, layer["ln2"]["scale"])
    # jax.nn.gelu defaults to the tanh form
    y = F.gelu(torch.matmul(h, weight(layer["w_in"], dt)).float(),
               approximate="tanh").to(dt)
    return x + torch.matmul(y, weight(layer["w_out"], dt))


def unembed(x: torch.Tensor, embed_leaf, dtype) -> torch.Tensor:
    """fp32 logits (..., vocab) from hidden states x (..., D) in ``dtype``
    against the ``(vocab, D)`` embedding cast to ``dtype``.
    ``torch.matmul`` of the fp32 upcasts: every product of two ``dtype``
    values is exact in fp32 and the sums are fp32, the reference's
    ``preferred_element_type=float32`` (a bf16 matmul would return bf16
    logits). With TF32 allowed the forward stays exact (TF32 holds a
    bf16 mantissa) and runs on the tensor cores; the backward's two
    products then round the fp32 cotangent (dlogits) to TF32's 10-bit
    mantissa. The training CLI allows it for bf16 compute on purpose:
    that is at least as precise as the TPU's default-precision fp32
    matmul."""
    return torch.matmul(x.float(), weight(embed_leaf, dtype).float().t())


def _layers(blocks: Params, n_layers: int):
    """The stacked ``(L, ...)`` leaves as L per-layer dicts of views.
    ``unbind`` has one backward node that stacks the L grads, where
    indexing would scatter each layer's grad into a zeroed copy of the
    whole stack."""
    def split(node):
        if isinstance(node, dict):
            parts = {k: split(v) for k, v in node.items()}
            return [{k: parts[k][i] for k in parts} for i in range(n_layers)]
        return node.unbind(0)

    return split(blocks)


def apply(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
          unembed_out: bool = True):
    """The full forward (``lm.py:484-568``): logits (B, S, vocab) fp32
    for ``tokens`` (B, S), or with ``unembed_out=False`` the final hidden
    states (B, S, D) in ``cfg.dtype`` (the hook of the chunked loss)."""
    if cfg.n_experts:
        raise NotImplementedError("mixture-of-experts is not ported")
    if cfg.ring_attention:
        raise NotImplementedError("ring attention is not ported")
    if cfg.remat and cfg.remat_policy == "dots":
        raise NotImplementedError(
            "remat policy 'dots' is not ported (ROADMAP queue A); use "
            "'full' or remat=False")
    B, S = tokens.shape
    x = embed_lookup(params["embed"], tokens).to(cfg.dtype)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    cos, sin = _rope_tables(positions, cfg.head_dim)
    for layer in _layers(params["blocks"], cfg.n_layers):
        if cfg.remat:
            x = checkpoint(_transformer_block, cfg, layer, x, cos, sin,
                           use_reentrant=False)
        else:
            x = _transformer_block(cfg, layer, x, cos, sin)
    x = _rmsnorm(x, params["ln_f"]["scale"])
    return unembed(x, params["embed"], cfg.dtype) if unembed_out else x


def _kv_quantize(t: torch.Tensor):
    """(..., hd) -> (int8 values, per-vector fp32 scale): symmetric int8
    over each position's head vector (``torch.round`` is half-to-even,
    like ``jnp.round``)."""
    t32 = t.float()
    amax = t32.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(t32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               quant: bool = False, *, device="cuda") -> Params:
    """Zeroed head-major KV cache ``(L, B, Hkv, max_len, hd)``; with
    ``quant`` int8 values plus one fp32 scale per (layer, slot, head,
    position)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.kv_heads, max_len, cfg.head_dim)
    if quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_s": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            "v_s": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        }
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
    }


def _write_fresh(c: torch.Tensor, li: int, rows: torch.Tensor,
                 wpos: torch.Tensor, new: torch.Tensor) -> None:
    """cache[li, b, :, wpos[b, t]] = new[b, t] in place; ``new`` is
    (B, T, Hkv[, hd]) (position-major, as the layer computes it)."""
    c[li][rows, :, wpos] = new.to(c.dtype)


def apply_with_cache(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                     cache: Params, lengths: torch.Tensor,
                     attend_len: int = 0) -> Tuple[torch.Tensor, Params]:
    """Incremental forward: ``tokens`` (B, T) appended to each row at its
    own cache offset ``lengths`` (B,) int32. Covers prefill (T = chunk)
    and decode (T = 1). Returns (logits (B, T, vocab) fp32, cache).

    The cached prefix admits position ``s`` iff ``s < lengths[b]``; the T
    fresh entries attend each other through a local causal block joined
    into one softmax with the prefix. ``attend_len`` bounds the
    attended window to ``[0, attend_len)`` (caller contract:
    ``lengths[b] + T <= attend_len``).

    Decode (T = 1) over an int8 cache runs the decode-attention kernel
    plus :func:`merge_local` where the kernel is built for the head dim
    and group (the plain grouped read otherwise); quantized projections
    take the w8a16 kernels. Unlike the JAX package's single post-scan write
    (``lm.py:1044-1066``) the fresh K/V land IN PLACE, per layer, right
    after that layer has read its prefix: the results are the same,
    because reads admit only ``s < lengths[b]`` and the fresh entries
    sit at ``lengths[b]`` and beyond. The write start clamps so the T
    entries fit, as ``dynamic_update_slice`` does.
    """
    if cfg.window:
        raise NotImplementedError("sliding-window attention is not ported")
    if cfg.n_experts:
        raise NotImplementedError("mixture-of-experts is not ported")
    blocks = params["blocks"]
    quant = "k_s" in cache
    B, T = tokens.shape
    dev = tokens.device
    S_cache = cache["k"].shape[3]
    S_max = attend_len or S_cache
    dt = cfg.dtype
    H, Hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    G = H // Hkv
    sm = hd ** -0.5
    lengths = lengths.to(device=dev, dtype=torch.int32)

    x = embed_lookup(params["embed"], tokens).to(dt)
    t_idx = torch.arange(T, dtype=torch.int32, device=dev)
    positions = lengths[:, None] + t_idx                      # (B, T)
    cos, sin = _rope_tables(positions, hd)     # shared by every layer
    # B1 where it is built for the shape; the grouped plain read of the
    # cache otherwise, as the reference gates its fused branch
    use_fdk = quant and T == 1 and _fd.kernel_built(hd, G)
    if quant and T == 1 and not use_fdk and tokens.is_cuda:
        _log_plain_route("int8 decode attention (B1)",
                         (("hd", hd), ("G", G)))
    use_stacked = all(isinstance(blocks.get(nm), QuantizedTensor)
                      for nm in BIG_NAMES)
    if not use_fdk:
        s_idx = torch.arange(S_max, dtype=torch.int32, device=dev)
        mask = (s_idx[None, :] < lengths[:, None])[:, None, None, None, :]
        local_mask = t_idx[None, :] <= t_idx[:, None]         # (T, T)
    starts = torch.clamp(lengths, 0, S_cache - T)
    wpos = starts[:, None] + t_idx                            # (B, T)
    rows = torch.arange(B, device=dev)[:, None]

    for li in range(cfg.n_layers):
        def proj(h_in, name, out_fp32=False):
            h2 = h_in.reshape(B * T, -1)
            leaf = blocks[name]
            if use_stacked:
                y = qdot_stacked(h2, leaf, li, compute_dtype=dt)
            else:
                layer_leaf = (leaf.layer(li)
                              if isinstance(leaf, QuantizedTensor)
                              else leaf[li])
                y = qdot(h2, layer_leaf, compute_dtype=dt)
            y = y.reshape(B, T, -1)
            return y if out_fp32 else y.to(dt)

        h = _rmsnorm(x, blocks["ln1"]["scale"][li])
        q = proj(h, "wq", True).to(dt).reshape(B, T, H, hd)
        k = proj(h, "wk", True).to(dt).reshape(B, T, Hkv, hd)
        v = proj(h, "wv", True).to(dt).reshape(B, T, Hkv, hd)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        if quant:
            # the fresh entries are quantized only for storage; the local
            # attendance below uses their exact values
            k_new, k_sc = _kv_quantize(k)
            v_new, v_sc = _kv_quantize(v)
        else:
            k_new, v_new = k, v
        if use_fdk:
            q4 = q.reshape(B, Hkv, G, hd)
            o, m_, l_ = quant_decode_attention(
                q4, cache["k"], cache["k_s"], cache["v"], cache["v_s"],
                lengths, li, S_max,
            )
            lg_l = torch.einsum("bkgd,bkd->bkg", q4.float() * sm,
                                k[:, 0].float())
            attn = merge_local(o, m_, l_, lg_l, v[:, 0])
            attn = attn.to(dt).reshape(B, 1, H * hd)
        else:
            if quant:
                k_read = (cache["k"][li, :, :, :S_max].float()
                          * cache["k_s"][li, :, :, :S_max, None]).to(dt)
                v_read = (cache["v"][li, :, :, :S_max].float()
                          * cache["v_s"][li, :, :, :S_max, None]).to(dt)
            else:
                k_read = cache["k"][li, :, :, :S_max]
                v_read = cache["v"][li, :, :, :S_max]
            # grouped-query contraction against the stored KV heads; one
            # joint softmax over (cached prefix ‖ local fresh entries)
            q5 = q.reshape(B, T, Hkv, G, hd).float()
            lg_c = torch.einsum("btkgd,bksd->bkgts", q5,
                                k_read.float()) * sm
            lg_c = torch.where(mask, lg_c, torch.full_like(lg_c, -1e9))
            lg_l = torch.einsum("btkgd,bukd->bkgtu", q5, k.float()) * sm
            lg_l = torch.where(local_mask, lg_l,
                               torch.full_like(lg_l, -1e9))
            probs = torch.softmax(torch.cat([lg_c, lg_l], dim=-1),
                                  dim=-1).to(dt)
            # each product rounds to the compute dtype, then they add
            # (the two einsums of lm.py:1000-1004)
            attn = (
                torch.einsum("bkgts,bksd->btkgd", probs[..., :S_max].float(),
                             v_read.float()).to(dt)
                + torch.einsum("bkgtu,bukd->btkgd",
                               probs[..., S_max:].float(),
                               v.float()).to(dt)
            )
            attn = attn.reshape(B, T, H * hd)
        # this layer has read its prefix: its fresh entries land now
        _write_fresh(cache["k"], li, rows, wpos, k_new)
        _write_fresh(cache["v"], li, rows, wpos, v_new)
        if quant:
            _write_fresh(cache["k_s"], li, rows, wpos, k_sc)
            _write_fresh(cache["v_s"], li, rows, wpos, v_sc)
        x = x + proj(attn, "wo")
        h = _rmsnorm(x, blocks["ln2"]["scale"][li])
        y = proj(h, "w_in", out_fp32=True)
        # jax.nn.gelu defaults to the tanh form
        y = F.gelu(y, approximate="tanh").to(dt)
        x = x + proj(y, "w_out")
    x = _rmsnorm(x, params["ln_f"]["scale"])
    logits = qdot(x.reshape(B * T, -1), params["embed"], compute_dtype=dt,
                  transpose_w=True).reshape(B, T, -1)
    return logits, cache


class TpuLM:
    """The model bundle the serving engine and the trainer hold: config
    plus the parameter, cache and forward functions."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init(self, seed: Union[int, torch.Generator] = 0, *,
             device="cuda") -> Params:
        return init_params(self.cfg, seed, device=device)

    def init_cache(self, batch: int, max_len: int, quant: bool = False, *,
                   device="cuda") -> Params:
        return init_cache(self.cfg, batch, max_len, quant, device=device)

    def apply_with_cache(self, params: Params, tokens: torch.Tensor,
                         cache: Params, lengths: torch.Tensor,
                         attend_len: int = 0,
                         lora: Optional[Params] = None,
                         adapter_idx: Optional[torch.Tensor] = None):
        if lora is not None or adapter_idx is not None:
            raise NotImplementedError("multi-LoRA is not ported yet")
        return apply_with_cache(self.cfg, params, tokens, cache, lengths,
                                attend_len)

    def apply(self, params: Params, tokens: torch.Tensor, *, mesh=None,
              unembed: bool = True, return_aux: bool = False):
        """Logits (B, S, vocab) fp32, or the final hidden states with
        ``unembed=False``; ``return_aux`` adds the MoE load-balance term
        (0.0: only dense models are ported)."""
        if mesh is not None:
            raise NotImplementedError("a device mesh is not ported: the "
                                      "forward runs on one card")
        out = apply(self.cfg, params, tokens, unembed_out=unembed)
        if return_aux:
            return out, torch.zeros((), dtype=torch.float32,
                                    device=out.device)
        return out

    def apply_pipelined(self, *args, **kwargs):
        raise NotImplementedError("pipeline parallelism is not ported: "
                                  "the forward runs on one card")
