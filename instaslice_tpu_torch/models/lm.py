"""The TpuLM model family in PyTorch (port of
``instaslice_tpu/models/lm.py``).

Parameters are plain dicts of tensors in the JAX package's layout
(per-layer leaves stacked ``(L, ...)``, projections ``(in, out)``, the
``(vocab, d)`` embedding doubling as the unembedding, fp32 norm scales;
a mixture-of-experts model adds the fp32 ``router`` (L, D, E) and takes
expert stacks ``w_in`` (L, E, D, F) and ``w_out`` (L, E, F, D)), so
:mod:`instaslice_tpu_torch.bridge` moves weights across with no
transpose. Ported here: :class:`ModelConfig`, :func:`init_params`, the
full forward :func:`apply` (:meth:`TpuLM.apply`: dense MLP or the GShard
top-k MoE with its load-balance term, GQA, causal attention through the
flash-attention kernels at the head dims they are built for and the
plain grouped formulation at others and under a sliding window, block
remat "full" and "dots" as ``torch.utils.checkpoint``; int8 and int4
leaves dequantize one layer at a time, the QLoRA base),
:func:`init_cache` and :func:`apply_with_cache` (dense MLP or MoE, bf16
or int8 KV cache, sliding windows through the banded cache read, int8 or
int4 weights, multi-LoRA deltas per row). Not yet ported, and raising
``NotImplementedError``: ring and pipeline attention.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from instaslice_tpu_torch import resolve_device
from instaslice_tpu_torch.models.quant import (
    QUANT_TYPES,
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
#: ``instaslice_tpu/parallel/pipeline.py: REMAT_POLICIES``): "full" keeps
#: only each block's inputs, "dots" also its contractions with no batch
#: dimension (:func:`dots_policy`); the cache forward never rematerializes
REMAT_POLICIES = ("full", "dots")

#: the ops remat "dots" saves: a contraction with no batch dimension
#: lands on ``mm`` (``torch.matmul`` of (..., K) by (K, N)); ``torch.einsum``
#: lowers to ``bmm`` even without batch dims, so products meant to be
#: saved are written as ``torch.matmul``
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Remat "dots", JAX's ``dots_with_no_batch_dims_saveable``
    (``instaslice_tpu/parallel/pipeline.py:45-62``) as a selective
    checkpoint policy: ``mm``/``addmm`` outputs are saved (the q/k/v/o and
    dense-MLP projections, the MoE router), everything else is recomputed
    in the backward, the batched ``bmm`` products (plain attention, the
    MoE dispatch, expert and combine einsums) and the elementwise work
    included. The flash kernels launch through ctypes, which a dispatch
    policy never sees, so their forward (B5) runs again in the recompute,
    as the reference recomputes its ``pallas_call``; the saved ``mm``
    outputs are only read by what follows them (the kernels write their
    own output buffers)."""
    if op in _DOTS_SAVED:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str, *args):
    """``fn(*args)`` under block-level rematerialization (``apply_remat``
    of the reference)."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, dots_policy)
    return checkpoint(fn, *args, use_reentrant=False, **kw)


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
    the two must agree). A mixture-of-experts model draws the router
    (L, D, E), stored fp32 whatever ``param_dtype`` is, then the expert
    stacks w_in (L, E, D, F) and w_out (L, E, F, D) in the stored dtype
    (``lm.py:239-246``)."""
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
                        ("wv", (L, D, Hkv * hd)), ("wo", (L, H * hd, D))):
        block[name] = _dense_init(gen, shape, dt, dev, stacked=True)
    E = cfg.n_experts
    if E:
        block["router"] = _dense_init(gen, (L, D, E), torch.float32, dev,
                                      stacked=True)
    mlp = ((L, E, D, Fd), (L, E, Fd, D)) if E else ((L, D, Fd), (L, Fd, D))
    for name, shape in zip(("w_in", "w_out"), mlp):
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
    shapes its kernel does not take and every window; on the card an
    unbuilt head dim is logged once, a window (a route by design) not."""
    if window or (impl == "auto" and not _fa.kernel_built(q.shape[-1])):
        if impl == "auto" and q.is_cuda and not window:
            _log_plain_route("attention (B5-B7)", (("hd", q.shape[-1]),))
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
                       cos: torch.Tensor, sin: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block (``lm.py:348-391``); x: (B, S, D). Returns
    ``(x, aux)``: the MoE load-balance term (0.0 for a dense block) rides
    alongside for the training loss.

    Weights are cast to ``cfg.dtype`` at each use, so fp32 master weights
    get fp32 grads through autograd. A ``cfg.dtype`` matmul returns its
    fp32 sums rounded once to ``cfg.dtype``: exactly the reference's
    ``preferred_element_type=float32`` product followed by
    ``.astype(cfg.dtype)``, which is how q, k, v, the attention output
    projection and the MLP down projection come out there too. The MLP up
    projection differs by one rounding in bf16: the reference applies the
    GELU to its fp32 sums, here they are rounded to ``cfg.dtype`` first
    (the experts' up projection in :func:`_moe_mlp` likewise)."""
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
    if cfg.n_experts:
        y, aux = _moe_mlp(h, layer["router"], weight(layer["w_in"], dt),
                          weight(layer["w_out"], dt), cfg.expert_top_k,
                          cfg.expert_capacity_factor)
        return x + y, aux
    # jax.nn.gelu defaults to the tanh form
    y = F.gelu(torch.matmul(h, weight(layer["w_in"], dt)).float(),
               approximate="tanh").to(dt)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + torch.matmul(y, weight(layer["w_out"], dt)), aux


def _moe_mlp(x: torch.Tensor, router_w: torch.Tensor, w_in: torch.Tensor,
             w_out: torch.Tensor, top_k: int = 2,
             capacity_factor: float = 1.25
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed MoE with capacity, GShard-style (``lm.py:394-472``):
    static shapes, one-hot dispatch and combine einsums, each token
    through only its top-k experts. x: (B, S, D) in the compute dtype;
    router_w: (D, E) fp32; w_in: (E, D, F); w_out: (E, F, D).

    Each expert takes at most ``C = max(1, ceil(capacity_factor · k · S /
    E))`` (token, choice) pairs per batch row, earlier tokens first
    (token-major: choice c of token s is pair s·k + c); a pair past its
    expert's capacity is dropped (its dispatch and combine rows are zero)
    and the token falls through the residual. The gates renormalize over
    the k chosen when k > 1; at k == 1 the raw gate stays, the router's
    only gradient path.

    Returns ``(y, aux)``: y (B, S, D) in x's dtype and the load-balance
    term ``E · Σ_e f_e · P_e`` (f_e: the share of tokens whose top-1
    choice is e; P_e: the mean router probability of e): 1 at perfect
    balance, up to E when the router collapses onto one expert.

    Differences from the JAX code that change no value: ties in the
    top-k break toward the lower expert index, as ``jax.lax.top_k``
    does, through a stable descending sort; the capacity one-hot is a
    comparison with ``arange(C)``, all-zero at ``pos >= C`` as
    ``jax.nn.one_hot`` is (``F.one_hot`` would raise there). Products
    the reference takes with fp32 sums then casts (the dispatch, the two
    expert products) are ``cfg.dtype`` einsums, whose fp32 sums round
    once; the combine rounds once in both. The experts' up projection
    rounds to the compute dtype before the GELU (one rounding in bf16
    that the reference does not take, as in the dense block). The router
    product is ``torch.matmul`` so remat "dots" saves it, as JAX's policy
    saves that unbatched dot."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    k = min(top_k, E)
    N = S * k
    C = max(1, int(math.ceil(capacity_factor * k * S / E)))
    dt = x.dtype
    gates = torch.softmax(torch.matmul(x.float(), router_w.float()), dim=-1)
    ranked, order = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = ranked[..., :k], order[..., :k]             # (B, S, k)
    if k > 1:
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    sel = F.one_hot(topi, E).float().reshape(B, N, E)
    # position of each (token, choice) pair in its expert's buffer
    pos = ((torch.cumsum(sel, dim=1) - sel) * sel).sum(-1).long()  # (B, N)
    slot = (pos[..., None] == torch.arange(C, device=x.device)).to(dt)
    disp = sel.to(dt)[:, :, :, None] * slot[:, :, None, :]   # (B, N, E, C)
    comb = disp * topv.reshape(B, N)[:, :, None, None].to(dt)
    # contract over (s, choice) against x itself, not x repeated k times
    expert_in = torch.einsum("bskec,bsd->becd",
                             disp.reshape(B, S, k, E, C), x)
    h = torch.einsum("becd,edf->becf", expert_in, w_in)
    h = F.gelu(h.float(), approximate="tanh").to(dt)
    y_e = torch.einsum("becf,efd->becd", h, w_out)
    y = torch.einsum("bskec,becd->bsd", comb.reshape(B, S, k, E, C), y_e)
    f_e = F.one_hot(topi[..., 0], E).float().mean(dim=(0, 1))
    p_e = gates.mean(dim=(0, 1))
    aux = E * (f_e * p_e).sum()
    return y.to(dt), aux


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
    whole stack. A quantized leaf (an int8 QLoRA base, int4 serving
    weights) splits into its layers' views, each dequantized only where
    its block uses it."""
    def split(node):
        if isinstance(node, dict):
            parts = {k: split(v) for k, v in node.items()}
            return [{k: parts[k][i] for k in parts} for i in range(n_layers)]
        if isinstance(node, QUANT_TYPES):
            return [node.layer(i) for i in range(n_layers)]
        return node.unbind(0)

    return split(blocks)


def apply(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
          unembed_out: bool = True, return_aux: bool = False):
    """The full forward (``lm.py:484-568``): logits (B, S, vocab) fp32
    for ``tokens`` (B, S), or with ``unembed_out=False`` the final hidden
    states (B, S, D) in ``cfg.dtype`` (the hook of the chunked loss);
    ``return_aux`` adds the MoE load-balance term averaged over layers
    (0.0 for a dense model) as a second output."""
    if cfg.ring_attention:
        raise NotImplementedError("ring attention is not ported")
    B, S = tokens.shape
    x = embed_lookup(params["embed"], tokens).to(cfg.dtype)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    cos, sin = _rope_tables(positions, cfg.head_dim)
    auxes = []
    for layer in _layers(params["blocks"], cfg.n_layers):
        if cfg.remat:
            x, aux = _remat(_transformer_block, cfg.remat_policy, cfg, layer,
                            x, cos, sin)
        else:
            x, aux = _transformer_block(cfg, layer, x, cos, sin)
        auxes.append(aux)
    x = _rmsnorm(x, params["ln_f"]["scale"])
    out = unembed(x, params["embed"], cfg.dtype) if unembed_out else x
    if return_aux:
        return out, torch.stack(auxes).mean()
    return out


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


def window_band(cfg: ModelConfig, S_cache: int, S_max: int) -> int:
    """Width of the sliding-window band :func:`apply_with_cache` reads
    from a cache of ``S_cache`` positions attended up to ``S_max``
    (``lm.py:799-801``): ``min(window - 1, S_cache)`` positions, the
    union of every fresh query's admissible cached keys; 0 when the model
    has no window or the band is not narrower than ``S_max`` (the prefix
    read, its mask windowed, serves then, and decode may take B1)."""
    if not cfg.window:
        return 0
    band = max(1, min(cfg.window - 1, S_cache))
    return band if band < S_max else 0


def _write_fresh(c: torch.Tensor, li: int, rows: torch.Tensor,
                 wpos: torch.Tensor, new: torch.Tensor) -> None:
    """cache[li, b, :, wpos[b, t]] = new[b, t] in place; ``new`` is
    (B, T, Hkv[, hd]) (position-major, as the layer computes it)."""
    c[li][rows, :, wpos] = new.to(c.dtype)


def _lora_deltas(cfg: ModelConfig, lora: Params, adapter_idx: torch.Tensor,
                 single: bool, B: int):
    """Per-row adapter deltas (``lm.py:736-775``) as ``delta(h_in, name,
    li)`` -> (B, T, out) fp32, or None for an unadapted target.

    ``lora`` is a :func:`~instaslice_tpu_torch.models.lora.stack_adapters`
    stack: ``(L, N+1, in, r)`` / ``(L, N+1, r, out)`` per target plus the
    (N+1,) ``scales``. Gathered (``single`` False): ``pick`` is the
    one-hot of ``adapter_idx`` (B,) over N+1 and ``sel = pick * scales``;
    the scale rides the A gather only (the delta is linear in the
    product). Single: every row takes adapter ``adapter_idx[0]`` and the
    stack is indexed once, on the device (the id is read by no host
    code: a captured decode step replays with whatever id the engine's
    buffer holds). The gathered per-row pair is computed for all
    L layers at once (one product per target and forward, not one per
    layer); each of its elements is one product rounded once to
    ``cfg.dtype``, the reference's value, and so is the single path's, so
    the two paths agree bit for bit. Then ``xa = h_in @ a`` with fp32
    sums, cast to ``cfg.dtype``, and ``xa @ b`` with fp32 sums."""
    dt = cfg.dtype
    aidx = adapter_idx.reshape(-1).to(torch.int64)
    scales = lora["scales"].to(dt)
    pairs = {}
    if single:
        aid = aidx[:1]
        a_scale = scales.index_select(0, aid)
        for t, ab in lora["blocks"].items():
            pairs[t] = ((ab["a"].index_select(1, aid)[:, 0].to(dt)
                         * a_scale).float(),
                        ab["b"].index_select(1, aid)[:, 0].to(dt).float())
    else:
        pick = F.one_hot(aidx, scales.shape[0]).to(dt)          # (B, N+1)
        sel = (pick * scales[None, :]).float()
        for t, ab in lora["blocks"].items():
            a_b = torch.einsum("bn,lnir->lbir", sel, ab["a"].to(dt).float())
            b_b = torch.einsum("bn,lnro->lbro", pick.float(),
                               ab["b"].to(dt).float())
            # rounded to the compute dtype, as the reference's einsum
            # returns it, then held in fp32 for the fp32-sum products
            pairs[t] = (a_b.to(dt).float(), b_b.to(dt).float())

    def delta(h_in: torch.Tensor, name: str, li: int):
        if name not in pairs:
            return None
        a, b = pairs[name]
        a, b = a[li], b[li]
        if single:
            a = a.expand(B, -1, -1)
            b = b.expand(B, -1, -1)
        xa = torch.bmm(h_in.float(), a)
        return torch.bmm(xa.to(dt).float(), b)

    return delta


def apply_with_cache(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                     cache: Params, lengths: torch.Tensor,
                     attend_len: int = 0, lora: Optional[Params] = None,
                     adapter_idx: Optional[torch.Tensor] = None,
                     single_adapter: bool = False
                     ) -> Tuple[torch.Tensor, Params]:
    """Incremental forward: ``tokens`` (B, T) appended to each row at its
    own cache offset ``lengths`` (B,) int32. Covers prefill (T = chunk)
    and decode (T = 1). Returns (logits (B, T, vocab) fp32, cache).

    The cached prefix admits position ``s`` iff ``s < lengths[b]``; the T
    fresh entries attend each other through a local causal block joined
    into one softmax with the prefix. ``attend_len`` bounds the
    attended window to ``[0, attend_len)`` (caller contract:
    ``lengths[b] + T <= attend_len``).

    Sliding windows (``lm.py:777-841``): where :func:`window_band` is
    nonzero each row reads only the band of ``window - 1`` cached
    positions from ``start = clamp(lengths - (window - 1), 0, S_cache -
    band)`` (the int8 values and their scales, or the bf16 cache),
    masked by ``s < lengths`` and ``position - s < window``; otherwise
    the prefix read keeps the window in its mask. The local (T, T) block
    is windowed too.

    Decode (T = 1) over an int8 cache runs the decode-attention kernel
    plus :func:`merge_local` where the kernel is built for the head dim
    and group (the plain grouped read otherwise), no band is read and the
    model is dense, as the reference gates its fused branch on ``not
    use_window`` and ``not cfg.n_experts`` (``lm.py:856-866``); int8
    projections take the w8a16 kernels (a dense model's six through the
    stacked one, gated on ``not cfg.n_experts`` as at ``lm.py:872-876``;
    an MoE model's four attention projections through the one-weight
    kernel on each layer's slice), int4 ones dequantize into
    ``torch.matmul``. An MoE layer's expert stacks dequantize one layer
    at a time into :func:`_moe_mlp` (``lm.py:1008-1013``), whose
    load-balance term is dropped, as in the reference. Unlike the JAX package's
    single post-scan write (``lm.py:1044-1066``) the fresh K/V land IN
    PLACE, per layer, right after that layer has read its prefix (or its
    band): the results are the same, because reads admit only ``s <
    lengths[b]`` and the fresh entries sit at ``lengths[b]`` and beyond.
    The write start clamps so the T entries fit, as
    ``dynamic_update_slice`` does.

    Multi-LoRA (``lm.py:736-775``, ``:896-915``): with a stacked ``lora``
    tree and ``adapter_idx`` (B,) each row adds its adapter's delta
    (:func:`_lora_deltas`) to the fp32 output of its adapted projections,
    the w8a16 kernel's (B2) included, before the cast to ``cfg.dtype``;
    index 0 is the all-zero adapter. ``single_adapter`` runs every row
    through ``adapter_idx[0]`` (the engine's fast path when its live
    slots agree), equal to the gathered path bit for bit.
    """
    blocks = params["blocks"]
    moe = bool(cfg.n_experts)
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
    band = window_band(cfg, S_cache, S_max)
    # B1 where it is built for the shape, no band is read and the model
    # is dense; the grouped plain read of the cache otherwise, as the
    # reference gates its fused branch (the band and MoE are routes by
    # design, not logged as plain ones)
    fdk_path = quant and T == 1 and not band and not moe
    use_fdk = fdk_path and _fd.kernel_built(hd, G)
    if fdk_path and not use_fdk and tokens.is_cuda:
        _log_plain_route("int8 decode attention (B1)",
                         (("hd", hd), ("G", G)))
    use_stacked = not moe and all(
        isinstance(blocks.get(nm), QuantizedTensor) for nm in BIG_NAMES)
    if band:
        start = torch.clamp(lengths - (cfg.window - 1), 0, S_cache - band)
        s_abs = start[:, None] + torch.arange(band, dtype=torch.int32,
                                              device=dev)   # (B, band)
        # indexes each row's band of a (B, Hkv, S, ...) layer of the cache
        at = (torch.arange(B, device=dev)[:, None, None],
              torch.arange(Hkv, device=dev)[None, :, None],
              s_abs[:, None, :].long())
        mask = ((s_abs[:, None, :] < lengths[:, None, None])
                & (positions[:, :, None] - s_abs[:, None, :] < cfg.window))
        mask = mask[:, None, None]                      # (B, 1, 1, T, band)
    elif not use_fdk:
        s_idx = torch.arange(S_max, dtype=torch.int32, device=dev)
        mask = s_idx[None, None, :] < lengths[:, None, None]  # (B, 1, S)
        if cfg.window:
            mask = mask & (positions[:, :, None] - s_idx[None, None, :]
                           < cfg.window)
        mask = mask[:, None, None]
    if not use_fdk:
        local_mask = t_idx[None, :] <= t_idx[:, None]         # (T, T)
        if cfg.window:
            local_mask &= t_idx[:, None] - t_idx[None, :] < cfg.window

    def read(c: torch.Tensor) -> torch.Tensor:
        """The attended positions of one layer of a cache leaf."""
        return c[at] if band else c[:, :, :S_max]

    starts = torch.clamp(lengths, 0, S_cache - T)
    wpos = starts[:, None] + t_idx                            # (B, T)
    rows = torch.arange(B, device=dev)[:, None]
    lora_delta = (_lora_deltas(cfg, lora, adapter_idx.to(dev),
                               single_adapter, B)
                  if lora is not None and adapter_idx is not None else None)

    def at_layer(name: str, li: int):
        """Layer ``li`` of a stacked leaf (views; a quantized leaf stays
        quantized)."""
        leaf = blocks[name]
        return leaf.layer(li) if isinstance(leaf, QUANT_TYPES) else leaf[li]

    for li in range(cfg.n_layers):
        def proj(h_in, name, out_fp32=False):
            h2 = h_in.reshape(B * T, -1)
            if use_stacked:
                y = qdot_stacked(h2, blocks[name], li, compute_dtype=dt)
            else:
                y = qdot(h2, at_layer(name, li), compute_dtype=dt)
            y = y.reshape(B, T, -1)
            if lora_delta is not None:
                d = lora_delta(h_in, name, li)
                if d is not None:
                    y = y + d
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
                k_read = (read(cache["k"][li]).float()
                          * read(cache["k_s"][li])[..., None]).to(dt)
                v_read = (read(cache["v"][li]).float()
                          * read(cache["v_s"][li])[..., None]).to(dt)
            else:
                k_read = read(cache["k"][li])
                v_read = read(cache["v"][li])
            S_attn = k_read.shape[2]
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
                torch.einsum("bkgts,bksd->btkgd",
                             probs[..., :S_attn].float(),
                             v_read.float()).to(dt)
                + torch.einsum("bkgtu,bukd->btkgd",
                               probs[..., S_attn:].float(),
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
        if moe:
            y, _ = _moe_mlp(h, blocks["router"][li],
                            weight(at_layer("w_in", li), dt),
                            weight(at_layer("w_out", li), dt),
                            cfg.expert_top_k, cfg.expert_capacity_factor)
        else:
            y = proj(h, "w_in", out_fp32=True)
            # jax.nn.gelu defaults to the tanh form
            y = proj(F.gelu(y, approximate="tanh").to(dt), "w_out")
        x = x + y
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
                         adapter_idx: Optional[torch.Tensor] = None,
                         single_adapter: bool = False):
        return apply_with_cache(self.cfg, params, tokens, cache, lengths,
                                attend_len, lora=lora,
                                adapter_idx=adapter_idx,
                                single_adapter=single_adapter)

    def apply(self, params: Params, tokens: torch.Tensor, *, mesh=None,
              unembed: bool = True, return_aux: bool = False):
        """Logits (B, S, vocab) fp32, or the final hidden states with
        ``unembed=False``; ``return_aux`` adds the layer-averaged MoE
        load-balance term (0.0 for a dense model)."""
        if mesh is not None:
            raise NotImplementedError("a device mesh is not ported: the "
                                      "forward runs on one card")
        return apply(self.cfg, params, tokens, unembed_out=unembed,
                     return_aux=return_aux)

    def apply_pipelined(self, *args, **kwargs):
        raise NotImplementedError("pipeline parallelism is not ported: "
                                  "the forward runs on one card")
