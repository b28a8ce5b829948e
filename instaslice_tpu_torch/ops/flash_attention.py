"""Flash attention for training, by hand for Hopper.

Port of ``instaslice_tpu/ops/flash_attention.py``. Three wrappers replace
its three Pallas kernels with ``csrc/flash_attention.cu``:

- :func:`flash_fwd` -> ``_flash_kernel`` (``:73``, B5): o and the per-row
  logsumexp ``lse``;
- :func:`flash_bwd_dq` -> ``_flash_bwd_dq_kernel`` (``:130``, B6);
- :func:`flash_bwd_dkv` -> ``_flash_bwd_dkv_kernel`` (``:183``, B7).

Each has its plain PyTorch version beside it (``*_ref``), which is what
it runs on a CPU tensor; on a CUDA tensor it launches its kernel or
raises. :class:`FlashAttention` is the ``_flash`` custom_vjp
(``:240-257``): its forward launches B5 and saves (q, k, v, o, lse); its
backward computes ``delta = rowsum(do * o)`` in plain torch (outside the
kernels, as at ``:268-273``) and launches B6 and B7.
:func:`flash_attention` is the public ``(B, S, H, hd)`` entry.

Conventions that differ from the TPU kernels: ``lse`` and ``delta`` are
``(B*H, S)`` fp32 (the 8-lane broadcast, ``_LANES``, is a TPU tiling
rule); any S and kv_len are taken (ragged tails are masked), where the
reference falls back to :func:`_xla_attention` unless its blocks tile S;
causal attention with S != kv_len raises (the reference routes that
cropped-query case to :func:`_xla_attention`; the model never makes it).

Bound on the H100: operations (hundreds of flops per byte at S = 1024).
bf16 inputs run the products on the tensor cores with fp32 sums, p and
ds rounded to bf16 where they feed a product (as in FlashAttention-2):
B5, B6 and B7 as warp-specialised ``wgmma`` kernels fed by TMA (one
producer warpgroup, two consumer warpgroups of 64 rows each); fp32
inputs run on the CUDA cores in fp32; see the CUDA source. The tiles
each block of B5, B6 and B7 visits are described here in plain Python
(:func:`fwd_tiles`, :func:`dq_tiles`, :func:`dkv_tiles`), mirroring the
kernels' schedule functions (``isl_flash_tiles``), so the CPU tests can
hold the schedule to covering every unmasked (query, key) pair once.
"""

from __future__ import annotations

import ctypes

import torch

from instaslice_tpu_torch.ops import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "isl_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      ctypes.c_float, _P],
    "isl_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, ctypes.c_float, _P],
    "isl_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, ctypes.c_float, _P],
    # the bf16 kernels' tile constants and schedule (for the tests)
    "isl_flash_tile_consts": [_P],
    "isl_flash_tiles": [_I, _I, _I, _I, _I, _I, _P, _P, _P],
}
_HEAD_DIMS = (128,)
_NEG = -1e30


# ------------------------------------------ tile schedules of the bf16 path
# Mirror of namespace wg of csrc/flash_attention.cu (held against it by
# tests/test_torch_cuda.py). A block has two consumer warpgroups, each
# owning half of the block's query rows (B5, B6) or keys (B7); a
# warpgroup computes one tile product for each tile it visits.

#: B5: query rows per block, per consumer warpgroup, keys per tile
FWD_BLOCK_Q, FWD_WG_Q, FWD_TILE_K = 128, 64, 128
#: B6: query rows per block, per consumer warpgroup, keys per tile
DQ_BLOCK_Q, DQ_WG_Q, DQ_TILE_K = 128, 64, 64
#: B7: keys per block, per consumer warpgroup, query rows per tile
DKV_BLOCK_K, DKV_WG_K, DKV_TILE_Q = 128, 64, 64
#: depth of each kernel's shared-memory ring of tiles
FWD_STAGES, DQ_STAGES, DKV_STAGES = 3, 4, 3


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fwd_wg_tiles(S: int, KV: int, causal: bool, y: int, w: int):
    """B5 block ``y``, consumer warpgroup ``w``: ``(query tile, first key
    tile, number of key tiles)`` it computes on; causal blocks take the
    longest query tiles first and stop at the diagonal tile; a
    warpgroup whose rows all lie past S computes nothing."""
    nq, nk = _cdiv(S, FWD_BLOCK_Q), _cdiv(KV, FWD_TILE_K)
    qi = nq - 1 - y if causal else y
    count = min(nk, qi + 1) if causal else nk
    live = qi * FWD_BLOCK_Q + w * FWD_WG_Q < S
    return qi, 0, count if live else 0


def dq_wg_tiles(S: int, KV: int, causal: bool, y: int, w: int):
    """B6 block ``y``, consumer warpgroup ``w``: ``(query tile, first key
    tile, number of key tiles)`` it computes on. Causal blocks take the
    longest query tiles first; each warpgroup stops at the key tile that
    holds its own diagonal (with 64-key tiles the block's first
    warpgroup needs one tile fewer than its second); a warpgroup whose
    rows all lie past S computes nothing."""
    nq, nk = _cdiv(S, DQ_BLOCK_Q), _cdiv(KV, DQ_TILE_K)
    qi = nq - 1 - y if causal else y
    row0 = qi * DQ_BLOCK_Q + w * DQ_WG_Q
    count = min(nk, _cdiv(row0 + DQ_WG_Q, DQ_TILE_K)) if causal else nk
    return qi, 0, count if row0 < S else 0


def dkv_wg_tiles(S: int, KV: int, causal: bool, kj: int, w: int):
    """B7 key block ``kj``, consumer warpgroup ``w``: ``(first query tile,
    number of query tiles)`` it computes on: from its diagonal tile when
    causal (earlier tiles see none of its keys), none when its keys all
    lie past KV."""
    nq = _cdiv(S, DKV_TILE_Q)
    first = (kj * DKV_BLOCK_K + w * DKV_WG_K) // DKV_TILE_Q if causal else 0
    live = kj * DKV_BLOCK_K + w * DKV_WG_K < KV
    return first, nq - first if live else 0


def fwd_tiles(S: int, KV: int, causal: bool):
    """Every product B5 computes, as ``((q_lo, q_hi), (k_lo, k_hi))``
    row and key ranges (before clipping to S and KV)."""
    out = []
    for y in range(_cdiv(S, FWD_BLOCK_Q)):
        for w in range(FWD_BLOCK_Q // FWD_WG_Q):
            qi, first, count = fwd_wg_tiles(S, KV, causal, y, w)
            q_lo = qi * FWD_BLOCK_Q + w * FWD_WG_Q
            for j in range(first, first + count):
                out.append(((q_lo, q_lo + FWD_WG_Q),
                            (j * FWD_TILE_K, (j + 1) * FWD_TILE_K)))
    return out


def dq_tiles(S: int, KV: int, causal: bool):
    """Every product B6 computes, as ``((q_lo, q_hi), (k_lo, k_hi))``."""
    out = []
    for y in range(_cdiv(S, DQ_BLOCK_Q)):
        for w in range(DQ_BLOCK_Q // DQ_WG_Q):
            qi, first, count = dq_wg_tiles(S, KV, causal, y, w)
            q_lo = qi * DQ_BLOCK_Q + w * DQ_WG_Q
            for j in range(first, first + count):
                out.append(((q_lo, q_lo + DQ_WG_Q),
                            (j * DQ_TILE_K, (j + 1) * DQ_TILE_K)))
    return out


def dkv_tiles(S: int, KV: int, causal: bool):
    """Every product B7 computes, as ``((q_lo, q_hi), (k_lo, k_hi))``."""
    out = []
    for kj in range(_cdiv(KV, DKV_BLOCK_K)):
        for w in range(DKV_BLOCK_K // DKV_WG_K):
            first, count = dkv_wg_tiles(S, KV, causal, kj, w)
            k_lo = kj * DKV_BLOCK_K + w * DKV_WG_K
            for i in range(first, first + count):
                out.append(((i * DKV_TILE_Q, (i + 1) * DKV_TILE_Q),
                            (k_lo, k_lo + DKV_WG_K)))
    return out


# ----------------------------------------------------------- plain versions

def _scores(q, k, causal: bool, scale_q: bool):
    """fp32 logits (BH, S, KV) with masked entries at -1e30: q scaled
    before the product (the forward) or the product scaled (the
    backward), as the TPU bodies do."""
    hd = q.shape[-1]
    sm = hd ** -0.5
    if scale_q:
        s = torch.matmul(q.float() * sm, k.float().transpose(1, 2))
    else:
        s = sm * torch.matmul(q.float(), k.float().transpose(1, 2))
    if causal:
        S, KV = q.shape[1], k.shape[1]
        keep = (torch.arange(KV, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
        s = torch.where(keep, s, torch.full_like(s, _NEG))
    return s


def flash_fwd_ref(q, k, v, causal: bool):
    """Plain B5: ``(o, lse)`` for (BH, S, hd) q and (BH, KV, hd) k, v;
    o in q's dtype, lse (BH, S) fp32."""
    s = _scores(q, k, causal, scale_q=True)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.matmul(p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _p_ds(q, k, v, do, lse, delta, causal: bool):
    """Recomputed probabilities p = exp(s - lse) and ds = p * (dp -
    delta), both fp32 (BH, S, KV)."""
    p = torch.exp(_scores(q, k, causal, scale_q=False) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_ref(q, k, v, do, lse, delta, causal: bool):
    """Plain B6: dq (BH, S, hd) in q's dtype."""
    _, ds = _p_ds(q, k, v, do, lse, delta, causal)
    sm = q.shape[-1] ** -0.5
    return (sm * torch.matmul(ds, k.float())).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal: bool):
    """Plain B7: ``(dk, dv)`` (BH, KV, hd) in k's and v's dtypes."""
    p, ds = _p_ds(q, k, v, do, lse, delta, causal)
    sm = q.shape[-1] ** -0.5
    dv = torch.matmul(p.transpose(1, 2), do.float())
    dk = sm * torch.matmul(ds.transpose(1, 2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _xla_attention(q, k, v, causal: bool):
    """The reference's plain formulation (``flash_attention.py:53-70``)
    over (B, S, H, hd): fp32 logits, the cropped-query causal mask (query
    row i sits at absolute position i + KV - S), probabilities cast to
    v's dtype before the value product."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        hd ** -0.5)
    if causal:
        S, KV = q.shape[1], k.shape[1]
        keep = (torch.arange(S, device=q.device)[:, None] + (KV - S)
                >= torch.arange(KV, device=q.device)[None, :])
        logits = torch.where(keep, logits, torch.full_like(logits, _NEG))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(v.dtype)


# ------------------------------------------------------------- the wrappers

def _check_qkv(what: str, q, k, v, causal: bool) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"{what}: q (BH, S, hd), k and v (BH, KV, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError(f"{what}: empty sequence")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"{what}: causal attention needs S == kv_len (got "
                         f"{q.shape[1]} and {k.shape[1]})")


def _check_cuda(what: str, tensors, rows) -> tuple:
    """Device, dtype code and layout checks for a launch; ``rows`` are the
    fp32 (BH, S) row statistics."""
    dev = build.require_cuda(what, *tensors, *rows)
    q = tensors[0]
    code = build.dtype_code(q, what)
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{what}: q, k, v (and do) must share one dtype")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{what}: head dim {q.shape[-1]} not built "
                         f"({_HEAD_DIMS})")
    if q.shape[0] > 65535:
        raise ValueError(f"{what}: B*H = {q.shape[0]} > 65535")
    for t in (*tensors, *rows):
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: storage must be 16-byte aligned")
    for t in rows:
        if t.dtype != torch.float32 or t.shape != q.shape[:2]:
            raise TypeError(f"{what}: lse and delta must be (BH, S) float32")
    return dev, code


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True):
    """B5: ``(o (BH, S, hd) in q's dtype, lse (BH, S) fp32)``."""
    what = "flash_fwd"
    _check_qkv(what, q, k, v, causal)
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal)
    dev, code = _check_cuda(what, (q, k, v), ())
    BH, S, hd = q.shape
    lib = build.library("flash_attention", _SIGNATURES)
    o = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=dev)
    rc = lib.isl_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), lse.data_ptr(), code, BH, S,
                           k.shape[1], hd, int(causal), hd ** -0.5,
                           build.stream_handle(dev))
    build.check_launch(rc, what)
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True):
    """B6: dq (BH, S, hd) in q's dtype."""
    what = "flash_bwd_dq"
    _check_qkv(what, q, k, v, causal)
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, causal)
    dev, code = _check_cuda(what, (q, k, v, do), (lse, delta))
    BH, S, hd = q.shape
    lib = build.library("flash_attention", _SIGNATURES)
    dq = torch.empty_like(q)
    rc = lib.isl_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              do.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), dq.data_ptr(), code, BH, S,
                              k.shape[1], hd, int(causal), hd ** -0.5,
                              build.stream_handle(dev))
    build.check_launch(rc, what)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """B7: ``(dk, dv)`` (BH, KV, hd) in the input dtype."""
    what = "flash_bwd_dkv"
    _check_qkv(what, q, k, v, causal)
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal)
    dev, code = _check_cuda(what, (q, k, v, do), (lse, delta))
    BH, S, hd = q.shape
    lib = build.library("flash_attention", _SIGNATURES)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = lib.isl_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               do.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(), code, BH, S, k.shape[1], hd,
                               int(causal), hd ** -0.5,
                               build.stream_handle(dev))
    build.check_launch(rc, what)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention over (BH, S, hd) with the blockwise backward: nothing
    (S, S) is saved, p is recomputed from (q, k, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention over (B, S, H, hd) q and (B, KV, H, hd) k, v, flash-style
    (forward B5, backward B6 + B7); matches :func:`_xla_attention` up to
    fp32 summation order."""
    B, S, H, hd = q.shape
    KV = k.shape[1]

    def heads_major(t, n):
        return t.transpose(1, 2).reshape(B * H, n, hd).contiguous()

    out = FlashAttention.apply(heads_major(q, S), heads_major(k, KV),
                               heads_major(v, KV), causal)
    return out.reshape(B, H, S, hd).transpose(1, 2)
