"""Decode attention over the stacked int8 KV cache, by hand for Hopper.

Port of ``instaslice_tpu/ops/flash_decode.py``: :func:`quant_decode_attention`
replaces the Pallas kernel ``_fd_kernel`` (``flash_decode.py:59``) with
``csrc/flash_decode.cu``. For ONE query step (T = 1) the G query rows of
every (batch row, KV head) attend layer ``layer`` of the head-major
cache ``(L, B, Hkv, S, hd)`` over the positions ``s < min(lengths[b],
s_attn)``; the result is the unnormalized fp32 accumulator and the
running max ``m`` and sum ``l``, which :func:`merge_local` (plain torch,
as it is XLA code outside the kernel in the JAX package) folds together
with the step's own fresh entry.

Bound on the H100: the bytes of the live int8 K/V prefix and its fp32
scales. The layer index is a pointer offset into the stacked buffer, so
no slice of the cache is ever copied (``flash_decode.py:13-26``). The
prefix is split across blocks: the grid is (B, Hkv, n_split), block z
taking positions ``[z P, (z + 1) P)`` of its row's live prefix, with P
and n_split from host-known values only (:func:`split_plan`); a second
kernel combines the splits' partials in split order
(:func:`combine_partials` is its plain mirror). See the CUDA source for
the rest of the design.

Conventions that differ from the TPU kernel: ``m`` and ``l`` come back
as ``(B, Hkv, G)`` (the 8-lane broadcast is a TPU tiling rule), and a
row with no admitted position returns ``m = -1e30, l = 0, acc = 0``
where the TPU kernel, which runs masked tiles, returns ``l`` = the tile
width. :func:`merge_local` gives the same result for both (its
``alpha = exp(-1e30 - lg)`` is 0), so hold the two packages to each
other through the merged output, never through raw ``l``.
"""

from __future__ import annotations

import ctypes

import torch

from instaslice_tpu_torch.ops import build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "isl_flash_decode": [
        _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
        _I, _I, _I, _I, _I, _L, _L, _L, _L, _I, _I, ctypes.c_float, _P,
    ],
    # the split plan of the CUDA source: (P, n_split)
    "isl_fd_plan": [_I, _I, _I, _P, _P],
}
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)
_NEG = -1e30

# ------------------------------------------------- the split of the prefix
# Plain mirrors of fd_plan and fd_combine_kernel in csrc/flash_decode.cu,
# for the tests (the plan is held against the kernel's by
# tests/test_torch_cuda.py); the wrapper asks the CUDA source for its plan.

#: positions per block are a multiple of SPLIT_TILE, at most
#: SPLIT_MAX_TILES of them; the grid aims at SPLIT_TARGET_BLOCKS blocks
SPLIT_TILE, SPLIT_MAX_TILES, SPLIT_TARGET_BLOCKS = 64, 4, 512


def split_plan(B: int, Hkv: int, s_attn: int):
    """``(P, n_split)``: block z of each (batch row, KV head) takes the
    positions ``[z P, (z + 1) P)`` of ``[0, s_attn)``. From host-known
    values only (never ``lengths``): the smallest multiple of 64 that
    keeps the grid within ``SPLIT_TARGET_BLOCKS`` blocks, at most 256."""
    tiles = -(-s_attn // SPLIT_TILE)
    per = -(-tiles * B * Hkv // SPLIT_TARGET_BLOCKS)
    P = SPLIT_TILE * min(max(per, 1), SPLIT_MAX_TILES)
    return P, -(-s_attn // P)


def combine_partials(part):
    """Plain mirror of the kernels' combine: the partials ``part`` (B,
    Hkv, n_split, G, hd + 2) fp32 (acc, then m and l, per split) ->
    ``(acc, m, l)`` with m the largest of the splits' maxima and acc and
    l summed split by split in order, each split rescaled by
    ``exp(m_z - m)`` (empty splits: m_z = -1e30, l_z = 0, acc_z = 0)."""
    hd = part.shape[-1] - 2
    m = part[..., hd].amax(dim=2)
    acc = torch.zeros_like(part[:, :, 0, :, :hd])
    l = torch.zeros_like(m)
    for z in range(part.shape[2]):
        w = torch.exp(part[:, :, z, :, hd] - m)
        acc = acc + part[:, :, z, :, :hd] * w[..., None]
        l = l + part[:, :, z, :, hd + 1] * w
    return acc, m, l


def quant_decode_attention_ref(q4, k3, ks3, v3, vs3, lengths, layer: int,
                               s_attn: int):
    """Plain version: fp32, masked joint softmax over the dequantized
    prefix, returned as the kernel's ``(acc, m, l)`` (rows with no
    admitted position: ``m = -1e30``, ``l = 0``, ``acc = 0``)."""
    hd = q4.shape[-1]
    sm = hd ** -0.5
    k = k3[layer, :, :, :s_attn].float() * ks3[layer, :, :, :s_attn, None]
    v = v3[layer, :, :, :s_attn].float() * vs3[layer, :, :, :s_attn, None]
    s = torch.einsum("bkgd,bksd->bkgs", q4.float() * sm, k)
    pos = torch.arange(s.shape[-1], device=q4.device)
    mask = pos[None, None, None, :] < lengths.to(q4.device)[
        :, None, None, None]
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    return torch.einsum("bkgs,bksd->bkgd", p, v), m, p.sum(dim=-1)


def merge_local(o, m, l, lg_l, v_local):
    """Online-softmax merge of the prefix partials with the current
    step's single local entry (logit ``lg_l`` (B, Hkv, G), value
    ``v_local`` (B, Hkv, hd)) -> normalized fp32 (B, Hkv, G, hd): the
    joint softmax over (prefix ‖ local)."""
    m_tot = torch.maximum(m, lg_l)
    alpha = torch.exp(m - m_tot)
    beta = torch.exp(lg_l - m_tot)
    l_tot = l * alpha + beta
    num = o * alpha[..., None] + (
        v_local[:, :, None, :].float() * beta[..., None]
    )
    return num / l_tot[..., None]


def _inner_contiguous(t: torch.Tensor, n_inner: int) -> bool:
    """The last ``n_inner`` dims are laid out contiguously."""
    expect = 1
    for size, stride in zip(reversed(t.shape[-n_inner:]),
                            reversed(t.stride()[-n_inner:])):
        if size > 1 and stride != expect:
            return False
        expect *= size
    return True


def quant_decode_attention(q4: torch.Tensor, k3: torch.Tensor,
                           ks3: torch.Tensor, v3: torch.Tensor,
                           vs3: torch.Tensor, lengths: torch.Tensor,
                           layer: int, s_attn: int):
    """Prefix attention for one decode step over the stacked int8
    cache -> ``(acc (B, Hkv, G, hd), m (B, Hkv, G), l (B, Hkv, G))``,
    all fp32.

    ``q4``: (B, Hkv, G, hd) fp32 or bf16. ``k3``/``v3``: (L, B, Hkv, S,
    hd) int8; ``ks3``/``vs3``: (L, B, Hkv, S) fp32 (a slot subset of a
    larger cache is fine: only the (Hkv, S[, hd]) inner dims must be
    contiguous). ``lengths``: (B,) int32. ``s_attn``: the attend bound,
    ``<= S``."""
    B, Hkv, G, hd = q4.shape
    L, Bk, Hk, S, hdk = k3.shape
    if (Bk, Hk, hdk) != (B, Hkv, hd) or v3.shape != k3.shape:
        raise ValueError(f"cache {tuple(k3.shape)} / {tuple(v3.shape)} "
                         f"does not match q4 {tuple(q4.shape)}")
    if ks3.shape != k3.shape[:-1] or vs3.shape != ks3.shape:
        raise ValueError("scales must be (L, B, Hkv, S)")
    if not 0 < s_attn <= S:
        raise ValueError(f"s_attn={s_attn} must be in (0, {S}]")
    if not 0 <= layer < L:
        raise IndexError(f"layer {layer} out of range [0, {L})")
    if q4.device.type == "cpu":
        return quant_decode_attention_ref(q4, k3, ks3, v3, vs3, lengths,
                                          layer, s_attn)
    what = "quant_decode_attention"
    dev = build.require_cuda(what, q4, k3, ks3, v3, vs3, lengths)
    if hd not in _HEAD_DIMS or G not in _GROUPS:
        raise ValueError(f"{what}: head dim {hd} / group {G} not built "
                         f"(head dims {_HEAD_DIMS}, groups {_GROUPS})")
    if k3.dtype != torch.int8 or v3.dtype != torch.int8:
        raise TypeError(f"{what}: K/V cache must be int8")
    if ks3.dtype != torch.float32 or vs3.dtype != torch.float32:
        raise TypeError(f"{what}: K/V scales must be float32")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise TypeError(f"{what}: lengths must be (B,) int32")
    if not (q4.is_contiguous() and lengths.is_contiguous()):
        raise ValueError(f"{what}: q4 and lengths must be contiguous")
    if k3.stride() != v3.stride() or ks3.stride() != vs3.stride():
        raise ValueError(f"{what}: K and V must share one layout")
    if not (_inner_contiguous(k3, 3) and _inner_contiguous(ks3, 2)):
        raise ValueError(f"{what}: cache (Hkv, S, hd) dims must be "
                         "contiguous")
    if k3.data_ptr() % 16 or v3.data_ptr() % 16 or q4.data_ptr() % 16:
        raise ValueError(f"{what}: cache and q4 storage must be 16-byte "
                         "aligned")
    lib = build.library("flash_decode", _SIGNATURES)
    o = torch.empty((B, Hkv, G, hd), dtype=torch.float32, device=dev)
    m = torch.empty((B, Hkv, G), dtype=torch.float32, device=dev)
    l = torch.empty((B, Hkv, G), dtype=torch.float32, device=dev)
    P, n_split = ctypes.c_int(), ctypes.c_int()
    build.check_launch(lib.isl_fd_plan(B, Hkv, s_attn, ctypes.byref(P),
                                       ctypes.byref(n_split)), what)
    # the splits' partials, combined in split order by the second kernel
    part = torch.empty((B, Hkv, n_split.value, G, hd + 2),
                       dtype=torch.float32, device=dev)
    rc = lib.isl_flash_decode(
        q4.data_ptr(), build.dtype_code(q4, what), k3.data_ptr(),
        ks3.data_ptr(), v3.data_ptr(), vs3.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), part.data_ptr(),
        n_split.value, B, Hkv, G, S, hd,
        k3.stride(0), k3.stride(1), ks3.stride(0), ks3.stride(1),
        layer, s_attn, hd ** -0.5, build.stream_handle(dev),
    )
    build.check_launch(rc, what)
    quant_decode_attention.launches += 1
    return o, m, l


quant_decode_attention.launches = 0
