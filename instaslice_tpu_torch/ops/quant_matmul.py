"""int8-weight x float-activation matmul (w8a16), by hand for Hopper.

Port of ``instaslice_tpu/ops/quant_matmul.py``. Three wrappers over the
CUDA kernels of ``csrc/quant_matmul.cu``:

- :func:`quant_matmul_stacked` replaces ``_qmm_stacked_kernel``
  (``quant_matmul.py:138``): ``x @ q3[layer]`` for the stacked
  ``(L, K, N)`` projections, the layer picked by a pointer offset so the
  stack is never sliced or copied (the reason the TPU kernel exists);
- :func:`quant_matmul` replaces ``_qmm_kernel`` (``:66``): the same CUDA
  kernels on an unstacked ``(K, N)`` weight (layer stride 0);
- :func:`quant_matmul_t` replaces ``_qmm_t_kernel`` (``:89``): the
  ``(N, K)`` embedding table used as the unembedding.

All three convert int8 to x's dtype exactly, sum in fp32 and apply the
fp32 per-output-channel scale once to the finished sum
(``quant_matmul.py:10-15``). Bound on the H100: the int8 weight bytes at
every row count served here (M <= 256; the tensor cores' time passes the
bytes' only above M ~ 147, and stays within 2x of it at 256).

Routing, by dtype and shape (:func:`route`; no route is a fallback for
another):

- bf16 ``x`` with 16-byte-aligned rows (``N % 16 == 0`` and ``K % 8 ==
  0`` for ``(K, N)``; ``K % 16 == 0`` for ``(N, K)``) and ``M <= 256``
  takes the tensor-core kernel: int8 -> bf16 in registers, ``mma.sync``
  with fp32 sums, a ``cp.async`` ring of int8 tiles, one pass over the
  weight whatever M is (the grid has channel tiles and K splits, no M
  dimension). :func:`plan` picks the tile by M and the K split by
  shape; a split's partial sums are added in split order by a second
  pass, so results are bit-equal from run to run;
- fp32 ``x`` (rounding it to bf16 would change the function), unaligned
  rows, or M > 256 take the masked CUDA-core kernels (exact int8 -> fp32,
  fp32 ``fmaf``), which tile M by 8 rows.

The design notes are in the CUDA source. The TPU-only tiling fallbacks
(``N % 128``, the VMEM budget, ``quant_matmul.py:216-224,282-292``) have
no counterpart: the CUDA kernels mask ragged edges.

Each wrapper takes its plain version (``*_ref``) only for CPU tensors;
for CUDA tensors it launches the kernel or raises, and counts the
launch in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from instaslice_tpu_torch.ops import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_TC = [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {
    "isl_qmm_kn": [_P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
    "isl_qmm_nk": [_P, _I, _P, _P, _I, _P, _I, _I, _I, _P],
    "isl_qmm_kn_tc": _TC,
    "isl_qmm_nk_tc": _TC,
    "isl_qmm_tc_tile": [_I, _I, _P, _P, _P, _P, _P, _P],
}

# masked CUDA-core kernel tiling (csrc/quant_matmul.cu): rows of x and
# columns of q per block of the (K, N) kernel
_KN_MT, _KN_NT = 8, 256

# tensor-core kernel (csrc/quant_matmul.cu, namespace tc): the step of a
# K split's length, and the most rows it takes
TC_K_STEP, TC_MAX_M = 128, 256
#: dynamic shared memory one block may request on the H100
SMEM_LIMIT = 232448
#: (largest M, warps over channels, warps over rows, 8-row tiles a warp,
#: k per ring stage, ring slots, bytes per microsecond one block streams):
#: the table ISL_TC_BY_M of the CUDA source for (K, N) and (N, K) weights,
#: and what ops/qmm_probe.py measured of each tile on an H100
_TC_TILES = {
    False: ((8, 4, 1, 1, 64, 4, 12.5e3), (16, 4, 1, 2, 64, 4, 12.5e3),
            (32, 4, 1, 4, 64, 4, 12.5e3), (64, 4, 1, 8, 64, 4, 12.5e3),
            (128, 8, 1, 16, 64, 4, 8.8e3), (256, 4, 2, 16, 64, 4, 4.4e3)),
    True: ((8, 4, 1, 1, 128, 4, 12.5e3), (16, 4, 1, 2, 128, 4, 12.5e3),
           (32, 4, 1, 4, 128, 3, 12.5e3), (64, 4, 1, 8, 128, 3, 12.5e3),
           (128, 8, 1, 16, 128, 3, 8.8e3), (256, 4, 2, 16, 64, 4, 4.4e3)),
}
# the planner's model of the card, from the same probe: bytes per
# microsecond the card streams in practice and the most one SM takes,
# and the microseconds a second pass costs beside its traffic
_CARD_B_PER_US, _SM_B_PER_US, _PASS2_US = 2.3e6, 19e3, 2.0


class Tile(NamedTuple):
    """What one block of the tensor-core kernel owns."""
    ct: int        # output channels
    mpad: int      # rows of x (M rounded up to the tile)
    threads: int
    smem: int      # dynamic shared memory, bytes
    kt: int        # k per ring stage
    stages: int    # ring slots
    rate: float    # bytes per microsecond one block streams (measured)


class Plan(NamedTuple):
    """One launch: ``entry`` is the C function; the tensor-core entries
    run ``tiles x splits`` blocks, each ``k_len`` deep in K."""
    entry: str
    tile: Tile | None
    k_len: int
    splits: int


def tc_tile(M: int, transposed: bool) -> Tile:
    """The tensor-core kernel's block tile at ``M`` rows."""
    for max_m, wc, wm, nt8, kt, stages, rate in _TC_TILES[bool(transposed)]:
        if M <= max_m:
            ct, mpad = 32 * wc, 8 * nt8 * wm
            w_bytes = ct * kt if transposed else kt * (ct + 16)
            return Tile(ct, mpad, 32 * wc * wm,
                        stages * (w_bytes + mpad * (2 * kt + 16)), kt, stages,
                        rate)
    raise ValueError(f"the tensor-core kernel takes M <= {TC_MAX_M}, got {M}")


def route(x_dtype: torch.dtype, M: int, K: int, N: int,
          transposed: bool) -> str:
    """``"tc"`` or ``"masked"``: which kernel a CUDA call takes (see the
    module docstring)."""
    if x_dtype != torch.bfloat16 or not 1 <= M <= TC_MAX_M:
        return "masked"
    aligned = (K % 16 == 0) if transposed else (N % 16 == 0 and K % 8 == 0)
    return "tc" if aligned else "masked"


def _split_tc(tile: Tile, M: int, K: int, N: int, sms: int):
    """(k_len, splits) for the tensor-core kernel: the split count with
    the least modelled time. The busiest SM holds ``ceil(blocks / sms)``
    blocks of ``ct x k_len`` bytes and streams them at what its resident
    blocks take together, up to an SM's share; the card as a whole
    streams no faster than its practical memory rate; a split adds its
    partial sums (written, then read by the second pass) and that pass's
    launch. Splits are multiples of ``TC_K_STEP`` long."""
    tiles = math.ceil(N / tile.ct)
    per_sm = max(1, min(SMEM_LIMIT // tile.smem, 2048 // tile.threads))
    best = None
    for want in range(1, max(1, K // TC_K_STEP) + 1):
        k_len = math.ceil(math.ceil(K / want) / TC_K_STEP) * TC_K_STEP
        splits = math.ceil(K / k_len)
        load = math.ceil(tiles * splits / sms)
        sm_rate = min(min(load, per_sm) * tile.rate, _SM_B_PER_US)
        cost = max(load * tile.ct * k_len / sm_rate, K * N / _CARD_B_PER_US)
        if splits > 1:
            cost += 8 * splits * M * N / _CARD_B_PER_US + _PASS2_US
        if best is None or cost < best[0]:
            best = (cost, k_len, splits)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def plan(x_dtype: torch.dtype, M: int, K: int, N: int, transposed: bool,
         sms: int = 132) -> Plan:
    """How a CUDA call of these shapes is launched: a pure function of
    the shapes, the dtype of x and the SM count (cached: the engine asks
    for the same few shapes on every step)."""
    if route(x_dtype, M, K, N, transposed) == "tc":
        tile = tc_tile(M, transposed)
        k_len, splits = _split_tc(tile, M, K, N, sms)
        return Plan("isl_qmm_nk_tc" if transposed else "isl_qmm_kn_tc",
                    tile, k_len, splits)
    if transposed:
        return Plan("isl_qmm_nk", None, K, 1)
    k_len, splits = _split_k(M, K, N, sms)
    return Plan("isl_qmm_kn", None, k_len, splits)


def quant_matmul_ref(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                     transpose_w: bool = False) -> torch.Tensor:
    """Plain version of the kernels' math: exact int8 -> fp32, fp32
    accumulation, the per-output-channel scale on the finished sum.
    ``q`` is (K, N), or (N, K) with ``transpose_w``; ``s`` has N
    elements. Returns fp32 (M, N)."""
    w = q.float()
    acc = x.float() @ (w.t() if transpose_w else w)
    return acc * s.float().reshape(1, -1)


def quant_matmul_t_ref(x, q, s) -> torch.Tensor:
    return quant_matmul_ref(x, q, s, transpose_w=True)


def quant_matmul_stacked_ref(x, q3, s3, layer: int) -> torch.Tensor:
    return quant_matmul_ref(x, q3[layer], s3[layer])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_k(M: int, K: int, N: int, sms: int):
    """(k_len, splits) of the masked (K, N) kernel: split K across
    blocks until the grid holds about two blocks per SM, keeping at
    least 64 rows per split."""
    tiles = math.ceil(M / _KN_MT) * math.ceil(N / _KN_NT)
    want = math.ceil(2 * sms / tiles)
    splits = max(1, min(want, math.ceil(K / 64)))
    k_len = math.ceil(math.ceil(K / splits) / 8) * 8
    return k_len, math.ceil(K / k_len)


def _check_common(what, x, q, s, K, N):
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, "
                         f"weight K={K}")
    if q.dtype != torch.int8:
        raise TypeError(f"{what}: weight must be int8, got {q.dtype}")
    for name, t in (("x", x), ("q", q), ("s", s)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q.data_ptr() % 16:
        raise ValueError(f"{what}: weight storage must be 16-byte aligned")


def _launch(what, x, q_ptr, s, s_ptr, M, K, N, transposed):
    """Plan and launch one product; returns fp32 (M, N)."""
    dev = x.device
    lib = build.library("quant_matmul", _SIGNATURES)
    p = plan(x.dtype, M, K, N, transposed, _sm_count(dev.index or 0))
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    part = (torch.empty((p.splits, M, N), dtype=torch.float32, device=dev)
            if p.splits > 1 else out)
    s_code = build.dtype_code(s, what)
    stream = build.stream_handle(dev)
    if p.tile is not None:
        rc = getattr(lib, p.entry)(
            x.data_ptr(), q_ptr, s_ptr, s_code, out.data_ptr(),
            part.data_ptr(), M, K, N, p.k_len, p.splits, stream)
    elif transposed:
        rc = lib.isl_qmm_nk(
            x.data_ptr(), build.dtype_code(x, what), q_ptr, s_ptr, s_code,
            out.data_ptr(), M, K, N, stream)
    else:
        rc = lib.isl_qmm_kn(
            x.data_ptr(), build.dtype_code(x, what), q_ptr, s_ptr, s_code,
            out.data_ptr(), part.data_ptr(), M, K, N, p.k_len, p.splits,
            stream)
    build.check_launch(rc, what)
    return out


def quant_matmul_stacked(x: torch.Tensor, q3: torch.Tensor,
                         s3: torch.Tensor, layer: int) -> torch.Tensor:
    """``x @ dequant(q3[layer], s3[layer])`` -> fp32 (M, N) without
    slicing the stack. ``q3``: (L, K, N) int8; ``s3``: (L, 1, N) scales
    (fp32 or bf16); ``x``: (M, K) fp32 or bf16."""
    L, K, N = q3.shape
    if x.device.type == "cpu":
        if x.dim() != 2 or x.shape[1] != K:
            raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, "
                             f"weight K={K}")
        return quant_matmul_stacked_ref(x, q3, s3, layer)
    what = "quant_matmul_stacked"
    build.require_cuda(what, x, q3, s3)
    _check_common(what, x, q3, s3, K, N)
    if s3.numel() != L * N:
        raise ValueError(f"{what}: scale has {s3.numel()} elements, "
                         f"want L*N = {L * N}")
    if not 0 <= layer < L:
        raise IndexError(f"{what}: layer {layer} out of range [0, {L})")
    out = _launch(
        what, x, q3.data_ptr() + layer * K * N, s3,
        s3.data_ptr() + layer * N * s3.element_size(), x.shape[0], K, N,
        False,
    )
    quant_matmul_stacked.launches += build.launched()
    return out


quant_matmul_stacked.launches = 0


def quant_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                 transpose_w: bool = False) -> torch.Tensor:
    """``x @ dequant(q, s)`` -> fp32 (M, N). ``q``: (K, N) int8, or
    (N, K) with ``transpose_w=True`` (routed to :func:`quant_matmul_t`);
    ``s``: N per-output-channel scales."""
    if transpose_w:
        return quant_matmul_t(x, q, s)
    K, N = q.shape
    if x.device.type == "cpu":
        if x.dim() != 2 or x.shape[1] != K:
            raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, "
                             f"weight K={K}")
        return quant_matmul_ref(x, q, s)
    what = "quant_matmul"
    build.require_cuda(what, x, q, s)
    _check_common(what, x, q, s, K, N)
    if s.numel() != N:
        raise ValueError(f"{what}: scale has {s.numel()} elements, "
                         f"want N = {N}")
    out = _launch(what, x, q.data_ptr(), s, s.data_ptr(), x.shape[0], K, N,
                  False)
    quant_matmul.launches += build.launched()
    return out


quant_matmul.launches = 0


def quant_matmul_t(x: torch.Tensor, q: torch.Tensor,
                   s: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(q, s)ᵀ`` -> fp32 (M, N) for the (N, K) layout (the
    embedding table as the unembedding); ``s`` holds N per-row
    scales."""
    N, K = q.shape
    if x.device.type == "cpu":
        if x.dim() != 2 or x.shape[1] != K:
            raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, "
                             f"weight K={K}")
        return quant_matmul_t_ref(x, q, s)
    what = "quant_matmul_t"
    build.require_cuda(what, x, q, s)
    _check_common(what, x, q, s, K, N)
    if s.numel() != N:
        raise ValueError(f"{what}: scale has {s.numel()} elements, "
                         f"want N = {N}")
    out = _launch(what, x, q.data_ptr(), s, s.data_ptr(), x.shape[0], K, N,
                  True)
    quant_matmul_t.launches += build.launched()
    return out


quant_matmul_t.launches = 0
