"""int8-weight x float-activation matmul (w8a16), by hand for Hopper.

Port of ``instaslice_tpu/ops/quant_matmul.py``. Three wrappers, two CUDA
kernels (``csrc/quant_matmul.cu``):

- :func:`quant_matmul_stacked` replaces ``_qmm_stacked_kernel``
  (``quant_matmul.py:138``): ``x @ q3[layer]`` for the stacked
  ``(L, K, N)`` projections, the layer picked by a pointer offset so the
  stack is never sliced or copied (the reason the TPU kernel exists);
- :func:`quant_matmul` replaces ``_qmm_kernel`` (``:66``): the same CUDA
  kernel on an unstacked ``(K, N)`` weight (layer stride 0);
- :func:`quant_matmul_t` replaces ``_qmm_t_kernel`` (``:89``): the
  ``(N, K)`` embedding table used as the unembedding.

All three: exact int8 -> fp32 convert, fp32 accumulation, the fp32
per-output-channel scale applied once to the finished sum
(``quant_matmul.py:10-15``). Bound on the H100: the int8 weight bytes
(decode row counts do ~M operations per weight byte). The design notes
are in the CUDA source. The TPU-only tiling fallbacks (``N % 128``, the
VMEM budget, ``quant_matmul.py:216-224,282-292``) have no counterpart:
the CUDA kernels mask ragged edges.

Each wrapper takes its plain version (``*_ref``) only for CPU tensors;
for CUDA tensors it launches the kernel or raises, and counts the
launch in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from instaslice_tpu_torch.ops import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "isl_qmm_kn": [_P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
    "isl_qmm_nk": [_P, _I, _P, _P, _I, _P, _I, _I, _I, _P],
}

# kernel tiling (csrc/quant_matmul.cu): rows of x and columns of q per
# block of the (K, N) kernel
_KN_MT, _KN_NT = 8, 256


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


def _split_k(M: int, K: int, N: int, device: torch.device):
    """(k_len, splits): split K across blocks until the grid holds about
    two blocks per SM, keeping at least 64 rows per split."""
    tiles = math.ceil(M / _KN_MT) * math.ceil(N / _KN_NT)
    want = math.ceil(2 * _sm_count(device.index or 0) / tiles)
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


def _launch_kn(what, x, q_ptr, s, s_ptr, M, K, N):
    dev = x.device
    lib = build.library("quant_matmul", _SIGNATURES)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    k_len, splits = _split_k(M, K, N, dev)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=dev)
            if splits > 1 else out)
    rc = lib.isl_qmm_kn(
        x.data_ptr(), build.dtype_code(x, what), q_ptr, s_ptr,
        build.dtype_code(s, what), out.data_ptr(), part.data_ptr(),
        M, K, N, k_len, splits, build.stream_handle(dev),
    )
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
    out = _launch_kn(
        what, x, q3.data_ptr() + layer * K * N, s3,
        s3.data_ptr() + layer * N * s3.element_size(), x.shape[0], K, N,
    )
    quant_matmul_stacked.launches += 1
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
    out = _launch_kn(what, x, q.data_ptr(), s, s.data_ptr(),
                     x.shape[0], K, N)
    quant_matmul.launches += 1
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
    dev = build.require_cuda(what, x, q, s)
    _check_common(what, x, q, s, K, N)
    if s.numel() != N:
        raise ValueError(f"{what}: scale has {s.numel()} elements, "
                         f"want N = {N}")
    M = x.shape[0]
    lib = build.library("quant_matmul", _SIGNATURES)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    rc = lib.isl_qmm_nk(
        x.data_ptr(), build.dtype_code(x, what), q.data_ptr(),
        s.data_ptr(), build.dtype_code(s, what), out.data_ptr(), M, K, N,
        build.stream_handle(dev),
    )
    build.check_launch(rc, what)
    quant_matmul_t.launches += 1
    return out


quant_matmul_t.launches = 0
