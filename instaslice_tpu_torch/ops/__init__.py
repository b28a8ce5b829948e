"""Hand-written CUDA kernels for Hopper, each beside its plain version.

One wrapper per TPU kernel of the JAX package:

==========================================  =================================
wrapper                                     replaces (instaslice_tpu/ops/...)
==========================================  =================================
flash_decode.quant_decode_attention         flash_decode.py:59 ``_fd_kernel``
quant_matmul.quant_matmul_stacked           quant_matmul.py:138
                                            ``_qmm_stacked_kernel``
quant_matmul.quant_matmul_t                 quant_matmul.py:89 ``_qmm_t_kernel``
quant_matmul.quant_matmul                   quant_matmul.py:66 ``_qmm_kernel``
flash_attention.flash_fwd                   flash_attention.py:73
                                            ``_flash_kernel``
flash_attention.flash_bwd_dq                flash_attention.py:130
                                            ``_flash_bwd_dq_kernel``
flash_attention.flash_bwd_dkv               flash_attention.py:183
                                            ``_flash_bwd_dkv_kernel``
==========================================  =================================

Every wrapper counts its kernel launches in its ``launches`` attribute;
:func:`launch_counts` reads them and :func:`reset_launch_counts` zeroes
them. A wrapper called under a CUDA-graph capture counts nothing (the
capture records the launch; it does not make it), and a replay runs no
wrapper: :func:`trace_launch_counts` counts a replayed graph's launches
from a device trace of its kernels.
"""

from __future__ import annotations

from typing import Dict

from instaslice_tpu_torch.ops import flash_attention as _fa
from instaslice_tpu_torch.ops import flash_decode as _fd
from instaslice_tpu_torch.ops import quant_matmul as _qm

#: wrapper name -> wrapper, for every kernel of the port
KERNEL_WRAPPERS = {
    "quant_decode_attention": _fd.quant_decode_attention,
    "quant_matmul_stacked": _qm.quant_matmul_stacked,
    "quant_matmul_t": _qm.quant_matmul_t,
    "quant_matmul": _qm.quant_matmul,
    "flash_fwd": _fa.flash_fwd,
    "flash_bwd_dq": _fa.flash_bwd_dq,
    "flash_bwd_dkv": _fa.flash_bwd_dkv,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


#: how a device trace names the kernel each wrapper call launches first
#: (B1's split kernel before its combine, B2-B4's product before any
#: K-split reduction; B5-B7 in bf16, namespace ``wg``, and fp32): a piece
#: of the demangled name. B2 and B4 launch the same (K, N) product
#: kernels, which a trace cannot tell apart: the caller names the one
#: its path runs
TRACE_NAMES = {
    "quant_decode_attention": ("::fd_kernel<",),
    "(K, N)": ("qmm_tc_kernel<false", "qmm_kn_kernel<"),
    "quant_matmul_t": ("qmm_tc_kernel<true", "qmm_nk_kernel<"),
    "flash_fwd": ("fa_fwd_kernel", "wg::fwd_kernel"),
    "flash_bwd_dq": ("fa_bwd_dq_kernel", "wg::dq_kernel"),
    "flash_bwd_dkv": ("fa_bwd_dkv_kernel", "wg::dkv_kernel"),
}


def trace_launch_counts(kernels, kn: str = "quant_matmul_stacked"
                        ) -> Dict[str, int]:
    """Launches by wrapper name from a device trace: ``kernels`` yields
    (name, count) for each kernel the card ran (``torch.profiler``'s
    ``key_averages()`` rows of device type CUDA). The (K, N) products
    count for ``kn``: B2 (``quant_matmul_stacked``) on every path but
    the mixture-of-experts engine's, whose attention projections are B4
    (``quant_matmul``) and where B2 is gated off."""
    out = dict.fromkeys(KERNEL_WRAPPERS, 0)
    for name, n in kernels:
        for wrapper, pieces in TRACE_NAMES.items():
            if any(p in name for p in pieces):
                out[kn if wrapper == "(K, N)" else wrapper] += n
                break
    return out


__all__ = ["KERNEL_WRAPPERS", "TRACE_NAMES", "launch_counts",
           "reset_launch_counts", "trace_launch_counts"]
