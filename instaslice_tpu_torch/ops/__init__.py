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
them.
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


__all__ = ["KERNEL_WRAPPERS", "launch_counts", "reset_launch_counts"]
