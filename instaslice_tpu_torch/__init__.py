"""PyTorch/CUDA port of the ``instaslice_tpu`` serving stack for an NVIDIA
H100 (Hopper, ``sm_90a``).

The JAX package ``instaslice_tpu`` stays the reference; this package
mirrors its layout (``models/lm.py``, ``models/quant.py``,
``ops/flash_decode.py``, ``ops/quant_matmul.py``, ``serving/...``) so
counterparts are easy to find, and imports nothing of it (nor JAX).
Every TPU kernel on the ported path is a hand-written CUDA kernel under
``csrc/`` with a plain PyTorch version beside it (``ops/``).

Entry points run on the card unless the caller passes ``device="cpu"``;
with no card the default raises instead of dropping to the CPU.

Importing the package loads neither torch nor numpy: the control plane
(the controller, the node agent, the device plugin, the telemetry
aggregator and the operator CLI) runs without them, as the reference's
runs without JAX, so its images carry no PyTorch. The data plane (the
models, the engine, the server, the ops) imports torch itself, and
:func:`resolve_device` imports it when it is called.
"""

from __future__ import annotations

#: the project's version, the reference's (``instaslice_tpu/__init__.py``)
__version__ = "0.1.0"

# the gate, finalizer and resource names, re-exported as the reference
# re-exports them (``instaslice_tpu/__init__.py``); NVIDIA's whole-GPU
# resource stands where its TPU one does
from instaslice_tpu_torch.api.constants import (  # noqa: F401,E402
    API_VERSION,
    FINALIZER,
    GATE_NAME,
    GPU_RESOURCE,
    GROUP,
    KIND,
    LEGACY_GATE_NAME,
    PLURAL,
    POD_RESOURCE_PREFIX,
    VERSION,
)


def resolve_device(device="cuda") -> "torch.device":
    """``device`` as a :class:`torch.device`; raises for a CUDA device
    when no card is present (never a silent fall back to the CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions"
            )
        if dev.index is None:      # "cuda" and "cuda:0" name one card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
