"""Moves a JAX-package parameter tree into the port, and back.

The input is the JAX package's tree after ``jax.device_get``: nested
dicts of numpy arrays (``ml_dtypes.bfloat16`` included) and
``QuantizedTensor`` nodes holding numpy ``q`` and ``s`` and
``Int4Tensor`` nodes holding numpy ``p`` and ``s`` (with their ``group``
and ``pack_axis``). The output is
the port's tree in the SAME layout (per-layer leaves ``(L, ...)``,
projections ``(in, out)``, embedding ``(V, D)``, fp32 norm scales), so
no transpose hides in the bridge, and the round trip is bit-exact.
LoRA adapter trees (``init_lora``) and multi-LoRA stacks
(``stack_adapters``, their ``scales`` included) are plain dicts of
arrays and cross the same way.

``torch.from_numpy`` rejects ml_dtypes' bfloat16, so bf16 arrays cross
as their uint16 bit patterns (``.view(np.uint16)`` ->
``torch.from_numpy`` -> ``.view(torch.bfloat16)``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from instaslice_tpu_torch import resolve_device
from instaslice_tpu_torch.models.quant import Int4Tensor, QuantizedTensor


def _to_torch(a, device: torch.device) -> torch.Tensor:
    # a writable C-ordered copy: arrays from jax.device_get are read-only
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree: Any, *, device="cuda") -> Any:
    """A JAX-package parameter tree (numpy leaves) -> the port's tree on
    ``device``. ``QuantizedTensor`` and ``Int4Tensor`` nodes become the
    port's :class:`QuantizedTensor` and :class:`Int4Tensor`."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        kind = type(node).__name__
        if kind == "QuantizedTensor":
            return QuantizedTensor(_to_torch(node.q, dev),
                                   _to_torch(node.s, dev))
        if kind == "Int4Tensor":
            return Int4Tensor(_to_torch(node.p, dev), _to_torch(node.s, dev),
                              int(node.group), int(node.pack_axis))
        return _to_torch(node, dev)

    return walk(tree)


def params_to_numpy(tree: Any) -> Any:
    """The port's tree -> numpy leaves (bf16 as ``ml_dtypes.bfloat16``);
    a :class:`QuantizedTensor` becomes its ``(q, s)`` pair, an
    :class:`Int4Tensor` its ``(p, s, group, pack_axis)``."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return (_to_numpy(tree.q), _to_numpy(tree.s))
    if isinstance(tree, Int4Tensor):
        return (_to_numpy(tree.p), _to_numpy(tree.s), tree.group,
                tree.pack_axis)
    return _to_numpy(tree)
