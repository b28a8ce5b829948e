"""What the observability gates' drives share: the port's tiny serving
model (the reference's CPU sizes: ``vocab 64, d_model 32, 2 heads, 2
layers, d_ff 64``, float32, seeded random weights) in a
:class:`~instaslice_tpu_torch.serving.ServingEngine` on ``device``, and
the sim's single H100 80GB node with MIG on, where a ``1g.10gb`` slice
stands for the reference's ``v5e-1x1``."""

from __future__ import annotations

#: the MIG profile a drive's pods ask for
PROFILE = "1g.10gb"


def tiny_engine(device: str, d_model: int = 32, d_ff: int = 64,
                max_batch: int = 4, seed: int = 0, max_len: int = 64):
    """The engine on ``device`` (``"cuda"`` raises without a card)."""
    import torch

    from instaslice_tpu_torch import resolve_device
    from instaslice_tpu_torch.models.lm import (
        ModelConfig,
        TpuLM,
        init_params,
    )
    from instaslice_tpu_torch.serving import ServingEngine

    dev = resolve_device(device)
    cfg = ModelConfig(vocab_size=64, d_model=d_model, n_heads=2, n_layers=2,
                      d_ff=d_ff, dtype=torch.float32, remat=False)
    return ServingEngine(TpuLM(cfg), init_params(cfg, seed, device=dev),
                         device=dev, max_batch=max_batch, max_len=max_len,
                         prefill_len=8)


def sim_cluster(**kw):
    """One H100 80GB node, one GPU, MIG on, the reference drives' grace."""
    from instaslice_tpu_torch.sim import SimCluster
    from instaslice_tpu_torch.topology import mig

    kw.setdefault("deletion_grace_seconds", 0.2)
    return SimCluster(n_nodes=1, generation=mig.H100_80GB, gpus_per_node=1,
                      mig=True, **kw)
