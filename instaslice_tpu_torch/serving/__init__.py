"""Serving stack of the port: the slot engine, sampling and KV accounting."""

from instaslice_tpu_torch.serving.engine import (
    AdmissionRequest,
    GenerationResult,
    ServingEngine,
)

__all__ = ["AdmissionRequest", "GenerationResult", "ServingEngine"]
