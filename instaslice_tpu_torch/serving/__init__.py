"""Serving stack of the port: the slot engine with its radix prefix
cache, sampling, KV accounting, the continuous scheduler and the HTTP
server (``python -m instaslice_tpu_torch.serving.api_server``)."""

from instaslice_tpu_torch.serving.engine import (
    AdmissionRequest,
    GenerationResult,
    ServingEngine,
)

__all__ = ["AdmissionRequest", "GenerationResult", "ServingEngine"]
