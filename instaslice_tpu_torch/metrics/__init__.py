"""Prometheus metrics of the port's serving plane (copied from
``instaslice_tpu/metrics``)."""

from instaslice_tpu_torch.metrics.metrics import (  # noqa: F401
    ServingMetrics,
    start_metrics_server,
)
