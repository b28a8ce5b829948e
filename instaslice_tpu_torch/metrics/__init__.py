"""Prometheus metrics of the port's serving plane and node agent
(copied from ``instaslice_tpu/metrics``)."""

from instaslice_tpu_torch.metrics.metrics import (  # noqa: F401
    OperatorMetrics,
    ServingMetrics,
    start_metrics_server,
)
