"""Node-agent process runner — the ``cmd/daemonset/main.go`` analog:
client resolution, device-backend selection, metrics server, health
probes, signal handling around the
:class:`~instaslice_tpu_torch.agent.reconciler.NodeAgent` (reference wiring:
``cmd/daemonset/main.go:55-168``). No leader election: exactly one agent
runs per node (DaemonSet), each keyed to its own CR.

A copy of ``instaslice_tpu/agent/runner.py`` (the port imports nothing
of the JAX package). ``from_args`` takes the port's
:func:`~instaslice_tpu_torch.device.select.select_backend`, whose
``auto`` is the NVML backend or an error."""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

from instaslice_tpu_torch.agent.reconciler import NodeAgent
from instaslice_tpu_torch.device.backend import DeviceBackend
from instaslice_tpu_torch.kube.client import KubeClient
from instaslice_tpu_torch.metrics.metrics import (
    EventMetrics,
    OperatorMetrics,
    start_metrics_server,
)
from instaslice_tpu_torch.obs import journal as obs_journal
from instaslice_tpu_torch.utils.probes import ProbeServer

log = logging.getLogger("instaslice_tpu_torch.agent.runner")


def _split_bind(bind_address: str) -> tuple:
    """(host, port) from ':8080' / '127.0.0.1:8080'. The host part is
    honored by the metrics server — the kube-rbac-proxy patch relies on a
    real 127.0.0.1 bind, not a cosmetic one."""
    host, _, port_s = bind_address.rpartition(":")
    try:
        return host, int(port_s)
    except ValueError:
        return host, 0


class AgentRunner:
    def __init__(
        self,
        client: KubeClient,
        backend: DeviceBackend,
        node_name: str,
        namespace: str = "instaslice-tpu-system",
        metrics_bind_address: str = ":8084",
        health_probe_bind_address: str = ":8085",
    ) -> None:
        self.metrics = OperatorMetrics()
        # the journal's event counters ride this process's /metrics
        # registry (tpuslice_events_total — docs/OBSERVABILITY.md);
        # detached again in run()'s shutdown path
        self._event_metrics = EventMetrics(registry=self.metrics.registry)
        obs_journal.attach_metrics(self._event_metrics)
        self.metrics_host, self.metrics_port = _split_bind(
            metrics_bind_address
        )
        self.probe_address = health_probe_bind_address
        self.agent = NodeAgent(
            client, backend, node_name, namespace, metrics=self.metrics
        )
        self._stop = threading.Event()
        self._ready = False
        self.probes: Optional[ProbeServer] = None

    @classmethod
    def from_args(cls, args) -> "AgentRunner":
        from instaslice_tpu_torch.device.select import select_backend
        from instaslice_tpu_torch.kube.real import build_client

        return cls(
            build_client(getattr(args, "kubeconfig", "")),
            select_backend(args.backend),
            node_name=args.node_name,
            namespace=args.namespace,
            metrics_bind_address=args.metrics_bind_address,
            health_probe_bind_address=args.health_probe_bind_address,
        )

    def stop(self, *_sig) -> None:
        self._stop.set()

    def run(self) -> int:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(levelname)s %(name)s %(message)s",
        )
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, self.stop)
            except ValueError:  # not the main thread (tests)
                pass
        self.probes = ProbeServer(
            self.probe_address, ready_check=lambda: self._ready
        ).start()
        start_metrics_server(
            self.metrics, self.metrics_port, host=self.metrics_host
        )
        self.agent.start()
        self._ready = True
        log.info("agent running (node=%s, backend=%s)",
                 self.agent.node_name, self.agent.backend.name)
        try:
            self._stop.wait()
        finally:
            # readiness drops FIRST (readyz -> 503 "draining") so the
            # Service routes around this replica while the agent's
            # reconcile/health loops wind down; liveness stays green
            if self.probes:
                self.probes.set_draining(True)
            self._ready = False
            self.agent.stop()
            if self.probes:
                self.probes.stop()
            obs_journal.detach_metrics(self._event_metrics)
        return 0
