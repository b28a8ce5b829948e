"""Controller process runner — the ``cmd/controller/main.go`` analog:
client resolution, metrics server, health probes, leader election, signal
handling around the :class:`~instaslice_tpu_torch.controller.reconciler.Controller`
reconcile loops (reference wiring: ``cmd/controller/main.go:55-168``,
leader-election id ``7cbd68d5.codeflare.dev``).

A copy of ``instaslice_tpu/controller/runner.py`` (the port imports
nothing of the JAX package); ``from_args`` builds the port's HTTP
client (``kube/real.py``), whose kubeconfig reader needs no PyYAML."""

from __future__ import annotations

import logging
import os
import signal
import socket
import threading
from typing import Optional

from instaslice_tpu_torch.controller.reconciler import Controller
from instaslice_tpu_torch.kube.client import KubeClient
from instaslice_tpu_torch.metrics.metrics import (
    EventMetrics,
    OperatorMetrics,
    start_metrics_server,
)
from instaslice_tpu_torch.obs import journal as obs_journal
from instaslice_tpu_torch.utils.election import EpochFence, LeaderElector
from instaslice_tpu_torch.utils.probes import ProbeServer

log = logging.getLogger("instaslice_tpu_torch.controller.runner")

LEASE_NAME = "tpuslice-controller-leader"


def _split_bind(bind_address: str) -> tuple:
    """(host, port) from ':8080' / '127.0.0.1:8080'. The host part is
    honored by the metrics server — the kube-rbac-proxy patch relies on a
    real 127.0.0.1 bind, not a cosmetic one."""
    host, _, port_s = bind_address.rpartition(":")
    try:
        return host, int(port_s)
    except ValueError:
        return host, 0


class ControllerRunner:
    def __init__(
        self,
        client: KubeClient,
        namespace: str = "instaslice-tpu-system",
        policy: str = "",
        deletion_grace_seconds: float = 30.0,
        metrics_bind_address: str = ":8080",
        health_probe_bind_address: str = ":8081",
        leader_elect: bool = False,
        identity: str = "",
        workers: Optional[int] = None,
        shard_leases: bool = False,
        repack: bool = False,
        repack_interval: float = 5.0,
        repack_max_concurrent: int = 2,
        repack_cooldown: float = 300.0,
        repack_frag_threshold: Optional[float] = None,
    ) -> None:
        """``shard_leases``: instead of ONE controller lease, each
        reconcile shard worker holds Lease ``<LEASE_NAME>-shard-<i>`` —
        multiple replicas split the shards between them (active-active
        horizontal scale-out) while per-key ordering still holds
        cluster-wide, and every write is fenced on the writing shard's
        lease (docs/SCALING.md).

        ``policy`` resolution: the explicit argument, else the
        ``TPUSLICE_PLACEMENT_POLICY`` env var, else first-fit —
        ``get_policy`` rejects unknown names with the registered list.

        ``repack``: run the defragmentation loop
        (:class:`~instaslice_tpu_torch.controller.defrag.Repacker`) next to
        the reconcile workers (docs/SCALING.md knobs)."""
        self.client = client
        policy = (
            policy
            or os.environ.get("TPUSLICE_PLACEMENT_POLICY", "")
            or "first-fit"
        )
        self.namespace = namespace
        self.leader_elect = leader_elect
        self.shard_leases = shard_leases
        self.identity = identity or f"{socket.gethostname()}-{os.getpid()}"
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
        # Leadership fence for controller writes, epoch-aware. With
        # per-shard leases the writing worker's own shard lease is the
        # fence (``_shard_check`` → ``Manager.shard_is_leader``, itself
        # epoch-verified; per-CR commits additionally pin
        # ``Manager.shard_fence`` for epoch stamping); with the single
        # global lease the EpochFence binds ``self.elector`` (None until
        # run(), and forever when election is off → fence open).
        self._fence = EpochFence(
            lambda: self.elector, check=self._shard_check
        )
        self.controller = Controller(
            client,
            namespace=namespace,
            policy=policy,
            deletion_grace_seconds=deletion_grace_seconds,
            metrics=self.metrics,
            # with election on, every controller write is fenced on the
            # lease — and on the lease EPOCH: a deposed leader (even one
            # that was partitioned and never saw its own deposition)
            # raises Fenced instead of racing its successor's writes,
            # and committed manifests carry the writer's epoch
            # (tested in tests/test_runtime.py, tests/
            # test_partition_chaos.py)
            fence=self._fence,
            workers=workers,
            shard_lease=(
                {
                    "namespace": namespace,
                    "prefix": LEASE_NAME,
                    "identity": self.identity,
                }
                if shard_leases else None
            ),
        )
        self.repacker = None
        if repack:
            from instaslice_tpu_torch.controller.defrag import Repacker

            self.repacker = Repacker(
                self.controller,
                interval=repack_interval,
                max_concurrent=repack_max_concurrent,
                cooldown=repack_cooldown,
                frag_threshold=repack_frag_threshold,
            )
        self._stop = threading.Event()
        self._ready = False
        self.probes: Optional[ProbeServer] = None
        self.elector: Optional[LeaderElector] = None

    def _shard_check(self) -> bool:
        """Local half of the controller fence: with per-shard leases the
        writing worker's own shard lease decides (epoch-verified inside
        ``shard_is_leader``); otherwise defer to the EpochFence's global
        elector."""
        if self.shard_leases:
            return self.controller.manager.shard_is_leader()
        return True

    @classmethod
    def from_args(cls, args) -> "ControllerRunner":
        from instaslice_tpu_torch.kube.real import build_client

        return cls(
            build_client(getattr(args, "kubeconfig", "")),
            namespace=args.namespace,
            policy=args.policy or "",
            deletion_grace_seconds=args.deletion_grace_seconds,
            metrics_bind_address=args.metrics_bind_address,
            health_probe_bind_address=args.health_probe_bind_address,
            leader_elect=args.leader_elect,
            workers=getattr(args, "workers", None),
            shard_leases=getattr(args, "shard_leases", False),
            repack=getattr(args, "repack", False),
            repack_interval=getattr(args, "repack_interval", 5.0),
            repack_max_concurrent=getattr(
                args, "repack_max_concurrent", 2
            ),
            repack_cooldown=getattr(args, "repack_cooldown", 300.0),
            repack_frag_threshold=getattr(
                args, "repack_frag_threshold", None
            ),
        )

    # ------------------------------------------------------------------

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
        if self.leader_elect and not self.shard_leases:
            # (with per-shard leases the workers acquire their own
            # shard Leases as they start — no global gate to wait on)
            self.elector = LeaderElector(
                self.client, self.namespace, LEASE_NAME, self.identity
            )
            log.info("waiting for leader lease %s/%s",
                     self.namespace, LEASE_NAME)
            if not self.elector.acquire(self._stop):
                return 0  # stopped while waiting
            self.elector.start_renewing(on_lost=self.stop)
        self.controller.start()
        if self.repacker is not None:
            self.repacker.start()
            log.info("repacker running (interval=%.1fs)",
                     self.repacker.interval)
        self._ready = True
        log.info("controller running (namespace=%s)", self.namespace)
        try:
            self._stop.wait()
        finally:
            if self.repacker is not None:
                self.repacker.stop()
            # readiness drops FIRST (readyz → 503 "draining") so the
            # Service routes around this replica while the reconcile
            # loops finish their in-flight keys; liveness stays green
            if self.probes:
                self.probes.set_draining(True)
            self._ready = False
            self.controller.stop()
            if self.elector:
                self.elector.release()
            if self.probes:
                self.probes.stop()
            obs_journal.detach_metrics(self._event_metrics)
        return 0
