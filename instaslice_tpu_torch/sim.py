"""SimCluster: a whole instaslice deployment on GPU nodes in one process.

Fake kube API + cluster controller + one node agent per simulated node
(each with its own :class:`~instaslice_tpu_torch.device.fake.FakeGpuBackend`)
+ a minimal kube-scheduler emulator that binds ungated pods to the node
advertising their per-pod extended resource — exactly how the real
scheduler places InstaSlice's pods (``org.instaslice/<podname>`` forces
the node, ``instaslice_daemonset.go:277-300``).

A copy of ``instaslice_tpu/sim.py`` (the port imports nothing of the JAX
package) over the port's ``FakeKube``, ``kube/httptest``,
``RealKubeClient``, ``Controller``, ``Repacker`` and ``NodeAgent``. Its
API is the reference's (``start``/``stop`` and the context manager,
``restart_controller``, ``restart_agent``, ``pod_manifest``, ``submit``,
``delete_pod``, the observers, the same fault, nemesis, plugin, fleet,
cache, bind-latency, repacker and stuck-grant knobs); what differs is
the node:

- every node is a GPU node: a ``FakeGpuBackend`` of ``gpus_per_node``
  GPUs, of ``generation`` ``h100-80gb`` or ``""`` (a card without a MIG
  catalog, granted whole only), MIG on or off as ``mig`` says. There is
  no ``cloudtpu`` backend;
- a GPU node's CR is its own group (``torusGroup`` its name, host offset
  ``(0, 0, 0)``, ``agent/discovery.py``), so the reference's
  ``shared_torus`` and ``nodes_per_group`` have no meaning here and are
  left out;
- fleet mode publishes each node's CR from that node's own lazily built
  backend (its inventory, one chip a GPU, and its reservations, which
  the GPU grid's adoption reads), not from a generation's chips per host;
- a pod's device resource is InstaSlice's ``nvidia.com/mig-<profile>``,
  or ``nvidia.com/gpu`` for the whole GPU (``gpu``), and the kubelet
  play runs over the port's hand-written gRPC wire
  (``deviceplugin/wire.py``).

This is the test tier SURVEY.md §4 says the reference is missing ("a
simulated multi-node cluster ... exercises the controller↔agent state
machine — the thing the reference never tests"), and the engine a grant
latency benchmark runs on.
"""

from __future__ import annotations

import logging
import shutil
import tempfile
import time
import uuid as uuidlib
from typing import Dict, List, Optional

from instaslice_tpu_torch.agent import NodeAgent
from instaslice_tpu_torch.api.constants import (
    DEVICE_PATHS_ANNOTATION,
    GATE_NAME,
    GPU_RESOURCE,
    KUBELET_ENV_CHIPS_ANNOTATION,
    MIG_RESOURCE_PREFIX,
    POD_RESOURCE_PREFIX,
)
from instaslice_tpu_torch.controller import Controller
from instaslice_tpu_torch.controller.gates import (
    GROUP_ANNOTATION,
    GROUP_SIZE_ANNOTATION,
    PROFILE_ANNOTATION,
)
from instaslice_tpu_torch.device import FakeGpuBackend
from instaslice_tpu_torch.kube import FakeKube, NotFound
from instaslice_tpu_torch.topology.mig import H100_80GB, WHOLE_GPU
from instaslice_tpu_torch.utils.lockcheck import named_lock

log = logging.getLogger("instaslice_tpu_torch.sim")

#: longest unix socket directory the plugins' sockets may sit in: the
#: kernel's sun_path holds 108 bytes, and a plugin's socket name
#: (``tpuslice-<profile>.sock``) takes up to 30 of them
_SOCKET_DIR_MAX = 70


def _plugin_dir(node: str) -> str:
    """A fresh directory for one node's plugin sockets: under the
    process's temp dir, or ``/tmp`` where that is too deep for a unix
    socket path."""
    root = tempfile.gettempdir()
    if len(root) + len(node) + 16 > _SOCKET_DIR_MAX:
        root = "/tmp"
    return tempfile.mkdtemp(prefix=f"dp-{node}-", dir=root)


def device_resource_name(profile: str) -> str:
    """InstaSlice's device resource of a GPU grid's profile:
    ``nvidia.com/gpu`` for the whole GPU, else
    ``nvidia.com/mig-<profile>``."""
    return GPU_RESOURCE if profile == WHOLE_GPU else \
        f"{MIG_RESOURCE_PREFIX}{profile}"


class FleetAgents:
    """Every simulated node's agent behind ONE sharded reconcile manager.

    A per-node :class:`NodeAgent` runs two threads (watch + worker);
    at 1k nodes that is thousands of idle threads before the first
    grant. Here a single watch on the TpuSlice namespace fans CR events
    out to ``workers`` key-hash-sharded workers, and the per-node agent
    objects (and their fake backends) are built lazily on first touch —
    the "lazy node construction" half of the scale tier
    (docs/SCALING.md). Per-key sharding keeps the per-node serialization
    NodeAgent.reconcile always had."""

    def __init__(
        self,
        client,
        backend_factory,
        namespace: str,
        workers: int = 8,
        metrics=None,
        wrap_backend=None,
    ) -> None:
        from instaslice_tpu_torch.utils.reconcile import Manager

        self.client = client
        self.namespace = namespace
        self.metrics = metrics
        self._backend_factory = backend_factory
        self._wrap_backend = wrap_backend or (lambda b: b)
        self._agents: Dict[str, NodeAgent] = {}
        self._lock = named_lock("sim.fleet")
        self.manager = Manager(
            name="agents",
            client=client,
            reconcile=self._reconcile,
            watches=[("TpuSlice", namespace, self._map_cr)],
            workers=workers,
        )

    @staticmethod
    def _map_cr(event: str, obj: dict) -> List[str]:
        """Only CRs carrying agent work map to a key: an allocation-less,
        reservation-less CR has nothing to realize or tear down, so the
        1k-node boot burst (and every idle resync) constructs no agents
        — this is what makes node construction actually lazy."""
        spec = obj.get("spec", {})
        if not spec.get("allocations") and not spec.get("prepared"):
            return []
        return [obj["metadata"]["name"]]

    def _ensure(self, node: str) -> NodeAgent:
        with self._lock:
            agent = self._agents.get(node)
            if agent is None:
                agent = NodeAgent(
                    self.client,
                    self._wrap_backend(self._backend_factory(node)),
                    node,
                    self.namespace,
                    metrics=self.metrics,
                    health_interval=0,
                    manager=self.manager,
                )
                self._agents[node] = agent
            return agent

    def _reconcile(self, key: str):
        return self._ensure(key).reconcile(key)

    def start(self) -> None:
        self.manager.start()

    def stop(self) -> None:
        self.manager.stop()


class SimCluster:
    def __init__(
        self,
        n_nodes: int = 1,
        generation: str = H100_80GB,
        gpus_per_node: int = 8,
        mig: bool = True,
        namespace: str = "instaslice-tpu-system",
        policy: str = "best-fit",
        deletion_grace_seconds: float = 0.3,
        health_interval: float = 0.15,
        metrics=None,
        device_plugins: bool = False,
        transport: str = "inproc",
        fault_plan=None,
        nemesis=None,
        fleet_agents: bool = False,
        agent_workers: int = 8,
        workers: Optional[int] = None,
        use_cache: bool = True,
        bind_latency: float = 0.0,
        repack: bool = False,
        repack_interval: float = 0.25,
        repack_max_concurrent: int = 2,
        repack_cooldown: float = 1.0,
        repack_frag_threshold: Optional[float] = None,
        repack_stuck_abort: Optional[float] = None,
        stuck_grant_deadline: Optional[float] = None,
    ) -> None:
        """``generation``: ``h100-80gb`` (the MIG catalog) or ``""`` (a
        card without one). ``gpus_per_node`` GPUs a node; ``mig``: MIG
        mode on every GPU (ignored without a catalog, where it is off).

        ``transport="inproc"`` wires every component straight to the
        in-process FakeKube. ``transport="http"`` puts the store behind
        :class:`FakeApiServer` and gives the controller, every agent, and
        the submit/observe side each their OWN :class:`RealKubeClient`
        connection — the full wire path (URL building, JSON verbs,
        streaming watch parsing, timestamp round-tripping) between every
        component, the way separate processes would talk to a real API
        server.

        ``fault_plan`` (a :class:`instaslice_tpu_torch.faults.FaultPlan`,
        or by default whatever ``TPUSLICE_FAULT_PLAN`` describes) wraps
        every component's kube client in a
        :class:`~instaslice_tpu_torch.faults.FaultyKubeClient` and every
        node backend in a
        :class:`~instaslice_tpu_torch.faults.FaultyBackend`, so any
        sim-driven tier runs under seeded fault injection with no code
        changes. The submit/observe client (``self.kube``) stays clean —
        tests assert through it.

        ``nemesis`` (a :class:`~instaslice_tpu_torch.faults.NemesisPlan`,
        or by default whatever ``TPUSLICE_NEMESIS_PLAN`` describes)
        additionally wraps each component's client in a
        :class:`~instaslice_tpu_torch.faults.NemesisKubeClient` with a
        per-component identity — ``controller`` and ``agent-<node>``
        (``agent-fleet`` for the fleet manager) — so partition rules
        can cut ONE component off the apiserver
        (``controller>apiserver:kind=partition,duration=5``) while
        the rest of the cluster keeps converging. The observer client
        stays clean here too.

        Scale-tier knobs (docs/SCALING.md):

        - ``fleet_agents``: drive all node agents from ONE sharded
          reconcile manager (``agent_workers`` workers) with lazy
          per-node construction, instead of two threads per node —
          required to simulate 1k+ nodes. No device plugins, health
          sweeps off.
        - ``workers`` / ``use_cache``: controller reconcile concurrency
          and informer-cache plane (``use_cache=False`` +
          ``workers=1`` is the serial re-list baseline).
        - ``bind_latency``: the simulated kubelet's delay between an
          ungated Pending pod appearing and its bind to Running.
        - ``repack``: run the defragmentation loop
          (:class:`~instaslice_tpu_torch.controller.defrag.Repacker`)
          against the controller — requires ``use_cache`` (the repacker
          reads the informer plane). ``repack_interval`` /
          ``repack_max_concurrent`` / ``repack_cooldown`` tune it for
          sim timescales."""
        from instaslice_tpu_torch.faults import (
            FaultPlan,
            FaultyBackend,
            FaultyKubeClient,
            NemesisKubeClient,
            NemesisPlan,
        )

        if generation not in ("", H100_80GB):
            raise ValueError(
                f"generation {generation!r}: a sim node is an H100 80GB "
                f"({H100_80GB!r}) or a card without a MIG catalog ('')")
        self.fault_plan = fault_plan or FaultPlan.from_env()
        self.nemesis = nemesis if nemesis is not None \
            else NemesisPlan.from_env()
        self.backing = FakeKube()
        self.server = None
        if transport == "http":
            from instaslice_tpu_torch.kube.httptest import FakeApiServer
            from instaslice_tpu_torch.kube.real import RealKubeClient

            self.server = FakeApiServer(self.backing).start()
            url = self.server.url
            self._component_client = lambda: RealKubeClient(url)
            self.kube: "FakeKube" = self._component_client()  # type: ignore
        elif transport == "inproc":
            self._component_client = lambda: self.backing
            self.kube = self.backing
        else:
            raise ValueError(f"unknown transport {transport!r}")
        # components get the faulty/nemesis view; the observer stays
        # clean. Layering (inside out): base transport → FaultyKubeClient
        # (API-level faults) → NemesisKubeClient (network-level faults,
        # per-component identity so partitions can be one-sided).
        def _client_for(ident: str = "") -> "KubeClient":
            c = self._component_client()
            if self.fault_plan is not None:
                c = FaultyKubeClient(c, self.fault_plan)
            if self.nemesis is not None and ident:
                c = NemesisKubeClient(c, self.nemesis, ident)
            return c

        self._client_for = _client_for
        if self.fault_plan is not None:
            self._wrap_backend = lambda b: FaultyBackend(
                b, self.fault_plan
            )
        else:
            self._wrap_backend = lambda b: b
        self.namespace = namespace
        self.generation = generation
        self.gpus_per_node = gpus_per_node
        self.mig = mig
        self.bind_latency = max(0.0, bind_latency)
        self._metrics = metrics
        self._health_interval = health_interval
        self.backends: Dict[str, FakeGpuBackend] = {}
        self.agents: Dict[str, NodeAgent] = {}
        self.fleet: Optional[FleetAgents] = None
        if fleet_agents and device_plugins:
            raise ValueError(
                "fleet_agents supports no device plugins"
            )
        self._nodes = [f"node-{i}" for i in range(n_nodes)]
        for node in self._nodes:
            self.kube.create(
                "Node",
                {
                    "apiVersion": "v1",
                    "kind": "Node",
                    "metadata": {"name": node, "namespace": ""},
                    "status": {"capacity": {}, "allocatable": {}},
                },
            )
            if fleet_agents:
                continue  # backends + agents built lazily by the fleet
            node_backend = self._new_backend()
            # observers (tests, invariant checks) read the clean
            # backend; the agent drives through the faulty wrapper
            self.backends[node] = node_backend
            self.agents[node] = NodeAgent(
                self._client_for(f"agent-{node}"),
                self._wrap_backend(node_backend),
                node, namespace,
                metrics=metrics, health_interval=health_interval,
            )
        if fleet_agents:
            self.fleet = FleetAgents(
                self._client_for("agent-fleet"),
                self._fleet_backend,
                namespace,
                workers=agent_workers,
                metrics=metrics,
                wrap_backend=self._wrap_backend,
            )
        #: constructor args remembered so restart_controller() can
        #: build a FRESH instance (crash-chaos driver, docs/RECOVERY.md)
        self._ctl_opts = dict(
            namespace=namespace,
            policy=policy,
            deletion_grace_seconds=deletion_grace_seconds,
            metrics=metrics,
            workers=workers,
            use_cache=use_cache,
            stuck_grant_deadline=stuck_grant_deadline,
        )
        self.controller = Controller(
            self._client_for("controller"), **self._ctl_opts
        )
        self.repacker = None
        self._repack_opts = None
        if repack:
            if not use_cache:
                raise ValueError(
                    "repack=True requires use_cache=True (the repacker "
                    "reads the informer plane)"
                )
            from instaslice_tpu_torch.controller.defrag import Repacker

            self._repack_opts = dict(
                interval=repack_interval,
                max_concurrent=repack_max_concurrent,
                cooldown=repack_cooldown,
                frag_threshold=repack_frag_threshold,
                stuck_abort_seconds=repack_stuck_abort,
            )
            self.repacker = Repacker(self.controller, **self._repack_opts)
        # Optional fake-kubelet tier: a per-node SlicePluginManager serving
        # device plugins over unix sockets on the hand-written gRPC wire;
        # the sim scheduler plays kubelet (GetPreferredAllocation →
        # Allocate) when binding pods that request an ``nvidia.com/mig-*``
        # or ``nvidia.com/gpu`` device resource.
        self.plugin_managers: Dict[str, "object"] = {}
        self._dp_allocated: Dict[str, set] = {}
        if device_plugins:
            from instaslice_tpu_torch.deviceplugin.server import (
                SlicePluginManager,
            )

            for node, backend in self.backends.items():
                self.plugin_managers[node] = SlicePluginManager(
                    backend,
                    plugin_dir=_plugin_dir(node),
                    poll_seconds=0.05,
                    register_with_kubelet=False,
                )
                self._dp_allocated[node] = set()
        # Watch-driven kube-scheduler emulator: pod events feed a
        # single-worker reconcile manager instead of a 20 ms full-pod
        # poll (O(pods) per sweep — at 10k pending pods the old sweep
        # burned more CPU than the operator it was hosting). Node
        # capacity lookups ride a resource-indexed Node informer.
        from instaslice_tpu_torch.utils.reconcile import Manager

        self._first_bindable: Dict[str, float] = {}
        self._sched_mgr = Manager(
            name="sim-scheduler",
            client=self.kube,
            reconcile=self._bind_pod,
            watches=[
                ("Pod", None, self._sched_pod_map),
                ("Node", None, lambda ev, obj: []),
            ],
            indexers={"Node": {"resource": self._node_resources}},
            workers=1,
            # the relist safety net for any missed event; events do the
            # real-time work so this can stay cheap
            resync_period=2.0,
        )

    # ------------------------------------------------------------ fleet

    def _new_backend(self) -> FakeGpuBackend:
        return FakeGpuBackend(gpu_count=self.gpus_per_node, mig=self.mig,
                              generation=self.generation)

    def _fleet_backend(self, node: str) -> FakeGpuBackend:
        """Lazy per-node backend for fleet mode (cached for observers —
        tests read ``sim.backends[node]`` for the clean view)."""
        b = self.backends.get(node)
        if b is None:
            b = self._new_backend()
            self.backends[node] = b
        return b

    def _publish_fleet_crs(self) -> None:
        """Bulk CR publication for fleet mode: what each agent's
        ``boot()`` would have created, without constructing 1k agents
        up front. The controller needs every node's capacity visible
        before the first placement. Each CR comes from the node's own
        backend: its inventory (one chip a GPU) and its reservations
        (none on a fresh sim node), which the GPU grid's adoption reads."""
        from instaslice_tpu_torch.agent.discovery import build_tpuslice

        client = self.fleet.client
        for node in self._nodes:
            backend = self._fleet_backend(node)
            ts = build_tpuslice(
                node, self.namespace, backend.discover(), backend
            )
            client.create("TpuSlice", ts.to_manifest())

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "SimCluster":
        for agent in self.agents.values():
            agent.start()
        if self.fleet is not None:
            self._publish_fleet_crs()
            self.fleet.start()
        for mgr in self.plugin_managers.values():
            mgr.start()
        self.controller.start()
        if self.repacker is not None:
            self.repacker.start()
        self._sched_mgr.start()
        return self

    def stop(self) -> None:
        if self.repacker is not None:
            self.repacker.stop()
        self.controller.stop()
        for mgr in self.plugin_managers.values():
            mgr.stop()
            shutil.rmtree(mgr.plugin_dir, ignore_errors=True)
        if self.fleet is not None:
            self.fleet.stop()
        for agent in self.agents.values():
            agent.stop()
        self._sched_mgr.stop(timeout=2)
        self.backing.stop_watches()
        if self.server is not None:
            self.server.stop()

    def __enter__(self) -> "SimCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------- crash-chaos driver

    def restart_controller(self) -> None:
        """Kill-and-restart the controller (and its repacker, when
        configured) against the durable CR state — the crash-chaos
        driver's primitive (docs/RECOVERY.md). The dead instance's
        in-memory state (placement overlay, pending set, coalesced
        writes, active migrations) dies with it; the fresh instance
        adopts everything from the API server exactly as a restarted
        process would. Safe after an InjectedCrash already
        crash-stopped the old manager."""
        from instaslice_tpu_torch.api.constants import REASON_CRASH_RECOVERED
        from instaslice_tpu_torch.obs.journal import get_journal

        if self.repacker is not None:
            try:
                self.repacker.stop()
            except Exception:
                log.warning("crashed repacker stop raised", exc_info=True)
        try:
            self.controller.stop()
        except Exception:
            log.warning("crashed controller stop raised", exc_info=True)
        self.controller = Controller(
            self._client_for("controller"), **self._ctl_opts
        )
        if self._repack_opts is not None:
            from instaslice_tpu_torch.controller.defrag import Repacker

            self.repacker = Repacker(self.controller, **self._repack_opts)
        get_journal().emit(
            "sim", reason=REASON_CRASH_RECOVERED,
            object_ref="component/controller",
            message="controller restarted (crash-chaos driver)",
        )
        self.controller.start()
        if self.repacker is not None:
            self.repacker.start()

    def restart_agent(self, node: str) -> None:
        """Kill-and-restart one node agent. Its device backend is NOT
        reset — device reservations are per-node durable truth, which
        is exactly what the restart's discovery sweep reconciles
        against the CR (orphan reaping, re-driven realizes)."""
        from instaslice_tpu_torch.api.constants import REASON_CRASH_RECOVERED
        from instaslice_tpu_torch.obs.journal import get_journal

        agent = self.agents.get(node)
        if agent is None:
            raise ValueError(
                f"no per-node agent for {node!r} (fleet_agents mode "
                "restarts are not supported)"
            )
        try:
            agent.stop()
        except Exception:
            log.warning("crashed agent stop raised", exc_info=True)
        self.agents[node] = NodeAgent(
            self._client_for(f"agent-{node}"),
            self._wrap_backend(self.backends[node]),
            node,
            self.namespace,
            metrics=self._metrics,
            health_interval=self._health_interval,
        )
        get_journal().emit(
            "sim", reason=REASON_CRASH_RECOVERED,
            object_ref=f"component/agent-{node}",
            message=f"agent {node} restarted (crash-chaos driver)",
        )
        self.agents[node].start()

    # ------------------------------------------------------ pod submission

    def pod_manifest(
        self,
        name: str,
        profile: str,
        namespace: str = "default",
        group: str = "",
        group_size: int = 0,
        annotations: Optional[dict] = None,
        device_resource: bool = False,
    ) -> dict:
        """The samples/test-pod.yaml analog: scheduling-gated, finalized,
        profile annotation + per-pod extended resource request + envFrom
        the ConfigMap named after the pod. With ``device_resource`` the
        pod also requests InstaSlice's device resource,
        ``nvidia.com/mig-<profile>: 1`` (``nvidia.com/gpu: 1`` for the
        whole GPU, ``gpu``), served by the slice plugins when
        ``device_plugins=True``."""
        ann = {PROFILE_ANNOTATION: profile}
        if group:
            ann[GROUP_ANNOTATION] = group
            ann[GROUP_SIZE_ANNOTATION] = str(group_size)
        if annotations:
            ann.update(annotations)
        limits = {f"{POD_RESOURCE_PREFIX}{name}": "1"}
        if device_resource:
            limits[device_resource_name(profile)] = "1"
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "namespace": namespace,
                "uid": f"uid-{name}-{uuidlib.uuid4().hex[:8]}",
                "annotations": ann,
            },
            "spec": {
                "schedulingGates": [{"name": GATE_NAME}],
                "containers": [
                    {
                        "name": "main",
                        "image": "torch-smoke",
                        "resources": {"limits": limits},
                        "envFrom": [{"configMapRef": {"name": name}}],
                    }
                ],
            },
            "status": {"phase": "Pending"},
        }

    def submit(self, name: str, profile: str, namespace: str = "default",
               group: str = "", group_size: int = 0,
               annotations: Optional[dict] = None,
               device_resource: bool = False) -> dict:
        return self.kube.create(
            "Pod",
            self.pod_manifest(
                name, profile, namespace, group, group_size, annotations,
                device_resource,
            ),
        )

    def delete_pod(self, name: str, namespace: str = "default") -> None:
        self.kube.delete("Pod", namespace, name)

    # ----------------------------------------------------------- observers

    def pod(self, name: str, namespace: str = "default") -> dict:
        return self.kube.get("Pod", namespace, name)

    def pod_phase(self, name: str, namespace: str = "default") -> str:
        try:
            return self.pod(name, namespace).get("status", {}).get("phase", "")
        except NotFound:
            return "Gone"

    def wait_phase(
        self, name: str, phase: str, timeout: float = 10.0,
        namespace: str = "default",
    ) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.pod_phase(name, namespace) == phase:
                return True
            # bounded observer poll (test helper); nothing to interrupt
            time.sleep(0.02)  # slicelint: disable=sleep-in-loop
        return False

    def wait_gone(self, name: str, timeout: float = 10.0,
                  namespace: str = "default") -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.pod_phase(name, namespace) == "Gone":
                return True
            # bounded observer poll (test helper); nothing to interrupt
            time.sleep(0.02)  # slicelint: disable=sleep-in-loop
        return False

    def allocations(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for m in self.kube.list("TpuSlice", namespace=self.namespace):
            for aid, a in m["spec"].get("allocations", {}).items():
                out[aid] = a
        return out

    def configmap(self, name: str, namespace: str = "default") -> Optional[dict]:
        try:
            return self.kube.get("ConfigMap", namespace, name)
        except NotFound:
            return None

    def unhealthy_chips(self, node: str) -> List[int]:
        ts = self.kube.get("TpuSlice", self.namespace, node)
        return list(ts.get("status", {}).get("unhealthyChips", []))

    # ----------------------------------------------- kube-scheduler emulator

    @staticmethod
    def _sched_pod_map(event: str, obj: dict) -> List[str]:
        if event == "DELETED":
            return []
        md = obj.get("metadata", {})
        if md.get("deletionTimestamp"):
            return []
        if obj.get("spec", {}).get("schedulingGates"):
            return []  # still gated: the ungate event re-maps it
        if obj.get("status", {}).get("phase") != "Pending":
            return []
        return [f"{md.get('namespace', '')}/{md.get('name', '')}"]

    @staticmethod
    def _node_resources(obj: dict) -> List[str]:
        cap = obj.get("status", {}).get("capacity", {}) or {}
        return [res for res, val in cap.items() if val == "1"]

    def _bind_pod(self, key: str) -> Optional[float]:
        """Bind one ungated Pending pod to the node advertising its
        per-pod extended resource (fallback: any node when the pod pins
        nothing). Sets phase=Running — container start is out of scope
        for the sim. ``bind_latency`` models kubelet/scheduler latency:
        a pod binds only after being bindable that long (returned as a
        requeue delay)."""
        ns, _, name = key.partition("/")
        try:
            pod = self.kube.get("Pod", ns, name)
        except NotFound:
            return None
        md = pod["metadata"]
        if md.get("deletionTimestamp"):
            return None
        if pod.get("spec", {}).get("schedulingGates"):
            return None
        if pod.get("status", {}).get("phase") != "Pending":
            return None
        if self.bind_latency > 0:
            uid = md.get("uid", name)
            t0 = self._first_bindable.setdefault(uid, time.monotonic())
            remain = self.bind_latency - (time.monotonic() - t0)
            if remain > 0:
                return max(0.01, remain)
        node = self._node_for(pod)
        if node is None:
            return 0.05  # capacity not advertised yet; retry shortly
        patch = {
            "spec": {"nodeName": node},
            "status": {"phase": "Running"},
        }
        dp_profile = self._device_resource_profile(pod)
        if self.plugin_managers and dp_profile:
            granted = self._kubelet_allocate(node, dp_profile)
            if granted is None:
                return 0.05  # no device yet: stays Pending, re-probe
            patch["metadata"] = {"annotations": granted}
        try:
            self.kube.patch("Pod", ns, name, patch)
        except NotFound:
            return None
        self._first_bindable.pop(md.get("uid", name), None)
        return None

    @staticmethod
    def _device_resource_profile(pod: dict) -> str:
        """Profile from an ``nvidia.com/mig-<profile>: 1`` limit, ``gpu``
        from ``nvidia.com/gpu: 1`` ("" when the pod uses only the
        annotation path — no device resource)."""
        for ctr in pod.get("spec", {}).get("containers", []) or []:
            limits = (ctr.get("resources") or {}).get("limits") or {}
            for key in limits:
                if key == GPU_RESOURCE:
                    return WHOLE_GPU
                if key.startswith(MIG_RESOURCE_PREFIX):
                    return key[len(MIG_RESOURCE_PREFIX):]
        return ""

    def _kubelet_allocate(self, node: str, profile: str) -> Optional[dict]:
        """Play kubelet against the node's slice device plugin over its
        unix socket on the hand-written gRPC wire: list devices,
        GetPreferredAllocation over the unallocated ones, Allocate the
        pick. Returns the annotations the injected response carries
        (device paths + chips), or None when no device of the profile is
        available yet (pod stays Pending — the kubelet behavior for
        exhausted extended resources)."""
        from instaslice_tpu_torch.deviceplugin.wire import (
            Channel,
            DevicePluginClient,
        )

        mgr = self.plugin_managers[node]
        plugin = mgr.ensure_profile(profile)
        taken = self._dp_allocated[node]
        devices = plugin.device_list()          # one snapshot for both
        # devices whose reservation vanished (teardown) free their slot
        taken &= {d.ID for d in devices}
        with Channel(f"unix://{plugin.socket_path}") as ch:
            client = DevicePluginClient(ch)
            avail = [
                d.ID for d in devices
                if d.health == "Healthy" and d.ID not in taken
            ]
            if not avail:
                return None
            pref = client.preferred(avail, 1)
            chosen = list(
                pref.container_responses[0].deviceIDs
            ) or avail[:1]
            resp = client.allocate(chosen)
        cresp = resp.container_responses[0]
        taken.update(chosen)
        ann = dict(cresp.annotations)
        ann[DEVICE_PATHS_ANNOTATION] = ",".join(
            d.host_path for d in cresp.devices
        )
        ann[KUBELET_ENV_CHIPS_ANNOTATION] = cresp.envs.get(
            "TPU_KUBELET_ASSIGNED_CHIPS", ""
        )
        return ann

    def _node_for(self, pod: dict) -> Optional[str]:
        wanted = None
        for ctr in pod.get("spec", {}).get("containers", []):
            for key in ((ctr.get("resources") or {}).get("limits") or {}):
                if key.startswith(POD_RESOURCE_PREFIX):
                    wanted = key
        nodes = self._sched_mgr.informer("Node")
        if nodes is None:
            return None
        if wanted is None:
            names = sorted(n["metadata"]["name"] for n in nodes.list())
            return names[0] if names else None
        advertising = nodes.by_index("resource", wanted)
        return advertising[0]["metadata"]["name"] if advertising else None
