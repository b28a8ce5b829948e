"""Node-agent reconciler: realize ``creating`` allocations, tear down
``deleted`` ones.

Reference analog: the daemonset hot loop (``instaslice_daemonset.go:95-275``
— SURVEY.md §3.2/§3.3). Reference weaknesses deliberately fixed:

- device errors flip the allocation to ``failed`` instead of being logged
  and skipped (``:172-189``);
- idempotency comes from the CR's ``prepared`` records + the device
  registry, not an in-memory cache (``cachedPreparedMig``, ``:87-93``);
- capacity is advertised via a real patch-and-verify helper, not a
  label-toggle hack against an external device plugin (``:474-497``).

A copy of ``instaslice_tpu/agent/reconciler.py`` (the port imports
nothing of the JAX package), line for line on a TPU generation. On a
GPU grid it takes the rules of :mod:`~instaslice_tpu_torch.agent.gpugrid`:
the node's part is the allocation's one part (``gpu<i>``), which keys
``pods_on_node``, ``realized_on`` and ``prepared[...].parts``; the
chips reserved and health-checked are GPU indices; the reserve names
the MIG profile and start slot (``""`` for the whole GPU); and the
handoff ConfigMap carries the UUIDs the reservation grants (those of
the live reservation on ``SliceExists``). Health goes to
``status.unhealthyChips`` only, as in the reference.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

from instaslice_tpu_torch.agent import gpugrid
from instaslice_tpu_torch.api.constants import (
    POD_RESOURCE_PREFIX,
    REASON_APISERVER_UNREACHABLE,
    REASON_CHIP_HEALED,
    REASON_CHIP_UNHEALTHY,
    REASON_DEGRADED_ENTERED,
    REASON_DEGRADED_EXITED,
    REASON_REALIZED,
    REASON_REALIZE_FAILED,
    REASON_TORN_DOWN,
)
from instaslice_tpu_torch.faults import maybe_crash
from instaslice_tpu_torch.obs.journal import emit_pod_event, get_journal
from instaslice_tpu_torch.agent.discovery import discover_node
from instaslice_tpu_torch.agent.handoff import configmap_manifest, slice_env
from instaslice_tpu_torch.api import (
    AllocationDetails,
    AllocationStatus,
    PreparedDetails,
    PreparedPart,
    TpuSlice,
    slice_uuid_for,
)
from instaslice_tpu_torch.device.backend import (
    DeviceBackend,
    DeviceError,
    SliceExists,
    SliceNotFound,
    TracedBackend,
)
from instaslice_tpu_torch.kube.client import (
    AlreadyExists,
    KubeClient,
    NotFound,
    update_with_retry,
)
from instaslice_tpu_torch.utils.lockcheck import named_lock
from instaslice_tpu_torch.utils.reconcile import Manager
from instaslice_tpu_torch.utils.trace import get_tracer

log = logging.getLogger("instaslice_tpu_torch.agent")


# slice_uuid_for moved to api.types (shared with the controller's
# occupancy computation); re-exported via the import above.


#: synthetic workqueue key driving the periodic chip-health sweep ("#" can
#: never collide with a node name)
HEALTH_KEY = "#health"


class NodeAgent:
    def __init__(
        self,
        client: KubeClient,
        backend: DeviceBackend,
        node_name: str,
        namespace: str = "instaslice-tpu-system",
        metrics=None,
        health_interval: float = 10.0,
        manager: Optional[Manager] = None,
    ) -> None:
        """``manager``: an externally-owned reconcile manager (the
        fleet-sim case — one sharded manager driving every node's agent
        logic, ``instaslice_tpu_torch.sim.FleetAgents``). The agent then
        neither builds nor starts its own watch/worker threads; requeue
        re-adds ride the shared queue."""
        self.client = client
        # every device op this agent issues becomes a ``device.<op>``
        # span, joining whatever trace the agent has bound (the
        # allocation's trace id during realize/teardown)
        self.backend = (
            backend if isinstance(backend, TracedBackend)
            else TracedBackend(backend)
        )
        self.node_name = node_name
        self.namespace = namespace
        self.metrics = metrics
        self.health_interval = health_interval
        #: static/degraded mode (docs/RECOVERY.md "Partitions & gray
        #: failures"): set when the apiserver becomes unreachable at the
        #: transport level. Realized slices keep serving (the device
        #: plane needs no apiserver), every kube mutation is suppressed,
        #: and each requeue re-probes; the first successful probe runs a
        #: boot-style sweep against durable truth before reconciling.
        self.degraded = False
        self._degraded_lock = named_lock("agent.degraded")
        self.degraded_retry_s = 1.0
        self._owns_manager = manager is None
        self.manager = manager or Manager(
            name=f"agent-{node_name}",
            client=client,
            reconcile=self.reconcile,
            watches=[
                (
                    "TpuSlice",
                    namespace,
                    lambda ev, obj: [obj["metadata"]["name"]]
                    if obj["metadata"]["name"] == node_name
                    else [],
                )
            ],
        )

    # ---------------------------------------------------------------- boot

    def boot(self) -> TpuSlice:
        """Discovery + CR publication (SURVEY.md §3.4)."""
        return discover_node(
            self.client, self.backend, self.node_name, self.namespace
        )

    @property
    def tracer(self):
        # resolved per use, never cached at construction: after
        # reset_tracer() the agent's grant spans must land in the NEW
        # default tracer, not an orphaned closed ring
        return get_tracer()

    def start(self) -> None:
        self.boot()
        if not self._owns_manager:
            return  # fleet-managed: the shared manager drives us
        self.manager.start()
        self.manager.queue.add(self.node_name)
        if self.health_interval > 0:
            self.manager.queue.add(HEALTH_KEY, delay=self.health_interval)

    def stop(self) -> None:
        if self._owns_manager:
            self.manager.stop()

    # ----------------------------------------------------------- reconcile

    def reconcile(self, key: str) -> Optional[float]:
        """Transport-aware wrapper: a connection-level apiserver failure
        anywhere in the reconcile flips the agent into static/degraded
        mode instead of crashing the loop; every requeue re-probes and
        the first success heals (boot-style sweep, then normal
        reconcile). Injected API errors (503s etc.) are NOT degraded
        triggers — they keep their existing retry semantics."""
        try:
            return self._reconcile_checked(key)
        except (ConnectionError, TimeoutError) as e:
            return self._enter_degraded(e)

    def _reconcile_checked(self, key: str) -> Optional[float]:
        if self.degraded:
            # any kube call below doubles as the heal probe; _heal
            # raises (→ _enter_degraded requeue) while still cut off
            self._heal()
        if key == HEALTH_KEY:
            return self._health_sweep()
        if key != self.node_name:
            return None
        try:
            obj = self.client.get("TpuSlice", self.namespace, key)
        except NotFound:
            return None
        ts = TpuSlice.from_manifest(obj)
        for alloc_id in sorted(ts.spec.allocations):
            alloc = ts.spec.allocations[alloc_id]
            key = gpugrid.part_key(alloc, self.node_name, ts.spec.generation)
            if key is None:
                continue
            if (
                alloc.status == AllocationStatus.CREATING
                and key not in alloc.realized_on
            ):
                self._realize(ts, alloc)
            elif alloc.status == AllocationStatus.DELETED:
                self._teardown(ts, alloc)
        return None

    # ------------------------------------------------- degraded/static mode

    def _enter_degraded(self, exc: BaseException) -> float:
        """Record (once) that the apiserver is unreachable and schedule
        the re-probe. Journaling is local — the journal needs no
        apiserver."""
        with self._degraded_lock:
            first = not self.degraded
            self.degraded = True
        if first:
            log.warning(
                "%s: apiserver unreachable (%s); entering static mode — "
                "realized slices keep serving, mutations suppressed",
                self.node_name, exc,
            )
            j = get_journal()
            j.emit(
                f"agent-{self.node_name}",
                reason=REASON_APISERVER_UNREACHABLE,
                object_ref=f"node/{self.node_name}",
                message=f"apiserver unreachable: {exc}",
            )
            j.emit(
                f"agent-{self.node_name}",
                reason=REASON_DEGRADED_ENTERED,
                object_ref=f"node/{self.node_name}",
                message="static mode: serving frozen device state, "
                        "kube mutations suppressed",
            )
        return self.degraded_retry_s

    def _heal(self) -> None:
        """Probe the apiserver and, on success, leave degraded mode via
        a boot-style sweep (discovery + orphan reap against durable
        truth — the partition may have deleted allocations we still hold
        reservations for). Raises the transport error while the
        partition persists, which re-enters degraded mode upstream."""
        # boot() == discover_node: its first kube call is the probe, and
        # its sweep is exactly the restart reconciliation docs/RECOVERY.md
        # prescribes for rejoining a cluster whose state moved on
        self.boot()
        with self._degraded_lock:
            self.degraded = False
        log.info("%s: apiserver reachable again; leaving static mode",
                 self.node_name)
        get_journal().emit(
            f"agent-{self.node_name}",
            reason=REASON_DEGRADED_EXITED,
            object_ref=f"node/{self.node_name}",
            message="healed: boot sweep reconciled durable truth",
        )
        # the health sweep stopped publishing while degraded — catch up
        if self.health_interval > 0:
            self.manager.queue.add(HEALTH_KEY)

    # ------------------------------------------------------------- realize

    def _chip_ids_for(self, ts: TpuSlice, alloc: AllocationDetails) -> List[int]:
        return gpugrid.chip_ids(alloc, self.node_name, ts.spec.generation)

    def _realize(self, ts: TpuSlice, alloc: AllocationDetails) -> None:
        with self.tracer.span(
            "agent.realize", trace_id=alloc.trace_id or None,
            node=self.node_name, alloc=alloc.alloc_id,
        ):
            self._realize_inner(ts, alloc)

    def _realize_inner(self, ts: TpuSlice, alloc: AllocationDetails) -> None:
        suid = slice_uuid_for(alloc.alloc_id, multihost=len(alloc.parts) > 1)
        chip_ids = self._chip_ids_for(ts, alloc)
        gpu = gpugrid.is_gpu_grid(ts.spec.generation)
        key = gpugrid.part_key(alloc, self.node_name, ts.spec.generation)
        device_uuids: tuple = ()
        t0 = time.monotonic()
        try:
            # the backend is span-instrumented (TracedBackend): this
            # reserve shows up as a device.reserve child span of
            # agent.realize, in the allocation's trace
            if gpu:
                device_uuids = self.backend.reserve(
                    suid, chip_ids, *gpugrid.reserve_args(alloc)
                ).device_uuids
            else:
                self.backend.reserve(suid, chip_ids)
        except SliceExists:
            log.info("%s: reservation %s already live (idempotent)",
                     self.node_name, suid)
            if gpu:
                device_uuids = next(
                    (r.device_uuids for r in self.backend.list_reservations()
                     if r.slice_uuid == suid), ())
        except DeviceError as e:
            log.warning("%s: reserve %s failed: %s", self.node_name, suid, e)
            for pod in alloc.pods_on_node(key):
                emit_pod_event(
                    self.client, pod.namespace, pod.pod_name,
                    reason=REASON_REALIZE_FAILED,
                    message=f"{self.node_name}: chip reservation failed: {e}",
                    component=f"agent-{self.node_name}",
                    pod_uid=pod.pod_uuid, trace_id=alloc.trace_id,
                    event_type="Warning",
                )
            self._mark_failed(alloc.alloc_id, f"{self.node_name}: {e}")
            if self.metrics:
                self.metrics.device_errors.inc()
            return
        if self.metrics:
            self.metrics.reserve_seconds.observe(time.monotonic() - t0)
        # crash point (docs/RECOVERY.md): the chips are reserved on the
        # device but the CR knows nothing yet — a death here is what
        # the restart orphan sweep + the stuck-grant watchdog recover
        maybe_crash("agent.realize")

        # Device handoff + node pinning for every pod this node serves.
        for pod in alloc.pods_on_node(key):
            env = slice_env(alloc, pod, self.node_name, ts.spec.generation,
                            device_uuids)
            cm = configmap_manifest(
                pod.handoff, pod.namespace, env, owner_pod_uid=pod.pod_uuid
            )
            try:
                self.client.create("ConfigMap", cm)
            except AlreadyExists:
                self.client.patch(
                    "ConfigMap", pod.namespace, pod.handoff,
                    {"data": env},
                )
            self._patch_node_capacity(pod.handoff, add=True)

        wid, local_key = alloc.parts[key]
        part = PreparedPart(
            node_name=self.node_name,
            worker_id=wid,
            local_box=local_key,
            chip_ids=chip_ids,
            device_handle=suid,
        )

        def mut(obj: dict) -> Optional[dict]:
            cur = TpuSlice.from_manifest(obj)
            a = cur.spec.allocations.get(alloc.alloc_id)
            if a is None or a.status not in (
                AllocationStatus.CREATING,
                AllocationStatus.CREATED,
            ):
                return None  # raced with delete/fail — leave it alone
            if key not in a.realized_on:
                a.realized_on.append(key)
            prep = cur.spec.prepared.get(suid)
            if prep is None:
                prep = PreparedDetails(
                    slice_uuid=suid,
                    pod_uuid=a.pods[0].pod_uuid if a.pods else "",
                    profile=a.profile,
                    box=a.box,
                    parts={},
                )
                cur.spec.prepared[suid] = prep
            elif not prep.pod_uuid:
                # a crashed-realize reservation the boot sweep adopted
                # as dangling: this IS its allocation — claim it so the
                # record stops reading as ownerless
                prep.pod_uuid = a.pods[0].pod_uuid if a.pods else ""
                prep.profile = a.profile
                prep.box = a.box
            prep.parts[key] = part
            # Note: the agent never flips CREATING→CREATED. Each agent
            # reports realized_on only in its own CR copy; the controller
            # aggregates the union across copies and owns the status
            # transition — otherwise no copy of a multi-host allocation
            # would ever look fully realized.
            return cur.to_manifest()

        update_with_retry(
            self.client, "TpuSlice", self.namespace, self.node_name, mut
        )
        log.info(
            "%s: realized %s (%s chips %s)",
            self.node_name, alloc.alloc_id, alloc.profile, chip_ids,
        )
        for pod in alloc.pods_on_node(key):
            emit_pod_event(
                self.client, pod.namespace, pod.pod_name,
                reason=REASON_REALIZED,
                message=(f"{self.node_name}: realized {alloc.profile} "
                         f"(chips {chip_ids})"),
                component=f"agent-{self.node_name}",
                pod_uid=pod.pod_uuid, trace_id=alloc.trace_id,
            )

    def _mark_failed(
        self,
        alloc_id: str,
        message: str,
        from_statuses=(AllocationStatus.CREATING,),
    ) -> None:
        def mut(obj: dict) -> Optional[dict]:
            cur = TpuSlice.from_manifest(obj)
            a = cur.spec.allocations.get(alloc_id)
            if a is None or a.status not in from_statuses:
                return None
            a.set_status(AllocationStatus.FAILED, message)
            return cur.to_manifest()

        update_with_retry(
            self.client, "TpuSlice", self.namespace, self.node_name, mut
        )

    # ------------------------------------------------------------ teardown

    def _teardown(self, ts: TpuSlice, alloc: AllocationDetails) -> None:
        with self.tracer.span(
            "agent.teardown", trace_id=alloc.trace_id or None,
            node=self.node_name, alloc=alloc.alloc_id,
        ):
            self._teardown_inner(ts, alloc)

    def _teardown_inner(self, ts: TpuSlice, alloc: AllocationDetails) -> None:
        suid = slice_uuid_for(alloc.alloc_id, multihost=len(alloc.parts) > 1)
        key = gpugrid.part_key(alloc, self.node_name, ts.spec.generation)
        # Always attempt release, even when this node never made it into
        # realized_on: a reserve that succeeded right as the allocation
        # was deleted (raced mut returning None) would otherwise leak the
        # device reservation forever.
        try:
            self.backend.release(suid)
        except SliceNotFound:
            pass
        except DeviceError as e:
            log.warning(
                "%s: release %s failed: %s (will retry)",
                self.node_name, suid, e,
            )
            if self.metrics:
                self.metrics.device_errors.inc()
            self.manager.queue.add(self.node_name, delay=1.0)
            return
        # crash point (docs/RECOVERY.md): chips released, CR still
        # carries the DELETED record + our realized_on — the restart
        # re-drives this teardown and release() is idempotent
        maybe_crash("agent.teardown")
        for pod in alloc.pods_on_node(key):
            try:
                self.client.delete("ConfigMap", pod.namespace, pod.handoff)
            except NotFound:
                pass
            self._patch_node_capacity(pod.handoff, add=False)

        def mut(obj: dict) -> Optional[dict]:
            cur = TpuSlice.from_manifest(obj)
            a = cur.spec.allocations.get(alloc.alloc_id)
            if a is None:
                return None
            if key in a.realized_on:
                a.realized_on.remove(key)
            prep = cur.spec.prepared.get(suid)
            if prep is not None:
                prep.parts.pop(key, None)
                if not prep.parts:
                    del cur.spec.prepared[suid]
            if not a.realized_on:
                # last agent out erases the allocation record entirely
                # (reference: instaslice_daemonset.go:252-267)
                del cur.spec.allocations[alloc.alloc_id]
            return cur.to_manifest()

        update_with_retry(
            self.client, "TpuSlice", self.namespace, self.node_name, mut
        )
        log.info("%s: tore down %s", self.node_name, alloc.alloc_id)
        get_journal().emit(
            f"agent-{self.node_name}",
            reason=REASON_TORN_DOWN,
            object_ref=f"alloc/{alloc.alloc_id}",
            message=f"released {suid} on {self.node_name}",
            trace_id=alloc.trace_id,
        )

    # -------------------------------------------------------------- health

    def _health_sweep(self) -> float:
        """Periodic per-chip health check (no reference analog: SURVEY.md
        §5 — "no health monitoring of slices"). Publishes failed chip ids
        to ``status.unhealthyChips`` via the status subresource (a plain
        update would be silently dropped by a real apiserver once the CRD
        declares ``subresources.status``) and fails in-flight allocations
        touching dead chips. Degraded GRANTED slices are the controller's
        business: it has the cross-node view a multi-host slice needs
        (``controller/reconciler.py: _reconcile_slice_health``), and the
        status write below is exactly what wakes it up."""
        try:
            health = self.backend.chip_health()
        except DeviceError as e:
            log.warning("%s: chip health probe failed: %s",
                        self.node_name, e)
            if self.metrics:
                self.metrics.device_errors.inc()
            return self.health_interval
        failed = sorted(i for i, ok in health.items() if not ok)
        if self.metrics:
            self.metrics.unhealthy_chips.labels(
                node=self.node_name
            ).set(len(failed))

        try:
            ts = TpuSlice.from_manifest(
                self.client.get("TpuSlice", self.namespace, self.node_name)
            )
        except NotFound:
            return self.health_interval
        if sorted(ts.status.unhealthy_chips) != failed:
            try:
                self.client.patch_status(
                    "TpuSlice", self.namespace, self.node_name,
                    {"unhealthyChips": failed},
                )
            except NotFound:
                return self.health_interval
            get_journal().emit(
                f"agent-{self.node_name}",
                reason=(REASON_CHIP_UNHEALTHY if failed
                        else REASON_CHIP_HEALED),
                object_ref=f"node/{self.node_name}",
                message=(f"chips {failed} unhealthy" if failed
                         else "all chips healthy again"),
            )
        if not failed:
            return self.health_interval

        failed_set = set(failed)
        for alloc_id in sorted(ts.spec.allocations):
            alloc = ts.spec.allocations[alloc_id]
            if gpugrid.part_key(alloc, self.node_name,
                                ts.spec.generation) is None:
                continue
            dead = failed_set.intersection(self._chip_ids_for(ts, alloc))
            if not dead:
                continue
            if alloc.status in (
                AllocationStatus.CREATING,
                AllocationStatus.CREATED,
            ):
                msg = f"{self.node_name}: chips {sorted(dead)} unhealthy"
                log.warning("failing in-flight allocation %s: %s",
                            alloc_id, msg)
                self._mark_failed(
                    alloc_id, msg,
                    from_statuses=(
                        AllocationStatus.CREATING,
                        AllocationStatus.CREATED,
                    ),
                )
        return self.health_interval

    # ---------------------------------------------------------------- node

    def _patch_node_capacity(self, handoff_name: str, add: bool) -> None:
        """Advertise/remove the per-pod extended resource on the Node
        (reference: ``createInstaSliceResource`` /
        ``cleanUpInstaSliceResource``, instaslice_daemonset.go:277-300,
        415-440). The per-pod resource is what pins the pod to the node
        that realized its slice; named by the pod's handoff name (pod name,
        or the stable handoff-name annotation for template-managed pods)."""
        res = f"{POD_RESOURCE_PREFIX}{handoff_name}"
        val = "1" if add else None
        try:
            self.client.patch_status(
                "Node", "", self.node_name,
                {
                    "capacity": {res: val},
                    "allocatable": {res: val},
                },
            )
        except NotFound:
            # Node objects are optional in unit tests / fake clusters.
            log.debug("node %s absent; skipping capacity patch",
                      self.node_name)
