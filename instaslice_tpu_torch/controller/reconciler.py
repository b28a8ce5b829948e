"""Controller reconciler: the allocation lifecycle driver.

Reference analog: ``InstasliceReconciler.Reconcile``
(``instaslice_controller.go:64-237``) and the flows in SURVEY.md
§3.1/§3.3. Reference quirks deliberately fixed:

- exactly one placement per request (the reference's node loop lacks a
  ``break`` and can double-allocate, ``:190-227``);
- multi-host allocations fan out to all involved CRs and repair partial
  fan-out on retry (the reference has no multi-node coordination);
- a ``failed`` realization is torn down and retried instead of wedging;
- pods force-deleted without our finalizer still get their allocations
  reaped (orphan cleanup on pod NotFound).

A copy of ``instaslice_tpu/controller/reconciler.py`` (the port imports
nothing of the JAX package). On every TPU generation it is the
reference's line for line; on a GPU grid (the H100 80GB's MIG grid, or
a card without a MIG catalog) it takes the rules of
:mod:`~instaslice_tpu_torch.controller.gpugrid` where the reference
reads a torus: the node's group of GPUs, the node's CR as the holder of
every part, the in-flight overlay by group id, GPU indices for chips,
an avoided node's every GPU, and a request read against each group's
own catalog.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from instaslice_tpu_torch.api.constants import (
    CAUSED_BY_ANNOTATION,
    FINALIZER,
    GATE_NAME,
    KIND,
    LEGACY_GATE_NAME,
    REASON_ADMITTED,
    REASON_CRASH_RECOVERED,
    REASON_DEGRADED,
    REASON_GRANT_DEADLINE,
    REASON_HEALED,
    REASON_HEALTH_EVICTED,
    REASON_NO_CAPACITY,
    REASON_PLACED,
    REASON_REJECTED,
    REASON_RETRYING,
    REASON_UNGATED,
)
from instaslice_tpu_torch.faults import maybe_crash
from instaslice_tpu_torch.obs.journal import emit_pod_event, get_journal
from instaslice_tpu_torch.api import (
    AllocationDetails,
    AllocationStatus,
    PodRef,
    TpuSlice,
    slice_uuid_for,
)
from instaslice_tpu_torch.controller import gpugrid
from instaslice_tpu_torch.controller.gates import (
    ERROR_ANNOTATION,
    GROUP_ANNOTATION,
    GROUP_SIZE_ANNOTATION,
    HANDOFF_ANNOTATION,
    extract_profile,
    is_pod_gated,
    pod_group,
)
from instaslice_tpu_torch.kube.client import (
    KubeClient,
    NotFound,
    update_with_retry,
)
from instaslice_tpu_torch.kube.coalesce import CoalescedWriter
from instaslice_tpu_torch.topology.grid import (
    NodeGrid,
    Shape,
    TorusGroup,
    get_generation,
    id_to_coord,
    volume,
)
from instaslice_tpu_torch.topology.frag import frag_metrics, snapshot_line
from instaslice_tpu_torch.topology.placement import Box, Occupancy, Placement
from instaslice_tpu_torch.topology.policy import AllocationPolicy, get_policy
from instaslice_tpu_torch.topology.profiles import TopologyProfile
from instaslice_tpu_torch.utils.reconcile import Manager, default_workers
from instaslice_tpu_torch.utils.trace import (
    TRACE_ID_SAFE,
    get_tracer,
    new_trace_id,
)

log = logging.getLogger("instaslice_tpu_torch.controller")

# ------------------------------------------------- informer index names
#: gated pods by "<namespace>/<group-id>" — the namespace scan
#: `_group_peers` used to do
INDEX_GATED_GROUP = "gated-group"
#: TpuSlice CRs by torus group id (spec.torusGroup, or the CR name for
#: standalone hosts)
INDEX_SLICE_GROUP = "torus-group"
#: TpuSlice CRs holding an allocation for a pod, by "uid:<pod-uid>" and
#: "key:<namespace>/<pod-name>" — makes `_find_allocation` O(holders)
INDEX_SLICE_POD = "alloc-pod"


def pod_indexers():
    def gated_group(obj: dict) -> List[str]:
        if not is_pod_gated(obj):
            return []
        md = obj.get("metadata", {})
        gid = (md.get("annotations") or {}).get(GROUP_ANNOTATION, "")
        if not gid:
            return []
        return [f"{md.get('namespace', '')}/{gid}"]

    return {INDEX_GATED_GROUP: gated_group}


def slice_indexers():
    def by_group(obj: dict) -> List[str]:
        name = obj.get("metadata", {}).get("name", "")
        return [obj.get("spec", {}).get("torusGroup") or name]

    def by_pod(obj: dict) -> List[str]:
        keys = []
        for alloc in obj.get("spec", {}).get("allocations", {}).values():
            for p in alloc.get("pods", []):
                if p.get("podUUID"):
                    keys.append(f"uid:{p['podUUID']}")
                keys.append(
                    f"key:{p.get('namespace', '')}/{p.get('podName', '')}"
                )
        return keys

    return {INDEX_SLICE_GROUP: by_group, INDEX_SLICE_POD: by_pod}


from instaslice_tpu_torch.utils.timeutil import parse_timestamp as _parse_timestamp
from instaslice_tpu_torch.utils.lockcheck import named_lock
from instaslice_tpu_torch.utils.guards import guarded_by, requires


class Controller:
    # shared across the sharded reconcile workers, the repacker loop,
    # and external callers (status endpoints, tests)
    _pending: guarded_by("controller.pending")
    _pending_profiles: guarded_by("controller.pending")
    _pending_trace: guarded_by("controller.pending")
    _failed_nodes: guarded_by("controller.failed_nodes")
    _inflight: guarded_by("controller.placement")

    def __init__(
        self,
        client: KubeClient,
        namespace: str = "instaslice-tpu-system",
        policy: str | AllocationPolicy = "first-fit",
        deletion_grace_seconds: float = 30.0,
        no_capacity_requeue: float = 2.0,
        metrics=None,
        fence=None,
        workers: Optional[int] = None,
        use_cache: bool = True,
        shard_lease: Optional[dict] = None,
        stuck_grant_deadline: Optional[float] = None,
    ) -> None:
        """``fence``: optional ``() -> bool`` leadership check; when it
        turns False every subsequent CR/pod write raises ``Fenced`` so a
        deposed leader cannot race its successor (update_with_retry
        re-checks it on every conflict retry).

        ``stuck_grant_deadline``: the self-healing watchdog bound
        (docs/RECOVERY.md) — an allocation stuck in ``creating`` this
        many seconds is rolled back and re-placed
        (``GrantDeadlineExceeded``), and a ``deleted`` record no agent
        erased within the same bound stops blocking its pod: the
        controller re-places under a fresh attempt epoch and leaves the
        stale copy for the (dead) agent's restart to reap. Default:
        ``TPUSLICE_STUCK_GRANT_DEADLINE`` or 300 s.

        ``workers``: reconcile concurrency (key-hash sharded; per-key
        ordering preserved). Default: ``TPUSLICE_RECONCILE_WORKERS`` or
        4 (docs/SCALING.md).

        ``use_cache=False`` restores the pre-informer serial behavior —
        full re-list per reconcile, direct (uncoalesced) CR writes —
        kept as the measured baseline for ``bench.py --scale``.

        ``shard_lease``: per-shard Lease leadership config forwarded to
        the :class:`Manager` (multi-replica shard splitting)."""
        self.client = client
        self.fence = fence
        self.workers = (
            default_workers(4) if workers is None else max(1, int(workers))
        )
        self._use_cache = use_cache
        self.namespace = namespace
        self.policy = (
            policy if isinstance(policy, AllocationPolicy) else get_policy(policy)
        )
        self.grace = deletion_grace_seconds
        self.no_capacity_requeue = no_capacity_requeue
        if stuck_grant_deadline is None:
            from instaslice_tpu_torch.utils.envutil import env_float

            stuck_grant_deadline = env_float(
                "TPUSLICE_STUCK_GRANT_DEADLINE", 300.0)
        self.stuck_grant_deadline = stuck_grant_deadline
        self.metrics = metrics
        self._pending_lock = named_lock("controller.pending")
        self._pending: set = set()
        #: pod key → requested profile name for capacity-starved pods —
        #: the repacker's trigger set (controller/defrag.py): a pending
        #: 2x2 here plus only-relocatable 1x1s in the way is exactly the
        #: stranded-capacity pattern it exists to clear
        self._pending_profiles: Dict[str, str] = {}
        #: pod key → trace id minted on the pod's FIRST no-capacity
        #: attempt: every ~2s requeue re-probes under the SAME trace id
        #: (and only the first attempt records a span), so a pod waiting
        #: an hour is one pending trace, not ~1800 single-span traces
        #: evicting real grants from the ring and the trace file
        self._pending_trace: Dict[str, str] = {}
        #: pod_uid → {node: monotonic deadline}: nodes whose device
        #: layer just failed this pod's allocation. The retry placement
        #: avoids them (falling back to ANY capacity when nothing else
        #: fits — a single-node cluster must still retry in place), so
        #: a node with a persistently failing device API cannot capture
        #: a pod in a fail→re-place-same-node loop.
        self._failed_nodes: Dict[str, Dict[str, float]] = {}
        self._failed_nodes_lock = named_lock("controller.failed_nodes")
        self.failed_node_avoid_seconds = 120.0
        #: placement critical section (in-memory only — never held
        #: across kube I/O): sharded workers compute placements one at
        #: a time against cache + overlay, then fan the writes out in
        #: parallel
        self._placement_lock = named_lock("controller.placement")
        #: alloc_id → (Box, involved node names, group id): placements
        #: chosen but whose CR writes have not landed in the cache yet;
        #: folded into occupancy so a concurrent worker can't hand out
        #: the same chips
        self._inflight: Dict[str, Tuple[Box, frozenset, str]] = {}
        #: gid → (signature, TorusGroup): memoized group construction
        #: for the legacy full-scan path (signature = member
        #: names/offsets/generation — NOT allocations)
        self._group_cache: Dict[str, Tuple[tuple, TorusGroup]] = {}
        #: gid → (index version, members, TorusGroup): per-group view
        #: for the indexed placement path, rebuilt only when the
        #: informer's per-group version moved
        self._members_cache: Dict[str, tuple] = {}
        #: (gid, profile, policy name) → (index version, in-flight
        #: overlay signature) under which the group had no room — an
        #: O(1) skip until one of its CRs actually changes. The policy
        #: name is part of the key: a runtime policy swap (or a policy
        #: that declines candidates a scan-order policy would take)
        #: must never inherit another policy's stale no-fit verdicts.
        self._no_fit: Dict[Tuple[str, str, str], tuple] = {}
        self.manager = Manager(
            name="controller",
            client=client,
            reconcile=self.reconcile,
            watches=[
                ("Pod", None, self._pod_map),
                (KIND, namespace, self._tpuslice_map),
            ],
            workers=self.workers,
            indexers={"Pod": pod_indexers(), KIND: slice_indexers()},
            transforms={KIND: TpuSlice.from_manifest},
            shard_lease=shard_lease,
        )
        self._pods_inf = self.manager.informer("Pod")
        self._slices_inf = self.manager.informer(KIND)
        #: batches same-CR allocation mutations from concurrent workers
        #: into one optimistic-concurrency round-trip (kube/coalesce.py)
        self._cr_writer = (
            CoalescedWriter(client, KIND, namespace, fence=fence)
            if use_cache else None
        )

    # --------------------------------------------------------------- wiring

    @staticmethod
    def _pod_map(event: str, obj: dict) -> List[str]:
        md = obj.get("metadata", {})
        return [f"{md.get('namespace', '')}/{md.get('name', '')}"]

    def _tpuslice_map(self, event: str, obj: dict) -> List[str]:
        """CR change → re-reconcile every pod it references (reference:
        ``podMapFunc``, instaslice_controller.go:398-407)."""
        keys = []
        for alloc in obj.get("spec", {}).get("allocations", {}).values():
            for p in alloc.get("pods", []):
                keys.append(f"{p.get('namespace', '')}/{p.get('podName', '')}")
        return keys

    @property
    def tracer(self):
        # resolved per use, never cached at construction: after
        # reset_tracer() (test isolation, trace-file rebinding) the
        # controller's spans must land in the NEW default tracer, not
        # an orphaned closed ring
        return get_tracer()

    def start(self) -> None:
        self.manager.start()
        if self._use_cache:
            # reconcile decisions read the cache; don't let the first
            # keys race an empty store (workers would mis-read "no
            # capacity" / "pod gone" before the initial relist lands)
            self.manager.wait_synced(timeout=10.0)

    def stop(self) -> None:
        self.manager.stop()

    # ---------------------------------------------------------- CR reading

    def _cache_ready(self) -> bool:
        return (
            self._use_cache
            and self._slices_inf is not None
            and self._slices_inf.synced()
        )

    def _get_pod(self, namespace: str, name: str) -> dict:
        """Pod read for reconcile decisions: informer cache once synced
        (reconcile keys COME from its events, so the store is at least
        as new as the event that queued us), API server before that.
        Cache objects are shared and read-only; every pod write below
        goes through get-mutate-update against the server."""
        if (
            self._use_cache
            and self._pods_inf is not None
            and self._pods_inf.synced()
        ):
            obj = self._pods_inf.get(namespace, name)
            if obj is None:
                raise NotFound(f"Pod {namespace}/{name} not found")
            return obj
        return self.client.get("Pod", namespace, name)

    def _load_slices(self) -> List[TpuSlice]:
        """All TpuSlice CRs, PARSED — from the informer's transform
        cache (one parse per stored resourceVersion) instead of a full
        re-list + re-parse per reconcile. The returned objects are
        shared, read-only views; mutations go through
        ``update_with_retry`` / the coalesced writer."""
        if self._cache_ready():
            return self._slices_inf.list_transformed()  # type: ignore
        return [
            TpuSlice.from_manifest(m)
            for m in self.client.list(KIND, namespace=self.namespace)
        ]

    def _torus_groups(
        self, slices: List[TpuSlice]
    ) -> Dict[str, Tuple[TorusGroup, List[TpuSlice]]]:
        """Group per-node CRs into physical meshes. Bounds = tight hull of
        member host tiles (sparse groups allowed)."""
        by_group: Dict[str, List[TpuSlice]] = {}
        for ts in slices:
            if not ts.status.processed or not ts.spec.generation:
                continue
            gid = ts.spec.torus_group or ts.name
            by_group.setdefault(gid, []).append(ts)
        out: Dict[str, Tuple[TorusGroup, List[TpuSlice]]] = {}
        for gid, members in by_group.items():
            if gpugrid.is_gpu_grid(members[0].spec.generation):
                gpus = gpugrid.build_group(gid, members)
                if gpus is not None:
                    out[gid] = (gpus, members)
                continue
            # memoize TorusGroup/NodeGrid construction on the topology
            # signature — names/offsets/generation never change per
            # grant, only allocations do, so at fleet scale this turns
            # an O(nodes) rebuild per reconcile into a dict hit
            sig = (
                members[0].spec.generation,
                tuple(sorted(
                    (m.name, tuple(m.spec.host_offset)) for m in members
                )),
            )
            cached = self._group_cache.get(gid)
            if cached is not None and cached[0] == sig:
                out[gid] = (cached[1], members)
                continue
            gen = get_generation(members[0].spec.generation)
            if any(m.spec.generation != members[0].spec.generation
                   for m in members):
                log.warning("torus group %s mixes generations; skipping", gid)
                continue
            hb = gen.host_bounds
            bounds: Shape = tuple(  # type: ignore[assignment]
                max(m.spec.host_offset[i] for m in members) + hb[i]
                for i in range(3)
            )
            try:
                group = TorusGroup(
                    group_id=gid,
                    generation=gen,
                    bounds=bounds,
                    hosts={
                        m.name: NodeGrid(
                            generation=gen,
                            host_offset=m.spec.host_offset,
                            torus_group=gid,
                        )
                        for m in members
                    },
                )
            except ValueError as e:
                log.warning("torus group %s invalid: %s", gid, e)
                continue
            self._group_cache[gid] = (sig, group)
            out[gid] = (group, members)
        return out

    @requires("controller.placement")
    def _occupancy(self, group: TorusGroup, members: List[TpuSlice]) -> Occupancy:
        """Union of desired (allocations) and realized (prepared) boxes,
        deduped across the member CRs an allocation is fanned out to
        (reference scans both sources too: instaslice_controller.go:306-329),
        plus the in-flight overlay — placements another worker chose
        whose CR writes haven't landed in the cache yet (caller holds
        ``_placement_lock``). Chips the agents report unhealthy are
        blocked last — they may sit inside live boxes (that grant's fate
        is the health monitor's call) but must never enter a new
        placement."""
        occ = Occupancy(group)
        seen: Dict[str, str] = {}
        for aid, (box, nodes, _gid) in self._inflight.items():
            if not gpugrid.inflight_applies(group, nodes, _gid) \
                    or aid in seen:
                continue
            # same seen-key scheme as the CR loop below, so an overlay
            # entry whose write already landed in a cached CR is not
            # occupied twice
            seen[aid] = box.key()
            occ.occupy(box, owner=f"a-{aid}")
        for ts in members:
            for alloc in ts.spec.allocations.values():
                if seen.get(alloc.alloc_id) == alloc.box:
                    continue
                seen[alloc.alloc_id] = alloc.box
                occ.occupy(Box.from_key(alloc.box), owner=f"a-{alloc.alloc_id}")
            for suid, prep in ts.spec.prepared.items():
                covered = any(
                    suid in (
                        slice_uuid_for(aid),
                        slice_uuid_for(aid, multihost=True),
                    )
                    for aid in ts.spec.allocations
                )
                if covered or seen.get(f"p-{suid}"):
                    continue
                seen[f"p-{suid}"] = prep.box
                occ.occupy(Box.from_key(prep.box), owner=f"p-{suid}")
        if gpugrid.is_gpu_grid(group.generation.name):
            occ.block(gpugrid.blocked_coords(group, members))
            return occ
        hb = group.generation.host_bounds
        for ts in members:
            if not ts.status.unhealthy_chips:
                continue
            grid = group.hosts.get(ts.name)
            if grid is None:
                continue
            occ.block([
                grid.global_coord(id_to_coord(cid, hb))
                for cid in ts.status.unhealthy_chips
                if 0 <= cid < volume(hb)
            ])
        return occ

    # Status precedence when merging per-CR copies of one allocation: a
    # terminal/failure state reported by ANY copy wins.
    _STATUS_PRECEDENCE = [
        AllocationStatus.DELETED,
        AllocationStatus.FAILED,
        AllocationStatus.UNGATED,
        AllocationStatus.CREATED,
        AllocationStatus.CREATING,
    ]

    def _find_allocation(
        self, slices: List[TpuSlice], pod_uid: str = "", pod_key: str = ""
    ) -> Optional[Tuple[AllocationDetails, List[TpuSlice]]]:
        """Locate an allocation by pod uid (or ns/name key) and every CR
        holding a copy, returning a MERGED view: each agent reports
        ``realized_on`` / status only in its own CR copy, so the union
        (and worst status) across copies is the cluster truth.

        Crash consistency (docs/RECOVERY.md): only copies of the
        NEWEST ``attempt_epoch`` merge. A crashed writer's half-landed
        older epoch (e.g. a DELETED copy a dead agent never erased)
        must not pollute the live epoch's realized_on/status — without
        the epoch fence, one stale DELETED copy would pin the merged
        status at DELETED forever and wedge the pod."""
        if self._cache_ready():
            # alloc-pod secondary index: only the holder CRs, not a
            # cluster-wide scan per reconcile
            ikey = f"uid:{pod_uid}" if pod_uid else f"key:{pod_key}"
            candidates = self._slices_inf.by_index(  # type: ignore
                INDEX_SLICE_POD, ikey, transformed=True
            )
        else:
            candidates = slices
        copies: List[AllocationDetails] = []
        holders: List[TpuSlice] = []
        for ts in candidates:
            for alloc in ts.spec.allocations.values():
                for p in alloc.pods:
                    if (pod_uid and p.pod_uuid == pod_uid) or (
                        pod_key
                        and f"{p.namespace}/{p.pod_name}" == pod_key
                    ):
                        copies.append(alloc)
                        if ts not in holders:
                            holders.append(ts)
                        break
        if not copies:
            return None
        top_epoch = max(c.attempt_epoch for c in copies)
        live = [c for c in copies if c.attempt_epoch == top_epoch]
        realized = set()
        messages = []
        status = AllocationStatus.CREATING
        for c in live:
            realized.update(c.realized_on)
            if c.message:
                messages.append(c.message)
            if self._STATUS_PRECEDENCE.index(
                c.status
            ) < self._STATUS_PRECEDENCE.index(status):
                status = c.status
        # Fresh object: live[0] is the live parsed spec inside a
        # holder; writing the synthetic merged view onto it would
        # persist it if a holder were ever serialized after the merge.
        merged = dataclasses.replace(
            live[0],
            realized_on=sorted(realized),
            status=status,
            message="; ".join(messages),
        )
        return merged, holders

    # ------------------------------------------------------------ reconcile

    def reconcile(self, key: str) -> Optional[float]:
        if self.metrics:
            self.metrics.reconciles.labels(component="controller").inc()
        ns, _, name = key.partition("/")
        try:
            pod = self._get_pod(ns, name)
        except NotFound:
            return self._reap_orphan(key)

        md = pod.get("metadata", {})
        if md.get("deletionTimestamp"):
            return self._handle_deletion(pod)

        if not is_pod_gated(pod):
            return self._maybe_finish_ungate(pod)

        return self._handle_gated(pod)

    # ----------------------------------------------------------- gated path

    def _handle_gated(self, pod: dict) -> Optional[float]:
        md = pod["metadata"]
        pod_uid = md.get("uid", "")
        slices = self._load_slices()
        existing = self._find_allocation(slices, pod_uid=pod_uid)
        #: crash recovery: >0 when a stale deleted epoch is being
        #: superseded — the fresh placement carries this attempt epoch
        #: and avoids the nodes still holding the unerased copy
        reuse_epoch = 0
        reuse_avoid: frozenset = frozenset()

        if existing is not None:
            alloc, holders = existing
            if alloc.status in (
                AllocationStatus.CREATING,
                AllocationStatus.CREATED,
                AllocationStatus.UNGATED,
            ):
                # never "repair" DELETED/FAILED fan-out: a missing copy
                # there means the agent already finished teardown and
                # re-writing the record would re-trigger it
                self._repair_fanout(alloc, slices)
            if (
                alloc.status == AllocationStatus.CREATING
                and alloc.fully_realized()
            ):
                # every agent reported in → promote, then ungate below
                self._promote_created(alloc)
                alloc.status = AllocationStatus.CREATED
            if alloc.status == AllocationStatus.CREATED:
                self._ungate_all(alloc)
                return None
            if alloc.status == AllocationStatus.FAILED:
                log.warning(
                    "allocation %s failed (%s); tearing down for retry",
                    alloc.alloc_id, alloc.message,
                )
                for ref in alloc.pods:
                    emit_pod_event(
                        self.client, ref.namespace, ref.pod_name,
                        reason=REASON_RETRYING,
                        message=(f"allocation failed: {alloc.message}; "
                                 "tearing down for retry"),
                        component="controller", pod_uid=ref.pod_uuid,
                        trace_id=alloc.trace_id, event_type="Warning",
                    )
                # only the node(s) whose OWN CR copy reports FAILED are
                # at fault — a healthy peer of a multi-host allocation
                # must stay placeable or the retry can be squeezed back
                # onto the failing node
                failing = {
                    ts.name
                    for ts in holders
                    for a in ts.spec.allocations.values()
                    if a.alloc_id == alloc.alloc_id
                    and a.attempt_epoch == alloc.attempt_epoch
                    and a.status == AllocationStatus.FAILED
                } or set(gpugrid.holders(alloc))
                now = time.monotonic()
                deadline = now + self.failed_node_avoid_seconds
                with self._failed_nodes_lock:
                    for ref in alloc.pods:
                        avoid = self._failed_nodes.setdefault(
                            ref.pod_uuid, {}
                        )
                        for node in failing:
                            avoid[node] = deadline
                    # global prune on write: uids that never re-place
                    # again must not pin expired entries forever
                    for uid in list(self._failed_nodes):
                        live = {n: dl for n, dl
                                in self._failed_nodes[uid].items()
                                if dl > now}
                        if live:
                            self._failed_nodes[uid] = live
                        else:
                            del self._failed_nodes[uid]
                self._mark_deleted(alloc)
                return 0.5
            if alloc.status == AllocationStatus.UNGATED:
                # our pod-ungate write must have been lost; redo it
                self._ungate_all(alloc)
                return None
            if (
                alloc.status == AllocationStatus.CREATING
                and self._grant_overdue(alloc)
            ):
                # stuck-grant watchdog (docs/RECOVERY.md): agents that
                # never realized within the deadline — a crashed agent,
                # a wedged device API — roll the epoch back and re-place
                # away from the laggards
                return self._grant_deadline_rollback(alloc)
            if self._stuck_deleted(alloc):
                # the teardown landed in the CR but no agent erased it
                # within the deadline (the agent died): stop waiting —
                # re-place under a fresh attempt epoch, avoiding the
                # nodes still holding the stale copy (its box stays in
                # occupancy, so the dead node's chips are never handed
                # out twice; the agent's restart reaps the copy)
                reuse_epoch = alloc.attempt_epoch + 1
                reuse_avoid = frozenset(
                    ts.name for ts in holders
                    if alloc.alloc_id in ts.spec.allocations
                )
                log.warning(
                    "allocation %s: deleted epoch %d unerased past "
                    "deadline; re-placing as epoch %d (avoiding %s)",
                    alloc.alloc_id, alloc.attempt_epoch, reuse_epoch,
                    sorted(reuse_avoid),
                )
            else:
                return self.no_capacity_requeue  # CREATING/DELETED: wait

        # ----- new allocation -----
        try:
            profile = extract_profile(pod)
        except ValueError as e:
            log.warning("pod %s/%s: %s", md.get("namespace"), md.get("name"), e)
            self._annotate_error(pod, str(e))
            return None
        if profile is None:
            return None  # not a TPU pod; ignore

        try:
            gid, size = pod_group(pod)
        except ValueError as e:
            self._annotate_error(pod, str(e))
            return None

        pods = [pod]
        if gid:
            peers = self._group_peers(md.get("namespace", ""), gid)
            if len(peers) < size:
                # Not enough GATED peers — but the group may already be
                # fully granted (its members ungated, so invisible to
                # _group_peers). Then this pod is surplus and must be
                # told so; silently requeueing would livelock forever.
                aid = self._group_alloc_id(md.get("namespace", ""), gid)
                for ts in slices:
                    a = ts.spec.allocations.get(aid)
                    if a is not None and not any(
                        p.pod_uuid == md.get("uid") for p in a.pods
                    ):
                        self._annotate_error(
                            pod,
                            f"pod group {gid!r} already has {size} "
                            "members; this pod is surplus (raise "
                            f"{GROUP_SIZE_ANNOTATION}?)",
                        )
                        return None
                return 1.0  # wait for the rest of the group
            pods = peers[:size]
            # A stable handoff name is per-POD state (ConfigMap + node
            # resource); a template-stamped identical name across a
            # multi-pod group would make agents overwrite each other's
            # worker env and tear down the survivor's ConfigMap. Refuse it.
            handoffs = [
                (p["metadata"].get("annotations") or {}).get(
                    HANDOFF_ANNOTATION, ""
                )
                for p in pods
            ]
            named = [h for h in handoffs if h]
            if named and len(set(named)) < len(pods):
                self._annotate_error(
                    pod,
                    f"pod group {gid!r}: {HANDOFF_ANNOTATION} must be "
                    "unique per pod (or omitted) in a multi-host group — "
                    "grouped pods each need their own handoff ConfigMap",
                )
                return None
            if not any(
                p["metadata"].get("uid") == md.get("uid") for p in pods
            ):
                # surplus member beyond group-size: surface it instead of
                # silently recomputing placements forever
                self._annotate_error(
                    pod,
                    f"pod group {gid!r} already has {size} members; this "
                    f"pod is surplus (raise {GROUP_SIZE_ANNOTATION}?)",
                )
                return None
        want_hosts = profile.hosts_needed()
        if len(pods) != want_hosts:
            self._annotate_error(
                pod,
                f"profile {profile.name} spans {want_hosts} host(s) but pod "
                f"group has {len(pods)} pod(s); set "
                f"{GROUP_SIZE_ANNOTATION}={want_hosts}",
            )
            return None

        avoid = self._avoid_nodes_for(pod_uid) | reuse_avoid
        # Admission into the allocation pipeline: mint THE trace id for
        # this grant. It is persisted on the allocation record, so the
        # agent's realize/teardown spans, the device-layer spans, and
        # the ungate all join the same trace (docs/OBSERVABILITY.md).
        # A capacity-starved pod keeps the id minted on its first
        # attempt, so the whole wait and the eventual grant are ONE
        # trace — and the ~2s requeues in between don't each record a
        # root span (the first pending attempt and the grant do).
        pod_key = self._pod_key(pod)
        with self._pending_lock:
            pending_tid = self._pending_trace.get(pod_key)
        trace_id = pending_tid or new_trace_id()
        # demand→supply causality: a pod submitted ON BEHALF of a
        # capacity-blocked request carries the blocked serving trace id
        # in its caused-by annotation; the grant's span and Admitted
        # event record it so the telemetry plane can stitch the two
        # traces into one timeline. Same sanitizer as X-Trace-Id —
        # annotation content must not leak into JSONL files unchecked.
        caused_by = (md.get("annotations") or {}).get(
            CAUSED_BY_ANNOTATION, ""
        )
        if caused_by and not TRACE_ID_SAFE.match(caused_by):
            caused_by = ""
        if pending_tid is None:
            # first attempt for this pod (capacity-starved requeues
            # re-enter with the pending trace id and stay silent):
            # admission into the allocation pipeline is THE "gated"
            # stage of the grant's event chain (make events-check)
            emit_pod_event(
                self.client, md.get("namespace", ""), md["name"],
                reason=REASON_ADMITTED,
                message=f"admitted: profile {profile.name}",
                component="controller", pod_uid=pod_uid,
                trace_id=trace_id,
                **({"caused_by": caused_by} if caused_by else {}),
            )
        pod_refs = [
            PodRef(
                pod_uuid=p["metadata"].get("uid", ""),
                pod_name=p["metadata"]["name"],
                namespace=p["metadata"].get("namespace", ""),
                worker_id=i,
                handoff_name=(
                    p["metadata"].get("annotations") or {}
                ).get(HANDOFF_ANNOTATION, ""),
            )
            for i, p in enumerate(
                sorted(pods, key=lambda p: p["metadata"]["name"])
            )
        ]
        if gid:
            aid = self._group_alloc_id(pod_refs[0].namespace, gid)
        else:
            aid = pod_refs[0].pod_uuid
        with self.tracer.span(
            "controller.allocate", trace_id=trace_id,
            pod=pod_key, profile=profile.name,
            **({"caused_by": caused_by} if caused_by else {}),
        ) as sp:
            # Placement critical section: in-memory only (cache +
            # overlay), never held across kube I/O — sharded workers
            # serialize the CHOICE of chips and parallelize everything
            # else (finalizers, CR fan-out, ungates, events).
            with self.tracer.span("controller.place") as psp, \
                    self._placement_lock:
                if aid in self._inflight:
                    # a peer pod's worker is granting this very
                    # allocation right now; take the existing path
                    # once its writes land
                    sp.drop = psp.drop = True
                    return 0.1
                if self._cache_ready():
                    # recheck behind the lock: a peer worker may have
                    # granted this allocation after our stale top-of-
                    # reconcile read (write-through makes it visible).
                    # A stuck deleted epoch does NOT count as granted —
                    # superseding it is exactly why we are here.
                    rechecked = self._find_allocation(
                        slices, pod_uid=pod_uid
                    )
                    if rechecked is not None and not self._stuck_deleted(
                        rechecked[0]
                    ):
                        sp.drop = psp.drop = True
                        return 0.05
                    # fresh cache view under the lock (the list read
                    # at the top of the reconcile predates it)
                    slices = self._load_slices()
                placement = self._place(profile, slices, avoid=avoid)
                if placement is None and avoid - reuse_avoid:
                    # nothing fits elsewhere — the failed node may be
                    # the only capacity (single-node cluster): retry in
                    # place rather than starving the pod. Stale-epoch
                    # holders stay avoided: their CR slot is occupied
                    # by the unerased record, so a placement there is
                    # GUARANTEED to bounce off the epoch fence — the
                    # fallback would only buy a re-place/teardown loop
                    placement = self._place(profile, slices,
                                            avoid=reuse_avoid)
                if placement is not None:
                    self._inflight[aid] = (
                        placement.box,
                        frozenset(placement.node_names),
                        placement.group_id,
                    )
                frag_note = ""
                if placement is None and pending_tid is None:
                    # the once-per-wait NoCapacity event carries a
                    # fragmentation snapshot (largest free box per
                    # group), so an operator can tell "chips free but
                    # scattered" from true exhaustion without tooling;
                    # computed here because occupancy reads require the
                    # placement lock
                    frag_note = self._frag_note(profile, slices)
            if placement is None:
                sp.attrs["placed"] = "false"
                sp.drop = pending_tid is not None
                if pending_tid is None:
                    # first no-capacity verdict only: the ~2s requeues
                    # would otherwise flood the journal and the pod's
                    # kubectl-describe event list
                    emit_pod_event(
                        self.client, md.get("namespace", ""), md["name"],
                        reason=REASON_NO_CAPACITY,
                        message=(f"no {profile.name} capacity; waiting "
                                 f"(re-probing every "
                                 f"{self.no_capacity_requeue:g}s)"
                                 + (f"; {frag_note}" if frag_note
                                    else "")),
                        component="controller", pod_uid=pod_uid,
                        trace_id=trace_id, event_type="Warning",
                    )
                with self._pending_lock:
                    self._pending_trace[pod_key] = trace_id
                self._set_pending(pod_key, True, profile=profile.name)
                return self.no_capacity_requeue
            self._set_pending(pod_key, False)
            sp.attrs["box"] = placement.box.key()
            if reuse_epoch:
                # the epoch marker precedes the fresh creating
                # transition, so `validate_events --epochs` splits the
                # chain exactly here
                get_journal().emit(
                    "controller", reason=REASON_CRASH_RECOVERED,
                    object_ref=f"alloc/{aid}",
                    message=(f"stale deleted epoch unerased past "
                             f"deadline; re-placing as attempt epoch "
                             f"{reuse_epoch}"),
                    trace_id=trace_id,
                )
            alloc = AllocationDetails.from_placement(
                placement, pod_refs, alloc_id=aid, trace_id=trace_id,
                attempt_epoch=reuse_epoch or 1,
                note="crash recovery" if reuse_epoch else "",
            )
            try:
                for p in pods:
                    self._ensure_finalizer(p)
                placed = self._write_allocation(alloc)
            finally:
                # the write (or its failure) is now the source of
                # truth: success is cache-visible via write-through,
                # failure is retried after requeue — either way the
                # overlay entry has served its purpose
                with self._placement_lock:
                    self._inflight.pop(aid, None)
            if not placed:
                # Server-side overlap guard refused the box on at least
                # one CR (stale cache at placement time). Roll the
                # partial fan-out back through the normal teardown
                # machinery — marking the record DELETED makes the
                # agents erase the copies that DID land; leaving them
                # would pin chips forever (the next reconcile would
                # find the partial allocation, take the existing path,
                # and _repair_fanout would retry the refused write
                # against the same overlap for eternity). Re-place
                # after the erase, under the SAME trace id, so the
                # retry doesn't re-emit Admitted or fork the grant
                # across two traces.
                sp.attrs["placed"] = "conflict"
                self._mark_deleted(alloc)
                with self._pending_lock:
                    self._pending_trace[pod_key] = trace_id
                return 0.2
            for ref in pod_refs:
                emit_pod_event(
                    self.client, ref.namespace, ref.pod_name,
                    reason=REASON_PLACED,
                    message=(f"placed {alloc.profile} at {alloc.box} "
                             f"across {sorted(alloc.parts)} "
                             f"(worker {ref.worker_id})"),
                    component="controller", pod_uid=ref.pod_uuid,
                    trace_id=trace_id,
                )
        if self.metrics:
            self.metrics.allocations.labels(status="creating").inc()
        log.info(
            "allocated %s: %s at %s across %s (trace %s)",
            alloc.alloc_id, alloc.profile, alloc.box, list(alloc.parts),
            trace_id,
        )
        return self.no_capacity_requeue  # check progress even if events drop

    # ------------------------------------------------ stuck-grant watchdog

    def _grant_overdue(self, alloc: AllocationDetails) -> bool:
        """True when a ``creating`` allocation blew the realize
        deadline (wall clock off the persisted ``created_at``, so the
        verdict survives controller restarts)."""
        return (
            self.stuck_grant_deadline > 0
            and alloc.created_at > 0
            and time.time() - alloc.created_at > self.stuck_grant_deadline
        )

    def _stuck_deleted(self, alloc: AllocationDetails) -> bool:
        """True when a ``deleted`` record sat unerased past the
        deadline — the owning agent is dead, and waiting for its erase
        would wedge the pod forever."""
        return (
            alloc.status == AllocationStatus.DELETED
            and self.stuck_grant_deadline > 0
            and alloc.deletion_requested_at > 0
            and time.time() - alloc.deletion_requested_at
            > self.stuck_grant_deadline
        )

    def _grant_deadline_rollback(self, alloc: AllocationDetails) -> float:
        """Stuck-grant watchdog action: journal, blame the nodes that
        never realized, roll the epoch back. The re-place happens on
        the next reconcile (through the FAILED-retry machinery's
        avoid set)."""
        age = time.time() - alloc.created_at
        laggards = gpugrid.laggards(alloc)
        log.warning(
            "allocation %s stuck in creating %.0fs (> %.0fs); rolling "
            "back (unrealized on %s)",
            alloc.alloc_id, age, self.stuck_grant_deadline, laggards,
        )
        get_journal().emit(
            "controller", reason=REASON_GRANT_DEADLINE,
            object_ref=f"alloc/{alloc.alloc_id}",
            message=(f"stuck in creating {age:.0f}s (deadline "
                     f"{self.stuck_grant_deadline:g}s); rolling back "
                     f"(unrealized on {laggards})"),
            trace_id=alloc.trace_id,
        )
        now = time.monotonic()
        deadline = now + self.failed_node_avoid_seconds
        with self._failed_nodes_lock:
            for ref in alloc.pods:
                avoid = self._failed_nodes.setdefault(ref.pod_uuid, {})
                for node in laggards:
                    avoid[node] = deadline
        for ref in alloc.pods:
            emit_pod_event(
                self.client, ref.namespace, ref.pod_name,
                reason=REASON_GRANT_DEADLINE,
                message=(f"grant stuck {age:.0f}s waiting on "
                         f"{laggards}; rolling back for re-placement"),
                component="controller", pod_uid=ref.pod_uuid,
                trace_id=alloc.trace_id, event_type="Warning",
            )
        self._mark_deleted(alloc)
        return 0.5

    @staticmethod
    def _group_alloc_id(namespace: str, gid: str) -> str:
        """Deterministic allocation id for a pod group. Group ids are only
        unique per namespace; qualify them so two namespaces using the
        same group name can't collide on alloc_id (and thus on the
        derived slice uuid at the device layer). A separator alone is
        ambiguous ('team--a'+'x' vs 'team'+'a--x'), so disambiguate with
        a short digest of the exact (ns, gid) pair."""
        h = hashlib.sha1(f"{namespace}\x00{gid}".encode()).hexdigest()[:10]
        return f"{gid}-{h}"

    def _group_peers(self, namespace: str, gid: str) -> List[dict]:
        if (
            self._use_cache
            and self._pods_inf is not None
            and self._pods_inf.synced()
        ):
            # gated-group secondary index: O(peers), not a full
            # namespace scan per group reconcile
            peers = list(
                self._pods_inf.by_index(
                    INDEX_GATED_GROUP, f"{namespace}/{gid}"
                )
            )
        else:
            peers = []
            for p in self.client.list("Pod", namespace=namespace):
                ann = p.get("metadata", {}).get("annotations") or {}
                if ann.get(GROUP_ANNOTATION) == gid and is_pod_gated(p):
                    peers.append(p)
        return sorted(peers, key=lambda p: p["metadata"]["name"])

    def _avoid_nodes_for(self, pod_uid: str) -> frozenset:
        """Nodes whose device layer recently failed this pod's
        allocation (entries expire after ``failed_node_avoid_seconds``,
        pruned here)."""
        with self._failed_nodes_lock:
            avoid = self._failed_nodes.get(pod_uid)
            if not avoid:
                return frozenset()
            now = time.monotonic()
            live = {n for n, dl in avoid.items() if dl > now}
            if not live:
                del self._failed_nodes[pod_uid]
                return frozenset()
            self._failed_nodes[pod_uid] = {
                n: dl for n, dl in avoid.items() if dl > now
            }
            return frozenset(live)

    def _build_group(
        self, gid: str, members: List[TpuSlice]
    ) -> Optional[TorusGroup]:
        """TorusGroup construction for one gid (mixed-generation and
        invalid-bounds checks included)."""
        gen_name = members[0].spec.generation
        if any(m.spec.generation != gen_name for m in members):
            log.warning("torus group %s mixes generations; skipping", gid)
            return None
        if gpugrid.is_gpu_grid(gen_name):
            return gpugrid.build_group(gid, members)
        gen = get_generation(gen_name)
        hb = gen.host_bounds
        bounds: Shape = tuple(  # type: ignore[assignment]
            max(m.spec.host_offset[i] for m in members) + hb[i]
            for i in range(3)
        )
        try:
            return TorusGroup(
                group_id=gid,
                generation=gen,
                bounds=bounds,
                hosts={
                    m.name: NodeGrid(
                        generation=gen,
                        host_offset=m.spec.host_offset,
                        torus_group=gid,
                    )
                    for m in members
                },
            )
        except ValueError as e:
            log.warning("torus group %s invalid: %s", gid, e)
            return None

    def _try_group(
        self, gid: str, group: TorusGroup, members: List[TpuSlice],
        profile: TopologyProfile, avoid: frozenset,
    ) -> Optional[Placement]:
        try:
            occ = self._occupancy(group, members)
        except ValueError as e:
            log.warning("group %s occupancy corrupt: %s", gid, e)
            return None
        for m in members:
            if m.name in avoid and gpugrid.is_gpu_grid(
                    group.generation.name):
                occ.block(gpugrid.avoid_coords(group))
            elif m.name in avoid:
                # blocked, not occupied: the tile may legitimately
                # hold other pods' live boxes
                hb = group.generation.host_bounds
                occ.block(Box(
                    anchor=tuple(m.spec.host_offset),  # type: ignore
                    shape=hb,
                ).coords())
        return self.policy.choose(group, profile, occ)

    def _place(
        self, profile: TopologyProfile, slices: List[TpuSlice],
        avoid: frozenset = frozenset(),
    ) -> Optional[Placement]:
        """Caller holds ``_placement_lock`` (via ``_handle_gated``):
        the overlay, the group memos, and the no-fit cache are all read
        and written under it."""
        if self._cache_ready():
            return self._place_indexed(profile, avoid)
        # legacy full-scan (the measured baseline, and pre-sync startup)
        for gid, (group, members) in sorted(
            self._torus_groups(slices).items()
        ):
            fit = gpugrid.group_profile(profile, group.generation.name)
            if fit is None:
                continue
            placement = self._try_group(gid, group, members, fit, avoid)
            if placement is not None:
                return placement
        return None

    @requires("controller.placement")
    def _place_indexed(
        self, profile: TopologyProfile, avoid: frozenset
    ) -> Optional[Placement]:
        """First-fit over the torus-group index with O(1) skip of
        unchanged no-fit groups: the informer bumps a per-group version
        on any member CR write, so a full group costs one dict probe
        per pending pod — not an occupancy recomputation — until one of
        its CRs actually changes (docs/SCALING.md)."""
        inf = self._slices_inf
        for gid in inf.index_keys(INDEX_SLICE_GROUP):  # type: ignore
            ver = inf.index_version(INDEX_SLICE_GROUP, gid)  # type: ignore
            inflight_sig = frozenset(
                aid for aid, (_b, _n, g) in self._inflight.items()
                if g == gid
            )
            fp = (ver, inflight_sig)
            memo_key = (gid, profile.name, self.policy.name)
            if not avoid and self._no_fit.get(memo_key) == fp:
                continue
            cached = self._members_cache.get(gid)
            if cached is not None and cached[0] == ver:
                members, group = cached[1], cached[2]
            else:
                members = [
                    m for m in inf.by_index(  # type: ignore
                        INDEX_SLICE_GROUP, gid, transformed=True
                    )
                    if m.status.processed and m.spec.generation
                ]
                group = self._build_group(gid, members) if members else None
                self._members_cache[gid] = (ver, members, group)
            fit = (gpugrid.group_profile(profile, group.generation.name)
                   if group is not None else None)
            if fit is None:
                continue
            placement = self._try_group(gid, group, members, fit, avoid)
            if placement is not None:
                self._no_fit.pop(memo_key, None)
                return placement
            if not avoid:
                self._no_fit[memo_key] = fp
        return None

    def _frag_note(self, profile: TopologyProfile,
                   slices: List[TpuSlice],
                   max_groups: int = 4) -> str:
        """Per-group fragmentation snapshot for the profile's generation
        (caller holds ``_placement_lock`` and passes the slices it
        already loaded — no kube I/O under the lock). Runs once per
        capacity wait, not per requeue, so the O(group) metric sweep
        stays off the hot path."""
        parts: List[str] = []
        try:
            for gid, (group, members) in sorted(
                self._torus_groups(slices).items()
            ):
                if gpugrid.group_profile(profile,
                                         group.generation.name) is None:
                    continue
                try:
                    occ = self._occupancy(group, members)
                except ValueError:
                    continue
                parts.append(
                    f"{gid}: {snapshot_line(frag_metrics(group, occ))}"
                )
                if len(parts) >= max_groups:
                    parts.append("...")
                    break
        except Exception:
            # snapshot is observability garnish: it must never turn a
            # NoCapacity verdict into a reconcile error
            log.debug("fragmentation snapshot failed", exc_info=True)
            return ""
        return "; ".join(parts)

    # --------------------------------------------------- allocation writes

    def _apply_cr(self, node: str, mut) -> Optional[dict]:
        """One TpuSlice CR mutation: coalesced (batched per CR across
        concurrent workers, one optimistic-concurrency round-trip per
        burst) when the cache plane is on, the classic direct
        ``update_with_retry`` otherwise. Server-confirmed results are
        written through to the informer cache so this worker's next
        placement sees its own write."""
        if self._cr_writer is not None:
            fence = self.fence
            if fence is not None and self.manager.shard_lease:
                # the batch may be committed by ANOTHER shard's worker:
                # pin the fence to THIS worker's shard lease now, so a
                # deposed shard's mutation is refused no matter which
                # thread lands the batch (kube/coalesce.py). The
                # EpochFence carries the shard lease's epoch so the
                # commit is stamped with (and verified against) the
                # leadership term that enqueued it.
                fence = self.manager.shard_fence()
            stored = self._cr_writer.apply(node, mut, fence=fence)
        else:
            stored = update_with_retry(
                self.client, KIND, self.namespace, node, mut,
                fence=self.fence,
            )
        if stored is not None and self._use_cache \
                and self._slices_inf is not None:
            self._slices_inf.write_through(stored)
        return stored

    def _write_allocation(self, alloc: AllocationDetails) -> bool:
        """Fan the allocation record out to every involved CR. Returns
        False when a CR's overlap guard refused the box — the
        last-resort defense (a stale cache or overlay bug proposing
        chips another allocation holds) that turns a would-be
        double-allocation into a cheap re-place."""
        new_box = Box.from_key(alloc.box)
        own_suids = (
            slice_uuid_for(alloc.alloc_id),
            slice_uuid_for(alloc.alloc_id, multihost=True),
        )
        ok = True
        for node in gpugrid.holders(alloc):
            # crash point (docs/RECOVERY.md): between per-node fan-out
            # writes — firing on call 1 dies before anything landed, on
            # call 2+ with a half-landed multi-node fan-out
            maybe_crash("controller.write_allocation")
            conflict = [False]

            def mut(obj: dict, _c=conflict) -> Optional[dict]:
                ts = TpuSlice.from_manifest(obj)
                _c[0] = False  # conflict retry re-reads fresh state
                held = ts.spec.allocations.get(alloc.alloc_id)
                if held is not None:
                    if held.attempt_epoch < alloc.attempt_epoch:
                        # a stale epoch's copy still occupies the slot
                        # (one record per alloc_id per CR): the write
                        # cannot land here until the agent erases it —
                        # surface as a conflict so the caller re-places
                        # instead of believing the epoch was written
                        _c[0] = True
                    return None
                for other in ts.spec.allocations.values():
                    if Box.from_key(other.box).overlaps(new_box):
                        _c[0] = True
                        return None
                for suid, prep in ts.spec.prepared.items():
                    if suid in own_suids:
                        continue
                    if Box.from_key(prep.box).overlaps(new_box):
                        _c[0] = True
                        return None
                ts.spec.allocations[alloc.alloc_id] = alloc
                return ts.to_manifest()

            self._apply_cr(node, mut)
            if conflict[0]:
                log.warning(
                    "allocation %s: box %s overlaps existing state on "
                    "%s; re-placing", alloc.alloc_id, alloc.box, node,
                )
                ok = False
        return ok

    def _repair_fanout(
        self, alloc: AllocationDetails, slices: List[TpuSlice]
    ) -> None:
        """A crash between fan-out writes leaves some CRs without the
        allocation record; complete it idempotently. Copies from an
        OLDER attempt epoch (the crashed writer's half-landed state)
        are marked deleted so their agents release and erase them —
        they are exactly what a restart must clean up, never what it
        repairs."""
        have = set()
        stale_nodes: List[str] = []
        for ts in slices:
            held = ts.spec.allocations.get(alloc.alloc_id)
            if held is None:
                continue
            if held.attempt_epoch == alloc.attempt_epoch:
                have.add(ts.name)
            elif (
                held.attempt_epoch < alloc.attempt_epoch
                and held.status != AllocationStatus.DELETED
            ):
                stale_nodes.append(ts.name)
        for node in stale_nodes:
            def mut(obj: dict) -> Optional[dict]:
                ts = TpuSlice.from_manifest(obj)
                a = ts.spec.allocations.get(alloc.alloc_id)
                if (
                    a is None
                    or a.attempt_epoch >= alloc.attempt_epoch
                    or a.status == AllocationStatus.DELETED
                ):
                    return None
                a.set_status(
                    AllocationStatus.DELETED,
                    f"stale attempt epoch {a.attempt_epoch} superseded "
                    f"by {alloc.attempt_epoch}",
                )
                a.deletion_requested_at = time.time()
                return ts.to_manifest()

            try:
                self._apply_cr(node, mut)
            except NotFound:
                log.warning("CR %s gone while reaping stale epoch of "
                            "%s", node, alloc.alloc_id)
        missing = set(gpugrid.holders(alloc)) - have
        if missing:
            self._write_allocation(alloc)

    def _for_each_holder(self, alloc: AllocationDetails, mutate) -> bool:
        """Apply ``mutate`` to the allocation in every holder CR. Returns
        True when at least one CR actually transitioned — the signal
        metrics must key on, or a crash-recovery re-run that loses the
        CR race observes the same event twice."""
        transitioned = False
        for node in gpugrid.holders(alloc):
            def mut(obj: dict) -> Optional[dict]:
                ts = TpuSlice.from_manifest(obj)
                a = ts.spec.allocations.get(alloc.alloc_id)
                if a is None:
                    return None
                if not mutate(a):
                    return None
                return ts.to_manifest()

            try:
                # _apply_cr returns the stored manifest exactly when
                # THIS mutation applied (the coalescer tracks per-op
                # application) — the transition signal
                stored = self._apply_cr(node, mut)
                transitioned = transitioned or stored is not None
            except NotFound:
                log.warning("CR %s gone while updating %s", node,
                            alloc.alloc_id)
        return transitioned

    def _promote_created(self, alloc: AllocationDetails) -> None:
        def mutate(a: AllocationDetails) -> bool:
            if a.status != AllocationStatus.CREATING:
                return False
            a.set_status(AllocationStatus.CREATED)
            return True

        self._for_each_holder(alloc, mutate)
        if self.metrics:
            self.metrics.allocations.labels(status="created").inc()

    def _mark_deleted(self, alloc: AllocationDetails) -> None:
        def mutate(a: AllocationDetails) -> bool:
            if a.status == AllocationStatus.DELETED:
                return False
            a.set_status(AllocationStatus.DELETED)
            a.deletion_requested_at = time.time()
            return True

        with self.tracer.span(
            "controller.teardown", trace_id=alloc.trace_id or None,
            alloc=alloc.alloc_id,
        ):
            self._for_each_holder(alloc, mutate)
        if self.metrics:
            self.metrics.allocations.labels(status="deleted").inc()

    # -------------------------------------------------------------- ungate

    def _ungate_all(self, alloc: AllocationDetails) -> None:
        """Remove the scheduling gate from every pod of the allocation,
        then mark it ungated (reference: ``unGatePod`` + status write,
        instaslice_controller.go:157-184)."""
        with self.tracer.span(
            "controller.ungate", trace_id=alloc.trace_id or None,
            alloc=alloc.alloc_id,
        ):
            self._ungate_all_inner(alloc)

    def _ungate_all_inner(self, alloc: AllocationDetails) -> None:
        for p in alloc.pods:
            def mut(pod: dict) -> Optional[dict]:
                gates = pod.get("spec", {}).get("schedulingGates", []) or []
                # drop the legacy (reference-spelled) gate too: a pod
                # admitted through is_pod_gated's interop path must not
                # stay gated after its grant
                kept = [g for g in gates
                        if g.get("name") not in (GATE_NAME,
                                                 LEGACY_GATE_NAME)]
                if len(kept) == len(gates):
                    return None
                pod["spec"]["schedulingGates"] = kept
                return pod

            try:
                update_with_retry(
                    self.client, "Pod", p.namespace, p.pod_name, mut,
                    fence=self.fence,
                )
            except NotFound:
                continue

        # crash point (docs/RECOVERY.md): gates removed, CREATED→UNGATED
        # status edge not yet written — the restart's ungated-pod pass
        # (_maybe_finish_ungate) completes exactly this
        maybe_crash("controller.ungate")
        granted_at = time.time()

        def mutate(a: AllocationDetails) -> bool:
            if a.status != AllocationStatus.CREATED:
                return False
            a.set_status(AllocationStatus.UNGATED)
            return True

        transitioned = self._for_each_holder(alloc, mutate)
        for p in alloc.pods:
            self._set_pending(f"{p.namespace}/{p.pod_name}", False)
        if transitioned:
            # only when the CREATED→UNGATED edge actually landed: the
            # crash-recovery re-run must not duplicate the grant event
            for p in alloc.pods:
                emit_pod_event(
                    self.client, p.namespace, p.pod_name,
                    reason=REASON_UNGATED,
                    message=(f"slice granted: scheduling gate removed "
                             f"({alloc.profile} at {alloc.box})"),
                    component="controller", pod_uid=p.pod_uuid,
                    trace_id=alloc.trace_id,
                )
        # observe only when the CREATED→UNGATED transition actually landed
        # in a CR: the crash-recovery path (_maybe_finish_ungate) re-runs
        # _ungate_all, and keying on the stale in-memory status would
        # double-count the north-star grant-latency metric
        if self.metrics and transitioned:
            if alloc.created_at:
                # exemplar: a bad histogram bucket links straight to the
                # trace that landed in it (docs/OBSERVABILITY.md)
                from instaslice_tpu_torch.metrics.metrics import (
                    observe_with_exemplar,
                )

                observe_with_exemplar(
                    self.metrics.slice_grant_seconds,
                    granted_at - alloc.created_at,
                    trace_id=alloc.trace_id,
                )
            self.metrics.allocations.labels(status="ungated").inc()

    def _maybe_finish_ungate(self, pod: dict) -> Optional[float]:
        """Pod already ungated/running: make sure the allocation status
        caught up (covers a crash between pod update and CR write), then
        reconcile slice health for the granted allocation.

        Restart reconciliation (docs/RECOVERY.md): this path also
        adopts lifecycles a dead component abandoned mid-flight — an
        ungated pod whose record is still ``creating`` (a crashed
        repacker's re-grant, a crash-recovery re-place) is driven
        through promote→ungate here, and an ungated pod with NO record
        at all (death between the repacker's drain and re-grant) is
        re-granted via :meth:`_recover_ungated_orphan`."""
        md = pod["metadata"]
        slices = self._load_slices()
        found = self._find_allocation(slices, pod_uid=md.get("uid", ""))
        if found is None:
            return self._recover_ungated_orphan(pod)
        alloc, holders = found
        if alloc.status == AllocationStatus.CREATING:
            self._repair_fanout(alloc, slices)
            if alloc.fully_realized():
                self._promote_created(alloc)
                alloc.status = AllocationStatus.CREATED
            elif self._grant_overdue(alloc):
                return self._grant_deadline_rollback(alloc)
            else:
                return self.no_capacity_requeue  # agents realizing
        if alloc.status == AllocationStatus.CREATED:
            self._ungate_all(alloc)
        if alloc.status == AllocationStatus.FAILED:
            # an adopted in-flight epoch failed to realize: tear it
            # down; the pod stays ungated and the DELETED→erase→
            # _recover_ungated_orphan loop re-places it
            self._mark_deleted(alloc)
            return 0.5
        if self._stuck_deleted(alloc):
            # dead agent never erased the teardown: the orphan-recovery
            # pass cannot fire until the record is gone, so supersede
            # it the same way the gated path does — re-grant fresh
            return self._recover_ungated_orphan(
                pod, supersede=alloc,
                stale_nodes=frozenset(
                    ts.name for ts in holders
                    if alloc.alloc_id in ts.spec.allocations
                ),
            )
        if alloc.status in (
            AllocationStatus.CREATED, AllocationStatus.UNGATED
        ):
            self._reconcile_slice_health(alloc, slices)
        return None

    def _recover_ungated_orphan(
        self, pod: dict,
        supersede: Optional[AllocationDetails] = None,
        stale_nodes: frozenset = frozenset(),
    ) -> Optional[float]:
        """Adopt a grant a dead component abandoned chip-less: an
        UNGATED pod carrying our finalizer whose allocation record is
        gone (the repacker died between drain and re-grant — its erase
        landed, its re-grant never did) or sits in an unerased stale
        deleted epoch (``supersede``). Re-place and re-grant under a
        fresh attempt epoch, journaled ``CrashRecovered``; the pod was
        never re-gated, so the eventual ungate is a pure status edge —
        exactly the repacker's own contract (docs/RECOVERY.md)."""
        md = pod.get("metadata", {})
        if md.get("deletionTimestamp"):
            return None
        if FINALIZER not in (md.get("finalizers") or []):
            return None  # never granted by us: nothing to recover
        if pod.get("status", {}).get("phase", "") in (
            "Succeeded", "Failed"
        ):
            return None
        try:
            profile = extract_profile(pod)
            gid, size = pod_group(pod)
        except ValueError:
            return None
        if profile is None:
            return None
        pods = [pod]
        if gid:
            # group members are all UNGATED here, so the gated-group
            # index cannot serve them; this path is rare (one crashed
            # migration), so a live list is fine
            namespace = md.get("namespace", "")
            peers = [
                p for p in self.client.list("Pod", namespace=namespace)
                if (p.get("metadata", {}).get("annotations") or {}).get(
                    GROUP_ANNOTATION
                ) == gid
                and not p.get("metadata", {}).get("deletionTimestamp")
            ]
            peers.sort(key=lambda p: p["metadata"]["name"])
            if len(peers) < size:
                return None  # partial group: let deletion/reap settle
            pods = peers[:size]
        if len(pods) != profile.hosts_needed():
            return None
        pod_refs = [
            PodRef(
                pod_uuid=p["metadata"].get("uid", ""),
                pod_name=p["metadata"]["name"],
                namespace=p["metadata"].get("namespace", ""),
                worker_id=i,
                handoff_name=(
                    p["metadata"].get("annotations") or {}
                ).get(HANDOFF_ANNOTATION, ""),
            )
            for i, p in enumerate(
                sorted(pods, key=lambda p: p["metadata"]["name"])
            )
        ]
        if gid:
            aid = self._group_alloc_id(pod_refs[0].namespace, gid)
        else:
            aid = pod_refs[0].pod_uuid
        epoch = (supersede.attempt_epoch + 1) if supersede is not None \
            else 1
        trace_id = new_trace_id()
        pod_key = self._pod_key(pod)
        with self.tracer.span(
            "controller.allocate", trace_id=trace_id,
            pod=pod_key, profile=profile.name, recovery="true",
        ) as sp:
            with self.tracer.span("controller.place") as psp, \
                    self._placement_lock:
                if aid in self._inflight:
                    # a live repacker (or a peer worker's recovery)
                    # owns this very allocation right now
                    sp.drop = psp.drop = True
                    return 0.1
                slices = self._load_slices()
                rechecked = self._find_allocation(
                    slices, pod_uid=md.get("uid", "")
                )
                if rechecked is not None and not self._stuck_deleted(
                    rechecked[0]
                ):
                    sp.drop = psp.drop = True
                    return 0.05  # someone re-granted already
                # honor the failed-node memory exactly like the gated
                # path: the stuck-grant watchdog may have just blamed a
                # wedged node, and recovery must not re-place straight
                # back onto it while other capacity exists. Stale-epoch
                # holders are NEVER retried in place even as a
                # fallback: the unerased record occupies their CR slot,
                # so the epoch fence in _write_allocation would refuse
                # the write every time — when they hold the only
                # capacity, the right move is the quiet requeue below
                # until the dead agent restarts and reaps the copy
                blamed = self._avoid_nodes_for(md.get("uid", ""))
                placement = self._place(profile, slices,
                                        avoid=blamed | stale_nodes)
                if placement is None and blamed:
                    placement = self._place(profile, slices,
                                            avoid=stale_nodes)
                if placement is not None:
                    self._inflight[aid] = (
                        placement.box,
                        frozenset(placement.node_names),
                        placement.group_id,
                    )
            if placement is None:
                sp.attrs["placed"] = "false"
                return self.no_capacity_requeue
            sp.attrs["box"] = placement.box.key()
            get_journal().emit(
                "controller", reason=REASON_CRASH_RECOVERED,
                object_ref=f"alloc/{aid}",
                message=(f"adopting abandoned grant for ungated pod "
                         f"{pod_key}: re-granting {profile.name} at "
                         f"{placement.box.key()} (attempt epoch "
                         f"{epoch})"),
                trace_id=trace_id,
            )
            for ref in pod_refs:
                emit_pod_event(
                    self.client, ref.namespace, ref.pod_name,
                    reason=REASON_CRASH_RECOVERED,
                    message=(f"allocation lost mid-lifecycle (crashed "
                             f"component); re-granting {profile.name} "
                             f"at {placement.box.key()}"),
                    component="controller", pod_uid=ref.pod_uuid,
                    trace_id=trace_id,
                )
            alloc = AllocationDetails.from_placement(
                placement, pod_refs, alloc_id=aid, trace_id=trace_id,
                attempt_epoch=epoch, note="crash recovery",
            )
            try:
                placed = self._write_allocation(alloc)
            finally:
                with self._placement_lock:
                    self._inflight.pop(aid, None)
            if not placed:
                sp.attrs["placed"] = "conflict"
                self._mark_deleted(alloc)
                return 0.2
        log.info(
            "crash recovery: re-granted %s for ungated pod %s at %s "
            "(epoch %d, trace %s)",
            aid, pod_key, alloc.box, epoch, trace_id,
        )
        return 0.5  # drive promote→ungate promptly

    def _reconcile_slice_health(
        self, alloc: AllocationDetails, slices: List[TpuSlice]
    ) -> None:
        """Degraded-slice handling for GRANTED allocations, driven by the
        per-node ``status.unhealthyChips`` the agents publish (their write
        wakes this reconciler via the CR watch). The controller owns this
        — not the agents — because a multi-host slice is only healthy as a
        whole: a chip death on one host degrades every worker pod of the
        group, including those on healthy hosts, and the signal must reach
        (or evict) all of them coherently. No reference analog (SURVEY.md
        §5: "no health monitoring of slices")."""
        from instaslice_tpu_torch.controller.gates import (
            RESTART_ON_FAILURE_ANNOTATION,
            UNHEALTHY_ANNOTATION,
        )

        by_name = {ts.name: ts for ts in slices}
        on_gpus = gpugrid.is_gpu_profile(alloc.profile)
        dead: Dict[str, List[int]] = (
            gpugrid.dead_chips(alloc, slices) if on_gpus else {}
        )
        for node in () if on_gpus else alloc.parts:
            ts = by_name.get(node)
            if ts is None or not ts.status.unhealthy_chips:
                continue
            try:
                hb = get_generation(ts.spec.generation).host_bounds
            except KeyError:
                continue
            hit = sorted(
                set(ts.status.unhealthy_chips)
                & set(alloc.local_chip_ids(node, hb))
            )
            if hit:
                dead[node] = hit
        message = (
            "; ".join(
                f"{n}: chips {c} unhealthy" for n, c in sorted(dead.items())
            )
            if dead
            else None
        )
        for p in alloc.pods:
            try:
                obj = self._get_pod(p.namespace, p.pod_name)
            except NotFound:
                continue
            md = obj.get("metadata", {})
            if md.get("deletionTimestamp"):
                continue
            ann = md.get("annotations") or {}
            if message is None:
                # healed: clear the stale degraded marker
                if UNHEALTHY_ANNOTATION in ann:
                    self.client.patch(
                        "Pod", p.namespace, p.pod_name,
                        {"metadata": {
                            "annotations": {UNHEALTHY_ANNOTATION: None}
                        }},
                    )
                    emit_pod_event(
                        self.client, p.namespace, p.pod_name,
                        reason=REASON_HEALED,
                        message="granted chips healthy again",
                        component="controller", pod_uid=p.pod_uuid,
                        trace_id=alloc.trace_id,
                    )
                continue
            if ann.get(RESTART_ON_FAILURE_ANNOTATION) == "true":
                log.warning(
                    "evicting pod %s/%s: %s (restart-on-failure)",
                    p.namespace, p.pod_name, message,
                )
                emit_pod_event(
                    self.client, p.namespace, p.pod_name,
                    reason=REASON_HEALTH_EVICTED,
                    message=f"evicting (restart-on-failure): {message}",
                    component="controller", pod_uid=p.pod_uuid,
                    trace_id=alloc.trace_id, event_type="Warning",
                )
                try:
                    self.client.delete("Pod", p.namespace, p.pod_name)
                except NotFound:
                    continue
                if self.metrics:
                    self.metrics.health_evictions.inc()
            elif ann.get(UNHEALTHY_ANNOTATION) != message:
                self.client.patch(
                    "Pod", p.namespace, p.pod_name,
                    {"metadata": {
                        "annotations": {UNHEALTHY_ANNOTATION: message}
                    }},
                )
                emit_pod_event(
                    self.client, p.namespace, p.pod_name,
                    reason=REASON_DEGRADED,
                    message=f"granted slice degraded: {message}",
                    component="controller", pod_uid=p.pod_uuid,
                    trace_id=alloc.trace_id, event_type="Warning",
                )

    # ------------------------------------------------------------ deletion

    def _handle_deletion(self, pod: dict) -> Optional[float]:
        """Finalizer + 30 s grace teardown (reference:
        instaslice_controller.go:89-142; SURVEY.md §3.3)."""
        md = pod["metadata"]
        self._set_pending(self._pod_key(pod), False)
        # the pod is going away: its failed-node memory goes with it
        with self._failed_nodes_lock:
            self._failed_nodes.pop(md.get("uid", ""), None)
        finalizers = md.get("finalizers", []) or []
        if FINALIZER not in finalizers:
            return None
        elapsed = time.time() - _parse_timestamp(
            md.get("deletionTimestamp", 0)
        )
        if elapsed < self.grace:
            return max(0.05, self.grace - elapsed)

        slices = self._load_slices()
        found = self._find_allocation(slices, pod_uid=md.get("uid", ""))
        if found is not None:
            alloc, _ = found
            if alloc.status != AllocationStatus.DELETED:
                self._mark_deleted(alloc)

        def mut(p: dict) -> Optional[dict]:
            fins = p.get("metadata", {}).get("finalizers", []) or []
            if FINALIZER not in fins:
                return None
            p["metadata"]["finalizers"] = [
                f for f in fins if f != FINALIZER
            ]
            return p

        try:
            update_with_retry(
                self.client, "Pod", md.get("namespace", ""), md["name"],
                mut, fence=self.fence,
            )
        except NotFound:
            pass
        return None

    def _reap_orphan(self, pod_key: str) -> Optional[float]:
        """Pod vanished (force-delete): reap its allocation."""
        self._set_pending(pod_key, False)
        slices = self._load_slices()
        found = self._find_allocation(slices, pod_key=pod_key)
        if found is None:
            return None
        alloc, _ = found
        if alloc.status != AllocationStatus.DELETED:
            log.info("reaping orphaned allocation %s (pod %s gone)",
                     alloc.alloc_id, pod_key)
            self._mark_deleted(alloc)
        return None

    # -------------------------------------------------------------- helpers

    @staticmethod
    def _pod_key(pod: dict) -> str:
        md = pod.get("metadata", {})
        return f"{md.get('namespace', '')}/{md.get('name', '')}"

    def _set_pending(self, key: str, pending: bool,
                     profile: str = "") -> None:
        """Track the set of capacity-starved pods; the gauge reports its
        size (a constant 0/1 would lie with >1 pending pod)."""
        with self._pending_lock:
            if pending:
                self._pending.add(key)
                if profile:
                    self._pending_profiles[key] = profile
            else:
                self._pending.discard(key)
                self._pending_trace.pop(key, None)
                self._pending_profiles.pop(key, None)
            if self.metrics:
                self.metrics.pending_pods.set(len(self._pending))

    def pending_requests(self) -> Dict[str, str]:
        """pod key → profile name for every capacity-starved pod (the
        repacker's stranded-capacity trigger)."""
        with self._pending_lock:
            return dict(self._pending_profiles)

    def _ensure_finalizer(self, pod: dict) -> None:
        md = pod["metadata"]
        if FINALIZER in (md.get("finalizers") or []):
            # already present in the view we were handed (cache or
            # fresh get): finalizers are only ever removed on deletion,
            # so the write (and its get round-trip) can be skipped
            return

        def mut(p: dict) -> Optional[dict]:
            fins = p.setdefault("metadata", {}).setdefault("finalizers", [])
            if FINALIZER in fins:
                return None
            fins.append(FINALIZER)
            return p

        update_with_retry(
            self.client, "Pod", md.get("namespace", ""), md["name"],
            mut, fence=self.fence,
        )

    def _annotate_error(self, pod: dict, message: str) -> None:
        md = pod["metadata"]
        current = (md.get("annotations") or {}).get(ERROR_ANNOTATION)
        if current == message[:512]:
            return
        try:
            self.client.patch(
                "Pod", md.get("namespace", ""), md["name"],
                {
                    "metadata": {
                        "annotations": {ERROR_ANNOTATION: message[:512]}
                    }
                },
            )
        except NotFound:
            return
        # emit only AFTER the annotation patch landed: the annotation is
        # this event's dedup marker, so a failed patch must not leave a
        # Rejected event behind to be re-emitted every ~2s reconcile
        emit_pod_event(
            self.client, md.get("namespace", ""), md["name"],
            reason=REASON_REJECTED, message=message[:512],
            component="controller", pod_uid=md.get("uid", ""),
            event_type="Warning",
        )
