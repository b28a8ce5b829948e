"""Allocation records of the ``TpuSlice`` custom resource: what the
device handoff and the backend need.

A copy of ``instaslice_tpu/api/types.py`` (the port imports nothing of
the JAX package), cut to :class:`AllocationStatus` and its transitions
(:func:`check_transition`), :class:`PodRef`, :class:`AllocationDetails`
and :func:`slice_uuid_for`. The rest of that file (``PreparedPart``,
``PreparedDetails``, ``TpuSliceSpec``/``Status``, ``TpuSlice``) comes
with the control plane.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional, Tuple

from instaslice_tpu_torch.api.constants import TRANSITION_REASONS
from instaslice_tpu_torch.topology.grid import Shape
from instaslice_tpu_torch.topology.placement import Box, Placement


class AllocationStatus(str, enum.Enum):
    """Allocation lifecycle — typed, unlike the reference's bare strings
    (``instaslice_controller.go:164-182`` flips ``"creating"/"created"/
    "ungated"/"deleted"`` literals inline).

    ``FAILED`` is new: the reference logs device errors and carries on
    (``instaslice_daemonset.go:172-189``, flagged in SURVEY.md §5); here a
    failed realization is a first-class state the controller can retry or
    surface.
    """

    CREATING = "creating"   # controller chose a placement, agent(s) must realize
    CREATED = "created"     # all host parts realized on hardware
    UNGATED = "ungated"     # scheduling gate removed, pod may bind
    DELETED = "deleted"     # teardown requested; agents must release chips
    FAILED = "failed"       # realization failed; controller decides retry


# Legal transitions (from → {to}). Anything else is a programming error.
_TRANSITIONS = {
    AllocationStatus.CREATING: {
        AllocationStatus.CREATED,
        AllocationStatus.FAILED,
        AllocationStatus.DELETED,
    },
    AllocationStatus.CREATED: {
        AllocationStatus.UNGATED,
        AllocationStatus.DELETED,
        AllocationStatus.FAILED,
    },
    AllocationStatus.UNGATED: {AllocationStatus.DELETED},
    AllocationStatus.FAILED: {
        AllocationStatus.CREATING,
        AllocationStatus.DELETED,
    },
    AllocationStatus.DELETED: set(),
}


#: Audit-trail bound: the CR keeps the last N status transitions (a full
#: grant lifecycle is ~5; retries add a few more). Bounded so a
#: crash-looping allocation cannot grow its CR without limit.
AUDIT_TRAIL_MAX = 10


def check_transition(old: AllocationStatus, new: AllocationStatus) -> None:
    if new == old:
        return
    if new not in _TRANSITIONS[old]:
        raise ValueError(f"illegal allocation transition {old.value} -> {new.value}")


@dataclasses.dataclass
class PodRef:
    """One consumer pod of an allocation. Single-host slices have exactly
    one; multi-host slices have one pod per host, each bound to a worker id
    (and through it to the host serving that worker)."""

    pod_uuid: str
    pod_name: str
    namespace: str
    worker_id: int = 0
    # Stable name for the handoff ConfigMap + per-pod extended resource
    # when the pod is template-managed (Deployment pods get generated
    # names, so a fixed ``envFrom`` / resource limit in the template can't
    # reference the real pod name). "" = use pod_name.
    handoff_name: str = ""

    @property
    def handoff(self) -> str:
        return self.handoff_name or self.pod_name

    def to_dict(self) -> dict:
        d = {
            "podUUID": self.pod_uuid,
            "podName": self.pod_name,
            "namespace": self.namespace,
            "workerId": self.worker_id,
        }
        if self.handoff_name:
            d["handoffName"] = self.handoff_name
        return d

    @staticmethod
    def from_dict(d: dict) -> "PodRef":
        return PodRef(
            pod_uuid=d["podUUID"],
            pod_name=d["podName"],
            namespace=d.get("namespace", ""),
            worker_id=int(d.get("workerId", 0)),
            handoff_name=d.get("handoffName", ""),
        )


@dataclasses.dataclass
class AllocationDetails:
    """Desired slice for one pod or pod group (reference:
    ``AllocationDetails``, instaslice_types.go:74-87 — pod identity, GPU
    UUID, start/size, status). The TPU version stores the global box plus
    the per-host decomposition so one allocation can fan out to several
    node agents, and a pod list so multi-host slices (one pod per host)
    are a single allocation — new capability, SURVEY.md §7."""

    alloc_id: str                    # pod UUID for singletons, group id else
    pods: List[PodRef]
    profile: str                     # canonical profile name, e.g. v5e-2x2
    torus_group: str
    box: str                         # Box.key() in global mesh coords
    # node name → (worker_id, local Box.key())
    parts: Dict[str, Tuple[int, str]]
    status: AllocationStatus = AllocationStatus.CREATING
    # nodes that have realized their part (subset of parts.keys())
    realized_on: List[str] = dataclasses.field(default_factory=list)
    message: str = ""                # last error for FAILED
    created_at: float = 0.0          # unix secs; grant-latency metric input
    deletion_requested_at: float = 0.0
    # observability: the trace id minted when the controller admitted the
    # gated pod — every span the controller, agents, and device layer
    # emit for this allocation carries it, so one grant is queryable
    # end-to-end (utils/trace.py; docs/OBSERVABILITY.md)
    trace_id: str = ""
    # audit trail: the last AUDIT_TRAIL_MAX status transitions, each
    # {"status", "ts", "message"} — persisted through to_dict/from_dict
    # so "why did this allocation end up here" survives controller
    # restarts (recorded by set_status, the transition choke point)
    transitions: List[dict] = dataclasses.field(default_factory=list)
    # crash consistency (docs/RECOVERY.md): which placement attempt this
    # record belongs to. A controller that dies mid-fan-out can leave an
    # old epoch's copy on one CR while its successor re-places the same
    # alloc_id at a new box — the merged view must never union
    # realized_on/status across epochs (a crashed writer's half-landed
    # state is NOT a concurrent writer). 0 = pre-epoch record (legacy
    # CRs), merged like epoch 0.
    attempt_epoch: int = 0

    def to_dict(self) -> dict:
        return {
            "allocId": self.alloc_id,
            "pods": [p.to_dict() for p in self.pods],
            "profile": self.profile,
            "torusGroup": self.torus_group,
            "box": self.box,
            "parts": {
                n: {"workerId": wid, "localBox": lb}
                for n, (wid, lb) in sorted(self.parts.items())
            },
            "status": self.status.value,
            "realizedOn": sorted(self.realized_on),
            "message": self.message,
            "createdAt": self.created_at,
            "deletionRequestedAt": self.deletion_requested_at,
            **({"traceId": self.trace_id} if self.trace_id else {}),
            **({"transitions": [dict(t) for t in self.transitions]}
               if self.transitions else {}),
            **({"attemptEpoch": self.attempt_epoch}
               if self.attempt_epoch else {}),
        }

    @staticmethod
    def from_dict(d: dict) -> "AllocationDetails":
        return AllocationDetails(
            alloc_id=d["allocId"],
            pods=[PodRef.from_dict(p) for p in d.get("pods", [])],
            profile=d["profile"],
            torus_group=d.get("torusGroup", ""),
            box=d["box"],
            parts={
                n: (p["workerId"], p["localBox"])
                for n, p in d.get("parts", {}).items()
            },
            status=AllocationStatus(d.get("status", "creating")),
            realized_on=list(d.get("realizedOn", [])),
            message=d.get("message", ""),
            created_at=float(d.get("createdAt", 0.0)),
            deletion_requested_at=float(d.get("deletionRequestedAt", 0.0)),
            trace_id=d.get("traceId", ""),
            transitions=[dict(t) for t in d.get("transitions", [])],
            attempt_epoch=int(d.get("attemptEpoch", 0)),
        )

    def global_box(self) -> Box:
        return Box.from_key(self.box)

    def set_status(self, new: AllocationStatus, message: str = "") -> None:
        """THE allocation state-transition choke point: validates the
        edge, then records it on the persisted audit trail and in the
        process flight recorder (obs/journal.py) with the grant's
        trace id — one call, three observability surfaces."""
        check_transition(self.status, new)
        old = self.status
        self.status = new
        if message:
            self.message = message
        if new != old:
            self._record_transition(new, message)

    def _record_transition(self, status: AllocationStatus,
                           message: str) -> None:
        from instaslice_tpu_torch.obs.journal import get_journal

        extra = (
            {"attempt_epoch": self.attempt_epoch}
            if self.attempt_epoch else {}
        )
        try:
            # chip count rides every transition so the telemetry plane
            # can integrate chip-seconds (ungated→deleted × chips) from
            # the journal alone, without re-resolving profiles
            extra["chips"] = len(self.global_box().coords())
        except (ValueError, KeyError, IndexError):
            pass  # malformed box key: the event still records
        ev = get_journal().emit(
            "allocation",
            reason=TRANSITION_REASONS[status.value],
            object_ref=f"alloc/{self.alloc_id}",
            message=message,
            trace_id=self.trace_id,
            status=status.value,
            **extra,
        )
        # the trail entry shares the journal event's timestamp, so the
        # describe-pod timeline dedupes the two surfaces exactly
        self.transitions.append({
            "status": status.value,
            "ts": round(ev.ts, 6),
            "message": message,
        })
        del self.transitions[:-AUDIT_TRAIL_MAX]

    def node_for_worker(self, worker_id: int) -> Optional[str]:
        for n, (wid, _) in self.parts.items():
            if wid == worker_id:
                return n
        return None

    def pods_on_node(self, node_name: str) -> List[PodRef]:
        part = self.parts.get(node_name)
        if part is None:
            return []
        wid = part[0]
        return [p for p in self.pods if p.worker_id == wid]

    def local_chip_ids(self, node_name: str, host_bounds: Shape) -> List[int]:
        """Local chip ids this allocation occupies on ``node_name`` (empty
        when the node serves no part). Shared by the agent (reservation,
        health intersection) and the controller (degraded-slice detection)."""
        part = self.parts.get(node_name)
        if part is None:
            return []
        from instaslice_tpu_torch.topology.grid import coord_to_id

        return sorted(
            coord_to_id(c, host_bounds)
            for c in Box.from_key(part[1]).coords()
        )

    def fully_realized(self) -> bool:
        return set(self.realized_on) >= set(self.parts)

    @staticmethod
    def from_placement(
        placement: Placement,
        pods: List[PodRef],
        alloc_id: str = "",
        now: Optional[float] = None,
        trace_id: str = "",
        note: str = "",
        attempt_epoch: int = 0,
    ) -> "AllocationDetails":
        """``note`` is appended to the seed transition's message — the
        repacker stamps its re-grants with it so a migration epoch is
        distinguishable from an original grant in the audit trail and
        the ``describe pod`` timeline. ``attempt_epoch`` stamps the
        placement attempt (crash recovery re-places with the prior
        epoch + 1 so stale half-landed copies are distinguishable)."""
        if not pods:
            raise ValueError("allocation needs at least one pod")
        alloc = AllocationDetails(
            alloc_id=alloc_id or pods[0].pod_uuid,
            pods=list(pods),
            profile=placement.profile.name,
            torus_group=placement.group_id,
            box=placement.box.key(),
            parts={
                p.node_name: (p.worker_id, p.local_box.key())
                for p in placement.parts
            },
            status=AllocationStatus.CREATING,
            created_at=time.time() if now is None else now,
            trace_id=trace_id,
            attempt_epoch=max(0, int(attempt_epoch)),
        )
        # seed the audit trail: a freshly placed allocation IS the
        # creating transition (set_status only sees later edges)
        alloc._record_transition(
            AllocationStatus.CREATING,
            f"{placement.profile.name} at {placement.box.key()}"
            + (f" ({note})" if note else ""),
        )
        return alloc


def slice_uuid_for(alloc_id: str, multihost: bool = False) -> str:
    """Deterministic per-allocation slice uuid — every agent serving a
    multi-host allocation derives the same id with no rendezvous, and the
    controller uses it to match ``prepared`` entries to allocations.

    Multi-host allocations get a distinguishable prefix: a node-local part
    of a multi-host slice is a full-host tile, which would otherwise be
    indistinguishable from a standalone whole-host reservation — and the
    device plugin must never advertise another job's part as an
    allocatable slice device."""
    return f"sl-mh-{alloc_id}" if multihost else f"sl-{alloc_id}"


def is_multihost_slice_uuid(suid: str) -> bool:
    return suid.startswith("sl-mh-")
