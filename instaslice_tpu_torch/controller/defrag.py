"""Live slice defragmentation: the repacker control loop.

Fragmentation-aware *placement* (``topology/frag.py`` +
``FragAwarePolicy``) slows fragmentation down; under a churny
multi-profile workload it still accumulates — four scattered 1x1s end
up blocking every 2x2 anchor while 75% of the chips sit free. The
repacker closes that gap the way "Serving DNN Models with
Multi-Instance GPUs" frames it (reconfigurable machine scheduling,
PAPERS.md): migration is a first-class scheduling move.

The loop watches two signals it already has for free: the controller's
capacity-starved pod set (``Controller.pending_requests()`` — pods the
once-per-wait ``NoCapacity`` event fired for) and group occupancy via
the informer indexes. When a pending profile is blocked *only by
relocatable smaller slices*, it plans a bounded migration set and
drives each migration through the existing lifecycle — no new state
machine edges:

1. **reserve** the victim's destination box in the controller's
   in-flight overlay (so neither the pending pod nor a concurrent grant
   can steal it mid-move);
2. **drain/teardown**: ``Controller._mark_deleted`` on the old record —
   the node agent releases the chips and erases the record, exactly as
   for a deleted pod;
3. **re-grant**: a fresh allocation epoch (same alloc id, same pods,
   new box, a new migration trace id) written through
   ``_write_allocation``'s overlap guard, realized by the destination
   agent, then promoted created → ungated. The pod was never gated, so
   the ungate is a pure status edge and the journal chain stays legal
   (``make events-check`` strict).

A realize failure mid-migration is rolled back via ``_mark_deleted``
exactly like the partial-fan-out path: the failed epoch tears
down, the slice is re-granted *anywhere* (usually its old box — chips
were freed, nothing else fits the pending profile either), and the
migration is recorded failed. The pod is chip-less only between erase
and re-grant — the same window a controller-retried device failure
always had.

Safety rails: at most ``max_concurrent`` in-flight migrations, a
per-pod ``cooldown`` after any move (successful or rolled back — also
the thrash brake), at most ``max_moves`` victims per target box, the
``tpu.instaslice.dev/no-repack`` pod annotation opts a workload out
entirely, and only single-host UNGATED slices strictly smaller than
the blocked profile are movable. Every decision is journaled
(``RepackPlanned/Migrating/Done/Failed``) and every migration epoch is
trace-correlated under its own trace id (docs/OBSERVABILITY.md).

A copy of ``instaslice_tpu/controller/defrag.py`` (the port imports
nothing of the JAX package). Allocation and pending profiles are parsed
by :func:`~instaslice_tpu_torch.controller.gpugrid.parse_profile`, so a
GPU grid's MIG names (``3g.40gb``) and whole GPU (``gpu``) parse, and a
group takes a profile by
:func:`~instaslice_tpu_torch.controller.gpugrid.group_profile`; on every
TPU generation both are the reference's rule.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from instaslice_tpu_torch.api import AllocationDetails, AllocationStatus
from instaslice_tpu_torch.api.constants import (
    REASON_MIGRATION_ABORTED,
    REASON_REPACK_DONE,
    REASON_REPACK_FAILED,
    REASON_REPACK_MIGRATING,
    REASON_REPACK_PLANNED,
    REPACK_OPTOUT_ANNOTATION,
)
from instaslice_tpu_torch.faults import maybe_crash
from instaslice_tpu_torch.controller.gpugrid import (
    group_profile,
    parse_profile,
)
from instaslice_tpu_torch.controller.reconciler import INDEX_SLICE_GROUP
from instaslice_tpu_torch.obs.journal import emit_pod_event, get_journal
from instaslice_tpu_torch.topology.placement import (
    Box,
    Occupancy,
    Placement,
    find_placements,
    legal_placements,
)
from instaslice_tpu_torch.utils.trace import get_tracer, new_trace_id
from instaslice_tpu_torch.utils.guards import requires, unguarded

log = logging.getLogger("instaslice_tpu_torch.controller.defrag")

COMPONENT = "repacker"


@dataclasses.dataclass
class Migration:
    """One in-flight slice migration — one allocation, one fresh epoch
    under one migration trace id."""

    alloc_id: str
    group_id: str
    profile: str
    old_box: str
    #: planned destination box key (None after a failure: rollback mode,
    #: re-place anywhere)
    dest_box: Optional[str]
    #: the box being cleared for the blocked profile (avoided while
    #: re-placing the victim, unless rolling back)
    target_box: str
    #: profile name of the pending request this migration serves
    pending_profile: str
    pods: List  # PodRef snapshot from the evicted allocation
    trace_id: str
    phase: str = "evicting"  # evicting | realizing
    rollback: bool = False
    attempts: int = 0
    started: float = 0.0
    warned_stuck: bool = False
    #: attempt epoch the fresh record is stamped with (old epoch + 1)
    epoch: int = 0
    #: monotonic time of the last phase transition — the stuck
    #: watchdog's idle clock (warn at ``stuck_warn_seconds``, abort at
    #: ``stuck_abort_seconds``)
    last_progress: float = 0.0

    def progress(self) -> None:
        """Record forward motion: re-arms the stall warning (a
        migration that un-sticks can warn again on a later stall) and
        resets the abort clock."""
        self.last_progress = time.monotonic()
        self.warned_stuck = False


class Repacker:
    """Defragmentation reconcile loop riding a :class:`Controller`'s
    informer caches, placement lock, and write machinery. Start after
    the controller; stop before it."""

    # single repack thread owns all mutable state; external readers
    # (status surfaces, tests after stop()) take GIL-atomic snapshots
    # of counters and never mutate
    _active: unguarded("repack-loop thread owned; shared reservations "
                       "live in Controller._inflight under "
                       "controller.placement, not here")
    _cooldown_until: unguarded("repack-loop thread owned")
    plans: unguarded("repack-loop owned counter; racy external reads")
    proactive_plans: unguarded("repack-loop owned counter")
    migrations_done: unguarded("repack-loop owned counter")
    migrations_failed: unguarded("repack-loop owned counter")
    migrations_aborted: unguarded("repack-loop owned counter")

    def __init__(
        self,
        controller,
        interval: float = 1.0,
        max_concurrent: int = 2,
        cooldown: float = 60.0,
        max_moves: int = 4,
        stuck_warn_seconds: float = 60.0,
        frag_threshold: Optional[float] = None,
        stuck_abort_seconds: Optional[float] = None,
    ) -> None:
        self.controller = controller
        self.interval = interval
        self.max_concurrent = max(1, int(max_concurrent))
        self.cooldown = cooldown
        self.max_moves = max(1, int(max_moves))
        self.stuck_warn_seconds = stuck_warn_seconds
        # self-healing watchdog (docs/RECOVERY.md): a migration idle in
        # one phase this long is ABORTED — a realizing epoch is rolled
        # back via _mark_deleted (bounded: one abort, then the
        # migration is surrendered), a stuck drain/rollback is handed
        # to the controller's stuck-grant machinery. 0 disables (the
        # warn-only behavior).
        if stuck_abort_seconds is None:
            from instaslice_tpu_torch.utils.envutil import env_float

            stuck_abort_seconds = env_float(
                "TPUSLICE_STUCK_MIGRATION_DEADLINE", 300.0)
        self.stuck_abort_seconds = stuck_abort_seconds
        self.migrations_aborted = 0
        # proactive repacking (ROADMAP item 1 headroom): when a group's
        # stranded-capacity fraction (topology/frag.py) exceeds this,
        # plan a consolidation for the largest currently-unplaceable
        # profile WITHOUT waiting for a pod to starve. 0/unset = off —
        # the default stays reactive so idle clusters don't churn.
        if frag_threshold is None:
            env = os.environ.get("TPUSLICE_REPACK_FRAG_THRESHOLD", "")
            frag_threshold = float(env) if env else 0.0
        if not 0.0 <= frag_threshold <= 1.0:
            raise ValueError(
                f"frag_threshold must be in [0, 1], got {frag_threshold}"
            )
        self.frag_threshold = frag_threshold
        self.proactive_plans = 0
        self._active: Dict[str, Migration] = {}
        self._cooldown_until: Dict[str, float] = {}  # pod uid → monotonic
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.migrations_done = 0
        self.migrations_failed = 0
        self.plans = 0

    @property
    def tracer(self):
        # resolved per use (never cached): reset_tracer() test isolation,
        # same contract as Controller.tracer
        return get_tracer()

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Repacker":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="repacker", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        from instaslice_tpu_torch.faults import InjectedCrash

        while not self._stop.wait(self.interval):
            try:
                self.run_once()
            except InjectedCrash as e:
                # a crash point fired: the repacker is dead mid-
                # migration, exactly like the process dying — the
                # restarted controller's orphan recovery adopts the
                # half-finished lifecycle (docs/RECOVERY.md)
                log.warning("repacker: %s — thread dying", e)
                self._stop.set()
                return
            except Exception:
                # one bad tick must not kill the loop; the next tick
                # re-reads everything from the caches
                log.exception("repacker tick failed")

    # ------------------------------------------------------------ main tick

    def run_once(self) -> None:
        """One repacker pass: advance in-flight migrations, then (under
        the concurrency cap) plan new ones for capacity-starved pods.
        Safe to call directly from tests for deterministic stepping."""
        c = self.controller
        if (
            not c._cache_ready()
            or c._pods_inf is None
            or not c._pods_inf.synced()
        ):
            # the repacker only runs against the informer plane — BOTH
            # caches: pod liveness checks happen under the placement
            # lock, where a live API fallback would stall every grant
            return
        for mig in list(self._active.values()):
            try:
                self._advance(mig)
            except Exception:
                log.exception("migration %s advance failed", mig.alloc_id)
        if len(self._active) >= self.max_concurrent:
            return
        pending = c.pending_requests()
        if not pending:
            if self.frag_threshold > 0:
                self._proactive_pass()
            return
        # pods per pending profile vs migrations already serving it: a
        # plan clears room for ONE pod, so never queue more migrations
        # than there are starved pods
        want: Dict[str, int] = {}
        for profile_name in pending.values():
            want[profile_name] = want.get(profile_name, 0) + 1
        serving: Dict[str, int] = {}
        for mig in self._active.values():
            serving[mig.pending_profile] = (
                serving.get(mig.pending_profile, 0) + 1
            )
        for pod_key, profile_name in sorted(pending.items()):
            if len(self._active) >= self.max_concurrent:
                return
            if serving.get(profile_name, 0) >= want[profile_name]:
                continue
            try:
                profile = parse_profile(profile_name)
            except ValueError:
                continue
            if self._plan_and_start(pod_key, profile):
                serving[profile_name] = serving.get(profile_name, 0) + 1

    # ------------------------------------------------------------- planning

    def _proactive_pass(self) -> None:
        """Repack below a fragmentation threshold, not only on a
        starved pod: for each group whose stranded-capacity fraction
        exceeds ``frag_threshold``, plan a consolidation for the
        largest catalog profile that currently has no free placement
        but would after the moves — the next big request then grants
        instantly instead of waiting out a reactive repack."""
        from instaslice_tpu_torch.topology.frag import frag_metrics
        from instaslice_tpu_torch.topology.profiles import profile_catalog

        c = self.controller
        inf = c._slices_inf
        for gid in sorted(inf.index_keys(INDEX_SLICE_GROUP)):
            if len(self._active) >= self.max_concurrent:
                return
            members = [
                m for m in inf.by_index(
                    INDEX_SLICE_GROUP, gid, transformed=True
                )
                if m.status.processed and m.spec.generation
            ]
            if not members:
                continue
            group = c._build_group(gid, members)
            if group is None:
                continue
            with c._placement_lock:
                try:
                    occ = c._occupancy(group, members)
                except ValueError as e:
                    log.warning("group %s occupancy corrupt: %s", gid, e)
                    continue
            # the enumeration (every aligned box x the whole catalog)
            # runs OUTSIDE the placement lock — it is advisory, every
            # grant serializes behind that lock, and _plan_group
            # recomputes occupancy under its own hold anyway
            m = frag_metrics(group, occ)
            if m.stranded_fraction <= self.frag_threshold:
                continue
            # largest-first: clearing the biggest unplaceable box
            # recovers the most stranded capacity per migration set
            catalog = profile_catalog(
                group.generation.name, group.chip_count
            )
            for profile in sorted(
                catalog, key=lambda p: -p.chip_count
            ):
                if m.fit_counts.get(profile.name, 0):
                    continue
                if profile.chip_count > m.free_chips:
                    continue
                if self._plan_and_start(None, profile, only_gid=gid,
                                        stranded=m.stranded_fraction):
                    self.proactive_plans += 1
                    break

    def _plan_and_start(self, pod_key: Optional[str], profile,
                        only_gid: Optional[str] = None,
                        stranded: float = 0.0) -> bool:
        """Find one group where ``profile`` is blocked only by movable
        slices, and start the plan's migrations (up to the concurrency
        cap). Destinations are reserved in the in-flight overlay UNDER
        THE SAME LOCK HOLD as the plan, so no concurrent grant can
        invalidate a destination between choice and reservation.
        Returns True when at least one migration started.

        ``pod_key`` None = a proactive (threshold-triggered) plan: no
        starved pod exists, so the RepackPlanned event lands on the
        group (``only_gid`` restricts the search to it)."""
        c = self.controller
        inf = c._slices_inf
        gids = ([only_gid] if only_gid is not None
                else sorted(inf.index_keys(INDEX_SLICE_GROUP)))
        for gid in gids:
            members = [
                m for m in inf.by_index(
                    INDEX_SLICE_GROUP, gid, transformed=True
                )
                if m.status.processed and m.spec.generation
            ]
            if not members:
                continue
            group = c._build_group(gid, members)
            fit = (group_profile(profile, group.generation.name)
                   if group is not None else None)
            if fit is None:
                continue
            launches = []
            with c._placement_lock:
                plan = self._plan_group(gid, group, members, fit)
                if plan is not None:
                    target_box, moves = plan
                    for alloc, dest in moves:
                        if len(self._active) >= self.max_concurrent:
                            break
                        mig = Migration(
                            alloc_id=alloc.alloc_id,
                            group_id=gid,
                            profile=alloc.profile,
                            old_box=alloc.box,
                            dest_box=dest.box.key(),
                            target_box=target_box.key(),
                            pending_profile=profile.name,
                            pods=list(alloc.pods),
                            trace_id=new_trace_id(),
                            started=time.monotonic(),
                            epoch=alloc.attempt_epoch + 1,
                            last_progress=time.monotonic(),
                        )
                        # reserve the destination BEFORE the drain: the
                        # overlay entry keeps the pending pod and every
                        # concurrent grant off the victim's landing box
                        # for the whole migration. Registering in
                        # _active here too makes the reservation
                        # crash-safe: even if the launch below dies
                        # mid-way, _advance owns the migration and its
                        # cleanup (the eviction nudge retries the drain)
                        c._inflight[mig.alloc_id] = (
                            dest.box, frozenset(dest.node_names), gid,
                        )
                        self._active[mig.alloc_id] = mig
                        launches.append((mig, alloc))
            if plan is None or not launches:
                continue
            self.plans += 1
            if pod_key is not None:
                ns, _, pod_name = pod_key.partition("/")
                with c._pending_lock:
                    pending_tid = c._pending_trace.get(pod_key, "")
                emit_pod_event(
                    c.client, ns, pod_name,
                    reason=REASON_REPACK_PLANNED,
                    message=(
                        f"repacking {len(launches)} slice(s) in {gid} "
                        f"to clear {plan[0].key()} for {profile.name}"
                    ),
                    component=COMPONENT, trace_id=pending_tid,
                )
            else:
                # proactive: no starved pod to pin the event on — the
                # journal records the group-level decision instead
                get_journal().emit(
                    COMPONENT, reason=REASON_REPACK_PLANNED,
                    object_ref=f"group/{gid}",
                    message=(
                        f"proactive repack (stranded fraction "
                        f"{stranded:.2f} > threshold "
                        f"{self.frag_threshold:.2f}): repacking "
                        f"{len(launches)} slice(s) to clear "
                        f"{plan[0].key()} for {profile.name}"
                    ),
                )
            for mig, alloc in launches:
                self._launch(mig, alloc)
            return True
        return False

    def _plan_group(
        self, gid: str, group, members, profile
    ) -> Optional[Tuple[Box, List[Tuple[AllocationDetails, Placement]]]]:
        """One group's migration plan: the target box needing the fewest
        moves whose blockers are all movable AND all re-placeable outside
        it. Caller holds the placement lock (occupancy contract)."""
        c = self.controller
        try:
            occ = c._occupancy(group, members)
        except ValueError as e:
            log.warning("group %s occupancy corrupt: %s", gid, e)
            return None
        if find_placements(group, profile, occ):
            return None  # already fits: the controller's requeue grants it
        movable = self._movable_allocs(group, members, profile)
        if not movable:
            return None
        taken = occ.taken
        movable_boxes = {
            aid: Box.from_key(a.box) for aid, a in movable.items()
        }
        # cheap pass first (overlap checks only): candidate target
        # boxes ordered by (fewest moves, lowest corner). The expensive
        # per-blocker policy feasibility below then runs only until the
        # FIRST feasible candidate — same selection criterion, a
        # fraction of the work inside the placement lock.
        cands = []
        for pl in legal_placements(group, profile):
            cover = [
                aid for aid, b in movable_boxes.items()
                if b.overlaps(pl.box)
            ]
            if not cover or len(cover) > self.max_moves:
                continue
            blocker_coords = {
                co for aid in cover
                for co in movable_boxes[aid].coords()
            }
            # every occupied chip inside the target must belong to a
            # movable blocker — an immovable slice, an unhealthy chip,
            # or an in-flight grant disqualifies the box
            if any(
                co in taken and co not in blocker_coords
                for co in pl.box.coords()
            ):
                continue
            cands.append(
                ((len(cover), sum(pl.box.anchor), pl.box.anchor),
                 pl.box, cover)
            )
        for _key, target, cover in sorted(cands, key=lambda t: t[0]):
            # feasibility: relocate each blocker (largest first) into a
            # simulated occupancy where EVERY currently-held chip stays
            # held (the victims have not moved yet — their destinations
            # are reserved in the overlay while their old boxes still
            # stand, so a dest overlapping ANY live box would corrupt
            # occupancy) and the target box is off-limits
            sim = Occupancy(group)
            sim.block(list(taken))
            sim.block(target.coords())
            moves: List[Tuple[AllocationDetails, Placement]] = []
            feasible = True
            for aid in sorted(
                cover,
                key=lambda a: (-movable_boxes[a].chip_count, a),
            ):
                try:
                    bp = group_profile(parse_profile(movable[aid].profile),
                                       group.generation.name)
                except ValueError:
                    bp = None
                if bp is None:
                    feasible = False
                    break
                dest = c.policy.choose(group, bp, sim)
                if dest is None:
                    feasible = False
                    break
                sim.occupy(dest.box)
                moves.append((movable[aid], dest))
            if feasible:
                return target, moves
        return None

    @requires("controller.placement")
    def _movable_allocs(
        self, group, members, profile
    ) -> Dict[str, AllocationDetails]:
        """Relocatable allocations: UNGATED, single-host, strictly
        smaller than the blocked profile, not already migrating or
        overlaid, pods alive / not deleting / not opted out / off
        cooldown."""
        c = self.controller
        now = time.monotonic()
        allocs: Dict[str, AllocationDetails] = {}
        for ts in members:
            for a in ts.spec.allocations.values():
                allocs.setdefault(a.alloc_id, a)
        out: Dict[str, AllocationDetails] = {}
        for aid, a in allocs.items():
            if a.status != AllocationStatus.UNGATED:
                continue
            if len(a.parts) != 1 or not a.pods:
                continue
            if aid in self._active or aid in c._inflight:
                continue
            try:
                if parse_profile(a.profile).chip_count >= \
                        profile.chip_count:
                    continue
            except ValueError:
                continue
            if any(
                now < self._cooldown_until.get(p.pod_uuid, 0.0)
                for p in a.pods
            ):
                continue
            if not all(self._pod_movable(p) for p in a.pods):
                continue
            out[aid] = a
        return out

    def _pod_movable(self, ref) -> bool:
        pod = self._live_pod(ref)
        if pod is None:
            return False
        ann = pod.get("metadata", {}).get("annotations") or {}
        return ann.get(REPACK_OPTOUT_ANNOTATION) != "true"

    def _live_pod(self, ref) -> Optional[dict]:
        """The pod behind ``ref``, or None when it is gone, deleting,
        or its name was reused by a different pod (uid mismatch) — the
        ONE liveness check for planning and re-granting."""
        pod = self._get_pod(ref.namespace, ref.pod_name)
        if pod is None:
            return None
        md = pod.get("metadata", {})
        if md.get("deletionTimestamp"):
            return None
        if ref.pod_uuid and md.get("uid") and md["uid"] != ref.pod_uuid:
            return None
        return pod

    def _get_pod(self, namespace: str, name: str) -> Optional[dict]:
        """Informer-only pod read: callers run under the placement lock
        (planning), where kube I/O is forbidden — ``run_once`` gates on
        the pod informer being synced, so this is always a dict hit."""
        c = self.controller
        if c._pods_inf is None or not c._pods_inf.synced():
            return None
        return c._pods_inf.get(namespace, name)

    # ------------------------------------------------------------ execution

    def _launch(self, mig: Migration, alloc: AllocationDetails) -> None:
        """Start one migration already registered (reservation +
        ``_active``) by ``_plan_and_start`` under the planning lock:
        journal it and open the drain. A failure here is recoverable —
        ``_advance``'s eviction nudge re-issues the drain."""
        c = self.controller
        for ref in mig.pods:
            emit_pod_event(
                c.client, ref.namespace, ref.pod_name,
                reason=REASON_REPACK_MIGRATING,
                message=(
                    f"slice migrating {mig.old_box} -> {mig.dest_box} "
                    f"(defragmentation: clearing {mig.target_box} for "
                    f"{mig.pending_profile})"
                ),
                component=COMPONENT, pod_uid=ref.pod_uuid,
                trace_id=mig.trace_id,
            )
        log.info(
            "repack %s: %s %s -> %s (clearing %s for %s, trace %s)",
            mig.alloc_id, mig.profile, mig.old_box, mig.dest_box,
            mig.target_box, mig.pending_profile, mig.trace_id,
        )
        with self.tracer.span(
            "repacker.evict", trace_id=mig.trace_id, alloc=mig.alloc_id,
        ):
            c._mark_deleted(alloc)

    def _advance(self, mig: Migration) -> None:
        idle = time.monotonic() - (mig.last_progress or mig.started)
        if not mig.warned_stuck and idle > self.stuck_warn_seconds:
            mig.warned_stuck = True
            log.warning(
                "migration %s stuck in %s for %.0fs (old %s dest %s)",
                mig.alloc_id, mig.phase, idle, mig.old_box,
                mig.dest_box,
            )
        if 0 < self.stuck_abort_seconds < idle:
            self._abort_stuck(mig, idle)
            return
        if mig.phase == "evicting":
            if self._record_gone(mig):
                self._place_migrated(mig)
            else:
                self._nudge_teardown(mig)
            return
        # realizing: drive the fresh epoch to UNGATED (or roll it back)
        c = self.controller
        found = None
        for ref in mig.pods:
            found = c._find_allocation(
                c._load_slices(), pod_uid=ref.pod_uuid
            )
            if found is not None:
                break
        if found is None:
            # record vanished under us (pod force-deleted → orphan
            # reaper, or an agent-side erase): nothing left to migrate
            self._finish(mig, ok=False,
                         msg="allocation record vanished mid-migration")
            return
        merged, _holders = found
        if merged.status == AllocationStatus.CREATING:
            if merged.fully_realized():
                c._promote_created(merged)
                merged.status = AllocationStatus.CREATED
            else:
                return  # agents still realizing
        if merged.status in (AllocationStatus.CREATED,
                             AllocationStatus.UNGATED):
            if merged.status == AllocationStatus.CREATED:
                def mutate(a: AllocationDetails) -> bool:
                    if a.status != AllocationStatus.CREATED:
                        return False
                    a.set_status(AllocationStatus.UNGATED)
                    return True

                c._for_each_holder(merged, mutate)
            if mig.rollback:
                self._finish(
                    mig, ok=False,
                    msg=(f"migration failed; rolled back to "
                         f"{merged.box}"),
                    final_box=merged.box,
                )
            else:
                self._finish(mig, ok=True, final_box=merged.box)
            return
        if merged.status == AllocationStatus.FAILED:
            # mid-migration realize failure: roll back exactly like the
            # partial fan-out path — tear the failed epoch down, then
            # re-grant anywhere (usually the old box, which we freed)
            log.warning(
                "migration %s realize failed (%s); rolling back",
                mig.alloc_id, merged.message,
            )
            get_journal().emit(
                COMPONENT, reason=REASON_REPACK_FAILED,
                object_ref=f"alloc/{mig.alloc_id}",
                message=(f"destination realize failed: {merged.message}; "
                         "tearing down for rollback"),
                trace_id=mig.trace_id,
            )
            c._mark_deleted(merged)
            mig.rollback = True
            mig.dest_box = None
            mig.attempts += 1
            mig.phase = "evicting"
            mig.progress()
            with c._placement_lock:
                c._inflight.pop(mig.alloc_id, None)
            return
        # DELETED: someone else is tearing the epoch down (pod deletion
        # mid-migration); wait for the erase, then bail in _record_gone
        if merged.status == AllocationStatus.DELETED:
            mig.phase = "evicting"
            mig.rollback = True
            mig.dest_box = None
            mig.progress()

    def _abort_stuck(self, mig: Migration, idle: float) -> None:
        """Watchdog escalation past the warn (docs/RECOVERY.md): a
        migration idle beyond ``stuck_abort_seconds`` stops holding a
        concurrency slot and a destination reservation. A first-time
        stuck *realizing* epoch is rolled back through ``_mark_deleted``
        (the one bounded abort — the rollback machinery re-places the
        victim on its freed chips); a stuck drain, or a rollback that
        is itself stuck, means a dead agent owns the next move: the
        migration is surrendered and the controller's stuck-grant /
        orphan-recovery watchdogs own the record from here."""
        c = self.controller
        self.migrations_aborted += 1
        get_journal().emit(
            COMPONENT, reason=REASON_MIGRATION_ABORTED,
            object_ref=f"alloc/{mig.alloc_id}",
            message=(f"migration stuck in {mig.phase} {idle:.0f}s "
                     f"(> {self.stuck_abort_seconds:g}s deadline); "
                     + ("rolling back" if mig.phase == "realizing"
                        and not mig.rollback
                        else "surrendering to controller watchdogs")),
            trace_id=mig.trace_id,
        )
        if mig.phase == "realizing" and not mig.rollback:
            for ts in c._slices_inf.by_index(
                INDEX_SLICE_GROUP, mig.group_id, transformed=True
            ):
                a = ts.spec.allocations.get(mig.alloc_id)
                if a is not None and a.status != AllocationStatus.DELETED:
                    c._mark_deleted(a)
                    break
            mig.rollback = True
            mig.dest_box = None
            mig.attempts += 1
            mig.phase = "evicting"
            mig.progress()
            with c._placement_lock:
                c._inflight.pop(mig.alloc_id, None)
            return
        self._finish(
            mig, ok=False,
            msg=(f"stuck in {mig.phase} {idle:.0f}s; aborted — "
                 "controller watchdogs own the record now"),
        )

    def _record_gone(self, mig: Migration) -> bool:
        c = self.controller
        for ts in c._slices_inf.by_index(
            INDEX_SLICE_GROUP, mig.group_id, transformed=True
        ):
            if mig.alloc_id in ts.spec.allocations:
                return False
        return True

    def _nudge_teardown(self, mig: Migration) -> None:
        """The drain write is one ``_mark_deleted`` call and can fail
        transiently (exhausted conflict retries, an API blip) — without
        a retry the migration would wedge in ``evicting`` forever,
        pinning its destination reservation and a concurrency slot.
        Re-issue the idempotent teardown for any holder copy that is
        still not DELETED; copies already DELETED are the agents'
        business and are left alone."""
        c = self.controller
        for ts in c._slices_inf.by_index(
            INDEX_SLICE_GROUP, mig.group_id, transformed=True
        ):
            a = ts.spec.allocations.get(mig.alloc_id)
            if a is not None and a.status != AllocationStatus.DELETED:
                c._mark_deleted(a)
                return

    def _place_migrated(self, mig: Migration) -> None:
        """Old record fully erased: write the fresh epoch. Placement
        choice (in-memory) happens under the placement lock; the CR
        fan-out happens outside it, like every controller grant."""
        c = self.controller
        # crash point (docs/RECOVERY.md): the victim's record is erased,
        # its chips are free, the re-grant has not landed — a death here
        # leaves an ungated pod with NO allocation, exactly what the
        # controller's _recover_ungated_orphan adopts on restart
        maybe_crash("repacker.migrate")
        if not all(self._live_pod(p) is not None for p in mig.pods):
            self._finish(mig, ok=False,
                         msg="pod gone mid-migration; not re-granting")
            return
        try:
            profile = parse_profile(mig.profile)
        except ValueError as e:
            self._finish(mig, ok=False, msg=f"unparseable profile: {e}")
            return
        with self.tracer.span(
            "repacker.migrate", trace_id=mig.trace_id,
            alloc=mig.alloc_id, profile=mig.profile,
        ) as sp:
            group_gone = False
            placement: Optional[Placement] = None
            with c._placement_lock:
                members = [
                    m for m in c._slices_inf.by_index(
                        INDEX_SLICE_GROUP, mig.group_id, transformed=True
                    )
                    if m.status.processed and m.spec.generation
                ]
                group = (
                    c._build_group(mig.group_id, members)
                    if members else None
                )
                if group is not None:
                    profile = group_profile(profile, group.generation.name)
                if group is None or profile is None:
                    group_gone = True
                else:
                    # our own reservation must not block the fit check
                    c._inflight.pop(mig.alloc_id, None)
                    try:
                        occ = c._occupancy(group, members)
                    except ValueError as e:
                        log.warning("group %s occupancy corrupt: %s",
                                    mig.group_id, e)
                        return  # retry next tick
                    if mig.dest_box:
                        dest = Box.from_key(mig.dest_box)
                        if occ.fits(dest):
                            placement = next(
                                (pl for pl
                                 in legal_placements(group, profile)
                                 if pl.box == dest),
                                None,
                            )
                    if placement is None and not mig.rollback:
                        # planned destination raced away: re-place
                        # anywhere except the box we are clearing
                        occ.block(Box.from_key(mig.target_box).coords())
                        placement = c.policy.choose(group, profile, occ)
                    if placement is None:
                        # rollback / last resort: anywhere at all (fresh
                        # occupancy — the target block polluted occ)
                        occ2 = c._occupancy(group, members)
                        placement = c.policy.choose(group, profile, occ2)
                    if placement is not None:
                        c._inflight[mig.alloc_id] = (
                            placement.box,
                            frozenset(placement.node_names),
                            mig.group_id,
                        )
            if group_gone:
                sp.attrs["placed"] = "no-group"
                self._finish(mig, ok=False,
                             msg="torus group vanished mid-migration")
                return
            if placement is None:
                # nothing fits this tick (transient churn): keep the
                # migration open and retry — the victim's chips stay
                # released, so this is the state to escape fastest
                sp.attrs["placed"] = "retry"
                mig.dest_box = None
                mig.attempts += 1
                return
            sp.attrs["box"] = placement.box.key()
            new_alloc = AllocationDetails.from_placement(
                placement, mig.pods, alloc_id=mig.alloc_id,
                trace_id=mig.trace_id,
                note="repack rollback" if mig.rollback else "repack",
                attempt_epoch=mig.epoch or 1,
            )
            try:
                placed = c._write_allocation(new_alloc)
            finally:
                with c._placement_lock:
                    c._inflight.pop(mig.alloc_id, None)
        if not placed:
            # server-side overlap guard refused a node's copy: roll the
            # partial fan-out back through the normal teardown machinery
            # (the partial fan-out path) and re-place after the erase
            log.warning("migration %s: overlap conflict; re-placing",
                        mig.alloc_id)
            c._mark_deleted(new_alloc)
            mig.dest_box = None
            mig.attempts += 1
            return
        mig.phase = "realizing"
        mig.progress()

    # ------------------------------------------------------------ completion

    def _finish(self, mig: Migration, ok: bool, msg: str = "",
                final_box: str = "") -> None:
        c = self.controller
        with c._placement_lock:
            c._inflight.pop(mig.alloc_id, None)
        if ok:
            self.migrations_done += 1
            for ref in mig.pods:
                emit_pod_event(
                    c.client, ref.namespace, ref.pod_name,
                    reason=REASON_REPACK_DONE,
                    message=(f"slice migrated {mig.old_box} -> "
                             f"{final_box or mig.dest_box} "
                             "(defragmentation)"),
                    component=COMPONENT, pod_uid=ref.pod_uuid,
                    trace_id=mig.trace_id,
                )
            log.info("repack %s done: %s -> %s", mig.alloc_id,
                     mig.old_box, final_box or mig.dest_box)
        else:
            self.migrations_failed += 1
            get_journal().emit(
                COMPONENT, reason=REASON_REPACK_FAILED,
                object_ref=f"alloc/{mig.alloc_id}",
                message=msg or "migration failed",
                trace_id=mig.trace_id,
            )
            log.warning("repack %s failed: %s", mig.alloc_id, msg)
        now = time.monotonic()
        for ref in mig.pods:
            self._cooldown_until[ref.pod_uuid] = now + self.cooldown
        for uid in [u for u, dl in self._cooldown_until.items()
                    if dl <= now]:
            del self._cooldown_until[uid]
        self._active.pop(mig.alloc_id, None)
