"""Minimal reconcile framework — the controller-runtime analog.

The reference gets watch-driven, key-deduplicated, requeue-capable
reconcile loops from controller-runtime (``SetupWithManager`` at
``instaslice_controller.go:410-424`` / ``instaslice_daemonset.go:500-552``;
requeue-after plumbing throughout). This module provides the same
contract: informer-backed watches map events to keys; dedup workqueues
drive N key-hash-sharded worker threads (``MaxConcurrentReconciles``);
a given key always lands on the same shard, so keys are never reconciled
concurrently with themselves while distinct keys proceed in parallel.
Optional per-shard Lease leadership (``utils/election.py``) splits the
shards across multiple controller replicas (docs/SCALING.md).

A copy of ``instaslice_tpu/utils/reconcile.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import heapq
import logging
import os
import threading
import time
import traceback
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from instaslice_tpu_torch.faults import InjectedCrash
from instaslice_tpu_torch.kube.informer import Informer
from instaslice_tpu_torch.utils.lockcheck import named_condition
from instaslice_tpu_torch.utils.guards import unguarded

log = logging.getLogger("instaslice_tpu_torch")

#: map a watch event to reconcile keys (reference: ``podMapFunc``,
#: instaslice_controller.go:398-407)
MapFunc = Callable[[str, dict], List[str]]

#: env knob for reconcile concurrency (controller-runtime's
#: ``MaxConcurrentReconciles``); consumers pass the result as ``workers``
WORKERS_ENV = "TPUSLICE_RECONCILE_WORKERS"


def default_workers(fallback: int = 1) -> int:
    """Worker count from :data:`WORKERS_ENV`, else ``fallback``."""
    raw = os.environ.get(WORKERS_ENV, "")
    try:
        n = int(raw) if raw else fallback
    except ValueError:
        n = fallback
    return max(1, n)


def shard_for(key: str, shards: int) -> int:
    """Stable key→shard assignment (crc32, not ``hash()`` — the builtin
    is salted per process, and two controller replicas splitting shards
    by Lease must agree on the mapping)."""
    if shards <= 1:
        return 0
    return zlib.crc32(key.encode()) % shards


class WorkQueue:
    """Deduplicating delayed work queue. ``add`` with delay=0 enqueues
    immediately; a key already queued is not duplicated; delayed adds keep
    the earliest due time. Stale heap entries (superseded by an earlier
    due time) are counted and compacted once they outnumber the live
    ones, so repeated delayed re-adds of one key can't grow the heap
    without bound."""

    #: compaction floor: below this many stale entries the O(n) rebuild
    #: costs more than the garbage
    COMPACT_MIN = 64

    def __init__(self) -> None:
        self._cond = named_condition("reconcile.workqueue")
        self._due: Dict[str, float] = {}
        self._heap: List[Tuple[float, str]] = []
        self._stale = 0
        self._closed = False

    def add(self, key: str, delay: float = 0.0) -> None:
        due = time.monotonic() + max(0.0, delay)
        with self._cond:
            if self._closed:
                return
            cur = self._due.get(key)
            if cur is not None and cur <= due:
                return
            if cur is not None:
                self._stale += 1  # the old heap entry just went stale
            self._due[key] = due
            heapq.heappush(self._heap, (due, key))
            if (
                self._stale >= self.COMPACT_MIN
                and self._stale > len(self._due)
            ):
                self._heap = [(d, k) for k, d in self._due.items()]
                heapq.heapify(self._heap)
                self._stale = 0
            self._cond.notify_all()

    def get(self, timeout: Optional[float] = None) -> Optional[str]:
        """Block until a key is due (or queue closed → None)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._closed and not self._heap:
                    return None
                now = time.monotonic()
                while self._heap:
                    due, key = self._heap[0]
                    if self._due.get(key) != due:
                        heapq.heappop(self._heap)  # stale entry
                        self._stale = max(0, self._stale - 1)
                        continue
                    break
                if self._heap:
                    due, key = self._heap[0]
                    if due <= now:
                        heapq.heappop(self._heap)
                        del self._due[key]
                        return key
                    wait = due - now
                else:
                    if self._closed:
                        return None
                    wait = None
                if deadline is not None:
                    remain = deadline - now
                    if remain <= 0:
                        return None
                    wait = remain if wait is None else min(wait, remain)
                self._cond.wait(wait)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return len(self._due)

    def heap_size(self) -> int:
        """Observability for tests: live + stale heap entries."""
        with self._cond:
            return len(self._heap)


class ShardedQueue:
    """Facade routing one logical queue onto per-shard
    :class:`WorkQueue` instances by stable key hash. Presents the same
    ``add``/``close``/``len`` surface callers always used, so a
    single-worker Manager and a 16-way one look identical from the
    outside."""

    def __init__(self, shards: int) -> None:
        self.shards = [WorkQueue() for _ in range(max(1, shards))]

    def add(self, key: str, delay: float = 0.0) -> None:
        self.shards[shard_for(key, len(self.shards))].add(key, delay)

    def close(self) -> None:
        for q in self.shards:
            q.close()

    def __len__(self) -> int:
        return sum(len(q) for q in self.shards)


class Manager:
    """Runs one reconciler: informer-backed watches feeding sharded
    workqueues, N worker threads calling ``reconcile(key)``.

    ``reconcile`` returns None (done) or a float (requeue after seconds —
    the reference's ``RequeueAfter`` pattern, e.g.
    instaslice_controller.go:93,201,225). Exceptions are logged and the
    key is requeued with backoff instead of crashing the loop.

    ``workers`` > 1 shards keys by :func:`shard_for`: per-key ordering
    is preserved (a key is only ever handled by its shard's single
    worker) while distinct keys reconcile in parallel.

    ``indexers`` / ``transforms``: per-kind secondary indexes and parse
    caches installed on the informers (``manager.informer(kind)`` hands
    the cache to the reconciler — this is what kills per-reconcile
    re-listing).

    ``shard_lease`` (dict with ``namespace``, ``prefix``, ``identity``,
    optional ``lease_seconds``/``retry_seconds``): each shard worker
    acquires Lease ``<prefix>-<shard>`` before draining its queue, so
    multiple controller replicas split the shards between them while a
    key still only ever runs on one replica (per-shard leadership,
    docs/SCALING.md). :meth:`shard_is_leader` exposes the calling
    worker's leadership for write fencing.
    """

    queue: unguarded("ShardedQueue synchronizes internally "
                     "(per-shard named_condition)")
    _reconcile_counts: unguarded("per-worker slots: worker i writes "
                                 "only index i; readers sum racily")
    _error_counts: unguarded("per-worker slots, see _reconcile_counts")
    _electors: unguarded("per-shard slots: each worker assigns only "
                         "its own shard key, once, at startup")

    def __init__(
        self,
        name: str,
        client,
        reconcile: Callable[[str], Optional[float]],
        watches: List[Tuple[str, Optional[str], MapFunc]],
        resync_period: float = 30.0,
        error_backoff: float = 0.5,
        tracer=None,
        workers: int = 1,
        indexers: Optional[Dict[str, Dict[str, Callable]]] = None,
        transforms: Optional[Dict[str, Callable[[dict], object]]] = None,
        shard_lease: Optional[dict] = None,
    ) -> None:
        self.name = name
        self.client = client
        self.reconcile = reconcile
        self.watches = watches
        self.resync_period = resync_period
        self.error_backoff = error_backoff
        # resolved per use, never cached: after reset_tracer() swaps the
        # process default, reconcile spans must land in the NEW tracer,
        # not an orphaned closed ring
        self._tracer = tracer
        self.workers = max(1, int(workers))
        self.queue = ShardedQueue(self.workers)
        self.shard_lease = shard_lease
        self._informers: Dict[Tuple[str, Optional[str]], Informer] = {}
        for kind, ns, fn in watches:
            ikey = (kind, ns)
            inf = self._informers.get(ikey)
            if inf is None:
                inf = Informer(
                    client,
                    kind,
                    namespace=ns,
                    resync_period=resync_period,
                    error_backoff=error_backoff,
                    indexers=(indexers or {}).get(kind),
                    transform=(transforms or {}).get(kind),
                    name=f"{name}-watch-{kind}",
                )
                self._informers[ikey] = inf
            inf.add_handler(self._make_handler(fn))
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._reconcile_counts = [0] * self.workers
        self._error_counts = [0] * self.workers
        self._electors: Dict[int, object] = {}
        self._local = threading.local()

    def _make_handler(self, fn: MapFunc) -> Callable[[str, dict], None]:
        def handler(event: str, obj: dict) -> None:
            for key in fn(event, obj):
                self.queue.add(key)

        return handler

    @property
    def tracer(self):
        if self._tracer is not None:
            return self._tracer
        from instaslice_tpu_torch.utils.trace import get_tracer

        return get_tracer()

    # ------------------------------------------------------------ counters

    @property
    def reconcile_count(self) -> int:
        return sum(self._reconcile_counts)

    @property
    def error_count(self) -> int:
        return sum(self._error_counts)

    # ------------------------------------------------------------ informers

    def informer(self, kind: str) -> Optional[Informer]:
        for (k, _), inf in self._informers.items():
            if k == kind:
                return inf
        return None

    def wait_synced(self, timeout: float = 10.0) -> bool:
        """Block until every informer finished its initial relist."""
        deadline = time.monotonic() + timeout
        for inf in self._informers.values():
            if not inf.wait_synced(max(0.0, deadline - time.monotonic())):
                return False
        return True

    # ----------------------------------------------------------- sharding

    def current_shard(self) -> Optional[int]:
        """The calling worker thread's shard id (None off a worker).
        Capture this BEFORE handing a write to a cross-thread committer
        (the coalesced writer) so the fence stays bound to the
        enqueueing worker's lease, not the committing thread's."""
        return getattr(self._local, "shard", None)

    def shard_is_leader(self, shard: Optional[int] = None) -> bool:
        """True when ``shard``'s Lease is verifiably held at the epoch
        this worker acquired it (default: the calling worker thread's
        shard; always True without ``shard_lease`` or off a worker
        thread). Reconcilers use this as a write fence piece: a worker
        whose shard Lease was lost — or whose lease *epoch* was
        superseded while it was partitioned — must not land writes
        racing the replica that took the shard over
        (``LeaderElector.verify_epoch``, docs/RECOVERY.md "Partitions
        & gray failures")."""
        if not self.shard_lease:
            return True
        if shard is None:
            shard = self.current_shard()
        if shard is None:
            return True
        elector = self._electors.get(shard)
        return elector is None or (
            elector.is_leader.is_set() and elector.verify_epoch()
        )

    def shard_fence(self, shard: Optional[int] = None):
        """An :class:`~instaslice_tpu_torch.utils.election.EpochFence` bound
        to ``shard``'s Lease elector (default: the calling worker's
        shard, captured NOW — hand the result to a cross-thread
        committer and it stays bound to the enqueueing worker's lease).
        Open (and epoch-less) without ``shard_lease``."""
        from instaslice_tpu_torch.utils.election import EpochFence

        if shard is None:
            shard = self.current_shard()

        def get_elector(s=shard):
            if not self.shard_lease or s is None:
                return None
            return self._electors.get(s)

        return EpochFence(get_elector)

    def _shard_elector(self, shard: int):
        from instaslice_tpu_torch.utils.election import LeaderElector

        cfg = self.shard_lease
        return LeaderElector(
            self.client,
            cfg["namespace"],
            f"{cfg['prefix']}-shard-{shard}",
            cfg["identity"],
            lease_seconds=cfg.get("lease_seconds", 15.0),
            retry_seconds=cfg.get("retry_seconds", 2.0),
        )

    # ------------------------------------------------------------- worker

    def _worker(self, shard: int) -> None:
        self._local.shard = shard
        elector = None
        if self.shard_lease:
            elector = self._shard_elector(shard)
            self._electors[shard] = elector
        queue = self.queue.shards[shard]
        while True:
            if elector is not None and not elector.is_leader.is_set():
                # (re)acquire the shard Lease before draining the queue;
                # level-triggered reconciles make the handover backlog
                # safe to replay
                if not elector.acquire(self._stop):
                    return  # stopped while waiting for leadership
                elector.start_renewing(on_lost=lambda: None)
                log.info("%s: shard %d leadership acquired",
                         self.name, shard)
            key = queue.get(timeout=0.25)
            if key is None:
                if self._stop.is_set():
                    return
                continue
            self._reconcile_counts[shard] += 1
            try:
                with self.tracer.span(
                    f"{self.name}.reconcile", key=key, shard=shard
                ):
                    requeue = self.reconcile(key)
            except InjectedCrash as e:
                # a crash point fired on this worker: the whole
                # component is dead, not just this thread — crash-stop
                # the manager (no joins: we ARE a worker) so the other
                # workers wind down like a killed process's threads,
                # and let the driver restart a fresh instance against
                # the durable state (docs/RECOVERY.md)
                log.warning("%s: %s — crash-stopping the manager",
                            self.name, e)
                self.halt()
                return
            except Exception:
                self._error_counts[shard] += 1
                log.warning(
                    "%s: reconcile(%s) raised:\n%s",
                    self.name, key, traceback.format_exc(),
                )
                requeue = self.error_backoff
            if requeue is not None and not self._stop.is_set():
                queue.add(key, delay=requeue)

    # ------------------------------------------------------------------

    def start(self) -> None:
        for inf in self._informers.values():
            inf.start()
        for shard in range(self.workers):
            w = threading.Thread(
                target=self._worker, args=(shard,),
                name=f"{self.name}-worker-{shard}", daemon=True,
            )
            w.start()
            self._threads.append(w)

    def halt(self) -> None:
        """Crash-stop: signal everything down WITHOUT joining worker
        threads — callable from a worker (a crash point fires on the
        thread it kills). Leases are deliberately NOT released: a
        killed process doesn't release its leases either; expiry hands
        them over. The manager is dead afterwards — restart means a
        fresh instance."""
        self._stop.set()
        self.queue.close()
        for inf in self._informers.values():
            inf.stop(timeout=0)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self.queue.close()
        for inf in self._informers.values():
            inf.stop(timeout=timeout)
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=timeout)
        for elector in self._electors.values():
            try:
                elector.release()
            except Exception:
                log.warning("%s: shard lease release failed", self.name,
                            exc_info=True)

    def wait_idle(self, timeout: float = 10.0, settle: float = 0.15) -> bool:
        """Test helper: block until the queue stays empty for ``settle``
        seconds. Returns False on timeout."""
        deadline = time.monotonic() + timeout
        quiet_since = None
        while time.monotonic() < deadline:
            if len(self.queue) == 0:
                if quiet_since is None:
                    quiet_since = time.monotonic()
                elif time.monotonic() - quiet_since >= settle:
                    return True
            else:
                quiet_since = None
            # observer poll (test helper): a stopped manager's queue is
            # already empty, so settle expires promptly either way
            time.sleep(0.02)  # slicelint: disable=sleep-in-loop
        return False
