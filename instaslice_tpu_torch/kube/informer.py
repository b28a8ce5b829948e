"""Informer: shared watch-driven object cache with secondary indexes.

The reference operator reads cluster state through controller-runtime's
cached client — every ``r.List`` in ``instaslice_controller.go`` hits an
informer store, never the API server. Our reconcilers instead re-listed
on every pass (``Controller._load_slices``), which is O(cluster-size)
API work per reconcile and the first thing that melts at 1k nodes
(docs/SCALING.md). This module is the missing layer: one watch stream
per (kind, namespace) keeps a thread-safe primary store (namespace/name)
plus caller-registered secondary indexes and an optional transform cache
(e.g. parsed ``TpuSlice`` objects), with resourceVersion resume riding
the same reconnect machinery ``kube/real.py`` provides.

Contract for readers: objects handed out by :meth:`get` / :meth:`list` /
:meth:`by_index` are SHARED snapshots — read-only by convention. A
mutation cannot corrupt the API server (writers go through
``update_with_retry``, which re-reads), but it would be visible to every
other cache reader. Writers that need a private copy must deepcopy.

A copy of ``instaslice_tpu/kube/informer.py`` (the port imports nothing
of the JAX package).
"""

from __future__ import annotations

import copy
import logging
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

from instaslice_tpu_torch.utils.lockcheck import named_lock
from instaslice_tpu_torch.utils.guards import guarded_by, unguarded

log = logging.getLogger("instaslice_tpu_torch")

#: secondary index function: raw manifest → index keys it belongs under
IndexFunc = Callable[[dict], List[str]]

#: event handler: (event, raw manifest) — called for every non-BOOKMARK
#: watch event (including synthesized relist-diff DELETEDs), after the
#: store reflects it
Handler = Callable[[str, dict], None]

_ObjKey = Tuple[str, str]  # (namespace, name)


def _rv_int(obj: dict) -> Optional[int]:
    try:
        return int(obj.get("metadata", {}).get("resourceVersion"))
    except (TypeError, ValueError):
        return None


class Informer:
    """List+watch cache for one (kind, namespace) pair.

    - primary key: (namespace, name)
    - ``indexers``: name → :data:`IndexFunc` secondary indexes,
      maintained incrementally on every event
    - ``transform``: optional raw-manifest → parsed-object function,
      applied once per stored resourceVersion (the client-go transformer
      analog — at 1k nodes, re-parsing every CR per reconcile dominates)
    - resourceVersion resume + relist-diff deletion synthesis: identical
      semantics to the watch loop the reconcile :class:`Manager` always
      had (tests/test_kubeauth.py pins them), now feeding a shared store.
    """

    # store + caches are shared between the watch thread and every
    # reader (reconcile workers, placement scans)
    _store: guarded_by("kube.informer")
    _transformed: guarded_by("kube.informer")
    generation: guarded_by("kube.informer")
    _handlers: unguarded("appended only before start(); the watch "
                         "thread afterwards only iterates")

    def __init__(
        self,
        client,
        kind: str,
        namespace: Optional[str] = None,
        resync_period: float = 30.0,
        error_backoff: float = 0.5,
        indexers: Optional[Dict[str, IndexFunc]] = None,
        transform: Optional[Callable[[dict], object]] = None,
        name: str = "",
    ) -> None:
        self.client = client
        self.kind = kind
        self.namespace = namespace
        self.resync_period = resync_period
        self.error_backoff = error_backoff
        self.name = name or f"informer-{kind}"
        self._transform = transform
        self._indexers: Dict[str, IndexFunc] = dict(indexers or {})
        self._lock = named_lock("kube.informer")
        self._store: Dict[_ObjKey, dict] = {}
        self._transformed: Dict[_ObjKey, object] = {}
        #: index name → index key → set of object keys
        self._indexes: Dict[str, Dict[str, set]] = {
            n: {} for n in self._indexers
        }
        #: reverse map for incremental index maintenance
        self._obj_index_keys: Dict[str, Dict[_ObjKey, List[str]]] = {
            n: {} for n in self._indexers
        }
        #: index name → index key → version counter, bumped whenever a
        #: member object changes. O(1) "did this group change?" checks —
        #: a 1k-node placement scan must not recompute per-member
        #: fingerprints per pending pod (docs/SCALING.md)
        self._index_versions: Dict[str, Dict[str, int]] = {
            n: {} for n in self._indexers
        }
        #: bumped on every store change — cheap cache-invalidation signal
        #: for derived structures (e.g. the controller's torus groups)
        self.generation = 0
        self._handlers: List[Handler] = []
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- handlers

    def add_handler(self, handler: Handler) -> None:
        """Register an event handler (before :meth:`start`)."""
        self._handlers.append(handler)

    # ------------------------------------------------------------- store

    def _apply(self, event: str, obj: dict) -> bool:
        """Fold one event into store + indexes. Returns True when the
        store changed (stale events — an older resourceVersion than the
        stored one — are ignored, so a relist racing a log-tail replay
        can never regress the cache)."""
        md = obj.get("metadata", {})
        okey = (md.get("namespace", ""), md.get("name", ""))
        with self._lock:
            cur = self._store.get(okey)
            if event == "DELETED":
                if cur is None:
                    return False
                rv, cur_rv = _rv_int(obj), _rv_int(cur)
                if rv is not None and cur_rv is not None and rv < cur_rv:
                    return False  # stale delete replayed after recreate
                del self._store[okey]
                self._transformed.pop(okey, None)
                self._unindex(okey)
                self.generation += 1
                return True
            if cur is not None:
                rv, cur_rv = _rv_int(obj), _rv_int(cur)
                if rv is not None and cur_rv is not None and rv <= cur_rv:
                    # stale replay (<) or an equal-rv re-delivery (a
                    # resync relist re-lists every object at its
                    # current version): nothing changed, so skip the
                    # re-transform and index-version bumps — otherwise
                    # every resync re-parses the whole fleet and
                    # invalidates every derived memo
                    return False
            self._store[okey] = obj
            if self._transform is not None:
                self._transformed[okey] = self._transform(obj)
            self._unindex(okey)
            for iname, fn in self._indexers.items():
                keys = [k for k in fn(obj) if k]
                versions = self._index_versions[iname]
                if keys:
                    self._obj_index_keys[iname][okey] = keys
                    idx = self._indexes[iname]
                    for k in keys:
                        idx.setdefault(k, set()).add(okey)
                        versions[k] = versions.get(k, 0) + 1
            self.generation += 1
            return True

    def _unindex(self, okey: _ObjKey) -> None:
        for iname in self._indexers:
            versions = self._index_versions[iname]
            for k in self._obj_index_keys[iname].pop(okey, []):
                versions[k] = versions.get(k, 0) + 1
                bucket = self._indexes[iname].get(k)
                if bucket is not None:
                    bucket.discard(okey)
                    if not bucket:
                        del self._indexes[iname][k]

    def write_through(self, obj: dict) -> None:
        """Fold a server-confirmed write result into the cache
        immediately, without waiting for the watch event (which arrives
        later and dedups on resourceVersion). This is what lets a
        sharded controller trust its cache right after its own writes —
        occupancy computed from the cache already includes the
        allocation the previous reconcile just landed."""
        if obj:
            self._apply("MODIFIED", obj)

    # ------------------------------------------------------------ readers

    def get(self, namespace: str, name: str) -> Optional[dict]:
        with self._lock:
            return self._store.get((namespace, name))

    def get_transformed(self, namespace: str, name: str) -> object:
        with self._lock:
            return self._transformed.get((namespace, name))

    def list(self, namespace: Optional[str] = None) -> List[dict]:
        with self._lock:
            if namespace is None:
                return list(self._store.values())
            return [o for (ns, _), o in self._store.items()
                    if ns == namespace]

    def list_transformed(self) -> List[object]:
        with self._lock:
            return list(self._transformed.values())

    def by_index(self, index: str, key: str,
                 transformed: bool = False) -> List[object]:
        with self._lock:
            okeys = sorted(self._indexes.get(index, {}).get(key, ()))
            src = self._transformed if transformed else self._store
            return [src[k] for k in okeys if k in src]

    def index_keys(self, index: str) -> List[str]:
        with self._lock:
            return sorted(self._indexes.get(index, {}))

    def index_version(self, index: str, key: str) -> int:
        """Monotonic counter bumped whenever any member of ``key``'s
        bucket changes — an O(1) staleness check for caches derived
        from an index bucket (the controller's per-group occupancy
        memos)."""
        with self._lock:
            return self._index_versions.get(index, {}).get(key, 0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def synced(self) -> bool:
        return self._synced.is_set()

    def wait_synced(self, timeout: float = 10.0) -> bool:
        return self._synced.wait(timeout)

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "Informer":
        self._thread = threading.Thread(
            target=self._run, name=f"{self.name}-watch", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # --------------------------------------------------------- watch loop

    def _run(self) -> None:
        from instaslice_tpu_torch.kube.client import ResourceVersionExpired

        # Replay (list+watch) on the first establishment and then once
        # per resync_period — not on every re-establishment. Between
        # replays, re-establish with the last seen resourceVersion so
        # events emitted while the watch was down are replayed, not lost.
        # (This is the watch loop Manager._watch_loop always ran — moved
        # here verbatim so the store it maintains is shared + indexed.)
        last_replay = float("-inf")
        force_replay = True
        # "0" = resume from the beginning of the event log, so that even
        # a watch that has never seen an event can't lose ones emitted
        # while it was re-establishing
        last_rv: Optional[str] = "0"
        watch_timeout = getattr(self.client, "preferred_watch_timeout", 0.25)
        while not self._stop.is_set():
            replay = (
                force_replay
                or time.monotonic() - last_replay >= self.resync_period
            )
            if replay:
                force_replay = False
                last_replay = time.monotonic()
            listed: set = set()
            in_burst = replay  # relist burst runs until the first BOOKMARK
            started = time.monotonic()
            events = 0
            try:
                # resource_version is ALWAYS passed: a resync relist
                # alone cannot show objects deleted while the watch was
                # down, so the log replay must ride along with it
                for event, obj in self.client.watch(
                    self.kind,
                    namespace=self.namespace,
                    replay=replay,
                    timeout=watch_timeout,
                    resource_version=last_rv,
                ):
                    if self._stop.is_set():
                        return
                    md = obj.get("metadata", {})
                    rv = md.get("resourceVersion")
                    if rv:
                        last_rv = rv
                    if event == "BOOKMARK":
                        if in_burst:
                            # end of the relist burst: anything we knew
                            # that the relist did not show is gone
                            in_burst = False
                            gone = []
                            with self._lock:
                                for skey in set(self._store) - listed:
                                    gone.append(self._store[skey])
                            for gobj in gone:
                                if self._apply("DELETED", gobj):
                                    self._dispatch("DELETED", gobj)
                            self._synced.set()
                        continue  # resume-point advance only, no object
                    events += 1  # real (non-BOOKMARK) events only
                    okey = (md.get("namespace", ""), md.get("name", ""))
                    if in_burst and event != "DELETED":
                        listed.add(okey)
                    self._apply(event, obj)
                    self._dispatch(event, obj)
            except ResourceVersionExpired:
                # stale resume point: resuming with it would hot-loop
                # 410s — drop it and force a relist next establishment
                log.info(
                    "%s: watch %s resourceVersion expired; relisting",
                    self.name, self.kind,
                )
                last_rv = None
                force_replay = True
                self._stop.wait(self.error_backoff)
            except Exception:
                log.warning(
                    "%s: watch %s failed:\n%s",
                    self.name, self.kind, traceback.format_exc(),
                )
                self._stop.wait(self.error_backoff)
            else:
                # a healthy stream lives for ~watch_timeout; one that
                # dies instantly with nothing to say is a broken server
                # or a stale-rv loop — pace it like an error
                if events == 0 and time.monotonic() - started < 0.05:
                    self._stop.wait(self.error_backoff)
            # watch ended (timeout/quiet) → re-establish; brief pause
            # keeps fake-kube polling cheap
            self._stop.wait(0.02)

    def _dispatch(self, event: str, obj: dict) -> None:
        """Call handlers OUTSIDE the store lock: handlers enqueue into
        workqueues (their own condition locks) and must never nest under
        the informer lock (lockcheck would flag the order edge)."""
        for h in self._handlers:
            try:
                h(event, obj)
            except Exception:
                log.warning(
                    "%s: handler failed for %s:\n%s",
                    self.name, event, traceback.format_exc(),
                )

    # ------------------------------------------------------------- debug

    def snapshot_copy(self, namespace: str, name: str) -> Optional[dict]:
        """A private deepcopy for callers that must mutate."""
        obj = self.get(namespace, name)
        return copy.deepcopy(obj) if obj is not None else None
