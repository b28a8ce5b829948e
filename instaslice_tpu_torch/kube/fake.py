"""In-process fake Kubernetes API server.

Models exactly the API-machinery semantics the operator depends on
(resourceVersion optimistic concurrency, finalizer-gated deletion, merge
patches, watch streams), so the full controller↔agent distributed state
machine runs — threaded, racy, and observable — inside one test process.
This is the missing test tier the reference never built (SURVEY.md §4:
"the 'distributed' seam (controller ↔ daemonset via CR) has no automated
test").

A copy of ``instaslice_tpu/kube/fake.py`` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from instaslice_tpu_torch.kube.client import (
    AlreadyExists,
    BadRequest,
    Conflict,
    KubeClient,
    NotFound,
    WatchEvent,
)
from instaslice_tpu_torch.utils.lockcheck import named_rlock

_Key = Tuple[str, str, str]  # (kind, namespace, name)


def merge_patch(base: dict, patch: dict) -> dict:
    """RFC 7386 merge patch: dicts deep-merge, None deletes, lists replace."""
    out = dict(base)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_patch(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class _Watcher:
    def __init__(self, kind: str, namespace: Optional[str]):
        self.kind = kind
        self.namespace = namespace
        self.q: "queue.Queue[Optional[WatchEvent]]" = queue.Queue()

    def matches(self, kind: str, namespace: str) -> bool:
        return self.kind == kind and (
            self.namespace is None or self.namespace == namespace
        )


class FakeKube(KubeClient):
    #: events retained for resourceVersion-resumed watches; beyond this a
    #: resume gets the 410-Gone treatment (full relist) like the real API
    HISTORY_MAX = 50_000

    def __init__(self) -> None:
        self._lock = named_rlock("kube.fake_store")
        self._objects: Dict[_Key, dict] = {}
        self._rv = 0
        self._watchers: List[_Watcher] = []
        #: (seq, event, kind, namespace, snapshot) — event log for resume
        self._history: List[Tuple[int, str, str, str, dict]] = []
        self.request_count = 0  # observability for tests/bench
        #: copy-on-read snapshots served by list(): one deepcopy per
        #: object per resourceVersion instead of one per read. Without
        #: this every reconcile's list() is O(cluster size) in
        #: deepcopies — the dominant fake-apiserver cost at 1k nodes.
        #: Snapshots are SHARED with callers: read-only by contract; a
        #: caller mutation can never reach ``_objects`` (the store),
        #: only other readers of the same stale snapshot. ``get()``
        #: still deepcopies (lock-free — stored objects are immutable)
        #: because get-mutate-update writers need a private copy; watch
        #: streams share the frozen stored objects directly.
        self._snapshots: Dict[_Key, dict] = {}
        self._snapshot_rv: Dict[_Key, str] = {}

    # ------------------------------------------------------------- helpers

    def _key(self, kind: str, obj: dict) -> _Key:
        md = obj.get("metadata", {})
        name = md.get("name", "")
        if not name:
            raise BadRequest(f"{kind} object missing metadata.name")
        return (kind, md.get("namespace", ""), name)

    def _next_rv(self) -> str:
        self._rv += 1
        return str(self._rv)

    def _snapshot(self, key: _Key, obj: dict) -> dict:
        """Copy-on-read: reuse the cached deepcopy while the stored
        resourceVersion is unchanged (invalidation keys on the rv
        recorded at snapshot time, NOT on the snapshot's own metadata —
        a caller scribbling on the shared snapshot must not be able to
        confuse the cache)."""
        rv = obj.get("metadata", {}).get("resourceVersion", "")
        snap = self._snapshots.get(key)
        if snap is None or self._snapshot_rv.get(key) != rv:
            snap = copy.deepcopy(obj)
            self._snapshots[key] = snap
            self._snapshot_rv[key] = rv
        return snap

    def _emit(self, event: str, kind: str, obj: dict) -> None:
        ns = obj.get("metadata", {}).get("namespace", "")
        # Store invariant: objects are IMMUTABLE once stored (every
        # write path builds a fresh object or fresh metadata before
        # committing), so the log and every watcher can share `obj`
        # itself — zero copies on the write path. Deepcopying here (the
        # old behavior) held the store lock for the whole copy on EVERY
        # write; under a dozen reconcile workers that lock convoy was
        # the control plane's actual throughput ceiling.
        if event == "DELETED":
            # the stored rv is stale at deletion time; stamp the event
            # with a fresh one (on a private metadata dict — the stored
            # object stays frozen) so resumed watches order it after
            # the last update (the real API server does the same)
            md = dict(obj.get("metadata", {}))
            md["resourceVersion"] = self._next_rv()
            obj = dict(obj)
            obj["metadata"] = md
        try:
            seq = int(obj["metadata"].get("resourceVersion") or self._rv)
        except (ValueError, KeyError):
            seq = self._rv
        # Trim in chunks: a per-write front-del would memmove the whole
        # list on every emit at steady state.
        self._history.append((seq, event, kind, ns, obj))
        if len(self._history) > 2 * self.HISTORY_MAX:
            del self._history[: len(self._history) - self.HISTORY_MAX]
        for w in list(self._watchers):
            if w.matches(kind, ns):
                w.q.put((event, obj))

    # -------------------------------------------------------------- client

    def create(self, kind: str, obj: dict) -> dict:
        stored = copy.deepcopy(obj)  # outside the lock: caller's object
        with self._lock:
            self.request_count += 1
            key = self._key(kind, stored)
            if key in self._objects:
                raise AlreadyExists(f"{kind} {key[1]}/{key[2]} exists")
            md = stored.setdefault("metadata", {})
            md["resourceVersion"] = self._next_rv()
            md.setdefault("uid", f"uid-{kind.lower()}-{md['name']}-{self._rv}")
            md.setdefault("creationTimestamp", time.time())
            self._objects[key] = stored
            self._emit("ADDED", kind, stored)
        return copy.deepcopy(stored)  # stored is frozen: copy lock-free

    def get(self, kind: str, namespace: str, name: str) -> dict:
        with self._lock:
            self.request_count += 1
            obj = self._objects.get((kind, namespace, name))
        if obj is None:
            raise NotFound(f"{kind} {namespace}/{name} not found")
        # get-mutate-update callers need a private copy; the stored
        # object is immutable, so the deepcopy happens lock-free
        return copy.deepcopy(obj)

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[dict]:
        with self._lock:
            self.request_count += 1
            out = []
            for key, obj in sorted(self._objects.items()):
                k, ns, _ = key
                if k != kind:
                    continue
                if namespace is not None and ns != namespace:
                    continue
                if label_selector:
                    labels = obj.get("metadata", {}).get("labels", {})
                    if any(labels.get(lk) != lv for lk, lv in label_selector.items()):
                        continue
                out.append(self._snapshot(key, obj))
            return out

    def update(self, kind: str, obj: dict) -> dict:
        merged = copy.deepcopy(obj)  # outside the lock: caller's object
        with self._lock:
            self.request_count += 1
            key = self._key(kind, merged)
            if key not in self._objects:
                raise NotFound(f"{kind} {key[1]}/{key[2]} not found")
            stored = self._objects[key]
            sent_rv = merged.get("metadata", {}).get("resourceVersion", "")
            if sent_rv and sent_rv != stored["metadata"]["resourceVersion"]:
                raise Conflict(
                    f"{kind} {key[1]}/{key[2]}: resourceVersion {sent_rv} "
                    f"!= {stored['metadata']['resourceVersion']}"
                )
            md = merged.setdefault("metadata", {})
            # server-owned fields survive the replace
            md["uid"] = stored["metadata"].get("uid", "")
            md["creationTimestamp"] = stored["metadata"].get("creationTimestamp")
            if "deletionTimestamp" in stored["metadata"]:
                md["deletionTimestamp"] = stored["metadata"]["deletionTimestamp"]
            out = self._commit(key, kind, merged)
        return copy.deepcopy(out)

    def _commit(self, key: _Key, kind: str, obj: dict) -> dict:
        """Store + emit, honoring finalizer-gated deletion. No-op writes
        (content identical to stored) do not bump resourceVersion and emit
        no event — matching the real API server, and required so a
        reconciler re-applying its own annotation can't feed itself an
        endless MODIFIED stream.

        ``obj.metadata`` must be private to this commit (callers pass a
        deepcopy or a freshly-built metadata dict): the rv stamp below
        must never reach a previously-stored — and therefore frozen —
        object. Returns the stored object itself (immutable; public
        verbs deepcopy outside the lock)."""
        md = obj["metadata"]
        if md.get("deletionTimestamp") and not md.get("finalizers"):
            del self._objects[key]
            self._snapshots.pop(key, None)
            self._snapshot_rv.pop(key, None)
            self._emit("DELETED", kind, obj)
            return obj
        stored = self._objects.get(key)
        if stored is not None:
            a = {k: v for k, v in stored.items() if k != "metadata"}
            b = {k: v for k, v in obj.items() if k != "metadata"}
            ma = {k: v for k, v in stored["metadata"].items()
                  if k != "resourceVersion"}
            mb = {k: v for k, v in md.items() if k != "resourceVersion"}
            if a == b and ma == mb:
                return stored
        md["resourceVersion"] = self._next_rv()
        self._objects[key] = obj
        self._emit("MODIFIED", kind, obj)
        return obj

    def patch(self, kind: str, namespace: str, name: str, patch: dict) -> dict:
        with self._lock:
            self.request_count += 1
            key = (kind, namespace, name)
            if key not in self._objects:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            stored = self._objects[key]
            merged = merge_patch(stored, patch)
            # unpatched subtrees SHARE structure with the (frozen)
            # stored object — cheap and safe; but metadata must be
            # private so _commit's rv stamp can't touch the old version
            merged["metadata"] = dict(merged.get("metadata", {}))
            # metadata server fields cannot be patched away
            for f in ("uid", "creationTimestamp", "resourceVersion"):
                if f in stored["metadata"]:
                    merged["metadata"][f] = stored["metadata"][f]
            if "deletionTimestamp" in stored["metadata"]:
                merged["metadata"]["deletionTimestamp"] = stored["metadata"][
                    "deletionTimestamp"
                ]
            out = self._commit(key, kind, merged)
        return copy.deepcopy(out)

    def patch_status(
        self, kind: str, namespace: str, name: str, patch: dict
    ) -> dict:
        return self.patch(kind, namespace, name, {"status": patch})

    def delete(self, kind: str, namespace: str, name: str) -> None:
        with self._lock:
            self.request_count += 1
            key = (kind, namespace, name)
            if key not in self._objects:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            obj = self._objects[key]
            md = obj["metadata"]
            if md.get("finalizers"):
                if not md.get("deletionTimestamp"):
                    # fresh object + metadata: stored versions are
                    # frozen (shared with the log and every watcher)
                    new_md = dict(md)
                    new_md["deletionTimestamp"] = time.time()
                    new_md["resourceVersion"] = self._next_rv()
                    new_obj = dict(obj)
                    new_obj["metadata"] = new_md
                    self._objects[key] = new_obj
                    self._emit("MODIFIED", kind, new_obj)
                return
            del self._objects[key]
            self._snapshots.pop(key, None)
            self._snapshot_rv.pop(key, None)
            self._emit("DELETED", kind, obj)

    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        replay: bool = True,
        timeout: Optional[float] = None,
        resource_version: Optional[str] = None,
    ) -> Iterator[WatchEvent]:
        """``resource_version`` resumes the stream after that version: every
        event with a newer version is replayed from the in-memory log before
        live events, so a re-established watch misses nothing (the informer
        relist+resume contract). A version older than the retained log gets
        a relist PLUS the retained log tail — the 410-Gone fallback; tail
        replay keeps recent DELETED events visible even then, at the cost
        of possible duplicates/reordering (safe for level-triggered
        consumers, which re-read state on reconcile anyway). ``replay=True``
        together with ``resource_version`` relists AND replays — the
        deletion-safe resync.

        Every establishment burst ends with a ``BOOKMARK`` event carrying
        only the current head resourceVersion, so consumers can advance
        their resume point even when no real events match their filter."""
        w = _Watcher(kind, namespace)

        def _relist() -> None:
            # stored objects are frozen and shared (read-only watch
            # contract): a 1k-node resync copies nothing
            for key, obj in sorted(self._objects.items()):
                k, ns, _ = key
                if k == kind and (namespace is None or ns == namespace):
                    w.q.put(("ADDED", obj))

        def _replay_log(after: int) -> None:
            for seq, ev, k, ns, snap in self._history:
                if (
                    seq > after
                    and k == kind
                    and (namespace is None or ns == namespace)
                ):
                    w.q.put((ev, snap))

        with self._lock:
            rv: Optional[int] = None
            if resource_version is not None:
                try:
                    rv = int(resource_version)
                except ValueError:
                    rv = None
            if rv is not None:
                resumable = (
                    not self._history or self._history[0][0] <= rv + 1
                )
                # relist when asked (resync) or forced (log truncated past
                # the resume point); always replay the usable log tail so
                # DELETED events — invisible to any relist — still arrive
                if replay or not resumable:
                    _relist()
                _replay_log(after=rv)
            elif replay:
                _relist()
            w.q.put(
                ("BOOKMARK",
                 {"metadata": {"resourceVersion": str(self._rv)}})
            )
            self._watchers.append(w)

        def _iter() -> Iterator[WatchEvent]:
            try:
                while True:
                    try:
                        item = w.q.get(timeout=timeout)
                    except queue.Empty:
                        return
                    if item is None:
                        return
                    yield item
            finally:
                with self._lock:
                    if w in self._watchers:
                        self._watchers.remove(w)

        return _iter()

    def stop_watches(self) -> None:
        with self._lock:
            for w in self._watchers:
                w.q.put(None)
