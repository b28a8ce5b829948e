"""Runtime lock-order race detector behind a named-lock factory.

Every lock in the project is created through :func:`named_lock` /
:func:`named_rlock` / :func:`named_condition` (enforced by
``tools/slicelint.py``'s ``raw-lock`` rule — direct
``threading.Lock()`` construction outside this module fails ``make
lint``). The factories return thin instrumented wrappers whose fast
path is a single module-flag check; armed (``TPUSLICE_LOCKCHECK=1``,
or :func:`arm` from a test) they additionally record, per thread, the
stack of locks currently held and, globally:

- the **acquisition-order graph**: an edge ``A -> B`` means some thread
  acquired ``B`` while holding ``A``. The moment an edge closes a cycle
  (``A -> B`` recorded while ``B -> ... -> A`` already exists), the
  cycle is reported — an ABBA deadlock that has not happened *yet* but
  will, on the right interleaving. This is lock-order checking in the
  witness/lockdep tradition: it needs only one benign interleaving of
  each path to prove the hazard, so a chaos run doubles as a race
  detector (``make chaos`` with ``TPUSLICE_LOCKCHECK=1``; the conftest
  fails the session if any cycle was seen).
- **hold times** per lock name (count/total/max), so a lock held across
  a blocking call shows up in :func:`report` even before it deadlocks
  anything.

Graph nodes are lock *names*, not instances: the per-request
``serve.pending`` locks aggregate into one node, which is exactly the
granularity an ordering discipline is written against. Name locks
``<package>.<what>`` (e.g. ``kube.breaker``, ``trace.ring``).

``Condition.wait`` releases the underlying lock for the wait's
duration; the wrapper mirrors that in the held-set, so waiting under a
condition can never fabricate a false ordering edge.

The detector's own state is guarded by a RAW ``threading.Lock`` — it
cannot instrument itself, and that lock is a leaf (no other lock is
ever taken under it).

A copy of ``instaslice_tpu/utils/lockcheck.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("instaslice_tpu_torch.lockcheck")

ENV_VAR = "TPUSLICE_LOCKCHECK"
#: hold-time above this is recorded as a long-hold incident (seconds)
HOLD_WARN_SECONDS = float(
    os.environ.get("TPUSLICE_LOCKCHECK_HOLD_WARN", "1.0")
)

_armed = os.environ.get(ENV_VAR, "") not in ("", "0")

# detector state — guarded by _state_lock (raw: leaf lock, see module doc)
# slicelint: disable=raw-lock
_state_lock = threading.Lock()
#: (held, acquired) -> (thread name, count)
_edges: Dict[Tuple[str, str], List] = {}
#: recorded cycles: {"chain": [names...], "threads": [...]} (chain is
#: closed: chain[0] is the name whose acquisition closed the cycle)
_cycles: List[dict] = []
#: name -> [count, total_s, max_s]
_holds: Dict[str, List[float]] = {}
#: long-hold incidents: (name, seconds, thread)
_long_holds: List[Tuple[str, float, str]] = []
_tls = threading.local()
#: thread -> its held-stack list, registered on the thread's first
#: instrumented acquire. The list itself is mutated lock-free by its
#: owner; :func:`live` reads racy GIL-consistent snapshots (debug
#: surface — a momentarily stale view is fine). Guarded by _state_lock
#: for membership only; dead threads are pruned on read.
_thread_stacks: Dict[threading.Thread, list] = {}


class LockOrderError(AssertionError):
    """Raised by :func:`assert_clean` when any lock-order cycle was
    observed (the wrapped report rides in ``.report``)."""

    def __init__(self, message: str, report_dict: dict) -> None:
        super().__init__(message)
        self.report = report_dict


def arm() -> None:
    """Turn detection on (tests; equivalent to TPUSLICE_LOCKCHECK=1)."""
    global _armed
    _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def armed() -> bool:
    return _armed


def reset() -> None:
    """Drop all recorded edges/cycles/holds (test isolation)."""
    with _state_lock:
        _edges.clear()
        _cycles.clear()
        _holds.clear()
        del _long_holds[:]


def snapshot() -> dict:
    """Opaque copy of the detector's global state, for :func:`restore`.

    Tests that must :func:`reset` for isolation (test_lockcheck.py's
    deliberate cycles) stash the session's REAL findings first and merge
    them back after — otherwise an armed full-suite run
    (``TPUSLICE_LOCKCHECK=1``) would have its genuine project-lock
    cycles erased before the conftest session gate reads them."""
    with _state_lock:
        return {
            "edges": {k: list(v) for k, v in _edges.items()},
            "cycles": [dict(c) for c in _cycles],
            "holds": {k: list(v) for k, v in _holds.items()},
            "long_holds": list(_long_holds),
        }


def restore(snap: dict) -> None:
    """Merge a :func:`snapshot` back into the current state (edge and
    hold counts add; cycles and long-hold incidents append)."""
    with _state_lock:
        for key, (thread, count) in snap["edges"].items():
            rec = _edges.get(key)
            if rec is None:
                _edges[key] = [thread, count]
            else:
                rec[1] += count
        _cycles.extend(dict(c) for c in snap["cycles"])
        for name, (count, total, mx) in snap["holds"].items():
            rec = _holds.setdefault(name, [0, 0.0, 0.0])
            rec[0] += count
            rec[1] += total
            rec[2] = max(rec[2], mx)
        _long_holds.extend(snap["long_holds"])


def report() -> dict:
    """Snapshot of the acquisition graph, detected cycles, and hold-time
    stats — JSON-shaped, for test assertions and debugging."""
    with _state_lock:
        return {
            "armed": _armed,
            "edges": [
                {"held": a, "acquired": b, "thread": t, "count": n}
                for (a, b), (t, n) in sorted(_edges.items())
            ],
            "cycles": [dict(c) for c in _cycles],
            "holds": {
                name: {
                    "count": int(c),
                    "totalSeconds": round(tot, 6),
                    "maxSeconds": round(mx, 6),
                }
                for name, (c, tot, mx) in sorted(_holds.items())
            },
            "longHolds": [
                {"name": n, "seconds": round(s, 3), "thread": t}
                for n, s, t in _long_holds
            ],
        }


def live() -> dict:
    """Currently-held locks, per live thread — the lock-triage view a
    hung process exposes on ``GET /v1/debug/locks``: which thread holds
    what, in acquisition order, and for how long. Entries are racy
    GIL-consistent snapshots (each stack is owned by its thread); a
    thread with nothing held is omitted."""
    now = time.monotonic()
    with _state_lock:
        dead = [t for t in _thread_stacks if not t.is_alive()]
        for t in dead:
            del _thread_stacks[t]
        stacks = [(t, list(st)) for t, st in _thread_stacks.items()]
    threads = []
    for t, st in stacks:
        held = [
            {
                "name": e[0],
                "heldSeconds": round(now - e[2], 6),
                "depth": int(e[3]),
            }
            for e in st
        ]
        if held:
            threads.append({"thread": t.name, "held": held})
    threads.sort(key=lambda d: d["thread"])
    return {"armed": _armed, "threads": threads}


def debug_locks_payload(qs: Optional[dict] = None) -> dict:
    """``GET /v1/debug/locks`` body: live per-thread held locks plus
    the accumulated acquisition-order graph, cycles, hold-time stats
    and long-hold incidents. Everything is empty while disarmed
    (``armed: false`` tells the caller to set TPUSLICE_LOCKCHECK=1) —
    the endpoint itself stays cheap either way."""
    payload = report()
    payload["live"] = live()["threads"]
    return payload


def assert_clean() -> None:
    """Raise :class:`LockOrderError` if any ABBA cycle was observed.
    The chaos tier calls this at session end, turning every chaos seed
    into a lock-order regression test."""
    rep = report()
    if rep["cycles"]:
        chains = "; ".join(
            " -> ".join(c["chain"]) for c in rep["cycles"]
        )
        raise LockOrderError(
            f"lock-order cycles detected: {chains} "
            "(see .report for edges/threads)", rep,
        )


# ------------------------------------------------------------ internals


def _held() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
        me = threading.current_thread()
        with _state_lock:
            _thread_stacks[me] = st
    return st


def _find(st: list, key: int) -> Optional[list]:
    for entry in reversed(st):
        if entry[1] == key:
            return entry
    return None


def _before_acquire(name: str, key: int, reentrant: bool = True) -> None:
    """Record ordering edges held-lock -> name; detect cycles the moment
    an edge closes one. Re-entry (same instance already held) records
    nothing for an RLock — its second acquire imposes no new order — but
    for a plain Lock it is a guaranteed self-deadlock, reported as the
    degenerate cycle ``name -> name`` BEFORE the thread blocks on it."""
    st = _held()
    if _find(st, key) is not None:
        if not reentrant:
            me = threading.current_thread().name
            with _state_lock:
                _cycles.append({"chain": [name, name], "threads": [me]})
            log.error(
                "self-deadlock: thread %s re-acquiring non-reentrant "
                "lock %s it already holds", me, name,
            )
        return
    me = threading.current_thread().name
    for entry in st:
        a = entry[0]
        if a == name:
            # distinct instances sharing a name: same-name nesting is
            # itself an ordering hazard ONLY for the same instance
            # (caught above); between instances it is indistinguishable
            # from legal striping, so it is not recorded as an edge
            continue
        with _state_lock:
            rec = _edges.get((a, name))
            if rec is not None:
                rec[1] += 1
                continue
            _edges[(a, name)] = [me, 1]
            chain = _cycle_path(name, a)
            if chain is not None:
                cyc = {
                    "chain": chain + [name],
                    "threads": sorted({me, *(
                        _edges[(chain[i], chain[i + 1])][0]
                        for i in range(len(chain) - 1)
                        if (chain[i], chain[i + 1]) in _edges
                    )}),
                }
                _cycles.append(cyc)
                log.error(
                    "lock-order cycle: %s (thread %s closing edge "
                    "%s -> %s)", " -> ".join(cyc["chain"]), me, a, name,
                )


def _cycle_path(src: str, dst: str) -> Optional[List[str]]:
    """Path src -> ... -> dst in the edge graph (callers hold
    _state_lock). Returns the node chain or None."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for (a, b) in _edges:
            if a != node or b in seen:
                continue
            if b == dst:
                return path + [b]
            seen.add(b)
            stack.append((b, path + [b]))
    return None


def _after_acquire(name: str, key: int) -> None:
    st = _held()
    entry = _find(st, key)
    if entry is not None:
        entry[3] += 1          # RLock re-entry
        return
    st.append([name, key, time.monotonic(), 1])


def _on_release(name: str, key: int) -> None:
    st = _held()
    entry = _find(st, key)
    if entry is None:
        return  # armed mid-hold (arm() raced an acquire) — tolerate
    entry[3] -= 1
    if entry[3] > 0:
        return
    st.remove(entry)
    if not _armed:
        # disarmed between acquire and release: drop the stale entry
        # (a leftover would fabricate self-deadlocks/edges on re-arm)
        # but record no stats for a hold that spanned the disarm
        return
    held_for = time.monotonic() - entry[2]
    me = threading.current_thread().name
    with _state_lock:
        rec = _holds.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += held_for
        if held_for > rec[2]:
            rec[2] = held_for
        if held_for >= HOLD_WARN_SECONDS:
            _long_holds.append((name, held_for, me))


# ------------------------------------------------------------- wrappers


class _InstrumentedLock:
    """Wraps a ``threading.Lock`` (can't be subclassed). Supports the
    full lock protocol incl. ``with``; instrumentation is a no-op while
    disarmed."""

    _inner_factory = staticmethod(threading.Lock)
    _reentrant = False

    def __init__(self, name: str) -> None:
        self.name = name
        self._inner = self._inner_factory()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _armed:
            _before_acquire(self.name, id(self), self._reentrant)
        ok = self._inner.acquire(blocking, timeout)
        if ok and _armed:
            _after_acquire(self.name, id(self))
        return ok

    def release(self) -> None:
        # also run disarmed IF this thread has entries: a disarm between
        # acquire and release must still pop the held-stack entry
        if _armed or getattr(_tls, "stack", None):
            _on_release(self.name, id(self))
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "_InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.name!r} {self._inner!r}>"


class _InstrumentedRLock(_InstrumentedLock):
    _inner_factory = staticmethod(threading.RLock)
    _reentrant = True

    def locked(self) -> bool:  # RLock has no .locked() before 3.12
        locked = getattr(self._inner, "locked", None)
        if locked is not None:
            return locked()
        if self._inner._is_owned():
            return True  # held by US — a try-acquire would just recurse
        if self._inner.acquire(blocking=False):
            self._inner.release()
            return False
        return True


class _InstrumentedCondition(threading.Condition):
    """``threading.Condition`` over its usual raw (R)Lock, with the
    enter/exit/wait surface instrumented at the condition level. The
    held-set entry is *suspended* across ``wait()`` — the lock really is
    released for the wait's duration, and modeling it as held would
    fabricate ordering edges from locks taken by other code while this
    thread sleeps."""

    def __init__(self, name: str, lock=None) -> None:
        super().__init__(lock)
        self.name = name
        # the base __init__ binds self.acquire/self.release as INSTANCE
        # attributes pointing straight at the raw lock; re-bind them to
        # the instrumented versions or explicit cv.acquire() calls would
        # bypass the detector entirely
        self.acquire = self._acquire_instrumented
        self.release = self._release_instrumented

    # with-statement / explicit acquire-release ------------------------

    def _acquire_instrumented(self, *args, **kwargs) -> bool:
        if _armed:
            _before_acquire(self.name, id(self))
        ok = self._lock.acquire(*args, **kwargs)
        if ok and _armed:
            _after_acquire(self.name, id(self))
        return ok

    def _release_instrumented(self) -> None:
        if _armed or getattr(_tls, "stack", None):
            _on_release(self.name, id(self))
        self._lock.release()

    def __enter__(self):
        self._acquire_instrumented()
        return self

    def __exit__(self, *exc) -> None:
        self._release_instrumented()

    # wait --------------------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> bool:
        suspended = None
        if _armed:
            st = _held()
            suspended = _find(st, id(self))
            if suspended is not None:
                st.remove(suspended)
        try:
            return super().wait(timeout)
        finally:
            if suspended is not None:
                # re-acquired: fresh hold clock (the wait was not a hold)
                suspended[2] = time.monotonic()
                _held().append(suspended)

    # wait_for() delegates to wait(); notify/notify_all need no hooks


# ------------------------------------------------------------- factory


def named_lock(name: str) -> _InstrumentedLock:
    """A ``threading.Lock`` analog carrying ``name`` in the detector's
    acquisition graph."""
    return _InstrumentedLock(name)


def named_rlock(name: str) -> _InstrumentedRLock:
    """Re-entrant variant; re-entry records no ordering edges."""
    return _InstrumentedRLock(name)


def named_condition(name: str, lock=None) -> _InstrumentedCondition:
    """A ``threading.Condition`` analog; ``wait()`` suspends the held
    entry so condition waits never fabricate ordering edges."""
    return _InstrumentedCondition(name, lock)
