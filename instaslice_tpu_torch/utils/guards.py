"""Static guarded-by annotations for the port's slicecheck
(``instaslice_tpu_torch/analysis/slicecheck.py``).

The lockcheck factories (utils/lockcheck.py) give every lock a stable
dotted name; these markers tie *fields* to those names so the static
analyzer can prove every access happens under the right lock.  The
annotations are zero-cost at runtime: ``guarded_by``/``unguarded`` are
used in PEP 526 class-body annotations, which CPython stores only in
``__annotations__`` — no descriptor, no per-access overhead.

Usage::

    class Reconciler:
        _pending: guarded_by("controller.pending")
        _boot_id: unguarded("written once before threads start")

        def __init__(self):
            self._pending_lock = named_lock("controller.pending")
            self._pending = set()

    class Helper:
        @requires("controller.placement")
        def _lookup(self, key):  # caller must already hold the lock
            ...

slicecheck then reports any read/write of ``_pending`` outside a
``with self._pending_lock:`` block (or a ``@requires``-annotated
callee), in this class or any other module that touches the field.

``guards_of``/``requirement_of`` expose the declarations at runtime so
the ``/v1/debug/locks`` surface can cross-reference the static map
against lockcheck's live held-lock state during chaos triage.

A copy of ``instaslice_tpu/utils/guards.py``: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, TypeVar

F = TypeVar("F", bound=Callable[..., Any])

#: attribute stamped on @requires-decorated functions
_REQUIRES_ATTR = "__slicecheck_requires__"


class _GuardDecl:
    """Annotation value produced by :func:`guarded_by`/:func:`unguarded`.

    Instances are plain data — they exist so ``__annotations__`` carries
    the lock name for runtime introspection (``guards_of``)."""

    __slots__ = ("lock", "reason", "reads")

    def __init__(self, lock: Optional[str], reason: Optional[str],
                 reads: str = "locked") -> None:
        self.lock = lock
        self.reason = reason
        self.reads = reads

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        if self.lock is not None:
            return f"guarded_by({self.lock!r}, reads={self.reads!r})"
        return f"unguarded({self.reason!r})"


def guarded_by(lock_name: str, reads: str = "locked") -> _GuardDecl:
    """Declare that a field is only touched while holding ``lock_name``.

    ``lock_name`` must match a lockcheck factory registration
    (``named_lock("controller.pending")`` etc.); slicecheck rejects
    names with no factory site (rule ``guard-unknown-lock``).

    ``reads="racy"`` declares the atomic-flag discipline: every WRITE
    (and every read that feeds a write decision) holds the lock, but
    plain reads are deliberately lock-free — GIL-atomic snapshots whose
    staleness the reader re-checks under the lock before acting.
    slicecheck then verifies writes only."""
    if reads not in ("locked", "racy"):
        raise ValueError(f"reads must be 'locked' or 'racy', not {reads!r}")
    return _GuardDecl(lock_name, None, reads)


def unguarded(reason: str) -> _GuardDecl:
    """Declare that a field is deliberately lock-free, and why.

    For fields slicecheck's shared-state heuristic would otherwise
    flag: written once before threads start, monotonic flags read
    racily by design, GIL-atomic counters, etc.  The reason string is
    the justification — it shows up in ``--dump-guards`` output."""
    return _GuardDecl(None, reason)


def requires(lock_name: str) -> Callable[[F], F]:
    """Mark a helper whose *caller* must already hold ``lock_name``.

    slicecheck treats the decorated function's body as lock-held for
    fields guarded by ``lock_name``, and (transitively) checks that
    every call site sits inside a ``with`` on that lock or another
    ``@requires`` scope."""

    def deco(fn: F) -> F:
        held = set(getattr(fn, _REQUIRES_ATTR, ()))
        held.add(lock_name)
        setattr(fn, _REQUIRES_ATTR, frozenset(held))
        return fn

    return deco


def requirement_of(fn: Callable[..., Any]) -> frozenset:
    """Lock names a ``@requires``-decorated callable expects held."""
    inner = fn
    while isinstance(inner, functools.partial):  # pragma: no cover
        inner = inner.func
    return getattr(inner, _REQUIRES_ATTR, frozenset())


def guards_of(cls: type) -> Dict[str, Dict[str, Optional[str]]]:
    """Field → declaration map for ``cls`` (MRO-merged, subclass wins).

    Returns ``{field: {"lock": name-or-None, "reason": ...}}`` — the
    runtime view of the class's ``guarded_by``/``unguarded``
    annotations, for the debug surface."""
    out: Dict[str, Dict[str, Optional[str]]] = {}
    for klass in reversed(cls.__mro__):
        for field, ann in getattr(klass, "__annotations__", {}).items():
            if isinstance(ann, str):
                # PEP 563 (`from __future__ import annotations`) leaves
                # the declaration as source text — recover it
                try:
                    ann = eval(  # noqa: S307 - closed namespace
                        ann,
                        {"guarded_by": guarded_by,
                         "unguarded": unguarded, "__builtins__": {}},
                    )
                except Exception:  # slicelint: disable=broad-except
                    # not a guard declaration (an ordinary type
                    # annotation string) — skip, nothing to report
                    continue
            if isinstance(ann, _GuardDecl):
                out[field] = {"lock": ann.lock, "reason": ann.reason,
                              "reads": ann.reads}
    return out
