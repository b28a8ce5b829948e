"""Coalesced optimistic-concurrency writes: batch mutations per object.

The grant hot path writes the same per-node ``TpuSlice`` CR once per pod
(allocation insert, status transitions, fan-out repairs) — at fleet
scale that is one get→mutate→update round-trip *per pod per node*, and
under sharded reconcile workers the round-trips race each other into
Conflict retry storms on the busiest CRs. This module batches them: a
caller enqueues its mutation and blocks; the first caller to arrive for
an object becomes the committing leader, drains every mutation queued
for that object, applies them in arrival order inside ONE
``update_with_retry`` round-trip, and wakes all waiters with the result.
Conflicts are retried per batch (every mutation re-applies against the
fresh read — the same re-entrancy contract ``update_with_retry`` always
demanded of single mutations).

Semantics preserved per caller:

- ``apply`` returns the stored manifest when its mutation was applied,
  ``None`` when the mutation aborted (returned None) — exactly what
  ``update_with_retry`` returns for a lone mutation.
- Errors (NotFound, Fenced, exhausted Conflict) raise in every waiter of
  the failed batch.

A copy of ``instaslice_tpu/kube/coalesce.py`` (the port imports nothing
of the JAX package). The controller, which comes next, batches its CR
writes through it.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from instaslice_tpu_torch.kube.client import (
    _journal_fenced,
    stamp_writer_epoch,
    update_with_retry,
)
from instaslice_tpu_torch.utils.lockcheck import named_lock

log = logging.getLogger("instaslice_tpu_torch")


class _Op:
    __slots__ = ("mutate", "fence", "done", "applied", "fenced",
                 "result", "exc")

    def __init__(
        self,
        mutate: Callable[[dict], Optional[dict]],
        fence: Optional[Callable[[], bool]] = None,
    ) -> None:
        self.mutate = mutate
        self.fence = fence
        self.done = threading.Event()
        self.applied = False
        self.fenced = False
        self.result: Optional[dict] = None
        self.exc: Optional[BaseException] = None


class CoalescedWriter:
    """Per-object write batcher for one (kind, namespace)."""

    def __init__(
        self,
        client,
        kind: str,
        namespace: str,
        fence: Optional[Callable[[], bool]] = None,
        attempts: int = 8,
    ) -> None:
        self.client = client
        self.kind = kind
        self.namespace = namespace
        self.fence = fence
        self.attempts = attempts
        self._lock = named_lock("kube.coalesce")
        self._pending: Dict[str, List[_Op]] = {}
        self._committing: set = set()
        # observability: how many mutations rode a shared round-trip
        self.ops = 0
        self.commits = 0

    def apply(
        self,
        name: str,
        mutate: Callable[[dict], Optional[dict]],
        fence: Optional[Callable[[], bool]] = None,
    ) -> Optional[dict]:
        """Queue ``mutate`` for object ``name``; block until a batch
        containing it commits (or fails). Thread-safe; the calling
        thread may be elected to commit the batch.

        ``fence`` (default: the writer's constructor fence) is
        evaluated PER OP on every commit attempt, never assumed from
        the committing thread's identity: with per-shard leadership the
        committing leader may belong to a different shard, so each op
        must carry a fence bound to the enqueueing worker's own lease
        (``Manager.shard_is_leader(shard)``). A tripped fence raises
        :class:`~instaslice_tpu_torch.kube.client.Fenced` in that caller
        while the rest of the batch commits normally."""
        op = _Op(mutate, fence if fence is not None else self.fence)
        with self._lock:
            self.ops += 1
            self._pending.setdefault(name, []).append(op)
            leader = name not in self._committing
            if leader:
                self._committing.add(name)
        if leader:
            self._commit_loop(name)
        op.done.wait()
        if op.exc is not None:
            raise op.exc
        return op.result if op.applied else None

    def _commit_loop(self, name: str) -> None:
        while True:
            with self._lock:
                batch = self._pending.pop(name, None)
                if not batch:
                    self._committing.discard(name)
                    return
            self._commit(name, batch)

    def _commit(self, name: str, batch: List[_Op]) -> None:
        from instaslice_tpu_torch.kube.client import Fenced

        def combined(obj: dict) -> Optional[dict]:
            cur = obj
            any_applied = False
            for op in batch:
                op.applied = False  # conflict retry re-reads fresh state
                # per-op fencing, re-evaluated every attempt: the
                # committing thread may belong to a DIFFERENT shard
                # than the enqueuer, so the op's own fence (bound to
                # the enqueueing worker's lease) decides — never the
                # committing thread's identity
                op.fenced = op.fence is not None and not op.fence()
                if op.fenced:
                    continue
                out = op.mutate(cur)
                if out is not None:
                    cur = out
                    op.applied = True
                    any_applied = True
                    # epoch-stamp per applied op (last writer's epoch
                    # wins — they all hold live leases or they would
                    # have fenced above)
                    stamp_writer_epoch(cur, op.fence)
            return cur if any_applied else None

        try:
            stored = update_with_retry(
                self.client, self.kind, self.namespace, name, combined,
                attempts=self.attempts,
            )
        # not swallowed: the exception is re-raised in EVERY waiter's
        # apply() — the batch-wide fan-out of what a lone
        # update_with_retry would have raised
        except BaseException as e:  # slicelint: disable=broad-except
            for op in batch:
                op.exc = e
                op.done.set()
            return
        self.commits += 1
        for op in batch:
            if op.fenced:
                _journal_fenced(self.kind, self.namespace, name,
                                op.fence)
                op.exc = Fenced(
                    f"deposed: refusing {self.kind} "
                    f"{self.namespace}/{name}"
                )
            else:
                op.result = stored if op.applied else None
            op.done.set()
