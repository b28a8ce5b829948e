"""Client interface + error model + conflict-retry discipline.

The reference handles write races between controller and daemonset on one
CR with blind get-latest-then-``Update`` plus a 1 s requeue on conflict
(``instaslice_controller.go:93,201``; ``instaslice_daemonset.go:123,200``
— SURVEY.md §7 calls this out as a hard part). Here every reconciler
mutates shared objects through :func:`update_with_retry`, which re-reads
and re-applies the mutation on ``Conflict`` — bounded, jittered, and
tested under real concurrency in the fake.

A copy of ``instaslice_tpu/kube/client.py`` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

import abc
import random
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple


class ApiError(Exception):
    """Base for API errors; carries an HTTP-ish status code."""

    code = 500

    def __init__(self, message: str = ""):
        super().__init__(message or self.__class__.__name__)


class NotFound(ApiError):
    code = 404


class AlreadyExists(ApiError):
    code = 409


class Conflict(ApiError):
    """resourceVersion mismatch on update (optimistic concurrency)."""

    code = 409


class BadRequest(ApiError):
    code = 400


class Fenced(ApiError):
    """A write was refused because the caller's leadership fence reports
    it deposed. Raised by :func:`update_with_retry` when a ``fence``
    callable returns False — the deposed leader must not race the new
    leader's writes. (The residual window — an attempt already past the
    fence check when deposition lands — is closed by resourceVersion
    conflicts: a write based on a pre-deposition read conflicts if the
    new leader wrote first.)"""

    code = 409


class ResourceVersionExpired(ApiError):
    """410 Gone on a watch: the resume resourceVersion fell out of the API
    server's event window. The watcher must relist (replay=True, no
    resourceVersion) — resuming with the stale version would hot-loop.
    Raised by the real client; the fake's retained-log tail replay makes
    it unnecessary there."""

    code = 410


#: A watch event: ("ADDED" | "MODIFIED" | "DELETED", manifest-dict), or
#: ("BOOKMARK", {"metadata": {"resourceVersion": ...}}) — a metadata-only
#: resume-point marker emitted at the end of every establishment burst,
#: never an object event; consumers must skip it when reading object fields
WatchEvent = Tuple[str, dict]


class KubeClient(abc.ABC):
    """Minimal typed-dict client. ``kind`` is the manifest Kind string
    ("Pod", "Node", "ConfigMap", "TpuSlice"); objects are manifest-shaped
    dicts with ``metadata.name`` / ``metadata.namespace`` /
    ``metadata.resourceVersion``."""

    @abc.abstractmethod
    def create(self, kind: str, obj: dict) -> dict: ...

    @abc.abstractmethod
    def get(self, kind: str, namespace: str, name: str) -> dict: ...

    @abc.abstractmethod
    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[dict]: ...

    @abc.abstractmethod
    def update(self, kind: str, obj: dict) -> dict:
        """Replace; raises :class:`Conflict` if ``metadata.resourceVersion``
        does not match the stored object."""

    @abc.abstractmethod
    def patch(self, kind: str, namespace: str, name: str, patch: dict) -> dict:
        """Merge-patch (RFC 7386 semantics: dicts deep-merge, ``None``
        deletes a key, lists replace)."""

    @abc.abstractmethod
    def patch_status(
        self, kind: str, namespace: str, name: str, patch: dict
    ) -> dict:
        """Merge-patch restricted to the status subresource."""

    @abc.abstractmethod
    def delete(self, kind: str, namespace: str, name: str) -> None:
        """Finalizer-aware: sets ``deletionTimestamp`` if finalizers are
        present, removes the object otherwise."""

    @abc.abstractmethod
    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        replay: bool = True,
        timeout: Optional[float] = None,
        resource_version: Optional[str] = None,
    ) -> Iterator[WatchEvent]:
        """Stream events. ``replay=True`` first yields current objects as
        synthetic ADDED events (the informer list+watch pattern).
        ``resource_version`` resumes after that version instead: events
        newer than it are replayed so nothing emitted while the watch was
        down is lost; an implementation may fall back to a relist (plus
        whatever log tail it retains — possibly duplicated/reordered, so
        consumers must be level-triggered) when it can no longer resume
        exactly (the 410-Gone contract). ``replay=True`` combined with
        ``resource_version`` does both: relist AND replay events after the
        version (a resync that cannot lose deletions — a relist alone
        never shows objects deleted while the watch was down). The
        establishment burst ends with
        a ``("BOOKMARK", {"metadata": {"resourceVersion": ...}})`` event
        carrying only the current head version, for advancing the resume
        point; it is not an object event."""


def stamp_writer_epoch(obj: dict, fence) -> None:
    """Stamp the writer's lease epoch (``fence.epoch``, when the fence
    carries one — :class:`~instaslice_tpu_torch.utils.election.EpochFence`)
    onto the manifest about to be committed, so the CR records which
    leadership term landed the write. No-op for plain boolean fences
    and fences that never held a lease."""
    epoch = getattr(fence, "epoch", None)
    if epoch is None:
        return
    from instaslice_tpu_torch.api.constants import WRITER_EPOCH_ANNOTATION

    meta = obj.setdefault("metadata", {})
    ann = meta.get("annotations")
    if ann is None:
        ann = meta["annotations"] = {}
    ann[WRITER_EPOCH_ANNOTATION] = str(epoch)


def _journal_fenced(kind: str, namespace: str, name: str, fence) -> None:
    """A fence refused a commit: journal it (the nemesis invariant
    checker pairs these against the successor's epoch to prove the
    deposed writer landed nothing)."""
    from instaslice_tpu_torch.api.constants import REASON_WRITE_FENCED
    from instaslice_tpu_torch.obs.journal import get_journal

    epoch = getattr(fence, "epoch", None)
    get_journal().emit(
        "kube",
        reason=REASON_WRITE_FENCED,
        object_ref=f"{kind}/{namespace}/{name}",
        message=(
            f"stale writer refused (lease epoch "
            f"{'?' if epoch is None else epoch})"
        ),
    )


def update_with_retry(
    client: KubeClient,
    kind: str,
    namespace: str,
    name: str,
    mutate: Callable[[dict], Optional[dict]],
    attempts: int = 8,
    fence: Optional[Callable[[], bool]] = None,
) -> Optional[dict]:
    """Get-mutate-update with conflict retry.

    ``mutate`` receives the latest manifest and returns the mutated
    manifest (may be the same object) or ``None`` to abort (e.g. the state
    it wanted to change is already gone — makes reconcilers idempotent).
    Returns the stored result, or ``None`` if aborted.

    ``fence`` (optional) is re-checked before EVERY attempt, including
    conflict retries: a leader deposed mid-retry-loop raises
    :class:`Fenced` instead of landing a write after the new leader has
    acted (the election-handover race the reference inherits unguarded
    from controller-runtime's default non-fenced client). A fence
    carrying a lease ``.epoch`` (:class:`~instaslice_tpu_torch.utils.
    election.EpochFence`) additionally stamps the committed manifest
    with the writer's epoch, and refusals are journaled as
    ``WriteFenced`` so the nemesis invariant checker can prove a
    deposed partitioned leader never landed a write
    (docs/RECOVERY.md "Partitions & gray failures").
    """
    last: Optional[ApiError] = None
    for attempt in range(attempts):
        if fence is not None and not fence():
            _journal_fenced(kind, namespace, name, fence)
            raise Fenced(f"deposed: refusing {kind} {namespace}/{name}")
        obj = client.get(kind, namespace, name)
        mutated = mutate(obj)
        if mutated is None:
            return None
        stamp_writer_epoch(mutated, fence)
        try:
            return client.update(kind, mutated)
        except Conflict as e:
            last = e
            # Full jitter keeps N agents hammering one CR from lockstep.
            # full-jitter conflict backoff, <= ~80 ms total; a free
            # function has no stop event and the nap is too short to
            # stretch any shutdown
            time.sleep(  # slicelint: disable=sleep-in-loop
                random.uniform(0, 0.01 * (2**attempt)))
    raise last if last is not None else Conflict("update_with_retry exhausted")
