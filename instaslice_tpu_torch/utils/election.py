"""Lease-based leader election.

The reference leans on controller-runtime's election (ids
``7cbd68d5.codeflare.dev`` / ``7cbd68d6.codeflare.dev`` —
``cmd/*/main.go:98-120``); this is the same coordination.k8s.io/v1 Lease
protocol implemented directly: acquire when the lease is free or expired,
renew at a third of the lease duration, step down (callback) when a renew
cannot be pushed before expiry. Runs against both the fake kube and a real
API server (timestamps parse both ways).

A copy of ``instaslice_tpu/utils/election.py`` (the port imports nothing
of the JAX package).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Callable, Optional

from instaslice_tpu_torch.api.constants import LEASE_DURATION_MS_ANNOTATION
from instaslice_tpu_torch.kube.client import (
    AlreadyExists,
    ApiError,
    Conflict,
    KubeClient,
    NotFound,
)
from instaslice_tpu_torch.utils.lockcheck import named_lock
from instaslice_tpu_torch.utils.timeutil import parse_timestamp, rfc3339_now

log = logging.getLogger("instaslice_tpu_torch.election")


class LeaderElector:
    def __init__(
        self,
        client: KubeClient,
        namespace: str,
        name: str,
        identity: str,
        lease_seconds: float = 15.0,
        retry_seconds: float = 2.0,
    ) -> None:
        self.client = client
        self.namespace = namespace
        self.name = name
        self.identity = identity
        self.lease_seconds = lease_seconds
        self.retry_seconds = retry_seconds
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.is_leader = threading.Event()
        #: the Lease's ``leaseTransitions`` value this elector wrote
        #: when it (last) held the lease — the monotonically increasing
        #: **lease epoch** write fencing stamps and compares
        #: (docs/RECOVERY.md "Partitions & gray failures"); -1 = never
        #: held
        self.epoch = -1
        self._epoch_verified_at = 0.0
        self._epoch_lock = named_lock("election.epoch")

    # ----------------------------------------------------------- protocol

    # Annotation carrying the precise (possibly sub-second) duration:
    # ``spec.leaseDurationSeconds`` is an integer in the coordination.k8s.io
    # schema, so a 0.3 s lease would truncate to 0 and read back as
    # instantly-expired to every elector (ownership ping-pong). The integer
    # field stays schema-valid (>= 1) for real API servers; electors prefer
    # the annotation when present.
    DURATION_MS_ANNOTATION = LEASE_DURATION_MS_ANNOTATION

    def _manifest(self, transitions: int) -> dict:
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {
                "name": self.name,
                "namespace": self.namespace,
                "annotations": {
                    self.DURATION_MS_ANNOTATION: str(
                        int(self.lease_seconds * 1000)
                    ),
                },
            },
            "spec": {
                "holderIdentity": self.identity,
                "leaseDurationSeconds": max(
                    1, int(math.ceil(self.lease_seconds))
                ),
                "renewTime": rfc3339_now(),
                "leaseTransitions": transitions,
            },
        }

    def _remote_duration(self, lease: dict) -> float:
        """The holder's advertised lease duration, preferring the precise
        millisecond annotation over the integer spec field."""
        ann = (
            lease.get("metadata", {}).get("annotations") or {}
        ).get(self.DURATION_MS_ANNOTATION)
        if ann is not None:
            try:
                return float(ann) / 1000.0
            except (TypeError, ValueError):
                pass
        return float(
            lease.get("spec", {}).get(
                "leaseDurationSeconds", self.lease_seconds
            )
        )

    def _note_acquired(self, transitions: int) -> None:
        """Record a successful acquire/renew: the transitions value we
        just wrote IS our epoch, and the write itself proves we held
        the lease at this instant (fence verification freshness)."""
        with self._epoch_lock:
            self.epoch = transitions
            self._epoch_verified_at = time.monotonic()

    def _try_acquire_or_renew(self) -> bool:
        try:
            lease = self.client.get("Lease", self.namespace, self.name)
        except NotFound:
            try:
                self.client.create(
                    "Lease", self._manifest(transitions=0)
                )
                self._note_acquired(0)
                return True
            except (AlreadyExists, Conflict):
                return False
        spec = lease.get("spec", {})
        holder = spec.get("holderIdentity", "")
        renew = parse_timestamp(spec.get("renewTime"))
        duration = self._remote_duration(lease)
        expired = time.time() - renew > duration
        if holder != self.identity and not expired:
            return False
        transitions = int(spec.get("leaseTransitions", 0))
        if holder != self.identity:
            transitions += 1
        new = self._manifest(transitions)
        new["metadata"]["resourceVersion"] = lease.get("metadata", {}).get(
            "resourceVersion", ""
        )
        try:
            self.client.update("Lease", new)
            self._note_acquired(transitions)
            return True
        except (Conflict, NotFound):
            return False

    # -------------------------------------------------------- epoch fence

    def verify_epoch(self, max_age: Optional[float] = None) -> bool:
        """True iff this elector verifiably still holds the lease at
        the epoch it acquired. Renewals refresh the verification for
        free (each successful renew read+wrote the lease); when the
        last proof is older than ``max_age`` (default lease/3) the
        lease is re-read. Any failure to *prove* leadership —
        transport down, holder changed, transitions bumped — returns
        False: a partitioned writer must refuse, not race, its
        successor (docs/RECOVERY.md "Partitions & gray failures")."""
        if max_age is None:
            max_age = max(0.05, self.lease_seconds / 3.0)
        with self._epoch_lock:
            epoch = self.epoch
            fresh = (
                time.monotonic() - self._epoch_verified_at <= max_age
            )
        if epoch < 0:
            return False
        if fresh:
            return True
        try:
            lease = self.client.get("Lease", self.namespace, self.name)
        except (ApiError, ConnectionError, TimeoutError, OSError) as e:
            log.warning("%s: cannot verify lease epoch for %s/%s: %s",
                        self.identity, self.namespace, self.name, e)
            return False
        spec = lease.get("spec", {})
        ok = (
            spec.get("holderIdentity") == self.identity
            and int(spec.get("leaseTransitions", 0)) == epoch
        )
        if ok:
            with self._epoch_lock:
                if self.epoch == epoch:
                    self._epoch_verified_at = time.monotonic()
        return ok

    # ------------------------------------------------------------- public

    def acquire(self, stop: Optional[threading.Event] = None) -> bool:
        """Block until leadership is held (True) or ``stop`` fires
        (False)."""
        while not (stop and stop.is_set()) and not self._stop.is_set():
            try:
                if self._try_acquire_or_renew():
                    self.is_leader.set()
                    log.info("%s: acquired lease %s/%s", self.identity,
                             self.namespace, self.name)
                    return True
            except ApiError as e:
                log.warning("lease acquire error: %s", e)
            waiter = stop or self._stop
            if waiter.wait(self.retry_seconds):
                break
        return False

    def start_renewing(self, on_lost: Callable[[], None]) -> None:
        """Background renewal at lease/3; calls ``on_lost`` (once) if the
        lease cannot be renewed before expiry."""

        def loop():
            interval = max(0.05, self.lease_seconds / 3.0)
            deadline = time.time() + self.lease_seconds
            while not self._stop.wait(interval):
                try:
                    ok = self._try_acquire_or_renew()
                except ApiError:
                    ok = False
                if ok:
                    deadline = time.time() + self.lease_seconds
                elif time.time() > deadline:
                    log.error("%s: lost lease %s/%s", self.identity,
                              self.namespace, self.name)
                    self.is_leader.clear()
                    on_lost()
                    return

        self._thread = threading.Thread(
            target=loop, name="leader-renew", daemon=True
        )
        self._thread.start()

    def release(self) -> None:
        """Stop renewing and give the lease up if we still hold it."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if not self.is_leader.is_set():
            return
        try:
            lease = self.client.get("Lease", self.namespace, self.name)
            if lease.get("spec", {}).get("holderIdentity") == self.identity:
                lease["spec"]["holderIdentity"] = ""
                lease["spec"]["renewTime"] = None
                self.client.update("Lease", lease)
        except ApiError:
            pass
        self.is_leader.clear()


class EpochFence:
    """Callable write fence bound to an elector's **lease epoch**.

    ``update_with_retry`` / :class:`~instaslice_tpu_torch.kube.coalesce.
    CoalescedWriter` call the fence before every commit attempt and
    read ``.epoch`` to stamp the committed manifest
    (``WRITER_EPOCH_ANNOTATION``). The fence is open only while the
    elector verifiably holds its lease *at the epoch it acquired* —
    a deposed, partitioned leader whose successor bumped
    ``leaseTransitions`` gets False (→ :class:`~instaslice_tpu_torch.kube.
    client.Fenced`), never a racing write.

    ``get_elector`` is a zero-arg callable returning the (possibly
    not-yet-constructed) elector — None means election is off and the
    fence stays open. ``check`` is an optional extra local predicate
    ANDed in (e.g. a manager's shard-leadership bit)."""

    def __init__(self, get_elector, check=None) -> None:
        self._get_elector = get_elector
        self._check = check

    @property
    def epoch(self) -> Optional[int]:
        el = self._get_elector()
        if el is None or el.epoch < 0:
            return None
        return el.epoch

    def __call__(self) -> bool:
        if self._check is not None and not self._check():
            return False
        el = self._get_elector()
        if el is None:
            return True
        return el.is_leader.is_set() and el.verify_epoch()
