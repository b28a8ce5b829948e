"""Flight recorder: a durable, queryable record of what the serving
plane decided and why.

Traces say how long things took and metrics how often; this module is
the third observability pillar — *what happened*: every serving
drain/shed, preemption, resume and SLO miss becomes a structured
:class:`Event` with a monotonic ``seq``, an injected wall clock, the
emitting ``component``, a ``reason`` constant from
:mod:`instaslice_tpu_torch.api.constants` (the ONE reason catalog), an
object reference, a human message, and the ``trace_id`` linking it into
the request's trace.

Events land in two places:

- a bounded in-memory ring (queryable from tests and the serving
  plane's ``GET /v1/debug/events``, :func:`debug_events_payload`);
- ``tpuslice_events_total{component,reason}`` counters (+ a
  last-event-timestamp gauge) on :class:`~instaslice_tpu_torch.metrics.
  metrics.EventMetrics`.

Emission is thread-safe via the lockcheck factory and must never hurt
the serving plane: an unknown reason logs one warning (it still
records) — the journal observes the serving loop, it never wedges it.

A copy of ``instaslice_tpu/obs/journal.py`` (the port imports nothing
of the JAX package), trimmed to what the port's server uses:
:class:`Journal` (``emit``, ``events``, ``counts``), :func:`get_journal`
and :func:`debug_events_payload`, the Kubernetes Event mirror of the
node agent's pod-scoped decisions (:func:`emit_pod_event`) and the
runner-attached metrics holders (:func:`attach_metrics`/
:func:`detach_metrics`). Left out: the JSONL sink
(``TPUSLICE_EVENT_FILE`` and its rotation), ``Event.from_dict``,
``Journal.tail``/``clear``/``close`` and ``reset_journal``.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import time
import uuid
from collections import deque
from typing import Callable, Dict, List, Optional

from instaslice_tpu_torch.api.constants import (
    EVENT_REASONS,
    TRACE_ID_ANNOTATION,
)
from instaslice_tpu_torch.utils.lockcheck import named_lock

log = logging.getLogger("instaslice_tpu_torch.obs")

_warned_reasons: set = set()


def _warn_unknown_reason(reason: str) -> None:
    """One warning per unknown reason, not a raise: a typo'd reason must
    show up loudly in the log (and fail ``make events-check``), but an
    event emit can never be allowed to wedge a reconcile."""
    if reason not in _warned_reasons:
        _warned_reasons.add(reason)
        log.warning(
            "journal event reason %r is not in the "
            "instaslice_tpu_torch.api.constants catalog — add it there "
            "(docs/OBSERVABILITY.md reason catalog)", reason,
        )


@dataclasses.dataclass
class Event:
    """One flight-recorder record."""

    seq: int                       # journal-wide monotonic
    ts: float                      # unix seconds (journal's clock)
    component: str                 # "controller" | "agent-<node>" | ...
    reason: str                    # constant from api/constants.py
    object_ref: str = ""           # "Pod/<ns>/<name>" | "alloc/<id>" | ...
    message: str = ""
    trace_id: str = ""             # links into the request's trace
    attrs: Dict[str, str] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {
            "seq": self.seq,
            "ts": round(self.ts, 6),
            "component": self.component,
            "reason": self.reason,
        }
        if self.object_ref:
            d["objectRef"] = self.object_ref
        if self.message:
            d["message"] = self.message
        if self.trace_id:
            d["traceId"] = self.trace_id
        if self.attrs:
            d["attrs"] = self.attrs
        return d

class Journal:
    """Bounded ring of events + metrics counters.

    ``clock`` is injectable (tests pin timestamps). ``metrics`` is any
    holder with ``events``/``last_event_ts`` (an
    :class:`~instaslice_tpu_torch.metrics.metrics.EventMetrics`); one with
    its own registry is created lazily when omitted."""

    def __init__(self, capacity: int = 4096,
                 clock: Optional[Callable[[], float]] = None,
                 metrics=None) -> None:
        self._lock = named_lock("journal.ring")
        self._events: deque = deque(maxlen=capacity)
        self._counts: Dict[str, int] = {}
        self._seq = 0
        self.clock: Callable[[], float] = clock or time.time
        if metrics is None:
            from instaslice_tpu_torch.metrics.metrics import EventMetrics

            metrics = EventMetrics()
        self.metrics = metrics

    # ------------------------------------------------------------ emission

    def emit(self, component: str, *, reason: str, object_ref: str = "",
             message: str = "", trace_id: str = "", **attrs) -> Event:
        """Record one event. ``reason`` is keyword-only and must come
        from the api/constants.py catalog (slicelint enforces the call
        sites; unknown reasons warn once and still record)."""
        if reason not in EVENT_REASONS:
            _warn_unknown_reason(reason)
        with self._lock:
            self._seq += 1
            ev = Event(
                seq=self._seq,
                ts=self.clock(),
                component=component,
                reason=reason,
                object_ref=object_ref,
                message=message,
                trace_id=trace_id,
                attrs={k: str(v) for k, v in attrs.items()},
            )
            self._events.append(ev)
            self._counts[reason] = self._counts.get(reason, 0) + 1
        for m in [self.metrics] + attached_metrics():
            m.events.labels(component=component, reason=reason).inc()
            m.last_event_ts.labels(component=component).set(ev.ts)
        return ev

    # ------------------------------------------------------------ querying

    def events(self, reason: Optional[str] = None,
               object_ref: Optional[str] = None,
               trace_id: Optional[str] = None,
               component: Optional[str] = None,
               since_seq: Optional[int] = None) -> List[Event]:
        with self._lock:
            out = list(self._events)
        if reason is not None:
            out = [e for e in out if e.reason == reason]
        if object_ref is not None:
            out = [e for e in out if e.object_ref == object_ref]
        if trace_id is not None:
            out = [e for e in out if e.trace_id == trace_id]
        if component is not None:
            out = [e for e in out if e.component == component]
        if since_seq is not None:
            out = [e for e in out if e.seq > since_seq]
        return out

    def counts(self) -> Dict[str, int]:
        """Per-reason totals since construction (not ring-bounded)."""
        with self._lock:
            return dict(self._counts)


#: Runner-attached metrics holders, MODULE-level so they follow the
#: process rather than one Journal instance: reset_journal() (test
#: isolation / env rebinding) swaps the default journal, and a runner's
#: /metrics counters must keep counting on the new one — the same
#: resolve-per-use hazard utils/reconcile.py documents for tracers.
_attached_metrics: List = []
_attach_lock = named_lock("journal.attach")


def attach_metrics(holder) -> None:
    """Count every journal emit (any instance, across resets) on
    ``holder`` too — an ``EventMetrics`` bound to a runner's /metrics
    registry. Attach, not replace: a process hosting both a controller
    and an agent runner keeps ``tpuslice_events_total`` on BOTH scrape
    registries. Counts start at attach time; detach on shutdown."""
    with _attach_lock:
        _attached_metrics.append(holder)


def detach_metrics(holder) -> None:
    """Undo :func:`attach_metrics` (runner shutdown). Without the
    detach, re-created runners (leader-election churn, test sessions)
    would accumulate dead registries that every later emit still pays
    to increment."""
    with _attach_lock:
        if holder in _attached_metrics:
            _attached_metrics.remove(holder)


def attached_metrics() -> List:
    with _attach_lock:
        return list(_attached_metrics)


_default: Optional[Journal] = None
_default_lock = named_lock("journal.default")


def get_journal() -> Journal:
    """Process-wide default journal (created lazily)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Journal()
        return _default


# ------------------------------------------------------- debug endpoint


# --------------------------------------------------- kubernetes mirroring


def _rfc3339(ts: float) -> str:
    return (
        datetime.datetime.fromtimestamp(ts, datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%S.%f") + "Z"
    )


def emit_pod_event(client, namespace: str, pod_name: str, *, reason: str,
                   message: str, component: str, pod_uid: str = "",
                   trace_id: str = "", event_type: str = "Normal",
                   journal: Optional[Journal] = None, **attrs) -> Event:
    """Journal a pod-scoped decision AND mirror it as a Kubernetes
    ``Event`` on the pod (fake and real clients both route the ``Event``
    kind), so ``kubectl describe pod`` explains the wait. The mirror is
    best-effort: an API failure is logged and dropped — an event write
    must never wedge the reconcile that emitted it.

    The mirror is deliberately synchronous (callers and tests observe
    the Event immediately; no queue/thread lifecycle to manage). Under
    a degraded API server the real client's retry backoff makes the
    first few mirrors slow, but its circuit breaker then fails the rest
    fast (CircuitOpen) until the server recovers — the stall is bounded
    and the events are dropped, not queued into a thundering herd."""
    j = journal or get_journal()
    ev = j.emit(
        component, reason=reason,
        object_ref=f"Pod/{namespace}/{pod_name}",
        message=message, trace_id=trace_id, **attrs,
    )
    manifest = {
        "apiVersion": "v1",
        "kind": "Event",
        "metadata": {
            "name": f"{pod_name}.{uuid.uuid4().hex[:12]}",
            "namespace": namespace,
            **({"annotations": {TRACE_ID_ANNOTATION: trace_id}}
               if trace_id else {}),
        },
        "involvedObject": {
            "kind": "Pod",
            "namespace": namespace,
            "name": pod_name,
            **({"uid": pod_uid} if pod_uid else {}),
        },
        "reason": reason,
        "message": message[:1024],
        "type": event_type,
        "source": {"component": component},
        "firstTimestamp": _rfc3339(ev.ts),
        "lastTimestamp": _rfc3339(ev.ts),
        "count": 1,
    }
    try:
        client.create("Event", manifest)
    except Exception:
        # best-effort by contract (injected kube faults land here too)
        log.debug("failed to mirror %s event for pod %s/%s",
                  reason, namespace, pod_name, exc_info=True)
    return ev


# ------------------------------------------------------- debug endpoint


def debug_events_payload(qs: Dict[str, List[str]],
                         journal: Optional[Journal] = None) -> dict:
    """The ``GET /v1/debug/events`` handler body (serving/api_server.py).
    ``qs`` is a ``urllib.parse.parse_qs`` dict; supported filters:
    ``reason``, ``object``, ``trace_id``, ``component``, ``since_seq``;
    ``n`` bounds the returned tail (default 100). Raises ValueError on
    malformed numbers (callers answer 400)."""
    j = journal or get_journal()

    def one(key: str) -> Optional[str]:
        val = (qs.get(key) or [""])[0]
        return val or None

    n = int((qs.get("n") or ["100"])[0])
    if n < 1:
        raise ValueError("n must be a positive integer")
    since = qs.get("since_seq")
    since_seq = int(since[0]) if since else None
    evs = j.events(
        reason=one("reason"), object_ref=one("object"),
        trace_id=one("trace_id"), component=one("component"),
        since_seq=since_seq,
    )
    return {
        "total": len(evs),
        "counts": j.counts(),
        "events": [e.to_dict() for e in evs[-n:]],
    }
