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
and :func:`debug_events_payload`. Left out: the JSONL sink
(``TPUSLICE_EVENT_FILE`` and its rotation), the Kubernetes Event mirror
(``emit_pod_event``), runner-attached metrics holders
(``attach_metrics``/``detach_metrics``), ``Event.from_dict``,
``Journal.tail``/``clear``/``close`` and ``reset_journal``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from instaslice_tpu_torch.api.constants import EVENT_REASONS
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
        self.metrics.events.labels(component=component, reason=reason).inc()
        self.metrics.last_event_ts.labels(component=component).set(ev.ts)
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
