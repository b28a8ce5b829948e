"""Lightweight structured tracing for the operator.

SURVEY.md §5: the reference has **no** tracing/profiling at all (no
OpenTelemetry/pprof anywhere in its go.mod). This module closes that gap
without external deps: every reconcile, device-layer operation, kube API
request, and serving-engine dispatch becomes a span in a thread-safe
in-memory ring (inspectable in tests, from the CLI, and over
``GET /v1/debug/trace``), optionally streamed as JSON lines to
``TPUSLICE_TRACE_FILE`` for offline analysis. Spans are cheap enough to
leave on in production — a monotonic clock read and a deque append per
span.

Spans form **traces**: every span carries a ``trace_id`` and a
``span_id``, and nesting is tracked per-thread via a contextvar — a span
opened inside another span becomes its child (same trace, ``parent_id``
set). A trace id minted at one plane's admission point (pod gating in
the controller, HTTP admission in the serving front-end) and threaded
through records (``AllocationDetails.trace_id``, the ``X-Trace-Id``
header) lets one request be followed controller → agent → device →
engine → response. Explicitly passing ``trace_id=`` re-roots a span into
that trace regardless of the ambient context (the cross-process
propagation hook); ``parent_id=`` links it under a specific span.

A copy of ``instaslice_tpu/utils/trace.py`` (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
import re
import threading
import time
import uuid
from collections import deque
from typing import Dict, Iterator, List, Optional
from instaslice_tpu_torch.utils.lockcheck import named_lock

#: the ONE accepted shape of an externally-supplied trace id — shared
#: by the serving plane's X-Trace-Id sanitizer and the metrics layer's
#: exemplar guard (exemplar labels have a 128-UTF-8-char OpenMetrics
#: budget; 64 chars of [A-Za-z0-9_.-] stays well inside it). Relaxing
#: the accepted shape means changing it HERE, so the two layers cannot
#: drift apart.
TRACE_ID_SAFE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


def new_trace_id() -> str:
    """Mint a fresh trace id (hex, 16 chars — W3C-trace-ids shortened)."""
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:8]


@dataclasses.dataclass
class Span:
    name: str                      # e.g. "controller.reconcile"
    start: float                   # unix seconds
    duration_ms: float
    attrs: Dict[str, str]
    error: str = ""
    trace_id: str = ""             # spans sharing it form one trace
    span_id: str = ""
    parent_id: str = ""            # "" = a trace root
    drop: bool = False             # set inside the block → not recorded

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "start": round(self.start, 6),
            "durationMs": round(self.duration_ms, 3),
            **({"error": self.error} if self.error else {}),
        }
        if self.trace_id:
            d["traceId"] = self.trace_id
        if self.span_id:
            d["spanId"] = self.span_id
        if self.parent_id:
            d["parentId"] = self.parent_id
        if self.attrs:
            d["attrs"] = self.attrs
        return d


#: the innermost open span on this thread/context (children inherit its
#: trace id and parent to it); contextvars keep it per-thread, so the
#: scheduler binding a request's trace never leaks into HTTP threads
_CURRENT: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "tpuslice_current_span", default=None
)


def current_span() -> Optional[Span]:
    return _CURRENT.get()


class Tracer:
    """Per-process tracer: bounded ring of finished spans + counters."""

    def __init__(self, capacity: int = 4096,
                 trace_file: Optional[str] = None) -> None:
        self._lock = named_lock("trace.ring")
        self._spans: deque = deque(maxlen=capacity)
        self._counts: Dict[str, int] = {}
        self._file = None
        # file writes get their own lock so a slow disk can't serialize
        # every reconcile thread behind the hot span-record lock; the
        # handle check AND the write both happen under it, so close()
        # can never yank the handle between them (and a write landing
        # after close is silently dropped, never an exception)
        self._file_lock = named_lock("trace.file")
        path = trace_file or os.environ.get("TPUSLICE_TRACE_FILE")
        if path:
            self._file = open(path, "a", buffering=1)

    @contextlib.contextmanager
    def span(self, name: str, trace_id: Optional[str] = None,
             parent_id: Optional[str] = None, **attrs) -> Iterator[Span]:
        """Record a span around the block. With no ``trace_id`` the span
        joins the ambient trace (the innermost open span on this thread)
        or roots a fresh one; an explicit ``trace_id`` re-roots it into
        that trace — parented to the ambient span only when the ambient
        span is in the SAME trace (a cross-trace parent link would make
        the child an orphan in its own trace). Setting ``span.drop``
        inside the block suppresses recording — for periodic retries
        that would otherwise flood the ring with identical spans."""
        cur = _CURRENT.get()
        if trace_id is None:
            tid = cur.trace_id if cur is not None else new_trace_id()
            pid = cur.span_id if cur is not None else ""
        else:
            tid = str(trace_id)
            pid = (cur.span_id
                   if cur is not None and cur.trace_id == tid else "")
        if parent_id is not None:
            pid = parent_id
        rec = Span(
            name=name,
            start=time.time(),
            duration_ms=0.0,
            attrs={k: str(v) for k, v in attrs.items()},
            trace_id=tid,
            span_id=new_span_id(),
            parent_id=pid,
        )
        token = _CURRENT.set(rec)
        t0 = time.monotonic()
        try:
            yield rec
        except BaseException as e:
            rec.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            _CURRENT.reset(token)
            rec.duration_ms = (time.monotonic() - t0) * 1e3
            if not rec.drop:
                self._record(rec)

    def record(self, name: str, duration_ms: float,
               trace_id: str = "", span_id: str = "",
               parent_id: str = "", start: Optional[float] = None,
               error: str = "", **attrs) -> Span:
        """Record an already-measured span (the cross-thread case: a
        serving request's lifecycle spans several threads, so its root
        span is assembled at completion rather than held open). With no
        explicit ``trace_id`` the span joins the ambient trace like
        :meth:`span` does — an event recorded inside an open span (a
        breaker trip inside a ``kube.request``) must land in THAT
        trace, not mint a disconnected single-span one."""
        if not trace_id:
            cur = _CURRENT.get()
            if cur is not None:
                trace_id = cur.trace_id
                if not parent_id:
                    parent_id = cur.span_id
        rec = Span(
            name=name,
            start=time.time() - duration_ms / 1e3 if start is None
            else start,
            duration_ms=duration_ms,
            attrs={k: str(v) for k, v in attrs.items()},
            error=error,
            trace_id=trace_id or new_trace_id(),
            span_id=span_id or new_span_id(),
            parent_id=parent_id,
        )
        self._record(rec)
        return rec

    def _record(self, rec: Span) -> None:
        with self._lock:
            self._spans.append(rec)
            self._counts[rec.name] = self._counts.get(rec.name, 0) + 1
            sink = self._file
        if sink is not None:
            line = json.dumps(rec.to_dict()) + "\n"
            with self._file_lock:
                if self._file is not None:
                    self._file.write(line)

    # ------------------------------------------------------------ querying

    def spans(self, name: Optional[str] = None,
              trace_id: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def trace(self, trace_id: str) -> List[Span]:
        """All ring spans of one trace, in start order."""
        return sorted(self.spans(trace_id=trace_id), key=lambda s: s.start)

    def slowest(self, n: int = 10, name: Optional[str] = None,
                roots_only: bool = False) -> List[Span]:
        """Top-``n`` spans by duration (``roots_only`` restricts to trace
        roots — 'the slowest traces')."""
        out = self.spans(name=name)
        if roots_only:
            out = [s for s in out if not s.parent_id]
        return sorted(out, key=lambda s: -s.duration_ms)[:n]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def summary(self) -> Dict[str, dict]:
        """Per-span-name count / p50 / p95 / max stats (for the CLI and
        the debug endpoint)."""
        by: Dict[str, List[float]] = {}
        for s in self.spans():
            by.setdefault(s.name, []).append(s.duration_ms)
        counts = self.counts()
        return summarize_durations(
            by, counts={n: counts.get(n) for n in by}
        )

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counts.clear()

    def close(self) -> None:
        """Close the trace-file handle. Idempotent, and safe against
        concurrent span completion: the span path re-checks the handle
        under the same lock, so a write racing close is dropped rather
        than hitting a closed file."""
        with self._file_lock:
            f, self._file = self._file, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass


def summarize_durations(
    by_name: Dict[str, List[float]],
    counts: Optional[Dict[str, Optional[int]]] = None,
) -> Dict[str, dict]:
    """Aggregate {span name → [durations ms]} into count/p50Ms/p95Ms/maxMs
    rows (shared by :meth:`Tracer.summary`, the serving debug endpoint,
    and the CLI's ``trace-summary``)."""
    out: Dict[str, dict] = {}
    for name in sorted(by_name):
        ds = sorted(by_name[name])
        count = None
        if counts is not None:
            count = counts.get(name)
        out[name] = {
            "count": count if count is not None else len(ds),
            "p50Ms": round(ds[len(ds) // 2], 3),
            "p95Ms": round(ds[min(len(ds) - 1, int(0.95 * len(ds)))], 3),
            "maxMs": round(ds[-1], 3),
        }
    return out


def debug_trace_payload(qs: Dict[str, list],
                        tracer: Optional["Tracer"] = None) -> dict:
    """Build the ``GET /v1/debug/trace`` response payload from parsed
    query-string lists — shared by the serving api_server, the router,
    and the operator probe servers so the debug surface cannot drift
    between planes. With no ``trace_id`` filter: per-span-name
    summaries, the slowest root spans, and the most recent spans
    (``n`` bounds both lists, default 20). With ``?trace_id=X``: every
    ring span of that trace in start order. Raises :class:`ValueError`
    on a malformed ``n`` (callers map to HTTP 400) and
    :class:`LookupError` when the requested trace has no ring spans
    (callers map to HTTP 404)."""
    t = tracer if tracer is not None else get_tracer()
    try:
        n = int((qs.get("n") or ["20"])[0])
        if n < 1:
            raise ValueError
    except ValueError:
        raise ValueError("n must be a positive integer") from None
    tid = (qs.get("trace_id") or [""])[0]
    if tid:
        spans = t.trace(tid)
        if not spans:
            raise LookupError(
                f"no spans for trace {tid!r} in the ring"
            )
        return {
            "traceId": tid,
            "spans": [s.to_dict() for s in spans],
        }
    return {
        "summary": t.summary(),
        "slowest": [
            s.to_dict() for s in t.slowest(n, roots_only=True)
        ],
        "recent": [s.to_dict() for s in t.spans()[-n:]],
    }


_default: Optional[Tracer] = None
_default_lock = named_lock("trace.default")


def get_tracer() -> Tracer:
    """Process-wide default tracer (created lazily)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Tracer()
        return _default


def reset_tracer(tracer: Optional[Tracer] = None) -> None:
    """Swap the process-wide default tracer (test isolation: a test that
    sets ``TPUSLICE_TRACE_FILE`` needs the default re-created so the env
    var is re-read, and the OLD default's file handle closed — otherwise
    every later test appends to the first test's temp file). The old
    default is closed; ``tracer=None`` lets the next :func:`get_tracer`
    lazily build a fresh one."""
    global _default
    with _default_lock:
        old, _default = _default, tracer
    if old is not None:
        old.close()
