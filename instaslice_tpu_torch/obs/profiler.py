"""Continuous performance profiler for the serving plane.

The fleet telemetry plane (obs/telemetry.py) answers *what* is slow —
goodput, SLO burn, chip-hours. This module answers **where the
milliseconds go**: every scheduler round decomposes into named segments
(admission / resume / preempt / prefill / dispatch / readback / host
bookkeeping) recorded as one bounded-ring :class:`RoundRecord`, and the
engine's dispatch seam emits timeline events (dispatch start, readback
landing, mid-traffic kernel builds) into a second ring. The serving
plane's ``GET /v1/debug/profile`` reads them
(:func:`debug_profile_payload`): armed state, per-segment p50/p95
summaries, the most recent round records and timeline events, or with
``?rid=`` one request's latency waterfall (:func:`waterfall_payload`:
queue → admission → prefill → decode rounds → (preempt / park /
resume) → finish, stitched from round records + journal events +
trace spans by rid / trace id).

Arming: ``TPUSLICE_PROFILE=1`` in the environment, ``--profile`` on
the server, or :meth:`Profiler.arm`. Disarmed, the hot path is
a single attribute check and a shared no-op timer (the scheduler's
``with pt.seg(...)`` blocks enter a reusable ``nullcontext``) — cheap
enough to leave compiled in everywhere. Armed, a round costs two
monotonic clock reads per segment plus one deque append; the
``profile-smoke`` gate asserts the armed serving path keeps >= 95%
of the unprofiled arm's tok/s. Knobs: ``TPUSLICE_PROFILE`` (arm),
``TPUSLICE_PROFILE_RING`` (ring capacity, default 4096),
``TPUSLICE_COMPILE_GRACE`` (seconds of traffic during which compile
deltas re-baseline silently — lazily-compiled first-dispatch programs
are startup, not the mid-run compile bug CompileObserved announces).

Compile attribution: :class:`CompileWatch` snapshots the engine's
loaded kernel libraries (``engine.compiled_programs()``) and the
process-wide compile wall-clock accumulator (fed by the port's nvcc
builds). Any growth
observed after the traffic grace window is a **mid-traffic compile**
— the scheduler journals it as ``CompileObserved`` with the program
name, the dispatch shape key, and the accumulated compile wall ms, so
the "cold mid-run compile polluted p95" class of bug self-announces
instead of requiring archaeology (docs/OBSERVABILITY.md "Profiling").

A copy of ``instaslice_tpu/obs/profiler.py`` (the port imports nothing
of the JAX package), trimmed to what the port's server uses: left out
are the Chrome trace export (``chrome_trace``, read by the reference's
CLI), ``reset_profiler`` and ``Profiler.disarm``/``clear``. The compile watch listens on the port's kernel
builds (``instaslice_tpu_torch.ops.build``) where the reference listens
on ``jax.monitoring``: an nvcc build or library load after the warm
window is the port's mid-traffic compile.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from instaslice_tpu_torch.api.constants import (
    REASON_DRAINED,
    REASON_SESSION_EXPORTED,
    REASON_SHED,
)
from instaslice_tpu_torch.utils.lockcheck import named_lock
from instaslice_tpu_torch.utils.trace import get_tracer, summarize_durations

#: the round-record segment vocabulary (docs/OBSERVABILITY.md
#: "Profiling" documents each): everything a scheduler round spends
#: time on lands in exactly one of these.
SEGMENTS = (
    "admission",   # admission pass: ordering, cost model, burst build
    "resume",      # un-parking preempted requests into freed slots
    "preempt",     # SLO preemption + block-pressure relief
    "prefill",     # engine prefill dispatch inside an admission
    "dispatch",    # decode/spec dispatch (host->device enqueue)
    "readback",    # blocking on the device->host token copy
    "host",        # everything else: pumps, sweeps, delivery, gauges
)


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in (
        "1", "true", "yes", "on"
    )


# ------------------------------------------------- compile wall clock

#: process-wide compile wall-ms accumulator, fed by the port's kernel
#: builds (``ops/build.py`` reports every nvcc build with its wall time)
_compile_lock = named_lock("profile.compile")
_compile_ms = 0.0
_listener_installed = False


def _on_build(name: str, seconds: float) -> None:
    global _compile_ms
    try:
        with _compile_lock:
            _compile_ms += float(seconds) * 1e3
    except Exception:  # noqa: BLE001  # slicelint: disable=broad-except
        pass           # monitoring must never break a dispatch


def install_compile_listener() -> None:
    """Register the kernel-build listener with ``ops/build.py``
    (idempotent). Called by :class:`CompileWatch`."""
    global _listener_installed
    with _compile_lock:
        if _listener_installed:
            return
        _listener_installed = True
    from instaslice_tpu_torch.ops import build

    build.add_build_listener(_on_build)


def compile_wall_ms() -> float:
    """Total kernel-build wall ms this process has spent."""
    with _compile_lock:
        return _compile_ms


class CompileWatch:
    """Detect kernel builds and loads that land outside the warm window.

    Snapshot ``engine.compiled_programs()`` at construction (the warm_*
    window: warm_prefill_buckets / warm_spec_programs and everything
    else that compiles before traffic). :meth:`mark_traffic` re-baselines
    at the first admission; :meth:`check` then reports any cache growth
    as mid-traffic compiles — except inside the ``grace`` window after
    traffic starts, where growth re-baselines silently (first-dispatch
    lazy compiles are startup cost, not the mid-run bug)."""

    def __init__(self, engine, grace: Optional[float] = None) -> None:
        self._engine = engine
        if grace is None:
            grace = float(os.environ.get(
                "TPUSLICE_COMPILE_GRACE", "5.0") or 5.0)
        self.grace = grace
        self.in_traffic = False
        self._traffic_t0 = 0.0
        self._counts = self._snapshot()
        self._wall = compile_wall_ms()
        install_compile_listener()

    def _snapshot(self) -> Dict[str, int]:
        try:
            return dict(self._engine.compiled_programs())
        except Exception:  # noqa: BLE001  # slicelint: disable=broad-except
            return {}

    def mark_traffic(self) -> None:
        """First admission: the warm window is over. Everything
        compiled so far belongs to it; re-baseline."""
        if not self.in_traffic:
            self.in_traffic = True
            self._traffic_t0 = time.monotonic()
            self._counts = self._snapshot()
            self._wall = compile_wall_ms()

    def check(self) -> List[dict]:
        """Compile-cache growth since the last check (after traffic
        started and past the grace window). Each entry:
        ``{"program", "count", "wall_ms"}``."""
        if not self.in_traffic:
            return []
        now = self._snapshot()
        if now == self._counts:
            return []
        wall = compile_wall_ms()
        out: List[dict] = []
        if time.monotonic() - self._traffic_t0 >= self.grace:
            for prog, n in sorted(now.items()):
                prev = self._counts.get(prog, 0)
                if n > prev:
                    out.append({
                        "program": prog,
                        "count": n - prev,
                        "wall_ms": round(max(0.0, wall - self._wall), 3),
                    })
        self._counts = now
        self._wall = wall
        return out


# ------------------------------------------------------- round timing


class RoundTimer:
    """Accumulates one scheduler round's segment timeline. Created via
    :meth:`Profiler.round_timer`; the scheduler wraps each phase in
    ``with pt.seg(name):`` and hands the timer back through
    :meth:`Profiler.finish_round`. All clocks are ``time.monotonic()``
    so engine-side landing stamps (``last_dispatch_landed``) can be
    spliced in via :meth:`add` without epoch mixing."""

    __slots__ = ("t0", "wall0", "segs", "meta", "_open")

    def __init__(self) -> None:
        self.t0 = time.monotonic()
        self.wall0 = time.time()
        self.segs: List[Tuple[str, float, float]] = []
        self.meta: Dict[str, object] = {}
        #: open-segment stack: [start, nested_elapsed_s] frames. segs
        #: may nest (prefill inside the admission pass); each instant
        #: must land in exactly ONE segment, so an enclosing segment
        #: records its wall MINUS everything nested inside it — that
        #: keeps sum(segs) <= round wall, the ledger invariant the
        #: reconciliation tests assert.
        self._open: List[List[float]] = []

    @contextlib.contextmanager
    def seg(self, name: str):
        s = time.monotonic()
        frame = [s, 0.0]
        self._open.append(frame)
        try:
            yield
        finally:
            e = time.monotonic()
            self._open.pop()
            if self._open:
                self._open[-1][1] += e - s
            dur = (e - s) - frame[1]
            if dur > 0:
                self.segs.append((
                    name,
                    round((s - self.t0) * 1e3, 3),
                    round(dur * 1e3, 3),
                ))

    def add(self, name: str, start: float, dur_s: float) -> None:
        """Record an externally-measured segment (``start`` is a
        ``time.monotonic()`` stamp, ``dur_s`` seconds)."""
        if dur_s <= 0:
            return
        self.segs.append((
            name,
            round((start - self.t0) * 1e3, 3),
            round(dur_s * 1e3, 3),
        ))

    def note(self, **meta) -> None:
        self.meta.update(meta)

    def bump(self, key: str, n: int = 1) -> None:
        self.meta[key] = int(self.meta.get(key, 0)) + n


class _NoopRoundTimer:
    """Shared disarmed timer: every method is a constant-time no-op
    and ``seg`` hands back one reusable nullcontext."""

    __slots__ = ()
    _null = contextlib.nullcontext()

    def seg(self, name: str):
        return self._null

    def add(self, name: str, start: float, dur_s: float) -> None:
        pass

    def note(self, **meta) -> None:
        pass

    def bump(self, key: str, n: int = 1) -> None:
        pass


NOOP_TIMER = _NoopRoundTimer()


@dataclasses.dataclass
class RoundRecord:
    """One scheduler round's anatomy: wall time, per-segment timeline
    (name, start offset ms, duration ms), and the round metadata the
    scheduler noted (phase, batch, n_steps, k, rids, trace ids,
    admitted/resumed/preempted counts, blocks free)."""

    idx: int                 # profiler-wide monotonic round number
    ts: float                # unix seconds at round start
    wall_ms: float
    phase: str               # "decode" | "spec"
    segs: Tuple[Tuple[str, float, float], ...]
    meta: Dict[str, object]

    def seg_totals(self) -> Dict[str, float]:
        """Per-segment summed ms (a segment name can appear several
        times in one round — e.g. split host work)."""
        out: Dict[str, float] = {}
        for name, _start, dur in self.segs:
            out[name] = round(out.get(name, 0.0) + dur, 3)
        return out

    def to_dict(self) -> dict:
        return {
            "idx": self.idx,
            "ts": round(self.ts, 6),
            "wallMs": round(self.wall_ms, 3),
            "phase": self.phase,
            "segs": [[n, s, d] for n, s, d in self.segs],
            "meta": dict(self.meta),
        }


# ------------------------------------------------------------ profiler


class Profiler:
    """Bounded rings of round records and timeline events + an armed
    flag. One per process by default (:func:`get_profiler`), created
    armed when ``TPUSLICE_PROFILE`` is set."""

    def __init__(self, capacity: Optional[int] = None,
                 armed: Optional[bool] = None) -> None:
        if capacity is None:
            try:
                capacity = int(os.environ.get(
                    "TPUSLICE_PROFILE_RING", "4096") or 4096)
            except ValueError:
                capacity = 4096
        capacity = max(16, capacity)
        self._lock = named_lock("profile.ring")
        self._rounds: deque = deque(maxlen=capacity)
        self._events: deque = deque(maxlen=capacity)
        self.rounds_recorded = 0
        self.events_recorded = 0
        if armed is None:
            armed = _env_flag("TPUSLICE_PROFILE")
        #: plain bool read on the hot path (GIL-atomic); flipped by
        #: arm()/disarm() — mid-flight timers of the old state record
        #: or drop harmlessly
        self.armed = bool(armed)

    def arm(self) -> None:
        self.armed = True

    # -------------------------------------------------------- recording

    def round_timer(self):
        """A fresh :class:`RoundTimer` when armed, the shared no-op
        otherwise — the scheduler never branches on armed itself."""
        return RoundTimer() if self.armed else NOOP_TIMER

    def finish_round(self, timer, phase: str = "",
                     **meta) -> Optional[RoundRecord]:
        """Close a round timer into a ring record. No-op (returns
        None) for the disarmed shared timer."""
        if timer is NOOP_TIMER or not isinstance(timer, RoundTimer):
            return None
        wall_ms = (time.monotonic() - timer.t0) * 1e3
        m = dict(timer.meta)
        m.update(meta)
        with self._lock:
            self.rounds_recorded += 1
            rec = RoundRecord(
                idx=self.rounds_recorded, ts=timer.wall0,
                wall_ms=round(wall_ms, 3), phase=str(phase),
                segs=tuple(timer.segs), meta=m,
            )
            self._rounds.append(rec)
        return rec

    def event(self, kind: str, name: str, dur_ms: float = 0.0,
              ts: Optional[float] = None, **attrs) -> None:
        """Append one timeline event (dispatch / readback / compile /
        proxy / migrate lanes). Constant-time no-op while disarmed."""
        if not self.armed:
            return
        ev = {
            "ts": round(time.time() if ts is None else ts, 6),
            "kind": str(kind),
            "name": str(name),
            "durMs": round(float(dur_ms), 3),
            "attrs": {k: str(v) for k, v in attrs.items()},
        }
        with self._lock:
            self.events_recorded += 1
            self._events.append(ev)

    # --------------------------------------------------------- querying

    def rounds(self, n: Optional[int] = None) -> List[RoundRecord]:
        with self._lock:
            out = list(self._rounds)
        return out[-n:] if n else out

    def events(self, n: Optional[int] = None,
               kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            out = list(self._events)
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        return out[-n:] if n else out

    def segment_summary(self) -> Dict[str, dict]:
        """Per-segment count/p50/p95/max over the ring's round records
        (per-round summed ms per segment), plus a ``round`` row for
        whole-round wall time — the ``GET /v1/debug/profile`` summary
        and the bench's per-arm profile artifact."""
        by: Dict[str, List[float]] = {}
        for rec in self.rounds():
            for name, dur in rec.seg_totals().items():
                by.setdefault(name, []).append(dur)
            by.setdefault("round", []).append(rec.wall_ms)
        return summarize_durations(by)

_default: Optional[Profiler] = None
_default_lock = named_lock("profile.default")


def get_profiler() -> Profiler:
    """Process-wide default profiler (created lazily; armed iff
    ``TPUSLICE_PROFILE`` was set at creation or ``arm()`` was called)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Profiler()
        return _default


# ---------------------------------------------------- debug endpoint


def debug_profile_payload(qs: Dict[str, list],
                          profiler: Optional[Profiler] = None,
                          tracer=None, journal=None) -> dict:
    """Build the ``GET /v1/debug/profile`` response from parsed
    query-string lists (serving/api_server.py). Default mode:
    armed state, per-segment summaries, and the ``n`` most recent
    round records / timeline events (default 20, bounded by the ring).
    ``?rid=X`` switches to the per-request waterfall (X is an engine
    rid or a trace id). Raises :class:`ValueError` on a malformed
    ``n`` (callers map to HTTP 400) and :class:`LookupError` when a
    requested rid has no recorded state (HTTP 404)."""
    p = profiler if profiler is not None else get_profiler()
    try:
        n = int((qs.get("n") or ["20"])[0])
        if n < 1:
            raise ValueError
    except ValueError:
        raise ValueError("n must be a positive integer") from None
    rid = (qs.get("rid") or [""])[0]
    if rid:
        return waterfall_payload(rid, profiler=p, tracer=tracer,
                                 journal=journal)
    return {
        "armed": p.armed,
        "rounds": p.rounds_recorded,
        "events": p.events_recorded,
        "compileWallMs": round(compile_wall_ms(), 3),
        "segments": p.segment_summary(),
        "recent": [r.to_dict() for r in p.rounds(n)],
        "recentEvents": p.events(n),
        "compiles": p.events(n, kind="compile"),
    }


# ------------------------------------------------------- waterfall


#: journal reason → the outcome a terminal event implies when the root
#: ``serve.request`` span is missing (shed before any span recorded)
_TERMINAL_OUTCOMES = {
    REASON_SHED: "shed",
    REASON_DRAINED: "drained",
    REASON_SESSION_EXPORTED: "migrated",
}

#: span name → waterfall stage label ("serve.decode_round" resolves
#: per-span from its phase attr)
_STAGE_NAMES = {
    "serve.queue": "queue",
    "serve.prefill": "prefill",
    "serve.preempt": "preempt",
    "serve.resume": "resume",
}


def waterfall_payload(rid, profiler: Optional[Profiler] = None,
                      tracer=None, journal=None) -> dict:
    """Stitch one request's latency waterfall from round records,
    journal events, and trace spans. ``rid`` is an engine rid (mapped
    to its trace id through the round records' rid/trace-id pairing)
    or a trace id directly. Raises :class:`LookupError` when nothing
    recorded mentions the request."""
    p = profiler if profiler is not None else get_profiler()
    t = tracer if tracer is not None else get_tracer()
    j = journal
    if j is None:
        from instaslice_tpu_torch.obs.journal import get_journal

        j = get_journal()
    key = str(rid)
    trace_id = ""
    if key.isdigit():
        want = int(key)
        for rec in reversed(p.rounds()):
            rids = list(rec.meta.get("rids") or ())
            tis = list(rec.meta.get("trace_ids") or ())
            if want in rids:
                i = rids.index(want)
                if i < len(tis) and tis[i]:
                    trace_id = str(tis[i])
                break
    if not trace_id:
        trace_id = key
    spans = t.trace(trace_id)
    evs = j.events(trace_id=trace_id)
    recs = [rec for rec in p.rounds()
            if trace_id in [str(x) for x in
                            (rec.meta.get("trace_ids") or ())]]
    if not spans and not evs and not recs:
        raise LookupError(
            "nothing recorded for request %r (not an engine rid in "
            "the round ring, not a trace id with spans or journal "
            "events)" % key
        )
    starts = ([s.start for s in spans] + [e.ts for e in evs]
              + [rec.ts for rec in recs])
    t0 = min(starts)
    root = None
    stages: List[dict] = []
    for s in sorted(spans, key=lambda x: x.start):
        if s.name == "serve.request":
            root = s
            continue
        if s.name == "serve.decode_round":
            stage = "%s round" % s.attrs.get("phase", "decode")
        elif s.name == "serve.migrate":
            stage = "migrate-%s" % s.attrs.get("direction", "out")
        else:
            stage = _STAGE_NAMES.get(s.name, s.name)
        stages.append({
            "stage": stage,
            "span": s.name,
            "startMs": round((s.start - t0) * 1e3, 3),
            "durationMs": round(s.duration_ms, 3),
            "attrs": dict(s.attrs),
        })
    markers = [{
        "atMs": round((e.ts - t0) * 1e3, 3),
        "reason": e.reason,
        "message": e.message,
    } for e in sorted(evs, key=lambda e: e.ts)]
    outcome = ""
    if root is not None:
        outcome = root.attrs.get("outcome", "")
    if not outcome:
        for e in evs:
            if e.reason in _TERMINAL_OUTCOMES:
                outcome = _TERMINAL_OUTCOMES[e.reason]
    preemptions = sum(1 for s in stages if s["stage"] == "preempt")
    if preemptions and outcome == "ok":
        outcome = "preempted-resumed"
    total_ms = (round(root.duration_ms, 3) if root is not None else
                round(max(
                    [s["startMs"] + s["durationMs"] for s in stages]
                    + [m["atMs"] for m in markers] + [0.0]
                ), 3))
    return {
        "rid": key,
        "traceId": trace_id,
        "outcome": outcome,
        "totalMs": total_ms,
        "preemptions": preemptions,
        "stages": stages,
        "markers": markers,
        "rounds": [rec.to_dict() for rec in recs],
    }
