"""Fleet telemetry plane: the sensor layer over every other plane.

Every other observability surface of the port is process-local — the
tracer (``utils/trace.py``), the flight recorder (``obs/journal.py``)
and the per-process Prometheus registries each describe ONE router,
replica, controller or agent. This module is the fleet-wide view, in
three parts:

- :class:`TraceStitcher` — **cross-process trace stitching**. Spans
  collected from each component's ``GET /v1/debug/trace`` and from
  ``TPUSLICE_TRACE_FILE`` JSONL files merge into one store keyed by
  trace id, rendered as a single causal timeline per request. The
  demand→supply link rides the ``caused_by`` span/event attribute the
  controller journals at admission (api/constants.py
  ``CAUSED_BY_ANNOTATION``): a request that waited on ``NoCapacity``
  links its serving trace to the controller grant trace that unblocked
  it, so ONE timeline shows router → replica → controller → agent.
  The engine's ``engine.*`` spans count as the ``serve`` component.

- :class:`FleetAggregator` — **metrics federation**. A periodic scrape
  of every ``/metrics`` + ``/v1/stats`` endpoint (replicas discovered
  live from the router's replica set, operator probe servers listed
  explicitly) summed into fleet rollups: goodput tokens/sec,
  per-tenant-class SLO attainment, KV pressure, and **chip-hours
  accounting** — chip-seconds integrated from allocation lifecycle
  events (``SliceUngated`` → ``SliceDeleted``/``SliceFailed``, chip
  count on the event) joined against served request counts into
  chip-hours per million requests. The chip count is what
  ``api/types.py`` stamps on every transition, the cells of the
  allocation's box: on a GPU grid those are memory slots, eighths of a
  GPU (a whole GPU is 8, a ``3g.40gb`` slice 4), so on a GPU node
  ``chip_seconds`` and ``chip_hours`` read as eighth-GPU-seconds and
  eighth-GPU-hours.

- :class:`BurnRateMonitor` — **multi-window SLO burn-rate alerting**
  (the Google SRE workbook shape): the error-budget burn rate is
  evaluated over a fast window pair (5m + 1h, threshold 14.4) and a
  slow pair (1h + 6h, threshold 6); an alert fires only when BOTH
  windows of a pair burn past the pair's threshold, and clears when no
  pair does. Transitions land in the journal as ``SLOBurnRateHigh`` /
  ``SLOBurnRateCleared`` and on the ``tpuslice_fleet_*`` gauges. The
  clock is injectable, so the sim and tests drive the windows
  deterministically.

Everything is surfaced on the aggregator's own HTTP plane —
``GET /v1/fleet`` (rollups + burn state), ``GET /v1/fleet/trace?trace_
id=X`` (the stitched timeline), plus the standard ``/healthz`` /
``/readyz`` / ``/metrics`` / ``/v1/debug/*`` set — and through the
``tpuslice-gpu fleet`` CLI. Run via ``tpuslice-gpu-telemetry --router
http://host:8080 --probe http://host:8081 ...``. It holds no tensor and
takes no ``--device``.

A copy of ``instaslice_tpu/obs/telemetry.py`` (the port imports nothing
of the JAX package).
"""

from __future__ import annotations

import argparse
import json
import logging
import re
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

from instaslice_tpu_torch.api.constants import (
    REASON_SLICE_DELETED,
    REASON_SLICE_FAILED,
    REASON_SLICE_UNGATED,
    REASON_SLO_BURN_CLEARED,
    REASON_SLO_BURN_HIGH,
)
from instaslice_tpu_torch.metrics.metrics import FleetMetrics, render
from instaslice_tpu_torch.obs.journal import (
    Journal,
    debug_events_payload,
    get_journal,
)
from instaslice_tpu_torch.obs.profiler import debug_profile_payload
from instaslice_tpu_torch.utils.guards import guarded_by
from instaslice_tpu_torch.utils.lockcheck import named_lock
from instaslice_tpu_torch.utils.trace import debug_trace_payload, get_tracer

log = logging.getLogger("instaslice_tpu_torch.obs.telemetry")


# ------------------------------------------------- exposition parsing

_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)(?:\s+\d+)?\s*$"
)
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> Dict[Tuple[str, frozenset], float]:
    """Parse Prometheus text exposition into
    ``{(metric_name, frozenset(label items)): value}`` — the subset the
    federation needs (counters/gauges/histogram series; no metadata).
    Zero-dep by design: the aggregator must work in the same
    environments the ``_NoopMetric`` degradation path targets."""
    out: Dict[Tuple[str, frozenset], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            continue
        name, labels_raw, raw_val = m.groups()
        labels = {}
        if labels_raw:
            for lm in _LABEL.finditer(labels_raw):
                labels[lm.group(1)] = (
                    lm.group(2)
                    .replace('\\"', '"')
                    .replace("\\n", "\n")
                    .replace("\\\\", "\\")
                )
        try:
            val = float(raw_val)
        except ValueError:
            continue
        out[(name, frozenset(labels.items()))] = val
    return out


def metric_sum(samples: Dict[Tuple[str, frozenset], float], name: str,
               **match: str) -> float:
    """Sum every series of ``name`` whose labels include ``match``."""
    want = set(match.items())
    return sum(
        v for (n, labels), v in samples.items()
        if n == name and want <= set(labels)
    )


def metric_by_label(samples: Dict[Tuple[str, frozenset], float],
                    name: str, label: str,
                    **match: str) -> Dict[str, float]:
    """``{label value: summed value}`` across every series of ``name``
    matching ``match`` — per-tenant-class rollups in one call."""
    want = set(match.items())
    out: Dict[str, float] = {}
    for (n, labels), v in samples.items():
        if n != name or not want <= set(labels):
            continue
        d = dict(labels)
        if label in d:
            out[d[label]] = out.get(d[label], 0.0) + v
    return out


def merge_profile_summaries(summaries: List[dict]) -> Dict[str, dict]:
    """Conservative fleet merge of per-replica profiler segment
    summaries (obs/profiler.py ``segment_summary`` shape): counts sum;
    p50/p95/max take the max across replicas — a percentile of
    percentiles is not a percentile, so the fleet view reports the
    honest upper bound per segment instead of a fabricated quantile."""
    out: Dict[str, dict] = {}
    for summ in summaries:
        for name, row in (summ or {}).items():
            cur = out.setdefault(name, {
                "count": 0, "p50Ms": 0.0, "p95Ms": 0.0, "maxMs": 0.0,
            })
            cur["count"] += int(row.get("count", 0) or 0)
            for k in ("p50Ms", "p95Ms", "maxMs"):
                cur[k] = max(cur[k], float(row.get(k, 0.0) or 0.0))
    return out


# --------------------------------------------------- trace stitching

#: span-name prefix → the component that plane's spans belong to (the
#: prefixes are pinned by the docs/OBSERVABILITY.md span taxonomy)
_COMPONENT_ALIASES = {
    "repacker": "controller",
    "device": "agent",
    "engine": "serve",
}


def span_component(name: str) -> str:
    """Classify a span into its emitting component by name prefix
    (``controller.allocate`` → controller, ``serve.request`` → serve,
    ``router.route`` → router, ...)."""
    head = name.split(".", 1)[0]
    return _COMPONENT_ALIASES.get(head, head)


class TraceStitcher:
    """Merge spans from many processes/files into per-trace timelines.

    Spans dedupe on ``(traceId, spanId)`` — the same span arriving via
    a debug endpoint AND a trace file records once. ``caused_by``
    attributes (on ``controller.allocate`` spans and ``Admitted``
    journal events) build the demand→supply link map: grant trace →
    the serving trace it unblocked."""

    # spans arrive from the aggregator poll thread, debug-endpoint
    # handlers, and file ingestion — all merge under telemetry.stitch
    _spans: guarded_by("telemetry.stitch")
    _caused_by: guarded_by("telemetry.stitch")

    def __init__(self) -> None:
        self._lock = named_lock("telemetry.stitch")
        #: trace id → {span id → span dict}
        self._spans: Dict[str, Dict[str, dict]] = {}
        #: grant trace id → serving trace id it was caused by
        self._caused_by: Dict[str, str] = {}

    def add_span(self, span: dict) -> None:
        tid = span.get("traceId") or ""
        sid = span.get("spanId") or ""
        if not tid or not sid:
            return
        with self._lock:
            self._spans.setdefault(tid, {})[sid] = span
            cb = (span.get("attrs") or {}).get("caused_by")
            if cb:
                self._caused_by[tid] = str(cb)

    def add_event(self, event: dict) -> None:
        """Journal events carry the causality stamp too — the
        ``Admitted`` event's ``caused_by`` attr links its grant trace
        even when the span ring has already rotated the span out."""
        cb = (event.get("attrs") or {}).get("caused_by")
        tid = event.get("traceId") or ""
        if cb and tid:
            with self._lock:
                self._caused_by[tid] = str(cb)

    def ingest_debug_payload(self, payload: dict) -> int:
        """Feed a ``GET /v1/debug/trace`` response (either shape)."""
        n = 0
        for key in ("recent", "slowest", "spans"):
            for span in payload.get(key) or []:
                self.add_span(span)
                n += 1
        return n

    def ingest_file(self, path: str) -> int:
        """Feed a ``TPUSLICE_TRACE_FILE`` JSONL file."""
        n = 0
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        self.add_span(json.loads(line))
                        n += 1
                    except (json.JSONDecodeError, TypeError):
                        continue
        except OSError as e:
            log.warning("cannot read trace file %s: %s", path, e)
        return n

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._spans)

    def spans(self, trace_id: str) -> List[dict]:
        with self._lock:
            out = list(self._spans.get(trace_id, {}).values())
        return sorted(out, key=lambda s: s.get("start", 0.0))

    def links_into(self, trace_id: str) -> List[str]:
        """Grant traces whose ``caused_by`` names ``trace_id``."""
        with self._lock:
            return sorted(
                g for g, s in self._caused_by.items() if s == trace_id
            )

    def caused_by(self, trace_id: str) -> Optional[str]:
        with self._lock:
            return self._caused_by.get(trace_id)

    def components(self, trace_id: str,
                   follow_links: bool = True) -> List[str]:
        comps = {
            span_component(s.get("name", ""))
            for s in self.spans(trace_id)
        }
        if follow_links:
            for g in self.links_into(trace_id):
                comps |= {
                    span_component(s.get("name", ""))
                    for s in self.spans(g)
                }
        return sorted(c for c in comps if c)

    def timeline(self, trace_id: str) -> dict:
        """The single causal timeline: the trace's own spans in start
        order plus every grant trace linked into it via ``caused_by``
        (the supply-side work a blocked request caused), all under the
        one requested root."""
        spans = self.spans(trace_id)
        linked = [
            {
                "traceId": g,
                "via": "caused_by",
                "spans": self.spans(g),
            }
            for g in self.links_into(trace_id)
        ]
        return {
            "traceId": trace_id,
            "spans": spans,
            "linked": linked,
            "components": self.components(trace_id),
            "spanCount": len(spans) + sum(
                len(x["spans"]) for x in linked
            ),
        }

    def orphans(self) -> List[dict]:
        """Spans whose ``parentId`` is missing from their own trace
        ACROSS every ingested source — the fleet-level propagation
        check ``tools/validate_trace.py --fleet`` runs. Per-file
        validation can pass while the fleet view is broken (the parent
        lives in a file that was never collected); this is the check
        that catches it."""
        out = []
        with self._lock:
            for tid, by_sid in self._spans.items():
                for span in by_sid.values():
                    pid = span.get("parentId")
                    if pid and pid not in by_sid:
                        out.append(span)
        return out


# ------------------------------------------------ chip-hours ledger


class ChipHoursAccountant:
    """Integrate chip-seconds from allocation lifecycle events.

    ``SliceUngated`` opens an interval (the slice is serving from here),
    ``SliceDeleted``/``SliceFailed`` closes it; the chip count rides
    the event (api/types.py stamps it on every transition: the cells of
    the allocation's box, so on a GPU grid its memory slots, eighths of
    a GPU, and a whole GPU is 8). Live
    allocations accrue to "now" so the gauge never under-reports a
    long-running fleet."""

    def __init__(self, clock: Callable[[], float] = time.time) -> None:
        self.clock = clock
        self._closed_chip_seconds = 0.0
        #: alloc object_ref → (ungated ts, chips)
        self._live: Dict[str, Tuple[float, int]] = {}

    def add_event(self, event: dict) -> None:
        reason = event.get("reason", "")
        ref = event.get("objectRef", "")
        if not ref.startswith("alloc/"):
            return
        ts = float(event.get("ts", 0.0))
        if reason == REASON_SLICE_UNGATED:
            try:
                chips = int((event.get("attrs") or {}).get("chips", 0))
            except (TypeError, ValueError):
                chips = 0
            if chips > 0:
                self._live[ref] = (ts, chips)
        elif reason in (REASON_SLICE_DELETED, REASON_SLICE_FAILED):
            started = self._live.pop(ref, None)
            if started is not None:
                t0, chips = started
                self._closed_chip_seconds += max(0.0, ts - t0) * chips

    def chip_seconds(self, now: Optional[float] = None) -> float:
        now = self.clock() if now is None else now
        live = sum(
            max(0.0, now - t0) * chips
            for t0, chips in self._live.values()
        )
        return self._closed_chip_seconds + live

    def chips_live(self) -> int:
        return sum(chips for _, chips in self._live.values())


# ------------------------------------------------ burn-rate monitor

#: (short window s, long window s, burn threshold) — the SRE-workbook
#: multiwindow pairs: the fast pair catches a cliff in minutes, the
#: slow pair catches a slow leak without paging on noise; both windows
#: of a pair must burn past the threshold to fire
DEFAULT_BURN_WINDOWS: Tuple[Tuple[float, float, float], ...] = (
    (300.0, 3600.0, 14.4),
    (3600.0, 21600.0, 6.0),
)


def _window_label(seconds: float) -> str:
    if seconds % 3600 == 0:
        return f"{int(seconds // 3600)}h"
    if seconds % 60 == 0:
        return f"{int(seconds // 60)}m"
    return f"{seconds:g}s"


class BurnRateMonitor:
    """Multi-window error-budget burn-rate evaluation over cumulative
    per-class (missed, served) counters.

    ``observe`` records one federation sample per class;
    ``evaluate`` computes, per window, ``burn = (1 - attainment over
    the window) / (1 - target)`` and fires/clears per the window
    pairs. Transitions journal ``SLOBurnRateHigh`` /
    ``SLOBurnRateCleared`` (component ``telemetry``) and every rate
    lands on the ``tpuslice_fleet_slo_burn_rate`` gauge."""

    def __init__(self, target: float = 0.99,
                 windows: Tuple[Tuple[float, float, float], ...] =
                 DEFAULT_BURN_WINDOWS,
                 clock: Callable[[], float] = time.time,
                 journal: Optional[Journal] = None,
                 metrics: Optional[FleetMetrics] = None) -> None:
        if not 0.0 < target < 1.0:
            raise ValueError("target must be in (0, 1)")
        self.target = target
        self.windows = tuple(windows)
        self.clock = clock
        self._journal = journal
        self.metrics = metrics or FleetMetrics()
        #: class → deque[(ts, missed cumulative, served cumulative)]
        self._hist: Dict[str, deque] = {}
        self._burning: Dict[str, bool] = {}
        # history only needs to cover the longest window (plus one
        # pre-window sample for the delta base)
        self._horizon = max(
            (w[1] for w in self.windows), default=21600.0
        )

    def _j(self) -> Journal:
        return self._journal if self._journal is not None \
            else get_journal()

    def observe(self, tenant_class: str, missed: float,
                served: float) -> None:
        now = self.clock()
        hist = self._hist.setdefault(tenant_class, deque())
        hist.append((now, float(missed), float(served)))
        while len(hist) > 2 and hist[1][0] < now - self._horizon:
            hist.popleft()

    def _burn_over(self, hist: deque, now: float,
                   window: float) -> float:
        """Burn rate over [now - window, now]: the cumulative-counter
        delta between the newest sample and the newest sample at or
        before the window start (the oldest retained sample stands in
        when history is shorter than the window)."""
        if not hist:
            return 0.0
        newest = hist[-1]
        base = hist[0]
        cutoff = now - window
        for sample in hist:
            if sample[0] <= cutoff:
                base = sample
            else:
                break
        d_missed = newest[1] - base[1]
        d_served = newest[2] - base[2]
        if d_served <= 0:
            return 0.0
        return (d_missed / d_served) / (1.0 - self.target)

    def evaluate(self) -> Dict[str, dict]:
        """One evaluation pass over every observed class. Returns
        ``{class: {"burning": bool, "rates": {window label: burn},
        "fired": [pair labels]}}`` and journals transitions."""
        now = self.clock()
        out: Dict[str, dict] = {}
        for cls, hist in sorted(self._hist.items()):
            rates: Dict[str, float] = {}
            fired: List[str] = []
            for short, long_, threshold in self.windows:
                b_short = self._burn_over(hist, now, short)
                b_long = self._burn_over(hist, now, long_)
                rates[_window_label(short)] = round(b_short, 3)
                rates[_window_label(long_)] = round(b_long, 3)
                if b_short >= threshold and b_long >= threshold:
                    fired.append(
                        f"{_window_label(short)}/{_window_label(long_)}"
                    )
            burning = bool(fired)
            was = self._burning.get(cls, False)
            self._burning[cls] = burning
            for label, rate in rates.items():
                self.metrics.burn_rate.labels(
                    tenant_class=cls, window=label
                ).set(rate)
            self.metrics.burning.labels(tenant_class=cls).set(
                1.0 if burning else 0.0
            )
            if burning and not was:
                self._j().emit(
                    "telemetry", reason=REASON_SLO_BURN_HIGH,
                    object_ref=f"class/{cls}",
                    message=(
                        f"SLO burn rate high for class {cls!r}: "
                        f"pairs {', '.join(fired)} past threshold "
                        f"(target {self.target:g})"
                    ),
                    tenant_class=cls, pairs=",".join(fired),
                )
            elif was and not burning:
                self._j().emit(
                    "telemetry", reason=REASON_SLO_BURN_CLEARED,
                    object_ref=f"class/{cls}",
                    message=(
                        f"SLO burn rate recovered for class {cls!r}"
                    ),
                    tenant_class=cls,
                )
            out[cls] = {"burning": burning, "rates": rates,
                        "fired": fired}
        return out

    def burning(self) -> Dict[str, bool]:
        return dict(self._burning)


# --------------------------------------------------- the aggregator


def _http_get(url: str, timeout: float) -> Tuple[int, bytes]:
    req = urllib.request.Request(url, method="GET")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _get_json(url: str, timeout: float) -> dict:
    _, body = _http_get(url, timeout)
    out = json.loads(body or b"{}")
    if not isinstance(out, dict):
        raise ValueError(f"{url} returned a non-object")
    return out


class FleetAggregator:
    """Scrape → federate → evaluate, one ``poll()`` per cycle.

    Replica endpoints are the static ``replica_urls`` plus whatever the
    router's ``/v1/stats`` replica set advertises at each poll (the
    fleet is elastic; discovery must be too). ``probe_urls`` are
    operator probe servers (controller/agent planes) — their
    ``/v1/debug/events`` feed chip-hours accounting and the causality
    link map, their ``/v1/debug/trace`` feeds the stitcher.
    ``event_files``/``trace_files`` ingest the JSONL sinks directly
    for offline runs. Everything tolerates a dead endpoint: a scrape
    error is counted and skipped, never raised."""

    # thread model: one poll at a time (the loop thread, or a test
    # driving poll() directly with the loop stopped) owns the scrape
    # bookkeeping; only the published rollup crosses to the HTTP
    # export handlers, under telemetry.fleet
    _fleet: guarded_by("telemetry.fleet")
    _seen_events: unguarded("poll-thread owned: ingestion only runs "
                            "inside _poll_inner")
    _last_tokens: unguarded("poll-thread owned: see _seen_events")
    _scrapes: unguarded("poll-thread owned counters; the rollup "
                        "exports a dict() copy taken on that thread")

    def __init__(self, router_url: Optional[str] = None,
                 replica_urls: Tuple[str, ...] = (),
                 probe_urls: Tuple[str, ...] = (),
                 trace_files: Tuple[str, ...] = (),
                 event_files: Tuple[str, ...] = (),
                 interval: float = 2.0,
                 slo_target: float = 0.99,
                 burn_windows: Tuple[Tuple[float, float, float], ...] =
                 DEFAULT_BURN_WINDOWS,
                 metrics: Optional[FleetMetrics] = None,
                 journal: Optional[Journal] = None,
                 clock: Callable[[], float] = time.time,
                 http_timeout: float = 3.0) -> None:
        self.router_url = (router_url or "").rstrip("/") or None
        self.replica_urls = tuple(u.rstrip("/") for u in replica_urls)
        self.probe_urls = tuple(u.rstrip("/") for u in probe_urls)
        self.trace_files = tuple(trace_files)
        self.event_files = tuple(event_files)
        self.interval = interval
        self.http_timeout = http_timeout
        self.clock = clock
        self.metrics = metrics or FleetMetrics()
        self._journal = journal
        self.stitcher = TraceStitcher()
        self.chip_hours = ChipHoursAccountant(clock=clock)
        self.burn = BurnRateMonitor(
            target=slo_target, windows=burn_windows, clock=clock,
            journal=journal, metrics=self.metrics,
        )
        self._lock = named_lock("telemetry.fleet")
        self._fleet: dict = {"ts": 0.0, "polls": 0}
        self._seen_events: set = set()
        self._last_tokens: Optional[Tuple[float, float]] = None
        self._scrapes = {"ok": 0, "error": 0}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------- scraping

    def discover_replicas(self) -> List[str]:
        urls = list(self.replica_urls)
        if self.router_url:
            try:
                stats = _get_json(
                    self.router_url + "/v1/stats", self.http_timeout
                )
                for u in (stats.get("replicas") or {}):
                    u = u.rstrip("/")
                    if u not in urls:
                        urls.append(u)
                self._scrapes["ok"] += 1
            except (urllib.error.URLError, OSError, ValueError,
                    json.JSONDecodeError) as e:
                self._scrapes["error"] += 1
                log.debug("router discovery failed: %s", e)
        return urls

    def _scrape_exposition(self, url: str) -> Optional[dict]:
        try:
            _, body = _http_get(url + "/metrics", self.http_timeout)
            self._scrapes["ok"] += 1
            return parse_exposition(body.decode())
        except (urllib.error.URLError, OSError, ValueError) as e:
            self._scrapes["error"] += 1
            log.debug("metrics scrape of %s failed: %s", url, e)
            return None

    def _scrape_json(self, url: str, path: str) -> Optional[dict]:
        try:
            out = _get_json(url + path, self.http_timeout)
            self._scrapes["ok"] += 1
            return out
        except (urllib.error.URLError, OSError, ValueError,
                json.JSONDecodeError) as e:
            self._scrapes["error"] += 1
            log.debug("scrape of %s%s failed: %s", url, path, e)
            return None

    def _ingest_events(self, events: List[dict]) -> None:
        for ev in events:
            key = (
                ev.get("seq"), round(float(ev.get("ts", 0.0)), 6),
                ev.get("component"), ev.get("reason"),
                ev.get("objectRef", ""),
            )
            if key in self._seen_events:
                continue
            self._seen_events.add(key)
            self.chip_hours.add_event(ev)
            self.stitcher.add_event(ev)

    # ---------------------------------------------------- federation

    def poll(self) -> dict:
        """One scrape→rollup→evaluate cycle (the periodic thread calls
        this; tests call it directly with a pinned clock)."""
        with get_tracer().span("telemetry.scrape"):
            return self._poll_inner()

    def _poll_inner(self) -> dict:
        now = self.clock()
        replicas = self.discover_replicas()
        per_replica: Dict[str, dict] = {}
        requests: Dict[str, float] = {}
        tokens = 0.0
        class_served: Dict[str, float] = {}
        class_missed: Dict[str, float] = {}
        kv_free = kv_total = 0.0
        profile_summaries: List[dict] = []
        profile_armed = 0

        for url in replicas:
            samples = self._scrape_exposition(url)
            stats = self._scrape_json(url, "/v1/stats")
            trace = self._scrape_json(url, "/v1/debug/trace?n=512")
            events = self._scrape_json(url, "/v1/debug/events?n=1000")
            profile = self._scrape_json(url, "/v1/debug/profile?n=1")
            alive = samples is not None or stats is not None
            per_replica[url] = {
                "ok": alive,
                **({"replica_id": stats.get("replica_id"),
                    "queued": stats.get("queued"),
                    "live_slots": stats.get("live_slots")}
                   if stats else {}),
            }
            if samples is not None:
                for (name, labels), v in samples.items():
                    if name == "tpuslice_serve_requests_total":
                        oc = dict(labels).get("outcome", "")
                        requests[oc] = requests.get(oc, 0.0) + v
                tokens += metric_sum(
                    samples, "tpuslice_serve_tokens_total"
                )
                for cls, v in metric_by_label(
                    samples, "tpuslice_serve_class_ttft_seconds_count",
                    "tenant_class",
                ).items():
                    class_served[cls] = class_served.get(cls, 0.0) + v
                for cls, v in metric_by_label(
                    samples, "tpuslice_serve_slo_missed_total",
                    "tenant_class", slo="ttft",
                ).items():
                    class_missed[cls] = class_missed.get(cls, 0.0) + v
            if stats is not None:
                kv = stats.get("kv") or {}
                free = float(kv.get("free") or 0)
                kv_free += free
                kv_total += free + float(kv.get("used") or 0)
            if trace is not None:
                self.stitcher.ingest_debug_payload(trace)
            if events is not None:
                self._ingest_events(events.get("events") or [])
            if profile is not None:
                if profile.get("armed"):
                    profile_armed += 1
                profile_summaries.append(profile.get("segments") or {})

        router_trace = router_events = None
        if self.router_url:
            router_trace = self._scrape_json(
                self.router_url, "/v1/debug/trace?n=512"
            )
            router_events = self._scrape_json(
                self.router_url, "/v1/debug/events?n=1000"
            )
        if router_trace is not None:
            self.stitcher.ingest_debug_payload(router_trace)
        if router_events is not None:
            self._ingest_events(router_events.get("events") or [])

        for url in self.probe_urls:
            trace = self._scrape_json(url, "/v1/debug/trace?n=512")
            events = self._scrape_json(url, "/v1/debug/events?n=1000")
            if trace is not None:
                self.stitcher.ingest_debug_payload(trace)
            if events is not None:
                self._ingest_events(events.get("events") or [])

        for path in self.trace_files:
            self.stitcher.ingest_file(path)
        for path in self.event_files:
            try:
                with open(path) as f:
                    evs = []
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            evs.append(json.loads(line))
                        except json.JSONDecodeError:
                            continue
                    self._ingest_events(evs)
            except OSError as e:
                log.warning("cannot read event file %s: %s", path, e)

        # ---- rollups
        ok_requests = requests.get("ok", 0.0) \
            + requests.get("migrated", 0.0)
        goodput = 0.0
        if self._last_tokens is not None:
            t_prev, tok_prev = self._last_tokens
            dt = now - t_prev
            if dt > 0 and tokens >= tok_prev:
                goodput = (tokens - tok_prev) / dt
        self._last_tokens = (now, tokens)

        attainment: Dict[str, dict] = {}
        for cls in sorted(set(class_served) | set(class_missed)):
            served = class_served.get(cls, 0.0)
            missed = class_missed.get(cls, 0.0)
            att = 1.0 - (missed / served) if served > 0 else 1.0
            attainment[cls] = {
                "served": int(served),
                "missed": int(missed),
                "attainment": round(att, 6),
            }
            self.burn.observe(cls, missed, served)
            self.metrics.attainment.labels(tenant_class=cls).set(att)
        burn = self.burn.evaluate()

        chip_seconds = self.chip_hours.chip_seconds(now)
        chips_live = self.chip_hours.chips_live()
        chip_hours_per_mreq = 0.0
        if ok_requests > 0:
            chip_hours_per_mreq = (
                (chip_seconds / 3600.0) / (ok_requests / 1e6)
            )

        self.metrics.goodput.set(goodput)
        self.metrics.tokens.set(tokens)
        for oc, v in requests.items():
            self.metrics.requests.labels(outcome=oc).set(v)
        if kv_total > 0:
            self.metrics.kv_free_fraction.set(kv_free / kv_total)
        self.metrics.chip_seconds.set(chip_seconds)
        self.metrics.chips_live.set(chips_live)
        self.metrics.chip_hours_per_mreq.set(chip_hours_per_mreq)

        with self._lock:
            polls = self._fleet.get("polls", 0) + 1
        fleet = {
            "ts": round(now, 6),
            "polls": polls,
            "replicas": per_replica,
            "requests": {k: int(v) for k, v in sorted(
                requests.items()
            )},
            "ok_requests": int(ok_requests),
            "tokens": int(tokens),
            "goodput_tokens_per_sec": round(goodput, 2),
            "attainment": attainment,
            "slo_target": self.burn.target,
            "burn": burn,
            "kv": {
                "free": int(kv_free),
                "total": int(kv_total),
                "free_fraction": round(kv_free / kv_total, 4)
                if kv_total else 1.0,
            },
            "chip_hours": {
                "chip_seconds": round(chip_seconds, 3),
                "chips_live": chips_live,
                "chip_hours_per_million_requests": round(
                    chip_hours_per_mreq, 4
                ),
            },
            "traces": len(self.stitcher.trace_ids()),
            "scrapes": dict(self._scrapes),
            # fleet-merged profiler rollup: only replicas serving
            # GET /v1/debug/profile contribute; disarmed replicas
            # contribute empty summaries (armed_replicas says how many
            # actually record)
            "profile": {
                "armed_replicas": profile_armed,
                "segments": merge_profile_summaries(profile_summaries),
            },
        }
        with self._lock:
            self._fleet = fleet
        return fleet

    def fleet(self) -> dict:
        """The latest rollup snapshot (``GET /v1/fleet``)."""
        with self._lock:
            return dict(self._fleet)

    # ------------------------------------------------------ lifecycle

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll()
                self.metrics.scrapes.labels(outcome="ok").inc()
            except Exception:  # noqa: BLE001 - the loop must survive
                self.metrics.scrapes.labels(outcome="error").inc()
                log.warning("telemetry poll failed", exc_info=True)
            self._stop.wait(self.interval)

    def start(self) -> "FleetAggregator":
        self._thread = threading.Thread(
            target=self._loop, name="telemetry-poll", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


# ------------------------------------------------------- HTTP plane


class _TelemetryHandler(BaseHTTPRequestHandler):
    aggregator: FleetAggregator = None  # type: ignore[assignment]

    def log_message(self, *a):  # quiet
        pass

    def _send(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        agg = type(self).aggregator
        qs = urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.path).query
        )
        if self.path.startswith("/healthz"):
            self._send(200, {"status": "ok"})
        elif self.path.startswith("/readyz"):
            fleet = agg.fleet()
            if fleet.get("polls", 0) > 0:
                self._send(200, {"status": "ok",
                                 "polls": fleet["polls"]})
            else:
                self._send(503, {"status": "no poll completed yet"})
        elif self.path.startswith("/v1/fleet/trace"):
            tid = (qs.get("trace_id") or [""])[0]
            if not tid:
                self._send(400, {"error": "trace_id is required"})
                return
            timeline = agg.stitcher.timeline(tid)
            if not timeline["spans"] and not timeline["linked"]:
                self._send(404, {"error": f"no spans collected for "
                                          f"trace {tid!r}"})
                return
            self._send(200, timeline)
        elif self.path.startswith("/v1/fleet"):
            self._send(200, agg.fleet())
        elif self.path.startswith("/metrics"):
            body = render(agg.metrics).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.startswith("/v1/debug/trace"):
            try:
                self._send(200, debug_trace_payload(qs))
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except LookupError as e:
                self._send(404, {"error": str(e)})
        elif self.path.startswith("/v1/debug/events"):
            try:
                self._send(200, debug_events_payload(qs))
            except ValueError as e:
                self._send(400, {"error": str(e)})
        elif self.path.startswith("/v1/debug/profile"):
            # debug parity with replicas/router/probes: the telemetry
            # process's OWN profiler ring (fleet rollup is /v1/fleet)
            try:
                self._send(200, debug_profile_payload(qs))
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except LookupError as e:
                self._send(404, {"error": str(e)})
        else:
            self._send(404, {"error": f"no route {self.path}"})


class TelemetryServer:
    """The aggregator's HTTP plane: ``/v1/fleet``, ``/v1/fleet/trace``,
    ``/healthz``, ``/readyz``, ``/metrics``, ``/v1/debug/*``."""

    def __init__(self, aggregator: FleetAggregator,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.aggregator = aggregator
        handler = type("BoundTelemetryHandler", (_TelemetryHandler,),
                       {"aggregator": aggregator})
        self._srv = ThreadingHTTPServer((host, port), handler)
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="telemetry-http",
            daemon=True,
        )

    @property
    def url(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "TelemetryServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5)


# -------------------------------------------------------------- CLI


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpuslice-gpu-telemetry")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9102)
    ap.add_argument("--router", default=None,
                    help="router base URL (replica set is discovered "
                         "from its /v1/stats)")
    ap.add_argument("--replica", action="append", default=[],
                    help="replica base URL (repeatable; in addition "
                         "to router discovery)")
    ap.add_argument("--probe", action="append", default=[],
                    help="operator probe-server base URL (repeatable; "
                         "controller/agent planes)")
    ap.add_argument("--trace-file", action="append", default=[],
                    help="TPUSLICE_TRACE_FILE JSONL to ingest each "
                         "poll (repeatable)")
    ap.add_argument("--event-file", action="append", default=[],
                    help="TPUSLICE_EVENT_FILE JSONL to ingest each "
                         "poll (repeatable)")
    ap.add_argument("--interval", type=float, default=5.0,
                    help="scrape interval seconds")
    ap.add_argument("--slo-target", type=float, default=0.99,
                    help="attainment target the burn rate is "
                         "normalized against")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    args = build_parser().parse_args(argv)
    agg = FleetAggregator(
        router_url=args.router,
        replica_urls=tuple(args.replica),
        probe_urls=tuple(args.probe),
        trace_files=tuple(args.trace_file),
        event_files=tuple(args.event_file),
        interval=args.interval,
        slo_target=args.slo_target,
    ).start()
    srv = TelemetryServer(agg, host=args.host, port=args.port).start()
    log.info("fleet telemetry aggregator on %s (interval %gs)",
             srv.url, args.interval)
    forever = threading.Event()
    try:
        while not forever.is_set():
            forever.wait(60)
    except KeyboardInterrupt:
        pass
    finally:
        agg.stop()
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
