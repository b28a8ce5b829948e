"""Prometheus metrics of the port's serving plane, node agent, router and
fleet telemetry.

A copy of ``OperatorMetrics`` (the node agent's), ``ServingMetrics``,
``RouterMetrics`` (the fleet router's), ``FleetMetrics`` (the fleet
telemetry aggregator's), ``EventMetrics``, ``render``,
``observe_with_exemplar`` and ``start_metrics_server`` from
``instaslice_tpu/metrics/metrics.py``: the port imports nothing of the
JAX package. A session exported off the server counts under the
requests counter's ``migrated`` outcome; the router counts the move under
``RouterMetrics.migrations``. Without ``prometheus_client`` every
metric is a no-op.
"""

from __future__ import annotations

import logging
from typing import Optional
from instaslice_tpu_torch.utils.lockcheck import named_lock

log = logging.getLogger("instaslice_tpu_torch.metrics")

try:
    from prometheus_client import (
        Counter,
        Gauge,
        Histogram,
        CollectorRegistry,
        start_http_server,
    )

    _PROM = True
except ImportError:  # pragma: no cover - prometheus_client is in the image
    _PROM = False

_warned_no_prom = False


def _warn_no_prom() -> None:
    """One loud warning instead of silently dropping every metric: an
    image built without prometheus_client used to serve an operator
    whose dashboards were empty with no hint why."""
    global _warned_no_prom
    if not _warned_no_prom:
        _warned_no_prom = True
        log.warning(
            "prometheus_client is not installed: ALL metrics are no-ops "
            "(grant latency, serve outcomes, TTFT/TPOT histograms). "
            "Install prometheus_client to restore the /metrics surface."
        )


class _NoopMetric:
    def labels(self, *a, **k):
        return self

    def inc(self, *a, **k):
        pass

    def dec(self, *a, **k):
        pass

    def set(self, *a, **k):
        pass

    def observe(self, *a, **k):
        pass


def observe_with_exemplar(hist, value: float, trace_id: str = "") -> None:
    """Observe ``value`` on ``hist``, attaching the trace id as an
    OpenMetrics exemplar when the client library supports it — a slow
    bucket of ``tpuslice_grant_seconds`` / ``tpuslice_serve_request_
    seconds`` then links straight to the trace that caused it. Falls
    back to a plain observe on noop metrics or older client libs
    (TypeError fires at the call boundary, before any increment).

    The id is validated against the shared ``TRACE_ID_SAFE`` shape
    HERE rather than relying on the client library's ValueError:
    prometheus_client increments the histogram BEFORE validating the
    exemplar, so a catch-and-reobserve fallback would double-count
    the observation."""
    from instaslice_tpu_torch.utils.trace import TRACE_ID_SAFE

    if trace_id and TRACE_ID_SAFE.match(trace_id):
        try:
            hist.observe(value, exemplar={"trace_id": trace_id})
            return
        except TypeError:
            pass  # old prometheus_client: no exemplar kwarg
    hist.observe(value)


def render(metrics) -> str:
    """Exposition-format dump of ``metrics.registry`` (any holder with a
    ``registry`` attribute) — lets tests and debug handlers assert on
    metric output without binding a port. "" when prometheus_client is
    missing or the holder is noop-backed."""
    if not _PROM or getattr(metrics, "registry", None) is None:
        return ""
    from prometheus_client import generate_latest

    return generate_latest(metrics.registry).decode()


class EventMetrics:
    """Flight-recorder counters, incremented by the event journal
    (``obs/journal.py``) on every emit. Pass an existing holder's
    ``registry`` to expose them on that holder's /metrics port; the
    journal's lazily-built default uses its own registry, rendered
    portlessly via :func:`render`."""

    def __init__(self, registry: Optional["CollectorRegistry"] = None):
        if not _PROM:
            _warn_no_prom()
            self.events = _NoopMetric()
            self.last_event_ts = _NoopMetric()
            self.registry = None
            return
        self.registry = registry or CollectorRegistry()
        self.events = Counter(
            "tpuslice_events_total",
            "Flight-recorder events emitted by the journal",
            ["component", "reason"],
            registry=self.registry,
        )
        self.last_event_ts = Gauge(
            "tpuslice_last_event_timestamp_seconds",
            "Unix timestamp of the most recent journal event",
            ["component"],
            registry=self.registry,
        )


class OperatorMetrics:
    """One instance per process; inject into Controller / NodeAgent."""

    def __init__(self, registry: Optional["CollectorRegistry"] = None):
        if not _PROM:
            _warn_no_prom()
            self.slice_grant_seconds = _NoopMetric()
            self.reserve_seconds = _NoopMetric()
            self.device_errors = _NoopMetric()
            self.allocations = _NoopMetric()
            self.pending_pods = _NoopMetric()
            self.reconciles = _NoopMetric()
            self.unhealthy_chips = _NoopMetric()
            self.health_evictions = _NoopMetric()
            self.registry = None
            return
        self.registry = registry or CollectorRegistry()
        # The north-star metric: request (allocation write) → pod ungated.
        self.slice_grant_seconds = Histogram(
            "tpuslice_grant_seconds",
            "Latency from allocation creation to pod ungate",
            buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120),
            registry=self.registry,
        )
        self.reserve_seconds = Histogram(
            "tpuslice_device_reserve_seconds",
            "Device-backend chip reservation latency",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5),
            registry=self.registry,
        )
        self.device_errors = Counter(
            "tpuslice_device_errors_total",
            "Device-backend operation failures",
            registry=self.registry,
        )
        self.allocations = Counter(
            "tpuslice_allocations_total",
            "Allocation state transitions",
            ["status"],
            registry=self.registry,
        )
        self.pending_pods = Gauge(
            "tpuslice_pending_pods",
            "Gated pods awaiting a slice",
            registry=self.registry,
        )
        self.reconciles = Counter(
            "tpuslice_reconciles_total",
            "Reconcile invocations",
            ["component"],
            registry=self.registry,
        )
        self.unhealthy_chips = Gauge(
            "tpuslice_unhealthy_chips",
            "Chips the health sweep currently reports failed",
            ["node"],
            registry=self.registry,
        )
        self.health_evictions = Counter(
            "tpuslice_health_evictions_total",
            "Pods evicted because their granted chips went unhealthy",
            registry=self.registry,
        )


class ServingMetrics:
    """Metrics for the serving front-end (serving/api_server.py) — the
    operator-side view of a granted slice doing inference work."""

    def __init__(self, registry: Optional["CollectorRegistry"] = None):
        if not _PROM:
            _warn_no_prom()
            self.requests = _NoopMetric()
            self.tokens = _NoopMetric()
            self.queue_depth = _NoopMetric()
            self.live_slots = _NoopMetric()
            self.request_seconds = _NoopMetric()
            self.draining = _NoopMetric()
            self.ttft_seconds = _NoopMetric()
            self.tpot_seconds = _NoopMetric()
            self.step_seconds = _NoopMetric()
            self.phase_seconds = _NoopMetric()
            self.batch_occupancy = _NoopMetric()
            self.kv_cache_utilization = _NoopMetric()
            self.prefill_batch_occupancy = _NoopMetric()
            self.dispatch_gap_seconds = _NoopMetric()
            self.kv_blocks_free = _NoopMetric()
            self.kv_blocks_used = _NoopMetric()
            self.kv_blocks_cow = _NoopMetric()
            self.kv_blocks_prefix = _NoopMetric()
            self.prefix_hits = _NoopMetric()
            self.prefix_misses = _NoopMetric()
            self.prefix_inserted = _NoopMetric()
            self.prefix_evicted = _NoopMetric()
            self.class_ttft_seconds = _NoopMetric()
            self.class_tpot_seconds = _NoopMetric()
            self.preemptions = _NoopMetric()
            self.resumes = _NoopMetric()
            self.slo_missed = _NoopMetric()
            self.spec_rounds = _NoopMetric()
            self.spec_proposed = _NoopMetric()
            self.spec_accepted = _NoopMetric()
            self.spec_acceptance = _NoopMetric()
            self.profile_rounds = _NoopMetric()
            self.round_segment_seconds = _NoopMetric()
            self.registry = None
            return
        self.registry = registry or CollectorRegistry()
        # outcome ∈ ok | error | timeout | rejected | shed (queue-full
        # 429) | drained (drain-time 503) | migrated (session exported
        # to a peer replica — the fleet router finishes it elsewhere).
        # Every HTTP request lands in EXACTLY one outcome —
        # tests/test_serving_chaos.py reconciles the sum against
        # delivered responses under fault injection.
        self.requests = Counter(
            "tpuslice_serve_requests_total",
            "Completion requests by outcome",
            ["outcome"],
            registry=self.registry,
        )
        self.tokens = Counter(
            "tpuslice_serve_tokens_total",
            "Tokens returned to clients",
            registry=self.registry,
        )
        self.queue_depth = Gauge(
            "tpuslice_serve_queue_depth",
            "Requests waiting for a slot",
            registry=self.registry,
        )
        self.live_slots = Gauge(
            "tpuslice_serve_live_slots",
            "Slots currently decoding",
            registry=self.registry,
        )
        self.request_seconds = Histogram(
            "tpuslice_serve_request_seconds",
            "Wall time from admission-queue entry to completion",
            buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120),
            registry=self.registry,
        )
        self.draining = Gauge(
            "tpuslice_serve_draining",
            "1 while the server is draining (readyz 503, no admission)",
            registry=self.registry,
        )
        # --- engine latency profiler (docs/OBSERVABILITY.md) ---
        # TTFT: admission-queue entry → first sampled token. The
        # user-facing responsiveness number the MIG-serving papers
        # (arXiv:2109.11067, ParvaGPU) drive reconfiguration from.
        self.ttft_seconds = Histogram(
            "tpuslice_serve_ttft_seconds",
            "Time to first token (queue entry to first sampled token)",
            buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5,
                     5, 10, 30, 60),
            registry=self.registry,
        )
        # TPOT: mean inter-token gap over a request's decode phase
        self.tpot_seconds = Histogram(
            "tpuslice_serve_tpot_seconds",
            "Per-request mean time per output token after the first",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1, 2.5),
            registry=self.registry,
        )
        # phase ∈ prefill | decode | spec — one scheduler dispatch each
        self.step_seconds = Histogram(
            "tpuslice_serve_step_seconds",
            "Engine dispatch wall time per scheduler round, by phase",
            ["phase"],
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1, 2.5, 5),
            registry=self.registry,
        )
        self.phase_seconds = Counter(
            "tpuslice_serve_phase_seconds_total",
            "Cumulative engine wall time split prefill vs decode",
            ["phase"],
            registry=self.registry,
        )
        self.batch_occupancy = Gauge(
            "tpuslice_serve_batch_occupancy",
            "Live slots / max_batch (decode batch utilization)",
            registry=self.registry,
        )
        # paged KV-cache (serving/kvcache.py): true block occupancy —
        # resident tokens over the capacity of the blocks they hold
        self.kv_cache_utilization = Gauge(
            "tpuslice_serve_kv_cache_utilization",
            "Resident tokens / capacity of allocated KV blocks",
            registry=self.registry,
        )
        # --- engine hot path (docs/SERVING.md "Engine hot path") ---
        # batched prefill: real rows / bucket rows per multi-slot
        # prefill dispatch (1.0 = the bucket was full; low values mean
        # bursts arrive narrower than the padding spends)
        self.prefill_batch_occupancy = Histogram(
            "tpuslice_serve_prefill_batch_occupancy",
            "Real rows / bucket rows per batched prefill dispatch",
            buckets=(0.125, 0.25, 0.5, 0.625, 0.75, 0.875, 1.0),
            registry=self.registry,
        )
        # host-side seam between consecutive engine dispatches — the
        # device-idle time overlap + batched admission exist to shrink
        self.dispatch_gap_seconds = Histogram(
            "tpuslice_serve_dispatch_gap_seconds",
            "Host planning time between engine dispatches (device idle)",
            buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                     0.01, 0.025, 0.05, 0.1, 0.25, 1),
            registry=self.registry,
        )
        self.kv_blocks_free = Gauge(
            "tpuslice_kv_blocks_free",
            "KV block pool: blocks free for admission",
            registry=self.registry,
        )
        self.kv_blocks_used = Gauge(
            "tpuslice_kv_blocks_used",
            "KV block pool: blocks held by live + parked requests",
            registry=self.registry,
        )
        self.kv_blocks_cow = Gauge(
            "tpuslice_kv_blocks_cow",
            "KV block pool: blocks copy-on-write shared by >1 holder",
            registry=self.registry,
        )
        # --- radix prefix cache (docs/SERVING.md "Radix prefix
        # cache") --- a hit skipped that prefix's prefill entirely; a
        # miss prefilled cold; inserted/evicted is the cache churn the
        # LRU keeps under block pressure
        self.kv_blocks_prefix = Gauge(
            "tpuslice_kv_blocks_prefix",
            "KV block pool: blocks held by the radix prefix cache",
            registry=self.registry,
        )
        self.prefix_hits = Counter(
            "tpuslice_serve_prefix_hits_total",
            "Admissions that reused a radix-cached prefix",
            registry=self.registry,
        )
        self.prefix_misses = Counter(
            "tpuslice_serve_prefix_misses_total",
            "Base-model admissions with no cached prefix to reuse",
            registry=self.registry,
        )
        self.prefix_inserted = Counter(
            "tpuslice_serve_prefix_inserted_total",
            "Radix tree nodes inserted by completed requests",
            registry=self.registry,
        )
        self.prefix_evicted = Counter(
            "tpuslice_serve_prefix_evicted_total",
            "Radix tree nodes evicted (LRU reclaim or drop_prefix)",
            registry=self.registry,
        )
        # --- multi-tenant SLO scheduler (serving/scheduler.py) ---
        # per-tenant-class latency: the histograms SLO attainment and
        # the (future) autoscaler read; class ∈ latency/standard/
        # best-effort (plus whatever a custom tenant spec names)
        self.class_ttft_seconds = Histogram(
            "tpuslice_serve_class_ttft_seconds",
            "Time to first token by tenant class",
            ["tenant_class"],
            buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5,
                     5, 10, 30, 60),
            registry=self.registry,
        )
        self.class_tpot_seconds = Histogram(
            "tpuslice_serve_class_tpot_seconds",
            "Per-request mean time per output token by tenant class",
            ["tenant_class"],
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1, 2.5),
            registry=self.registry,
        )
        self.preemptions = Counter(
            "tpuslice_serve_preemptions_total",
            "Requests parked so a latency-class request made its TTFT",
            registry=self.registry,
        )
        self.resumes = Counter(
            "tpuslice_serve_resumes_total",
            "Parked requests resumed into a freed slot",
            registry=self.registry,
        )
        self.slo_missed = Counter(
            "tpuslice_serve_slo_missed_total",
            "Completed requests that exceeded their class SLO target",
            ["tenant_class", "slo"],
            registry=self.registry,
        )
        # --- speculative decoding (docs/SERVING.md "Speculative
        # decoding") --- rounds is draft+verify dispatch chains;
        # proposed/accepted is the draft-token ledger behind the
        # acceptance rate the adaptive-k ladder follows (bonus tokens
        # are not counted — they are free either way)
        self.spec_rounds = Counter(
            "tpuslice_serve_spec_rounds_total",
            "Speculative rounds dispatched (draft + verify chains)",
            registry=self.registry,
        )
        self.spec_proposed = Counter(
            "tpuslice_serve_spec_proposed_total",
            "Draft tokens proposed across speculative rounds",
            registry=self.registry,
        )
        self.spec_accepted = Counter(
            "tpuslice_serve_spec_accepted_total",
            "Draft tokens accepted by target verification",
            registry=self.registry,
        )
        self.spec_acceptance = Histogram(
            "tpuslice_serve_spec_acceptance_rate",
            "Per-round draft acceptance rate (accepted / proposed)",
            buckets=(0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875,
                     1.0),
            registry=self.registry,
        )
        # --- continuous profiler (obs/profiler.py, docs/
        # OBSERVABILITY.md "Profiling") --- only populated while
        # profiling is armed (TPUSLICE_PROFILE=1 / --profile); the
        # round count reconciles exactly with the scheduler's
        # rounds_total ledger and the profiler ring's recorded count
        self.profile_rounds = Counter(
            "tpuslice_serve_profile_rounds_total",
            "Scheduler rounds recorded by the armed profiler",
            registry=self.registry,
        )
        # segment ∈ admission | resume | preempt | prefill | dispatch
        # | readback | host — one observation per segment per recorded
        # round (the per-round segment sums; a round's segments sum to
        # at most its wall time)
        self.round_segment_seconds = Histogram(
            "tpuslice_serve_round_segment_seconds",
            "Per-round scheduler time by anatomy segment (armed only)",
            ["segment"],
            buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                     0.01, 0.025, 0.05, 0.1, 0.25, 1),
            registry=self.registry,
        )


class RouterMetrics:
    """Metrics for the fleet serving router (``serving/router.py``) — the
    operator-side view of N replicas serving as one endpoint."""

    def __init__(self, registry: Optional["CollectorRegistry"] = None):
        if not _PROM:
            _warn_no_prom()
            self.requests = _NoopMetric()
            self.routed = _NoopMetric()
            self.migrations = _NoopMetric()
            self.replicas = _NoopMetric()
            self.breaker_opens = _NoopMetric()
            self.replica_ejections = _NoopMetric()
            self.replica_latency = _NoopMetric()
            self.registry = None
            return
        self.registry = registry or CollectorRegistry()
        # outcome ∈ ok | ok-migrated (survived ≥1 live migration) |
        # shed | unavailable | upstream-error | transport-error |
        # no-replica | client-gone
        self.requests = Counter(
            "tpuslice_router_requests_total",
            "Proxied completion requests by outcome",
            ["outcome"],
            registry=self.registry,
        )
        # policy ∈ session | prefix | least-loaded — which routing rule
        # picked the replica (docs/SERVING.md "Fleet router & session
        # migration"); a healthy prefix-heavy workload routes mostly
        # "prefix", which is exactly the TTFT win
        self.routed = Counter(
            "tpuslice_router_routed_total",
            "Routing decisions by policy rule",
            ["policy"],
            registry=self.registry,
        )
        # outcome ∈ resumed (imported + resumed, zero re-prefill) |
        # fallback (re-prefilled on a peer) | lost (terminal 502)
        self.migrations = Counter(
            "tpuslice_router_migrations_total",
            "Live KV session migrations by outcome",
            ["outcome"],
            registry=self.registry,
        )
        self.replicas = Gauge(
            "tpuslice_router_replicas",
            "Engine replicas registered with the router",
            registry=self.registry,
        )
        self.breaker_opens = Counter(
            "tpuslice_router_breaker_open_total",
            "Per-replica circuit breaker open events",
            registry=self.registry,
        )
        # gray-failure ejections (docs/RECOVERY.md "Partitions & gray
        # failures"): replicas pulled from routing on latency EWMA
        # alone — the breaker never fires for these
        self.replica_ejections = Counter(
            "tpuslice_router_replica_ejections_total",
            "Gray-failure replica ejections (latency EWMA past "
            "threshold at 100% success)",
            registry=self.registry,
        )
        self.replica_latency = Gauge(
            "tpuslice_router_replica_latency_ewma_seconds",
            "Per-replica stats-poll latency EWMA p95 estimate",
            ["replica"],
            registry=self.registry,
        )


class FleetMetrics:
    """Metrics for the fleet telemetry aggregator (obs/telemetry.py) —
    rollups computed FROM every other plane's scraped registries, on
    the aggregator's own registry (docs/OBSERVABILITY.md "Fleet
    telemetry")."""

    def __init__(self, registry: Optional["CollectorRegistry"] = None):
        if not _PROM:
            _warn_no_prom()
            self.goodput = _NoopMetric()
            self.requests = _NoopMetric()
            self.tokens = _NoopMetric()
            self.attainment = _NoopMetric()
            self.burn_rate = _NoopMetric()
            self.burning = _NoopMetric()
            self.kv_free_fraction = _NoopMetric()
            self.chip_seconds = _NoopMetric()
            self.chips_live = _NoopMetric()
            self.chip_hours_per_mreq = _NoopMetric()
            self.scrapes = _NoopMetric()
            self.registry = None
            return
        self.registry = registry or CollectorRegistry()
        self.goodput = Gauge(
            "tpuslice_fleet_goodput_tokens_per_sec",
            "Fleet-wide generated tokens/sec over the last scrape "
            "interval",
            registry=self.registry,
        )
        self.requests = Gauge(
            "tpuslice_fleet_requests_total",
            "Fleet-wide served completion requests by outcome "
            "(summed across replica registries)",
            ["outcome"],
            registry=self.registry,
        )
        self.tokens = Gauge(
            "tpuslice_fleet_tokens_total",
            "Fleet-wide generated tokens (summed across replica "
            "registries)",
            registry=self.registry,
        )
        self.attainment = Gauge(
            "tpuslice_fleet_slo_attainment",
            "Per-tenant-class TTFT SLO attainment (1 - missed/served)",
            ["tenant_class"],
            registry=self.registry,
        )
        self.burn_rate = Gauge(
            "tpuslice_fleet_slo_burn_rate",
            "Error-budget burn rate per evaluation window",
            ["tenant_class", "window"],
            registry=self.registry,
        )
        self.burning = Gauge(
            "tpuslice_fleet_slo_burning",
            "1 while a burn-rate alert is active for the class",
            ["tenant_class"],
            registry=self.registry,
        )
        self.kv_free_fraction = Gauge(
            "tpuslice_fleet_kv_free_fraction",
            "Fleet KV pressure: free blocks / total blocks across "
            "replicas",
            registry=self.registry,
        )
        self.chip_seconds = Gauge(
            "tpuslice_fleet_chip_seconds_total",
            "Chip-seconds integrated from allocation lifecycle events "
            "(ungated→deleted × chips; live allocations accrue to now)",
            registry=self.registry,
        )
        self.chips_live = Gauge(
            "tpuslice_fleet_chips_live",
            "Chips currently held by ungated allocations",
            registry=self.registry,
        )
        self.chip_hours_per_mreq = Gauge(
            "tpuslice_fleet_chip_hours_per_million_requests",
            "Chip-hours per million served-ok requests (the macro-bench "
            "headline; 0 until the first ok request)",
            registry=self.registry,
        )
        self.scrapes = Counter(
            "tpuslice_fleet_scrapes_total",
            "Aggregator scrape cycles by outcome",
            ["outcome"],
            registry=self.registry,
        )


_server_started = named_lock("metrics.server_start")


def start_metrics_server(metrics, port: int, host: str = "") -> bool:
    """Serve ``metrics.registry`` on ``host:port``; False if unavailable.
    ``metrics`` is any holder with a ``registry`` attribute
    (:class:`ServingMetrics`).

    ``host`` matters: the kube-rbac-proxy deployment binds the manager to
    127.0.0.1 so the sidecar is the only path to /metrics
    (config/default/manager_auth_proxy_patch.yaml) — ignoring the host
    and listening on 0.0.0.0 would silently bypass the auth proxy."""
    if not _PROM or metrics.registry is None or port <= 0:
        return False
    with _server_started:
        start_http_server(
            port, addr=host or "0.0.0.0", registry=metrics.registry
        )
    return True
