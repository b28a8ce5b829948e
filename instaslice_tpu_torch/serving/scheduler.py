"""Continuous-batching, tenant-aware serving scheduler.

The serving plane's decision loop, split out of ``api_server.py`` (the
HTTP front-end keeps parsing/transport; this module owns everything
between "request submitted" and "result delivered"). It replaces the
old fixed decode rounds with per-step scheduling in the sense the
MIG-serving reconfigurable-scheduling paper (arXiv:2109.11067) frames:
*which requests run each step*, not just which slice they land on.

What it decides, every round:

- **Admission** is priority-ordered, not FIFO: requests carry a tenant
  (``X-Tenant`` header / ``tenant`` field), tenants map to priority
  classes (``latency`` > ``standard`` > ``best-effort``) with weighted
  fair-share inside a class (start-time virtual clock: admitting a
  request advances its tenant's virtual time by ``max_tokens/weight``,
  and the lowest virtual time goes first — a heavy tenant cannot starve
  a light one, a weighted tenant gets its share). Admission gates on
  free *KV blocks* as well as free slots (``ServingEngine.can_admit``),
  so parked and pinned blocks push back on new work — and the block
  charge is radix-aware (``admit_block_cost``): a prompt whose prefix
  the radix cache holds pays only its non-shared suffix, while
  cached-but-unreferenced blocks count as free (the engine LRU-evicts
  them deterministically inside the admission op).
- **Decode rounds are right-sized**: bounded by the smallest remaining
  budget among live requests (a finished request's slot — and blocks —
  are reusable on the very next step) and shortened while requests
  wait, so admission latency is a few steps, not a full block.
  ``mode="fixed"`` reconstructs classic static batching (FIFO with
  head-of-line blocking, full ``block_size`` rounds regardless of
  budgets — ROADMAP item 3's "fixed decode rounds") as the measured
  baseline for ``bench.py --serving``. NB the loop this module
  replaced already trimmed rounds to the smallest budget; fixed mode
  isolates what full fixed rounds cost, it is not a byte-for-byte
  replay of the old scheduler.
- **SLO-aware preemption**: when a latency-class request has waited
  past ``preempt_margin`` of its TTFT target and no slot is free, the
  newest lowest-class live request is *parked* —
  ``ServingEngine.preempt_slot`` reads its KV stripe out beside its
  block table, so resuming (``resume_request``) is one stripe write,
  never a re-prefill. Parked state holds its blocks; under block
  pressure the scheduler sheds parked best-effort requests (clean 503)
  — eviction frees blocks, not stripes.
- **Per-adapter LoRA grouping**: among equally-ranked admission
  candidates, requests whose adapter matches one already decoding are
  preferred, concentrating each decode step on fewer adapters (the
  measured multi-adapter overhead is the per-row one-hot gather over
  the full adapter stack; fewer distinct adapters per step is the
  schedulable half of that cost).

Every decision is journaled (``RequestPreempted`` / ``RequestResumed``
/ ``SLOMissed``) under the request's trace id, and per-tenant-class
TTFT/TPOT histograms feed SLO attainment (docs/OBSERVABILITY.md).

A copy of ``instaslice_tpu/serving/scheduler.py`` over the port's engine
(``instaslice_tpu_torch.serving.engine``) and the port's copies of its
jax-free dependencies: the port imports nothing of the JAX package. The
session-migration half is the reference's: the ``control`` op queue,
``migrate_out`` (with the ``serve.export`` crash point),
``import_session``, ``_bind_resumes``, ``_sweep_stale_imports`` and
``TPUSLICE_IMPORT_TTL``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
import uuid
from typing import Dict, List, Optional

from instaslice_tpu_torch.api.constants import (
    REASON_COMPILE_OBSERVED,
    REASON_DRAIN_BEGIN,
    REASON_DRAIN_END,
    REASON_DRAINED,
    REASON_PREEMPTED,
    REASON_RESUMED,
    REASON_SESSION_EXPORTED,
    REASON_SESSION_IMPORTED,
    REASON_SHED,
    REASON_SLO_MISSED,
)
from instaslice_tpu_torch.faults import maybe_crash
from instaslice_tpu_torch.obs.journal import get_journal
from instaslice_tpu_torch.obs.profiler import (
    NOOP_TIMER,
    CompileWatch,
    get_profiler,
)
from instaslice_tpu_torch.utils.guards import guarded_by, unguarded
from instaslice_tpu_torch.serving.engine import (
    AdmissionRequest,
    GenerationResult,
    ServingEngine,
)
from instaslice_tpu_torch.utils.lockcheck import named_lock
from instaslice_tpu_torch.utils.trace import get_tracer, new_span_id

log = logging.getLogger("instaslice_tpu_torch.serving.scheduler")

#: priority classes, best first. Admission and preemption order by
#: rank; unknown class names rank as "standard".
CLASS_RANK = {"latency": 0, "standard": 1, "best-effort": 2}

#: stable per-PROCESS nonce, surfaced on ``/v1/stats`` as
#: ``replica_id``: the fleet router keys replica identity on it (plus
#: the monotonic ``uptime_seconds``) so a restarted replica — same URL,
#: empty radix cache, dead sessions — is detected instead of trusted
REPLICA_ID = uuid.uuid4().hex[:12]


def class_rank(name: str) -> int:
    return CLASS_RANK.get(name, CLASS_RANK["standard"])


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's scheduling contract: fair-share ``weight`` inside
    its class, and optional TTFT/TPOT SLO targets in seconds (0 = no
    target — nothing to miss, nothing to preempt for)."""

    name: str
    weight: float = 1.0
    tenant_class: str = "standard"
    ttft_slo: float = 0.0
    tpot_slo: float = 0.0


#: what an unknown (or absent) tenant gets
DEFAULT_SPEC = TenantSpec(name="", weight=1.0, tenant_class="standard")


def parse_tenant_specs(spec: str) -> Dict[str, TenantSpec]:
    """``name:weight:class[:ttft_slo[:tpot_slo]]``, comma-separated —
    the ONE tenant grammar, shared by the server (``--tenants`` /
    ``TPUSLICE_TENANTS``) and loadgen's traffic generator so a bench
    scenario and the policy it runs against cannot drift.

    >>> parse_tenant_specs("gold:4:latency:0.5,free:1:best-effort")
    """
    out: Dict[str, TenantSpec] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if not fields[0]:
            raise ValueError(f"tenant spec {part!r}: empty name")
        name = fields[0]
        try:
            weight = float(fields[1]) if len(fields) > 1 and fields[1] \
                else 1.0
            ttft = float(fields[3]) if len(fields) > 3 and fields[3] \
                else 0.0
            tpot = float(fields[4]) if len(fields) > 4 and fields[4] \
                else 0.0
        except ValueError:
            raise ValueError(
                f"tenant spec {part!r}: weight/slo must be numbers "
                "(name:weight:class[:ttft_slo[:tpot_slo]])"
            ) from None
        cls = fields[2] if len(fields) > 2 and fields[2] else "standard"
        if cls not in CLASS_RANK:
            raise ValueError(
                f"tenant spec {part!r}: class {cls!r} not one of "
                f"{sorted(CLASS_RANK)}"
            )
        if weight <= 0:
            raise ValueError(f"tenant spec {part!r}: weight must be > 0")
        if name in out:
            raise ValueError(f"tenant {name!r} given twice")
        out[name] = TenantSpec(name, weight, cls, ttft, tpot)
    return out


class QueueFull(Exception):
    """Admission queue at capacity: the request was shed (HTTP 429 with
    Retry-After) instead of joining a line it would only time out in."""

    def __init__(self, retry_after: float = 1.0):
        super().__init__("admission queue full")
        self.retry_after = retry_after


class Draining(Exception):
    """The server is draining (SIGTERM / POST /v1/drain): no new
    admissions; clients get a clean 503 and should hit another replica."""


class Pending:
    #: write-protocol (see __init__ comment at ``lock``): the HTTP
    #: thread flags a timeout and the scheduler decides the outcome
    #: under ``serve.pending``; plain reads are advisory GIL-atomic
    #: snapshots the authoritative path re-checks under the lock
    timed_out: guarded_by("serve.pending", reads="racy")
    results: unguarded(
        "scheduler thread fills results before done.set(); waiters "
        "read only after done (Event ordering), streamers via stream_q"
    )

    def __init__(self, prompt: List[int], max_tokens: int,
                 prefix_op: str = "", stream: bool = False,
                 stop: Optional[List[List[int]]] = None,
                 want_logprobs: bool = False, n: int = 1,
                 adapter: int = 0, trace_id: str = "",
                 tenant: str = "", session_key: str = "",
                 resume_rid: Optional[int] = None):
        self.prompt = prompt
        self.max_tokens = max_tokens
        #: opaque caller-supplied key (``X-Session-Key``, minted by the
        #: fleet router per proxied request): a targeted
        #: ``/v1/sessions/export`` selects by it, and the export blob
        #: echoes it so the router matches blobs to in-flight streams
        self.session_key = session_key
        #: continuation of an imported session (``"resume": rid``):
        #: instead of admission prefill, the scheduler binds this
        #: pending to the already-parked engine state and resumes it
        self.resume_rid = resume_rid
        #: set when this request's session was exported off this
        #: replica: the terminal response carries the blob instead of
        #: tokens (outcome "migrated", never a 503)
        self.migrated: Optional[dict] = None
        #: the request's trace id (minted/accepted at HTTP admission);
        #: every span of this request's lifecycle carries it, and the
        #: root ``serve.request`` span uses ``span_id`` so children
        #: recorded earlier parent correctly
        self.trace_id = trace_id
        self.span_id = new_span_id() if trace_id else ""
        #: set when the engine samples this request's first token
        #: (admission prefill) — TTFT = first_token_at - t0
        self.first_token_at: Optional[float] = None
        self.stop = stop or []         # normalized token-id sequences
        self.want_logprobs = want_logprobs
        self.n = n                     # parallel samples (OpenAI "n")
        self.adapter = adapter         # LoRA adapter id (0 = base)
        #: tenant name from the X-Tenant header / "tenant" field; the
        #: scheduler binds the policy spec (class/weight/SLOs) at submit
        self.tenant = tenant
        self.spec: TenantSpec = DEFAULT_SPEC
        #: submit-order sequence number (FIFO tiebreak), stamped by the
        #: scheduler at submit
        self.seq = 0
        self.preemptions = 0           # times this request was parked
        # "register"/"drop" → not a completion: mutate the engine's
        # prefix cache on the scheduler thread (the engine owner)
        self.prefix_op = prefix_op
        self.done = threading.Event()
        self.rid_index: Dict[int, int] = {}    # engine rid → choice idx
        self.results: Dict[int, GenerationResult] = {}  # choice idx → r
        self.error: str = ""
        #: shed-specific Retry-After override (seconds); None = the
        #: handler's default (drain budget) — pressure sheds hint ONE
        #: decode round instead
        self.retry_after: Optional[float] = None
        # load-shedding/drain disposition ("" = normal): "drain" — was
        # queued when the drain started; "evicted" — in flight past the
        # drain budget (or parked state shed under KV-block pressure).
        # Either way the client gets a clean 503 and the metrics outcome
        # is "drained", never "error"/"ok".
        self.shed: str = ""
        self.timed_out = False        # set by the HTTP layer on 503,
        #                               or on a broken streaming socket
        # serializes the timeout decision against completion: the HTTP
        # thread may only flag timed_out while done is still unset (via
        # flag_timeout), and the scheduler decides the metrics outcome +
        # sets done under the same lock — so a request can never be
        # 503'd AND counted ok
        self.lock = named_lock("serve.pending")
        self.server_fault = False     # engine-side failure (HTTP 500),
        #                               vs a client mistake (HTTP 400)
        self.t0 = time.monotonic()
        self.t0_wall = time.time()    # span start timestamps
        # streaming: the scheduler pushes dict events after every decode
        # block ({"kind": "delta"/"final", "index": choice, ...}); a str
        # is a pre-admission error. ``sent`` tracks per-rid delivery.
        self.stream_q: Optional["queue.Queue"] = (
            queue.Queue() if stream else None
        )
        self.sent: Dict[int, int] = {}

    def flag_timeout(self) -> None:
        """Mark this request timed out / abandoned — unless it already
        completed, in which case the scheduler's ok-count stands and
        the flag stays clear. Every timeout writer (sync wait expiry,
        broken streaming socket) must come through here."""
        with self.lock:
            if not self.done.is_set():
                self.timed_out = True

    @property
    def result(self) -> Optional[GenerationResult]:
        """First choice (the n == 1 common case)."""
        return self.results.get(0)


class Scheduler(threading.Thread):
    """Owns the engine: admission, block decode, budgets, preemption,
    delivery.

    Also the serving plane's profiler: it owns every timestamp a
    request's latency decomposes into (queue wait, prefill, decode
    rounds, delivery), so TTFT/TPOT histograms (global and per tenant
    class), the per-round step-time and occupancy gauges, the KV-block
    gauges, and the per-request trace spans are all emitted from here.

    ``mode``: ``"continuous"`` (default) enables priority/fair-share
    admission, budget-trimmed rounds, and SLO preemption;
    ``"fixed"`` is the classic static-batching baseline the bench
    measures against (FIFO + head-of-line blocking, full-block rounds
    decoded past every budget — see the module docstring for how it
    relates to the loop this class replaced).
    """

    #: Retry-After hint on a 429 shed: one block decode is the natural
    #: re-try grain — by then the queue has moved
    shed_retry_after = 1.0

    # ---- thread model (slicecheck-verified): the run loop owns the
    # engine and ALL scheduling state below; the only cross-thread
    # writers come through queue/_control (both internally locked) or
    # the serve.submit critical section. External reads (stats(),
    # tests) are racy len()/int snapshots by design.
    _seq: guarded_by("serve.submit")
    _by_rid: unguarded("scheduler-thread owned (run loop owns the "
                       "engine); stats() reads are racy snapshots")
    _budget: unguarded("scheduler-thread owned; see _by_rid")
    _ready: unguarded("scheduler-thread owned; see _by_rid")
    _parked: unguarded("scheduler-thread owned; see _by_rid")
    _imports: unguarded("scheduler-thread owned: written only by "
                        "control ops drained on the run loop")
    preempted: unguarded("scheduler-thread ledger counter; external "
                         "reads are diagnostics")
    resumed: unguarded("scheduler-thread ledger counter")
    parked_shed: unguarded("scheduler-thread ledger counter")
    slo_misses: unguarded("scheduler-thread ledger counter")
    migrated_in: unguarded("scheduler-thread ledger counter")
    drain_deadline: unguarded(
        "single float written by drain() then read by the run loop; "
        "GIL-atomic, and draining.is_set() orders the handoff"
    )
    rounds_total: unguarded("scheduler-thread ledger counter (dispatch "
                            "rounds; the profiler ring reconciles "
                            "against it)")
    _round_timer: unguarded("scheduler-thread owned: the in-flight "
                            "round's anatomy timer (NOOP when the "
                            "profiler is disarmed)")
    _compile_watch: unguarded("scheduler-thread owned: polled at round "
                              "end only")

    def __init__(self, engine: ServingEngine, block_size: int = 16,
                 metrics=None, max_queue: int = 0,
                 drain_budget: float = 30.0, fault_hook=None,
                 tenants=None, mode: Optional[str] = None,
                 preempt_margin: float = 0.5,
                 overlap: Optional[bool] = None,
                 prefill_chunk_budget: Optional[int] = None):
        super().__init__(name="serve-scheduler", daemon=True)
        self.engine = engine
        self.block_size = block_size
        #: host/device overlap: dispatch each decode block, do the
        #: round's queue-pump/timeout-sweep host work while the device
        #: computes, then block on the tokens (engine
        #: decode_block_start/finish). Env TPUSLICE_ENGINE_OVERLAP=0
        #: restores the fully synchronous dispatch (the bench baseline).
        if overlap is None:
            overlap = os.environ.get(
                "TPUSLICE_ENGINE_OVERLAP", "1"
            ).lower() not in ("0", "false", "no")
        self.overlap = overlap
        #: chunk-scheduling bound: while a latency-class request is
        #: DECODING, an admission burst may add at most this many chunk
        #: rounds of prefill per scheduler round (longer prompts wait,
        #: shorter bursts ride along) — long prompts must not stall a
        #: latency tenant's TPOT for their whole prefill. 0 disables
        #: the bound. Env TPUSLICE_PREFILL_CHUNK_BUDGET.
        if prefill_chunk_budget is None:
            prefill_chunk_budget = int(os.environ.get(
                "TPUSLICE_PREFILL_CHUNK_BUDGET",
                str(max(2, block_size // 4)),
            ))
        self.prefill_chunk_budget = prefill_chunk_budget
        #: wall time when the previous engine dispatch landed — the
        #: engine.dispatch_gap observable (device-idle seam between
        #: rounds); None while the batch is empty
        self._last_dispatch_end: Optional[float] = None
        self.queue: "queue.Queue[Pending]" = queue.Queue()
        self.stop_flag = threading.Event()
        self._by_rid: Dict[int, Pending] = {}
        self._budget: Dict[int, int] = {}
        #: submitted-but-unadmitted requests, in arrival order; the
        #: admission pass reorders by (class, fair-share) each round —
        #: there is no FIFO head-of-line parking in continuous mode
        self._ready: List[Pending] = []
        #: preempted requests: engine rid → Pending (their engine-side
        #: state is parked in ``engine.parked`` under the same rid)
        self._parked: Dict[int, Pending] = {}
        if mode is None:
            mode = os.environ.get("TPUSLICE_SCHED_MODE", "continuous")
        if mode not in ("continuous", "fixed"):
            raise ValueError(
                f"mode must be 'continuous' or 'fixed', got {mode!r}"
            )
        self.mode = mode
        if tenants is None:
            tenants = os.environ.get("TPUSLICE_TENANTS", "")
        self.tenants: Dict[str, TenantSpec] = (
            parse_tenant_specs(tenants) if isinstance(tenants, str)
            else dict(tenants or {})
        )
        self.preempt_margin = preempt_margin
        #: per-tenant virtual time (weighted fair share inside a class)
        self._vtime: Dict[str, float] = {}
        self._vclock = 0.0
        self._seq = 0
        self.preempted = 0            # scheduler-side ledger (journal +
        self.resumed = 0              # metrics reconcile against these)
        self.parked_shed = 0
        self.slo_misses = 0
        # ---- fleet tier: live session migration (docs/SERVING.md
        # "Fleet router & session migration") ----
        #: monotonic birth — /v1/stats uptime_seconds (the router's
        #: restart detector, alongside REPLICA_ID)
        self.started_at = time.monotonic()
        #: control ops (session export/import) run ON the scheduler
        #: thread — it owns the engine — handed over via this queue and
        #: drained at the top of every round, drain rounds included
        #: (drain-with-migrate is exactly when exports must still run)
        self._control: "queue.Queue" = queue.Queue()
        #: imported-but-not-yet-resumed sessions: engine rid → binding
        #: metadata (remaining budget, streamed-token watermark, tenant)
        #: from the blob; a ``resume`` completion claims it. Swept
        #: after ``import_ttl`` so an orphaned import cannot hold KV
        #: blocks forever (env: TPUSLICE_IMPORT_TTL).
        self._imports: Dict[int, dict] = {}
        self.import_ttl = float(
            os.environ.get("TPUSLICE_IMPORT_TTL", "") or 60.0)
        #: crash hook: called (once) when an InjectedCrash kills this
        #: scheduler thread, so the owning ApiServer can sever its
        #: client connections like a dying process would
        #: (ApiServer.kill, docs/RECOVERY.md)
        self.on_fatal = None
        self.migrated_out = 0         # sessions exported off this
        self.migrated_in = 0          # replica / resumed onto it
        self.migrate_preempts = 0     # exports that parked a LIVE slot
        #                               (ledger: engine.preempted_total
        #                               == preempted + migrate_preempts)
        #: admission bound (0 = unbounded): past it, submit() sheds with
        #: 429 instead of queueing a request that would 503 at timeout.
        #: The lock makes bound-check + enqueue atomic across the HTTP
        #: threads (one per request): without it, C concurrent
        #: submitters could all pass the check and overshoot by C-1.
        self.max_queue = max_queue
        self._submit_lock = named_lock("serve.submit")
        self.drain_budget = drain_budget
        #: flipped by drain()/undrain(); while set, /readyz is 503, no
        #: admissions, queued requests shed, in-flight finish until the
        #: deadline then evict
        self.draining = threading.Event()
        self.drain_deadline = 0.0
        #: set once a drain has fully quiesced (no queue, no in-flight)
        self.drained = threading.Event()
        #: faults.scheduler_fault_hook seam: consulted once per loop
        #: round inside the round guard — an injected raise must never
        #: kill the serving thread
        self.fault_hook = fault_hook
        if metrics is None:
            from instaslice_tpu_torch.metrics.metrics import ServingMetrics

            metrics = ServingMetrics()
        self.metrics = metrics
        #: last-exported radix-cache counter snapshot: the engine keeps
        #: cumulative ints, Prometheus counters take deltas
        self._prefix_exported = {"hits": 0, "misses": 0,
                                 "inserted": 0, "evicted": 0}
        #: same delta discipline for the speculative-decoding ledger
        self._spec_exported = {"rounds": 0, "proposed": 0,
                               "accepted": 0}
        # ---- continuous profiler (obs/profiler.py, docs/
        # OBSERVABILITY.md "Profiling") ----
        self.profiler = get_profiler()
        #: dispatch rounds executed (idle wait-loops excluded) — the
        #: ledger the profiler ring + profile_rounds metric reconcile
        #: against
        self.rounds_total = 0
        #: the CURRENT round's anatomy timer; _admit_one/_admit_batch
        #: charge their prefill segments through it. NOOP between
        #: rounds and whenever the profiler is disarmed.
        self._round_timer = NOOP_TIMER
        #: mid-traffic kernel-build detector (CompileObserved journal
        #: reason); baselined after the engine's warm-up, grace-windowed
        #: for the lazy first-dispatch builds
        self._compile_watch = CompileWatch(engine)

    @property
    def _head(self) -> Optional[Pending]:
        """The oldest unadmitted request (diagnostics + the bounded-
        queue tests' visibility hook; admission itself no longer parks
        a head-of-line request)."""
        return self._ready[0] if self._ready else None

    def _bind_tenant(self, pending: Pending) -> None:
        spec = self.tenants.get(pending.tenant)
        if spec is None:
            # unknown tenants get the default class at weight 1 — a
            # tenant header is routing metadata, never a 400
            spec = DEFAULT_SPEC if not pending.tenant else TenantSpec(
                name=pending.tenant
            )
        pending.spec = spec

    def submit(self, pending: Pending) -> None:
        """Admit into the scheduler queue, or shed: :class:`Draining`
        while a drain is on (503), :class:`QueueFull` past the
        admission bound (429 + Retry-After). Shed requests are counted
        here — exactly one metrics outcome per request, always."""
        # prefix-cache mutations are not completions: they never enter
        # the outcome ledger (here or in _maybe_complete), so the
        # requests_total counters reconcile against completion traffic
        is_completion = not pending.prefix_op
        self._bind_tenant(pending)
        if self.draining.is_set():
            if is_completion:
                self.metrics.requests.labels(outcome="drained").inc()
                # one journal event per drained completion: the journal's
                # RequestDrained count reconciles EXACTLY with the
                # metrics outcome ledger (tests/test_serving_chaos.py)
                get_journal().emit(
                    "serving", reason=REASON_DRAINED,
                    message="rejected at admission: server draining (503)",
                    trace_id=pending.trace_id,
                )
            raise Draining("server draining")
        shed = False
        with self._submit_lock:
            if self.max_queue > 0 and (
                self.queue.qsize() + len(self._ready) >= self.max_queue
            ):
                shed = True
            else:
                pending.seq = self._seq = self._seq + 1
                self.queue.put(pending)
        if shed:
            # count + journal AFTER releasing the admission lock: the
            # journal's JSONL write is disk I/O, and overload (when
            # shedding fires) is exactly when submitters must not
            # serialize behind it
            if is_completion:
                self.metrics.requests.labels(outcome="shed").inc()
                get_journal().emit(
                    "serving", reason=REASON_SHED,
                    message=(f"admission queue full "
                             f"(max_queue={self.max_queue}): "
                             "shed with 429"),
                    trace_id=pending.trace_id,
                )
            raise QueueFull(self.shed_retry_after)

    # ------------------------------------------------------------ drain

    def drain(self, budget: Optional[float] = None) -> None:
        """Stop admission, flip readiness, let in-flight requests
        finish for ``budget`` seconds (default ``drain_budget``), then
        evict the rest with a clean 503. Idempotent; ``drained`` is set
        once fully quiesced."""
        budget_s = self.drain_budget if budget is None else budget
        with self._submit_lock:
            # check-and-set AND emit under the lock: SIGTERM and
            # POST /v1/drain arriving together must journal ONE
            # DrainBegin, and a racing undrain() must not invert the
            # Begin/End order (these two events are rare — unlike the
            # hot shed path, lock-held I/O is fine here)
            self.drain_deadline = time.monotonic() + budget_s
            self.drained.clear()
            already = self.draining.is_set()
            self.draining.set()
            if not already:
                get_journal().emit(
                    "serving", reason=REASON_DRAIN_BEGIN,
                    message=(f"drain started: admission stopped, "
                             f"in-flight requests get {budget_s:.1f}s"),
                )
        self.metrics.draining.set(1)

    def undrain(self) -> None:
        """Resume admission after a drain (rolling-restart aborted,
        readiness restored)."""
        with self._submit_lock:
            was_draining = self.draining.is_set()
            self.draining.clear()
            self.drained.clear()
            if was_draining:
                get_journal().emit(
                    "serving", reason=REASON_DRAIN_END,
                    message="drain cancelled: admission resumed",
                )
        self.metrics.draining.set(0)

    # -------------------------------------------- session migration ops

    def control(self, fn, timeout: float = 30.0):
        """Run ``fn`` ON the scheduler thread (the engine owner) and
        return its result to the calling (HTTP) thread. The migration
        endpoints come through here: export/import mutate engine state,
        and the engine is single-threaded by design."""
        res: dict = {"done": threading.Event()}
        self._control.put((fn, res))
        if not res["done"].wait(timeout):
            raise TimeoutError(
                "scheduler did not service the control op in "
                f"{timeout:.0f}s"
            )
        if "error" in res:
            raise res["error"]
        return res.get("value")

    def _run_control(self) -> None:
        """Drain pending control ops (top of every round — drain
        rounds included: drain-with-migrate exports exactly then)."""
        while True:
            try:
                fn, res = self._control.get_nowait()
            except queue.Empty:
                return
            try:
                res["value"] = fn()
            except Exception as e:  # noqa: BLE001 - relayed to caller
                log.warning("control op failed: %s", e)
                res["error"] = e
            res["done"].set()

    def migrate_out(self, session_key: Optional[str] = None,
                    limit: int = 0) -> int:
        """Export in-flight sessions off this replica (the drain-
        without-503 / rebalance primitive): preempt live slots, ship
        each session's parked stripe through its OWN in-flight HTTP
        response as a ``text_completion.migration`` terminal (the
        response IS the handoff — the router thread already holding
        both connections imports it into the destination and stitches
        the streams), then drop the source copy.

        Safety rules (docs/SERVING.md): only single-choice (n == 1)
        completions with ≥1 token of budget left migrate — n>1 forks
        share stripes and a spent request should just finish here;
        timed-out requests are already dead. ``session_key`` targets
        one session; ``limit`` bounds the count (rebalance moves one);
        0 = everything eligible. Returns sessions exported. Callers go
        through :meth:`control`."""
        eng = self.engine
        if getattr(eng, "_multiproc", False) or getattr(
                getattr(eng, "engine", None), "_multiproc", False):
            # check BEFORE preempting anything: export_session refuses
            # multi-process meshes, and preempt-then-fail would strand
            # every live request in parked state
            log.warning("migrate_out refused: sessions cannot be "
                        "exported off a multi-process mesh")
            return 0
        moved = 0
        candidates = [
            ("live", slot, req.request_id)
            for slot, req in sorted(eng.slots.items())
        ] + [("parked", None, rid) for rid in list(self._parked)]
        for kind, slot, rid in candidates:
            if limit and moved >= limit:
                break
            p = self._by_rid.get(rid)
            if p is None or p.prefix_op or p.n != 1 or p.timed_out:
                continue
            if session_key is not None and p.session_key != session_key:
                continue
            gen = (eng.slots[slot].generated if kind == "live"
                   else eng.parked[rid].req.generated)
            remaining = self._budget.get(rid, 0) - len(gen)
            if remaining < 1:
                continue        # about to finish: cheaper to let it
            try:
                if kind == "live":
                    eng.preempt_slot(slot)
            except Exception as e:  # noqa: BLE001 - keep serving
                log.warning("pre-export preempt of rid %d failed: %s",
                            rid, e)
                if eng.cache_poisoned():
                    self._recover_engine(e)
                continue
            if kind == "live":
                self.migrate_preempts += 1
            try:
                blob = eng.export_session(rid)
            except Exception as e:  # noqa: BLE001 - keep serving
                # the preempt LANDED: register the rid as ordinary
                # parked state so _resume_parked resumes it on this
                # replica — an export failure must degrade to "didn't
                # migrate", never to a stranded client (the engine
                # holds the stripe, the scheduler must keep the claim)
                log.warning("session export of rid %d failed: %s "
                            "(parking for normal resume)", rid, e)
                if eng.cache_poisoned():
                    self._recover_engine(e)
                if kind == "live" and rid in eng.parked:
                    self._parked[rid] = p
                continue
            blob["session_key"] = p.session_key
            blob["remaining_budget"] = remaining
            blob["sent"] = p.sent.get(rid, 0)
            blob["tenant"] = p.tenant
            blob["want_logprobs"] = p.want_logprobs
            blob["trace_id"] = p.trace_id
            # crash point (docs/RECOVERY.md): the blob exists but the
            # source copy still holds the session — a death here loses
            # the in-flight response; the router's migration timeout
            # falls the client back to re-prefill on a survivor
            maybe_crash("serve.export")
            # copy-then-delete: the blob exists (and is about to ride
            # the terminal response) before the source copy drops
            eng.drop_parked(rid)
            self._parked.pop(rid, None)
            self._by_rid.pop(rid, None)
            self._budget.pop(rid, None)
            self.migrated_out += 1
            get_journal().emit(
                "serving", reason=REASON_SESSION_EXPORTED,
                message=(f"session exported mid-stream "
                         f"({len(blob['generated'])} tokens in, "
                         f"{remaining} budget left, tenant "
                         f"{p.tenant or 'default'!r})"),
                trace_id=p.trace_id,
            )
            if p.trace_id:
                get_tracer().record(
                    "serve.migrate", 0.0, trace_id=p.trace_id,
                    parent_id=p.span_id, direction="out",
                )
            p.migrated = blob
            if p.stream_q is not None:
                p.stream_q.put({"kind": "migrated", "session": blob})
            self._maybe_complete(p)
            moved += 1
        return moved

    def import_session(self, blob: dict) -> int:
        """Control-op wrapper for the import endpoint: materialize the
        inbound session as parked engine state and remember the
        binding metadata until a ``resume`` completion claims it."""
        def op() -> int:
            rid = self.engine.import_session(blob)
            self._imports[rid] = {
                "budget": max(0, int(blob.get("remaining_budget", 0))),
                "sent": max(0, int(blob.get("sent", 0))),
                "tenant": str(blob.get("tenant", "") or ""),
                "want_logprobs": bool(blob.get("want_logprobs", False)),
                "trace_id": str(blob.get("trace_id", "") or ""),
                "ts": time.monotonic(),
            }
            get_journal().emit(
                "serving", reason=REASON_SESSION_IMPORTED,
                message=(f"session imported as rid {rid} "
                         f"({len(blob.get('generated', []))} tokens "
                         "in, awaiting resume)"),
                trace_id=str(blob.get("trace_id", "") or ""),
            )
            return rid

        return self.control(op)

    def _bind_resumes(self) -> None:
        """Bind ``resume`` completions to their imported sessions: the
        pending adopts the parked rid (budget, streamed-token
        watermark, tenant from the import metadata) and joins
        ``_parked`` — ``_resume_parked`` takes it from there with zero
        re-prefill."""
        for p in [p for p in self._ready if p.resume_rid is not None]:
            self._ready.remove(p)
            rid = p.resume_rid
            meta = self._imports.pop(rid, None)
            parked = self.engine.parked.get(rid)
            if meta is None or parked is None:
                p.error = (f"ValueError: no imported session {rid} "
                           "awaiting resume on this replica")
                if p.stream_q is not None:
                    p.stream_q.put(p.error)
                self.metrics.requests.labels(outcome="rejected").inc()
                self._record_request_span(p, "rejected")
                p.done.set()
                continue
            p.tenant = meta["tenant"]
            self._bind_tenant(p)
            p.want_logprobs = meta["want_logprobs"]
            p.prompt = list(parked.req.prompt)
            p.max_tokens = len(parked.req.generated) + meta["budget"]
            p.rid_index[rid] = 0
            p.sent[rid] = meta["sent"]
            # the first token was sampled on the SOURCE replica: TTFT
            # here is the migration gap, not a prefill wait
            p.first_token_at = time.monotonic()
            self._by_rid[rid] = p
            self._budget[rid] = p.max_tokens
            self._parked[rid] = p
            self.migrated_in += 1
            if p.trace_id:
                get_tracer().record(
                    "serve.migrate", 0.0, trace_id=p.trace_id,
                    parent_id=p.span_id, direction="in",
                )

    def _sweep_stale_imports(self) -> None:
        """An imported session nobody resumed holds KV blocks — drop
        it after ``import_ttl`` (the router retries the import or falls
        back to re-prefill; an orphan must not shrink the pool)."""
        if not self._imports:
            return
        now = time.monotonic()
        for rid, meta in list(self._imports.items()):
            if now - meta["ts"] > self.import_ttl:
                log.warning("dropping imported session %d: never "
                            "resumed within %.0fs", rid,
                            self.import_ttl)
                self.engine.drop_parked(rid)
                self._imports.pop(rid, None)

    def _fail_shed(self, p: Pending, shed: str, msg: str,
                   retry_after: Optional[float] = None) -> None:
        p.shed = shed
        p.retry_after = retry_after
        p.error = p.error or msg
        if p.stream_q is not None:
            p.stream_q.put(p.error)
        self._maybe_complete(p)

    def _shed_queued(self) -> None:
        """Draining: everything still queued gets its terminal 503 NOW
        — a queued request can only get worse by waiting out the drain."""
        self._pump()
        ready, self._ready = self._ready, []
        for p in ready:
            self._fail_shed(p, "drain",
                            "server draining: request not admitted")

    def _evict_for_drain(self) -> None:
        """Drain budget exhausted: in-flight requests — live slots AND
        parked preemptees — are evicted with a clean 503 (their tokens
        were never delivered)."""
        eng = self.engine
        for slot, req in list(eng.slots.items()):
            p = self._by_rid.pop(req.request_id, None)
            self._budget.pop(req.request_id, None)
            if p is None:
                continue
            eng.evict_slot(slot)
            self._fail_shed(p, "evicted",
                            "evicted: drain budget exceeded")
        for rid, p in list(self._parked.items()):
            self._drop_parked(rid, p, "evicted: drain budget exceeded")

    def _drop_parked(self, rid: int, p: Pending, msg: str) -> None:
        """Shed one parked request (drain eviction or KV pressure):
        blocks free NOW, client gets a clean 503."""
        self.engine.drop_parked(rid)
        self._parked.pop(rid, None)
        self._by_rid.pop(rid, None)
        self._budget.pop(rid, None)
        self.parked_shed += 1
        # NOT a drain: the eviction just freed blocks, so the right
        # client back-off is one decode round, not the drain budget
        self._fail_shed(p, "evicted", msg,
                        retry_after=self.shed_retry_after)

    # ------------------------------------------------------------- loop

    def run(self) -> None:
        from instaslice_tpu_torch.faults import InjectedCrash

        while not self.stop_flag.is_set():
            try:
                self._round()
            except InjectedCrash as e:
                # a crash point fired: this replica is dead — no drain,
                # no terminal responses. Tell the owning server to
                # sever its client connections (a dying process RSTs
                # them; clients classify the truncation) and die.
                log.warning("scheduler: %s — replica dying", e)
                self.stop_flag.set()
                hook, self.on_fatal = self.on_fatal, None
                if hook is not None:
                    try:
                        hook()
                    except Exception:  # noqa: BLE001 - dying anyway
                        log.warning("on_fatal hook raised",
                                    exc_info=True)
                return
            except Exception as e:  # noqa: BLE001 - keep serving
                # one bad round (injected fault, transient device error
                # outside the decode guard) must never kill the
                # scheduler thread — recover poisoned state, carry on
                log.exception("scheduler round failed: %s", e)
                if self.engine.cache_poisoned():
                    self._recover_engine(e)

    def _pump(self) -> None:
        """Move newly-submitted requests from the handoff queue into
        the admission list (under the submit lock so the bound check in
        :meth:`submit` counts exactly one population)."""
        with self._submit_lock:
            while True:
                try:
                    self._ready.append(self.queue.get_nowait())
                except queue.Empty:
                    return

    def _round(self) -> None:
        eng = self.engine
        if self.fault_hook is not None:
            self.fault_hook()   # may raise (injected); run() recovers
        # round-anatomy timer (obs/profiler.py): NOOP unless the
        # profiler is armed; _admit_one/_admit_batch charge prefill
        # time through self._round_timer
        pt = self.profiler.round_timer()
        self._round_timer = pt
        # migration control ops first, drain rounds included: a
        # drain-with-migrate exports exactly while draining
        with pt.seg("host"):
            self._run_control()
            self._sweep_stale_imports()
        if self.draining.is_set():
            # no admission; shed the queue, enforce the drain budget.
            # Parked preemptees are IN-FLIGHT work: the drain budget is
            # theirs too, so resume them into freeing slots instead of
            # letting resumable KV sit until the deadline 503
            with pt.seg("admission"):
                self._shed_queued()
            if self.mode == "continuous":
                with pt.seg("resume"):
                    self._resume_parked()
            if time.monotonic() >= self.drain_deadline:
                self._evict_for_drain()
            if not self._by_rid:
                self.drained.set()
        else:
            with pt.seg("host"):
                self._pump()
                self._bind_resumes()
                self._sweep_timeouts()
            if self.mode == "continuous":
                with pt.seg("resume"):
                    self._resume_parked()
                with pt.seg("preempt"):
                    self._relieve_block_pressure()
                    self._maybe_preempt()
            elif self._parked:
                # fixed mode never preempts, but migrated-in sessions
                # park on arrival and must still resume on the baseline
                with pt.seg("resume"):
                    self._resume_parked()
            with pt.seg("admission"):
                self._admit()
        with pt.seg("host"):
            # evict abandoned requests: the HTTP layer already 503'd
            # the client, so decoding the slot to its budget would burn
            # batch capacity producing tokens nobody reads
            for slot, req in list(eng.slots.items()):
                p = self._by_rid.get(req.request_id)
                if p is not None and p.timed_out:
                    eng.evict_slot(slot)
                    self._by_rid.pop(req.request_id, None)
                    self._budget.pop(req.request_id, None)
                    self._maybe_complete(p)
            for rid, p in list(self._parked.items()):
                if p.timed_out:
                    self._drop_parked(rid, p, "timed out while parked")
            # budget enforcement BEFORE decoding (add_request already
            # produced one token, so a max_tokens=1 arrival is done on
            # admission — decoding first would waste a batch-wide step
            # whose tokens get truncated away; same ordering rationale
            # as ServingEngine.generate())
            for slot, req in list(eng.slots.items()):
                b = self._budget.get(req.request_id)
                if b is not None and len(req.generated) >= b:
                    eng.finish_slot(slot, n_keep=b)
            self._deliver()
            self._export_kv_gauges()
        if not eng.slots:
            self._last_dispatch_end = None   # no dispatch to gap against
            # idle wait-loop, not a dispatch round: drop the timer so
            # quiesced serving leaks zero ring entries
            self._round_timer = NOOP_TIMER
            self.stop_flag.wait(0.005)
            return
        self.rounds_total += 1
        n = self._select_steps()
        spec = eng.draft_model is not None
        phase = "spec" if spec else "decode"
        round_rids = [r.request_id for r in eng.slots.values()]
        # spec rounds: plan this round's k ONCE (adaptive ladder +
        # budget/latency caps) so the headroom charge, the dispatch,
        # and a distributed engine's START broadcast all see the same
        # value; headroom charges up to k+1 tokens per slot per round
        # through KVBlockPool.blocks_for (growth_cost's shared math)
        spec_k = (eng.spec_plan_k(self._spec_budget_cap())
                  if spec else 0)
        self._ensure_block_headroom(spec_k + 1 if spec else max(1, n))
        use_overlap = self.overlap and (
            hasattr(eng, "spec_step_start") if spec
            else (n >= 1 and hasattr(eng, "decode_block_start"))
        )
        t_step = time.monotonic()
        self._observe_dispatch_gap(t_step)
        try:
            if spec:
                if use_overlap:
                    # same seam as decode_block_start/finish: the
                    # draft+verify chain computes (and its outputs
                    # stream back) while the host pumps the queue
                    with pt.seg("dispatch"):
                        eng.spec_step_start(k=spec_k)
                    with pt.seg("host"):
                        self._overlap_host_work()
                    self._finish_dispatch(pt, eng.spec_step_finish)
                else:
                    self._finish_dispatch(
                        pt, lambda: eng.spec_step(k=spec_k),
                        seg="dispatch",
                    )
            elif n >= 1:
                if use_overlap:
                    # host/device overlap: the block computes (and its
                    # token copy streams back) while the host does the
                    # next round's queue-pump/timeout planning — then
                    # block on the tokens
                    with pt.seg("dispatch"):
                        eng.decode_block_start(n)
                    with pt.seg("host"):
                        self._overlap_host_work()
                    self._finish_dispatch(pt, eng.decode_block_finish)
                else:
                    self._finish_dispatch(
                        pt, lambda: eng.decode_block(n),
                        seg="dispatch",
                    )
            else:
                self._finish_dispatch(pt, eng.step, seg="dispatch")
        except Exception as e:  # noqa: BLE001 - recover, keep serving
            log.exception("decode failed: %s", e)
            self._last_dispatch_end = None
            if eng.cache_poisoned():
                # the failed call poisoned the cache: every later
                # decode would refuse — reset the device state, fail
                # the in-flight requests, keep serving
                self._recover_engine(e)
        finally:
            self._observe_round(
                phase, time.monotonic() - t_step,
                spec_k + 1 if spec else n, round_rids,
            )
            self._finish_profile_round(pt, phase, spec, spec_k, n,
                                       round_rids)
            self._round_timer = NOOP_TIMER
        self._deliver()

    def _finish_dispatch(self, pt, fn, seg: str = "readback") -> None:
        """Run the blocking half of an engine dispatch and split its
        wall time at the device_get landing (engine
        ``last_dispatch_landed``): device-bound time goes to ``seg``,
        the host bookkeeping AFTER the tokens landed (chain stitching,
        spec EMA/ladder, _sync_tables) goes to ``host``. The landing —
        not fn's return — also anchors ``_last_dispatch_end``, so
        dispatch_gap_seconds measures true device idleness on the
        decode AND spec paths alike."""
        eng = self.engine
        t0 = time.monotonic()
        fn()
        t1 = time.monotonic()
        landed = eng.last_dispatch_landed
        if landed is None or not (t0 <= landed <= t1):
            landed = t1   # no readback this call (e.g. empty slots)
        pt.add(seg, t0, landed - t0)
        pt.add("host", landed, t1 - landed)
        self._last_dispatch_end = landed

    def _finish_profile_round(self, pt, phase: str, spec: bool,
                              spec_k: int, n: int,
                              round_rids: List[int]) -> None:
        """Close the round's anatomy record into the profiler ring
        (armed rounds only), feed the per-segment histograms, then poll
        the compile watch — a mid-traffic kernel build journals itself
        with this round's dispatch shape key."""
        pt.note(
            batch=len(round_rids),
            n_steps=(spec_k + 1 if spec else n),
            k=spec_k,
            rids=list(round_rids),
            trace_ids=[
                (p.trace_id if (p := self._by_rid.get(r)) is not None
                 else "")
                for r in round_rids
            ],
        )
        rec = self.profiler.finish_round(pt, phase=phase)
        if rec is not None:
            self.metrics.profile_rounds.inc()
            for name, total_ms in rec.seg_totals().items():
                self.metrics.round_segment_seconds.labels(
                    segment=name
                ).observe(total_ms / 1e3)
        shape_key = (f"phase={phase} k={spec_k}" if spec
                     else f"phase={phase} n_steps={n}")
        for c in self._compile_watch.check():
            get_journal().emit(
                "scheduler",
                reason=REASON_COMPILE_OBSERVED,
                object_ref=c["program"],
                message=(f"kernel library {c['program']} loaded "
                         f"mid-traffic ({shape_key}, "
                         f"{c['wall_ms']:.0f} ms build wall)"),
                program=c["program"],
                shape_key=shape_key,
                wall_ms=c["wall_ms"],
                count=c["count"],
            )
            self.profiler.event(
                "compile", c["program"], dur_ms=c["wall_ms"],
                shape_key=shape_key, count=c["count"],
            )

    def _observe_dispatch_gap(self, t_dispatch: float) -> None:
        """Device-idle seam between consecutive engine dispatches: all
        the host-side planning/delivery time the device spent waiting.
        The number batched prefill + overlap exist to shrink."""
        if self._last_dispatch_end is None:
            return
        gap = max(0.0, t_dispatch - self._last_dispatch_end)
        self.metrics.dispatch_gap_seconds.observe(gap)
        get_tracer().record("engine.dispatch_gap", gap * 1e3)

    def _overlap_host_work(self) -> None:
        """Host work safe to run while a decode block is in flight:
        nothing here may mutate engine state (the block's readback
        assumes the slot map it dispatched against), so it is queue
        plumbing and metrics only."""
        self._pump()
        self._sweep_timeouts()
        self._drain_prefill_occupancy()

    def _drain_prefill_occupancy(self) -> None:
        """Move the engine's per-dispatch batched-prefill occupancy
        samples into the histogram (engine code stays metrics-free)."""
        occ = getattr(self.engine, "_prefill_occ", None)
        if occ:
            for v in occ:
                self.metrics.prefill_batch_occupancy.observe(v)
            del occ[:]

    def _min_remaining_budget(self) -> Optional[int]:
        """Smallest remaining token budget among live requests this
        scheduler owns (None when it owns none) — at-budget slots were
        already removed this round, so the value is >= 1. THE shared
        round-trimming input for decode blocks AND spec rounds."""
        eng = self.engine
        owned = [
            r for r in eng.slots.values()
            if r.request_id in self._budget
        ]
        if not owned:
            return None
        return min(
            self._budget[r.request_id] - len(r.generated)
            for r in owned
        )

    def _latency_pressure(self) -> bool:
        """Someone LATENCY-sensitive is waiting — a queued
        latency-class request or a parked preemptee — so rounds
        shorten (their TTFT is bounded by the round length). A
        best-effort backlog keeps full rounds: shrinking for it would
        trade fleet throughput for latency nobody asked for. THE
        shared predicate for decode blocks AND spec rounds."""
        return bool(self._parked) or any(
            not p.prefix_op
            and class_rank(p.spec.tenant_class)
            == CLASS_RANK["latency"]
            for p in self._ready
        )

    def _select_steps(self) -> int:
        """This round's decode-block length. Continuous: trimmed to the
        smallest remaining budget (the freed slot readmits at the very
        next boundary) and shortened while requests wait so admission
        latency is a few steps. Fixed (the bench baseline): always the
        full block — requests that finish mid-round hold their slot to
        the round's end, which is exactly the waste continuous batching
        removes."""
        eng = self.engine
        n = self.block_size
        if self.mode == "continuous":
            budget = self._min_remaining_budget()
            if budget is not None:
                n = min(n, budget)
            if self._latency_pressure():
                n = min(n, max(1, self.block_size // 4))
        worst = max(
            len(r.prompt) + len(r.generated)
            for r in eng.slots.values()
        )
        n = min(n, eng.max_len - 2 - worst)
        # round DOWN to a power of two LAST (after the cache-headroom
        # clamp, or a slot nearing max_len would reintroduce arbitrary
        # step counts): each distinct n_steps is a separate compiled
        # scan, and budget-trimmed blocks would otherwise touch every
        # value in [1, block_size] — a bounded {1,2,4,8,...} set keeps
        # the compile cache warm while still never overshooting
        if self.mode == "continuous" and n > 1:
            n = 1 << (n.bit_length() - 1)
        return n

    def _spec_budget_cap(self) -> Optional[int]:
        """Emitted-token cap for the next spec round (None = no cap):
        the spec counterpart of :meth:`_select_steps`' trimming. A
        round emits up to k+1 tokens per slot, so the cap binds k at
        cap-1: the smallest remaining budget among live requests (the
        freed slot readmits at the next round boundary; spec overshoot
        past a budget is no longer structural), shortened while a
        latency-class request or a parked preemptee waits — their TTFT
        is bounded by the round length, exactly the decode path's
        rule. Fixed mode keeps full-depth rounds (the baseline must
        not change shape)."""
        if self.mode != "continuous":
            return None
        cap = self._min_remaining_budget()
        if self._latency_pressure():
            short = max(1, self.block_size // 4)
            cap = short if cap is None else min(cap, short)
        return cap

    def _ensure_block_headroom(self, n_steps: int) -> None:
        """Guarantee the pool covers this round's table growth: shed
        parked requests (newest, lowest class first) until the worst-
        case growth fits. Live tables alone can never exceed the pool
        (each slot is bounded by its row) — only parked state
        over-subscribes, and it is exactly the state with the weakest
        claim on the blocks."""
        eng = self.engine
        need = 0
        for req in eng.slots.values():
            t = eng._tables.get(req.request_id)
            if t is None:
                continue
            after = len(req.prompt) + len(req.generated) + n_steps
            # THE cost model is ensure()'s own (growth blocks + a
            # boundary copy-on-write only when genuinely shared) — a
            # hand-copied condition here would drift and either shed
            # parked clients needlessly or let ensure() raise mid-round
            need += eng.kv.growth_cost(t, after)
        # evictable radix-cache blocks satisfy headroom before any
        # parked client is shed: stale cache has the weakest claim of
        # all (the engine reclaims it inside the decode op's
        # _sync_tables, deterministically on every replica)
        if need <= eng.kv.free_blocks() + eng.radix.evictable_blocks():
            return
        for rid, p in sorted(
            self._parked.items(),
            key=lambda kv: (class_rank(kv[1].spec.tenant_class),
                            kv[1].t0),
            reverse=True,
        ):
            if need <= eng.kv.free_blocks():
                return
            self._drop_parked(
                rid, p,
                "evicted: kv block pressure while parked",
            )

    def _observe_round(self, phase: str, dt: float, n_steps: int,
                       rids: List[int]) -> None:
        """Profiler output for one engine dispatch: step-time histogram,
        prefill-vs-decode time split, and one ``serve.decode_round``
        span per participating request — every trace shows which rounds
        its tokens came from and what each cost."""
        self.metrics.step_seconds.labels(phase=phase).observe(dt)
        self.metrics.phase_seconds.labels(phase=phase).inc(dt)
        tracer = get_tracer()
        start = time.time() - dt
        seen = set()
        for rid in rids:
            p = self._by_rid.get(rid)
            if p is None or not p.trace_id or id(p) in seen:
                continue  # untraced (prefix op) or n>1 fork already done
            seen.add(id(p))
            tracer.record(
                "serve.decode_round", dt * 1e3, trace_id=p.trace_id,
                parent_id=p.span_id, start=start, phase=phase,
                n_steps=n_steps, batch=len(rids),
            )

    def _record_request_span(self, p: Pending, outcome: str) -> None:
        """The request's ROOT span, recorded at its terminal moment
        (assembled here rather than held open: the lifecycle crosses
        the HTTP and scheduler threads). Shed/timeout/drain requests
        get one too — a 429 must be traceable, not just counted."""
        if not p.trace_id:
            return
        get_tracer().record(
            "serve.request", (time.monotonic() - p.t0) * 1e3,
            trace_id=p.trace_id, span_id=p.span_id, start=p.t0_wall,
            error=p.error if outcome == "error" else "",
            outcome=outcome,
            tokens=sum(len(r.tokens) for r in p.results.values()),
        )

    # -------------------------------------------------------- admission

    def _sweep_timeouts(self) -> None:
        """Unadmitted requests past their HTTP deadline leave the
        admission list with the full ledger treatment — outcome counter
        AND latency observation (the slowest requests must not vanish
        from the histogram) AND root span; prefix ops stay out of the
        completion ledger like everywhere else."""
        keep: List[Pending] = []
        for p in self._ready:
            if not p.timed_out:
                keep.append(p)
                continue
            if not p.prefix_op:
                self.metrics.requests.labels(outcome="timeout").inc()
                from instaslice_tpu_torch.metrics.metrics import (
                    observe_with_exemplar,
                )

                observe_with_exemplar(
                    self.metrics.request_seconds,
                    time.monotonic() - p.t0,
                    trace_id=p.trace_id,
                )
                self._record_request_span(p, "timeout")
            p.done.set()
        self._ready = keep

    def _live_adapters(self) -> set:
        eng = self.engine
        return {
            eng._slot_adapter_host.get(s, 0) for s in eng.slots
        }

    def _admission_order(self) -> List[Pending]:
        """Continuous: (class rank, tenant virtual time, adapter
        affinity, arrival) — weighted fair share inside each priority
        class, with a bias toward adapters already decoding so each
        step runs fewer distinct LoRA deltas. Fixed: pure arrival
        order (the FIFO baseline). Prefix ops sort first either way —
        they are cheap engine mutations, not batch work."""
        if self.mode == "fixed":
            return sorted(self._ready,
                          key=lambda p: (0 if p.prefix_op else 1, p.seq))
        live = self._live_adapters()
        return sorted(
            self._ready,
            key=lambda p: (
                -1 if p.prefix_op else class_rank(p.spec.tenant_class),
                self._vtime.get(self._vtime_key(p), 0.0),
                0 if (p.adapter in live or not live) else 1,
                p.seq,
            ),
        )

    def _vtime_key(self, p: Pending) -> str:
        """Configured tenants get their own virtual clock; every
        unknown tenant shares one — X-Tenant is untrusted input, and a
        client cycling fresh names per request must not grow the dict
        (or dodge fair share) forever."""
        return p.tenant if p.tenant in self.tenants else ""

    def _charge(self, p: Pending) -> None:
        """Advance the tenant's virtual clock by the admitted work over
        its weight — start-time weighted fair queueing, floored at the
        global clock so an idle tenant cannot bank unbounded credit."""
        v = max(self._vtime.get(self._vtime_key(p), 0.0), self._vclock)
        self._vtime[self._vtime_key(p)] = v + max(
            1, p.max_tokens
        ) / max(p.spec.weight, 1e-6)
        self._vclock = v

    def _admit(self) -> None:
        """Admission dispatcher: continuous mode on a batched-prefill
        engine collects this round's admissible set and admits it as
        ONE burst (one dispatch chain — engine.add_requests; on a
        draft-carrying engine the target chunks batch and the draft
        rides per-row inside each round); fixed mode keeps the
        sequential per-request path (the FIFO baseline must not change
        shape)."""
        eng = self.engine
        if (self.mode != "continuous"
                or not getattr(eng, "batched_prefill", False)):
            self._admit_sequential()
            return
        batch: List[Pending] = []
        slots_left = eng.free_slots()
        # cached-but-unreferenced radix blocks count as free: the
        # engine reclaims them deterministically inside the admission
        # op, so planning must not refuse work the pool can take
        blocks_left = eng.kv.free_blocks() + eng.radix.evictable_blocks()
        rounds_needed = 0
        P = eng.prefill_len
        latency_live = any(
            vp is not None
            and class_rank(vp.spec.tenant_class) == CLASS_RANK["latency"]
            for r in eng.slots.values()
            for vp in (self._by_rid.get(r.request_id),)
        )
        for p in self._admission_order():
            if p.prefix_op:
                if not eng.free_slots():
                    continue
                self._ready.remove(p)
                self._do_prefix_op(p)
                continue
            # fail-fast a request the engine would REJECT (prompt too
            # long, bad adapter) BEFORE it can join — one invalid
            # request must 400 alone, not poison the all-or-nothing
            # burst for its co-admitted neighbors
            try:
                eng._check_prompt_fits(p.prompt)
                if not 0 <= p.adapter <= eng.n_adapters:
                    raise ValueError("adapter out of range")
            except ValueError:
                self._ready.remove(p)
                self._admit_one(p)      # its 400 path
                continue
            # THE shared admission cost model (engine.admit_block_cost):
            # a radix hit charges only its non-shared suffix, so a
            # burst of prompts sharing a cached prefix admits together
            # where the full-prompt charge would refuse most of it.
            # ONE tree walk per request per round: the match feeds the
            # cost, the evictable-supply reserve (locking the path
            # removes its blocks from what reclaim can free), and the
            # chunk-budget math below
            pref = (eng._match_prefix(p.prompt) if p.adapter == 0
                    else None)
            need = (eng.admit_block_cost(p.prompt, p.n, p.adapter,
                                         match=pref)
                    + eng.match_reserve(pref))
            if p.n > slots_left or need > blocks_left:
                continue
            n_chunks = -(-len(p.prompt) // P)
            if pref is not None:
                n_chunks -= pref.length // P
            if (latency_live and self.prefill_chunk_budget > 0
                    and batch
                    and n_chunks > max(self.prefill_chunk_budget,
                                       rounds_needed)):
                # chunk scheduling: a long prompt would extend this
                # round's prefill stall past the budget while a
                # latency-class request is decoding — it waits (and
                # goes first once it heads the order with nothing
                # admitted before it, so it cannot starve)
                continue
            rounds_needed = max(rounds_needed, n_chunks)
            slots_left -= p.n
            blocks_left -= need
            batch.append(p)
        if not batch:
            return
        for p in batch:
            self._ready.remove(p)
        if len(batch) == 1:
            # a lone admission keeps the sequential path (and its
            # trace shape: engine.prefill nested under serve.prefill)
            self._admit_one(batch[0])
        else:
            self._admit_batch(batch)

    def _do_prefix_op(self, p: Pending) -> None:
        """Prefix-cache mutation (register/drop) — not batch work; the
        engine call + error handling shared by both admission paths."""
        eng = self.engine
        try:
            if p.prefix_op == "register":
                eng.register_prefix(p.prompt)
            elif not eng.drop_prefix(p.prompt):
                p.error = "ValueError: no such prefix"
        except Exception as e:
            p.error = f"{type(e).__name__}: {e}"
            # surfaced to the client via p.error, but the
            # server log must show engine-side failures too
            log.warning("prefix %s failed: %s", p.prefix_op, p.error)
            # register_prefix prefills: a device failure there
            # poisons the cache
            if eng.cache_poisoned():
                p.server_fault = True
                self._recover_engine(e)
        p.done.set()

    def _admit_batch(self, batch: List[Pending]) -> None:
        """Admit a collected burst through engine.add_requests — one
        dispatch chain, every request's first token sampled at its
        end. Ledger treatment mirrors _admit_one per request."""
        eng = self.engine
        tracer = get_tracer()
        t_admit = time.monotonic()
        for p in batch:
            if p.trace_id:
                tracer.record(
                    "serve.queue", (t_admit - p.t0) * 1e3,
                    trace_id=p.trace_id, parent_id=p.span_id,
                    start=p.t0_wall,
                )
        try:
            with self._round_timer.seg("prefill"):
                rid_lists = eng.add_requests([
                    AdmissionRequest(p.prompt, p.n, p.stop, p.adapter)
                    for p in batch
                ])
        except Exception as e:  # noqa: BLE001 - keep serving
            # the all-or-nothing burst failed (device error, injected
            # fault): recover any poisoned cache, then retry each
            # request ALONE so accounting is per request (a transient
            # mid-burst must not 500 every co-admitted client; the
            # requests re-record their queue spans — rare enough)
            log.warning("batched admission failed (%s); retrying "
                        "per-request", e)
            if eng.cache_poisoned():
                self._recover_engine(e)
            for p in batch:
                # re-check capacity per request: a recovery (or a
                # transient) may have changed what fits, and a request
                # that could simply wait a round must re-queue, not 500
                if eng.can_admit(p.prompt, p.n, p.adapter):
                    self._admit_one(p)
                else:
                    self._ready.append(p)
            return
        dt = time.monotonic() - t_admit
        # admission prefill IS an engine dispatch: anchor the gap here
        # or the whole burst's device compute would read as host idle
        self._last_dispatch_end = time.monotonic()
        self._compile_watch.mark_traffic()
        self._round_timer.bump("admitted", len(batch))
        self.metrics.step_seconds.labels(phase="prefill").observe(dt)
        self.metrics.phase_seconds.labels(phase="prefill").inc(dt)
        self._drain_prefill_occupancy()
        now = time.monotonic()
        for p, rids in zip(batch, rid_lists):
            p.first_token_at = now
            if p.trace_id:
                tracer.record(
                    "serve.prefill", dt * 1e3, trace_id=p.trace_id,
                    parent_id=p.span_id, tokens=len(p.prompt), n=p.n,
                    batched=len(batch),
                )
            self._charge(p)
            for i, rid in enumerate(rids):
                p.rid_index[rid] = i
                self._by_rid[rid] = p
                self._budget[rid] = p.max_tokens

    def _admit_sequential(self) -> None:
        eng = self.engine
        for p in self._admission_order():
            if p.prefix_op:
                # register needs a free slot to prefill through
                if not eng.free_slots():
                    if self.mode == "fixed":
                        break
                    continue
                # leave _ready BEFORE the engine call: an in-flight
                # admission no longer occupies a queue position, so
                # the max_queue bound counts exactly the waiting set
                # (the pre-scheduler semantics the shed tests pin)
                self._ready.remove(p)
                self._do_prefix_op(p)
                continue
            pref = (eng._match_prefix(p.prompt) if p.adapter == 0
                    else None)
            if not eng.can_admit(p.prompt, p.n, p.adapter, match=pref):
                # a request the engine would REJECT (prompt too long
                # for the cache) must fail fast with its 400, not
                # starve behind a block gate until the HTTP timeout
                try:
                    eng._check_prompt_fits(p.prompt)
                except ValueError:
                    self._ready.remove(p)
                    self._admit_one(p)    # raises inside → 400 path
                    continue
                if self.mode == "fixed":
                    break   # head-of-line blocking: the FIFO baseline
                continue    # a smaller/later request may still fit
            self._ready.remove(p)
            self._admit_one(p)

    def _admit_one(self, p: Pending) -> None:
        eng = self.engine
        tracer = get_tracer()
        t_admit = time.monotonic()
        if p.trace_id:
            # queue-wait span: submit → the moment a slot freed
            tracer.record(
                "serve.queue", (t_admit - p.t0) * 1e3,
                trace_id=p.trace_id, parent_id=p.span_id,
                start=p.t0_wall,
            )
        try:
            with tracer.span(
                "serve.prefill", trace_id=p.trace_id or None,
                parent_id=p.span_id or None,
                tokens=len(p.prompt), n=p.n,
            ), self._round_timer.seg("prefill"):
                rids = eng.add_request_n(p.prompt, p.n,
                                         stop=p.stop,
                                         adapter=p.adapter)
            dt_admit = time.monotonic() - t_admit
            p.first_token_at = time.monotonic()
            # admission prefill is an engine dispatch (gap anchor)
            self._last_dispatch_end = p.first_token_at
            self._compile_watch.mark_traffic()
            self._round_timer.bump("admitted")
            self.metrics.step_seconds.labels(
                phase="prefill"
            ).observe(dt_admit)
            self.metrics.phase_seconds.labels(
                phase="prefill"
            ).inc(dt_admit)
        except Exception as e:
            p.error = f"{type(e).__name__}: {e}"
            # client mistakes are the client's problem (400,
            # below); an engine-side admission failure must
            # also land in the server log, not just the 500
            if not isinstance(e, (ValueError, TypeError)):
                log.warning("admission failed: %s", p.error)
            # ValueError/TypeError = the client's prompt was
            # bad (too long, empty, unknown adapter) → 400 +
            # outcome "rejected". ANYTHING else (device error,
            # injected fault, transient host failure) is the
            # server's problem → 500 + outcome "error" — a
            # transient engine failure must never be pinned on
            # the client
            client_mistake = isinstance(e, (ValueError, TypeError))
            p.server_fault = not client_mistake
            self.metrics.requests.labels(
                outcome="rejected" if client_mistake else "error"
            ).inc()
            # a device-side failure mid-prefill poisons the
            # cache (a stripe may be half written), and
            # without recovery every later device call
            # refuses
            if eng.cache_poisoned():
                self._recover_engine(e)
            if p.stream_q is not None:
                p.stream_q.put(p.error)
            self._record_request_span(
                p, "rejected" if client_mistake else "error"
            )
            p.done.set()
            return
        self._charge(p)
        for i, rid in enumerate(rids):
            p.rid_index[rid] = i
            self._by_rid[rid] = p
            self._budget[rid] = p.max_tokens

    # ------------------------------------------------- preempt / resume

    def _resume_parked(self) -> None:
        """Un-park preempted requests as slots free — best class first,
        then longest-parked. A resumed request was already admitted
        once, so it outranks everything still in the queue."""
        if not self._parked:
            return
        eng = self.engine
        # a latency-class waiter past its preempt margin has first
        # claim on freed slots: resuming a lower-class preemptee into
        # one would just re-park it next round — a stripe-transfer
        # ping-pong that serves nobody
        waiters = self._preempt_waiters()
        for rid, p in sorted(
            self._parked.items(),
            key=lambda kv: (class_rank(kv[1].spec.tenant_class),
                            kv[1].t0),
        ):
            if not eng.free_slots():
                return
            if waiters and class_rank(p.spec.tenant_class) \
                    > CLASS_RANK["latency"]:
                continue
            try:
                eng.resume_request(rid)
            except Exception as e:  # noqa: BLE001 - keep serving
                # a failed resume (injected fault mid stripe-write)
                # must not wedge the parked request forever: fail it
                # cleanly and recover any poisoned cache
                log.warning("resume of rid %d failed: %s", rid, e)
                if eng.cache_poisoned():
                    self._recover_engine(e)
                self._drop_parked(rid, p, f"resume failed: {e}")
                continue
            self._parked.pop(rid, None)
            self.resumed += 1
            self.metrics.resumes.inc()
            get_journal().emit(
                "serving", reason=REASON_RESUMED,
                message=(f"resumed after {p.preemptions} preemption(s) "
                         f"(tenant {p.tenant or 'default'!r}, class "
                         f"{p.spec.tenant_class})"),
                trace_id=p.trace_id,
            )
            if p.trace_id:
                get_tracer().record(
                    "serve.resume", 0.0, trace_id=p.trace_id,
                    parent_id=p.span_id,
                )

    def _relieve_block_pressure(self) -> None:
        """A latency-class waiter past its preempt margin that cannot
        admit for lack of BLOCKS (slots may well be free — this must
        not hide behind the slot-preemption path): shed parked
        lower-class requests, newest first, until its blocks exist.
        Without this the waiter would livelock — parked state holds
        the pool, resume refuses to hand it a slot, and nothing else
        sheds parked blocks when no live slot needs growth."""
        waiters = self._preempt_waiters()
        if not waiters or not self._parked:
            return
        eng = self.engine
        waiter = min(
            waiters,
            key=lambda p: (self._vtime.get(self._vtime_key(p), 0.0),
                           p.seq),
        )
        m = (eng._match_prefix(waiter.prompt) if waiter.adapter == 0
             else None)
        need = (eng.admit_block_cost(waiter.prompt, 1, waiter.adapter,
                                     match=m)
                + eng.match_reserve(m))
        if eng.kv.free_blocks() + eng.radix.evictable_blocks() >= need:
            return
        for rid, p in sorted(
            self._parked.items(),
            key=lambda kv: (class_rank(kv[1].spec.tenant_class),
                            kv[1].t0),
            reverse=True,
        ):
            if class_rank(p.spec.tenant_class) \
                    <= class_rank(waiter.spec.tenant_class):
                break
            self._drop_parked(
                rid, p,
                "evicted: kv block pressure from a latency-class "
                "admission",
            )
            if eng.kv.free_blocks() >= need:
                return

    def _preempt_waiters(self) -> List[Pending]:
        """Latency-class completions that have waited past the preempt
        margin of their TTFT target and still can't admit. Multi-choice
        requests (n > 1) deliberately don't qualify: preemption frees
        ONE slot per round, and n-way admission is all-or-nothing — an
        n>1 latency request rides ordinary class-ordered admission and
        forgoes preemption (documented in docs/SERVING.md)."""
        now = time.monotonic()
        return [
            p for p in self._ready
            if not p.prefix_op and not p.timed_out and p.n == 1
            and class_rank(p.spec.tenant_class) == CLASS_RANK["latency"]
            and p.spec.ttft_slo > 0
            and now - p.t0 > self.preempt_margin * p.spec.ttft_slo
        ]

    def _maybe_preempt(self) -> None:
        """SLO-aware preemption: park the newest lowest-class live
        request so a latency-class request about to miss its TTFT
        target gets the slot. One preemption per round — the margin
        check re-fires next round if the pressure persists."""
        eng = self.engine
        waiters = self._preempt_waiters()
        if not waiters or eng.free_slots():
            return
        waiter = min(
            waiters,
            key=lambda p: (self._vtime.get(self._vtime_key(p), 0.0),
                           p.seq),
        )
        # preemption frees a SLOT, never blocks (the victim parks with
        # its table): when the waiter is still block-starved after
        # _relieve_block_pressure, parking someone cannot admit it
        wm = (eng._match_prefix(waiter.prompt) if waiter.adapter == 0
              else None)
        if (eng.kv.free_blocks() + eng.radix.evictable_blocks()
                < eng.admit_block_cost(waiter.prompt, 1,
                                       waiter.adapter, match=wm)
                + eng.match_reserve(wm)):
            return
        victims = [
            (slot, vp) for slot, req in eng.slots.items()
            for vp in (self._by_rid.get(req.request_id),)
            if vp is not None and vp.n == 1
            and class_rank(vp.spec.tenant_class)
            > class_rank(waiter.spec.tenant_class)
        ]
        if not victims:
            return
        slot, vp = max(
            victims,
            key=lambda sv: (class_rank(sv[1].spec.tenant_class),
                            sv[1].t0),
        )
        try:
            rid = eng.preempt_slot(slot)
        except Exception as e:  # noqa: BLE001 - keep serving
            log.warning("preempt of slot %d failed: %s", slot, e)
            if eng.cache_poisoned():
                self._recover_engine(e)
            return
        vp.preemptions += 1
        self._parked[rid] = vp
        self.preempted += 1
        self.metrics.preemptions.inc()
        get_journal().emit(
            "serving", reason=REASON_PREEMPTED,
            message=(f"parked (class {vp.spec.tenant_class}) so a "
                     f"latency-class request makes its "
                     f"{waiter.spec.ttft_slo:.2f}s TTFT target"),
            trace_id=vp.trace_id,
        )
        if vp.trace_id:
            get_tracer().record(
                "serve.preempt", 0.0, trace_id=vp.trace_id,
                parent_id=vp.span_id,
            )

    # --------------------------------------------------------- delivery

    def _recover_engine(self, e: Exception) -> None:
        """Reset poisoned device state and fail every in-flight request
        whose KV went with the old cache (500s, not silent drops).
        Parked stripes are independent copies and survive."""
        log.warning("recovering engine after device failure: %s", e)
        for rid in self.engine.recover():
            p = self._by_rid.pop(rid, None)
            self._budget.pop(rid, None)
            if p is None:
                continue
            p.server_fault = True
            p.error = p.error or (
                "engine recovered after device failure: "
                f"{type(e).__name__}: {e}"
            )
            if p.stream_q is not None:
                p.stream_q.put(p.error)
            self._maybe_complete(p)

    def _observe_slo(self, p: Pending, now: float) -> None:
        """Per-class latency histograms + the SLO-miss ledger, emitted
        once at the request's successful completion."""
        cls = p.spec.tenant_class
        tokens = sum(len(r.tokens) for r in p.results.values())
        ttft = tpot = None
        if p.first_token_at is not None:
            ttft = p.first_token_at - p.t0
            self.metrics.class_ttft_seconds.labels(
                tenant_class=cls
            ).observe(ttft)
            if tokens > 1:
                tpot = (now - p.first_token_at) / (tokens - 1)
                self.metrics.class_tpot_seconds.labels(
                    tenant_class=cls
                ).observe(tpot)
        missed = []
        if p.spec.ttft_slo > 0 and ttft is not None \
                and ttft > p.spec.ttft_slo:
            missed.append(("ttft", ttft, p.spec.ttft_slo))
        if p.spec.tpot_slo > 0 and tpot is not None \
                and tpot > p.spec.tpot_slo:
            missed.append(("tpot", tpot, p.spec.tpot_slo))
        for kind, actual, target in missed:
            self.slo_misses += 1
            self.metrics.slo_missed.labels(
                tenant_class=cls, slo=kind
            ).inc()
            get_journal().emit(
                "serving", reason=REASON_SLO_MISSED,
                message=(f"{kind} {actual:.3f}s exceeded the "
                         f"{target:.3f}s target (tenant "
                         f"{p.tenant or 'default'!r}, class {cls})"),
                trace_id=p.trace_id,
            )

    def _maybe_complete(self, p: Pending) -> None:
        """Finalize a pending once NONE of its engine rids are live:
        metrics count the HTTP request once, waiters wake once."""
        if p.done.is_set():
            return
        if any(rid in self._by_rid for rid in p.rid_index):
            return
        if p.prefix_op:
            # prefix-cache mutations stay out of the completion ledger
            # (their normal path completes inline in _admit, uncounted
            # — counting only the shed ones would skew reconciliation)
            with p.lock:
                p.done.set()
            return
        # a request the HTTP layer already 503'd must not read as a
        # success on the dashboard — the client never got the tokens.
        # Outcome read + done.set() are atomic under p.lock so the HTTP
        # thread's expiring wait cannot interleave (503 counted as ok).
        with p.lock:
            outcome = ("migrated" if p.migrated is not None
                       else "timeout" if p.timed_out
                       else "drained" if p.shed
                       else "error" if p.error else "ok")
            self.metrics.requests.labels(outcome=outcome).inc()
            if outcome == "drained":
                # queued-shed and budget-evicted requests: same journal
                # ledger as the submit-time drain rejections above
                get_journal().emit(
                    "serving", reason=REASON_DRAINED,
                    message=p.error or "drained",
                    trace_id=p.trace_id,
                )
            from instaslice_tpu_torch.metrics.metrics import (
                observe_with_exemplar,
            )

            now = time.monotonic()
            observe_with_exemplar(
                self.metrics.request_seconds, now - p.t0,
                trace_id=p.trace_id,
            )
            if p.first_token_at is not None:
                observe_with_exemplar(
                    self.metrics.ttft_seconds, p.first_token_at - p.t0,
                    trace_id=p.trace_id,
                )
                tokens = sum(len(r.tokens) for r in p.results.values())
                if outcome == "ok" and tokens > 1:
                    # mean inter-token gap over the decode phase: the
                    # per-request TPOT the client experienced
                    self.metrics.tpot_seconds.observe(
                        (now - p.first_token_at) / (tokens - 1)
                    )
            if outcome == "ok":
                self._observe_slo(p, now)
            self._record_request_span(p, outcome)
            p.done.set()

    def _export_kv_gauges(self) -> None:
        """The block-pool gauges cost a full table scan (cow count) —
        refreshed once per round, not in every _deliver call."""
        eng = self.engine
        self.metrics.kv_cache_utilization.set(eng.kv_utilization())
        self._drain_prefill_occupancy()
        kv = eng.kv_stats()
        self.metrics.kv_blocks_free.set(kv["free"])
        self.metrics.kv_blocks_used.set(kv["used"])
        self.metrics.kv_blocks_cow.set(kv["cow"])
        self.metrics.kv_blocks_prefix.set(kv.get("prefix_blocks", 0))
        # radix-cache ledger: engine counters are cumulative, the
        # Prometheus counters get the per-round delta
        snap = {"hits": eng.prefix_hits, "misses": eng.prefix_misses,
                "inserted": eng.prefix_inserted,
                "evicted": eng.prefix_evicted}
        for key, metric in (("hits", self.metrics.prefix_hits),
                            ("misses", self.metrics.prefix_misses),
                            ("inserted", self.metrics.prefix_inserted),
                            ("evicted", self.metrics.prefix_evicted)):
            delta = snap[key] - self._prefix_exported[key]
            if delta > 0:
                metric.inc(delta)
        self._prefix_exported = snap
        if eng.draft_model is not None:
            sp = {"rounds": eng.spec_rounds,
                  "proposed": eng.spec_proposed,
                  "accepted": eng.spec_accepted}
            for key, metric in (
                ("rounds", self.metrics.spec_rounds),
                ("proposed", self.metrics.spec_proposed),
                ("accepted", self.metrics.spec_accepted),
            ):
                delta = sp[key] - self._spec_exported[key]
                if delta > 0:
                    metric.inc(delta)
            self._spec_exported = sp
            # per-round acceptance-rate samples (engine code stays
            # metrics-free, like the prefill-occupancy drain)
            samples = getattr(eng, "_spec_rate_samples", None)
            if samples:
                for v in samples:
                    self.metrics.spec_acceptance.observe(v)
                del samples[:]

    def _deliver(self) -> None:
        eng = self.engine
        self.metrics.queue_depth.set(
            self.queue.qsize() + len(self._ready)
        )
        self.metrics.live_slots.set(len(eng.slots))
        self.metrics.batch_occupancy.set(
            len(eng.slots) / max(1, eng.max_batch)
        )
        # stream incremental tokens for live slots (capped at the
        # request budget so a truncated tail is never streamed)
        for req in eng.slots.values():
            p = self._by_rid.get(req.request_id)
            if p is None or p.stream_q is None:
                continue
            have = len(req.generated)
            if p.stop:
                # hold back the longest-stop-minus-one tail: those
                # tokens could still become part of a stop match
                # spanning the next block and be truncated away
                have -= max(len(s) for s in p.stop) - 1
            b = self._budget.get(req.request_id)
            if b is not None:
                have = min(have, b)
            sent = p.sent.get(req.request_id, 0)
            if have > sent:
                p.stream_q.put({
                    "kind": "delta",
                    "index": p.rid_index[req.request_id],
                    "tokens": list(req.generated[sent:have]),
                    "logprobs": list(req.logprobs[sent:have]),
                })
                p.sent[req.request_id] = have
        keep: List[GenerationResult] = []
        for r in eng.finished:
            p = self._by_rid.pop(r.request_id, None)
            if p is None:
                keep.append(r)        # not ours (direct engine use)
                continue
            b = self._budget.pop(r.request_id, None)
            if b is not None and len(r.tokens) > b:
                r.tokens = r.tokens[:b]
                r.logprobs = r.logprobs[:b]
                # the cut can drop the evidence the engine finished on —
                # the client-visible reason must describe the tokens it
                # got: a dropped eos, or a stop match that sat beyond
                # the budget (stop matches at the original length since
                # the match itself is excluded), read as plain budget
                # exhaustion
                if (r.finished_reason == "stop"
                        or (r.finished_reason == "eos"
                            and self.engine.eos_id not in r.tokens)):
                    r.finished_reason = "max_new_tokens"
            idx = p.rid_index[r.request_id]
            p.results[idx] = r
            if not p.timed_out:
                self.metrics.tokens.inc(len(r.tokens))
            if p.stream_q is not None:
                sent = p.sent.get(r.request_id, 0)
                if len(r.tokens) > sent:
                    p.stream_q.put({
                        "kind": "delta", "index": idx,
                        "tokens": list(r.tokens[sent:]),
                        "logprobs": list(r.logprobs[sent:]),
                    })
                    p.sent[r.request_id] = len(r.tokens)
                p.stream_q.put({"kind": "final", "index": idx,
                                "result": r})
            self._maybe_complete(p)
        eng.finished = keep

    def stats(self) -> dict:
        eng = self.engine
        out = {
            # fleet-router inputs: a stable per-process identity plus a
            # monotonic age — the router's staleness/restart detector
            # (a rebooted replica has a new nonce and a reset clock,
            # and its advertised prefixes and sessions died with it)
            "replica_id": REPLICA_ID,
            "uptime_seconds": round(
                time.monotonic() - self.started_at, 3
            ),
            "live_slots": len(eng.slots),
            "free_slots": eng.free_slots(),
            "draining": self.draining.is_set(),
            "max_queue": self.max_queue,
            "queued": self.queue.qsize() + len(self._ready),
            "tokens_generated": eng.tokens_generated,
            "max_batch": eng.max_batch,
            "max_len": eng.max_len,
            "speculative": eng.draft_model is not None,
            "spec": (eng.spec_stats()
                     if hasattr(eng, "spec_stats")
                     else {"enabled": False}),
            "mesh": dict(eng.mesh.shape) if eng.mesh is not None else None,
            "prefixes": len(eng.prefixes),
            "prefix_hits": eng.prefix_hits,
            "prefix_tokens_saved": eng.prefix_tokens_saved,
            # the radix block gains "digest": hashed hot-prefix chains
            # the fleet router shadow-indexes for prefix-affine routing
            "radix": dict(
                (eng.radix_stats()
                 if hasattr(eng, "radix_stats") else {}),
                **({"digest": eng.radix_digest()}
                   if hasattr(eng, "radix_digest") else {}),
            ),
            "mode": self.mode,
            "overlap": self.overlap,
            "engine": {
                "batched_prefill": getattr(eng, "batched_prefill",
                                           False),
                "adapter_fastpath": getattr(eng, "adapter_fastpath",
                                            False),
                "prefill_batches": getattr(eng, "prefill_batches", 0),
                "prefill_rows": getattr(eng, "prefill_rows", 0),
                "prefill_pad_rows": getattr(eng, "prefill_pad_rows", 0),
                "fastpath_rounds": getattr(eng, "fastpath_rounds", 0),
                "gathered_rounds": getattr(eng, "gathered_rounds", 0),
                "compiled_programs": (
                    eng.compiled_programs()
                    if hasattr(eng, "compiled_programs") else {}
                ),
                # the port's: "B1", or "plain (why)" where the decode
                # attention of this model runs without a kernel
                "attention_route": eng.attention_route(),
                # the port's: what runs decode blocks and spec rounds
                # ("cuda graphs" or "eager (why)"), the captured graphs
                # by form against compile_budget, capture seconds
                "decode_graphs": eng.graph_stats(),
            },
            "parked": len(self._parked),
            "preempted": self.preempted,
            "resumed": self.resumed,
            "parked_shed": self.parked_shed,
            "slo_misses": self.slo_misses,
            # live-migration ledger (router + bench reconcile on it)
            "sessions": {
                "exported": getattr(eng, "exported_total", 0),
                "imported": getattr(eng, "imported_total", 0),
                "migrated_out": self.migrated_out,
                "migrated_in": self.migrated_in,
                "migrate_preempts": self.migrate_preempts,
                "imports_pending": len(self._imports),
            },
            "kv": eng.kv_stats(),
            "tenant_classes": {
                name: s.tenant_class for name, s in self.tenants.items()
            },
            # continuous-profiler ledger: rounds_total counts every
            # dispatch round; armed rounds land in the profiler ring
            # (rounds_recorded) — equal while armed from round 0
            "profile": {
                "armed": self.profiler.armed,
                "rounds_total": self.rounds_total,
                "rounds_recorded": self.profiler.rounds_recorded,
                "events_recorded": self.profiler.events_recorded,
            },
        }
        return out
