"""The serving plane's flight-recorder ``reason`` catalog.

A copy of the serving reasons of ``instaslice_tpu/api/constants.py``
(the ones the scheduler, the profiler and the journal of the port emit;
the session-migration reasons are left out with the migration path):
the port imports nothing of the JAX package. Every journal event names
its reason from HERE, so dashboards and validators keyed on the
reference's catalog read the port's events unchanged.
"""

# serving data plane
REASON_DRAIN_BEGIN = "DrainBegin"
REASON_DRAIN_END = "DrainEnd"
REASON_SHED = "RequestShed"
REASON_DRAINED = "RequestDrained"

# serving scheduler (serving/scheduler.py): SLO-aware preemption. A
# best-effort request parked so a latency-class request makes its TTFT
# target; Resumed when a slot frees, SLOMissed when a completed
# request's TTFT/TPOT exceeded its tenant class target.
REASON_PREEMPTED = "RequestPreempted"
REASON_RESUMED = "RequestResumed"
REASON_SLO_MISSED = "SLOMissed"

# continuous profiler (obs/profiler.py): a kernel library built or
# loaded OUTSIDE the warm window (and past the traffic grace) announces
# itself with the library name, the dispatch shape key, and the build
# wall ms.
REASON_COMPILE_OBSERVED = "CompileObserved"

#: every reason the port's journal accepts without a warning
EVENT_REASONS = frozenset({
    REASON_DRAIN_BEGIN, REASON_DRAIN_END, REASON_SHED, REASON_DRAINED,
    REASON_PREEMPTED, REASON_RESUMED, REASON_SLO_MISSED,
    REASON_COMPILE_OBSERVED,
})
