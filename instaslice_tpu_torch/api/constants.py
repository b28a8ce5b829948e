"""The flight-recorder ``reason`` catalog of the serving plane, of
allocations and of the device plugin, the label the handoff ConfigMap
carries, and the resources and annotations of the device plugin.

A copy of the serving, allocation and chip-health reasons of
``instaslice_tpu/api/constants.py`` (the ones the scheduler, the
profiler, the journal, ``api/types.py`` and ``deviceplugin/server.py``
of the port emit, the session-migration reasons among them) and of its
``GROUP``, ``POD_UID_LABEL`` and allocate-response annotations: the
port imports nothing of the JAX package. Its ``TPU_RESOURCE`` and
``TPU_PROFILE_RESOURCE_PREFIX`` become NVIDIA's resource names, the
ones InstaSlice's pods request (``samples/test-pod.yaml``) and
``topology/mig.py``'s ``parse_mig_profile`` reads. Every journal event names
its reason from HERE, so dashboards and validators keyed on the
reference's catalog read the port's events unchanged.
"""

#: API group of the ``TpuSlice`` resource and its labels
GROUP = "tpu.instaslice.dev"
#: Handoff ConfigMap owner label (garbage collection + discovery)
POD_UID_LABEL = f"{GROUP}/pod-uid"

#: Extended resource of a whole GPU, advertised by the device plugin in
#: chips mode and by the slice manager for whole-GPU reservations
GPU_RESOURCE = "nvidia.com/gpu"
#: Per-profile MIG resources (``nvidia.com/mig-3g.40gb``) advertised by
#: the slice device-plugin manager and requested in pod limits
MIG_RESOURCE_PREFIX = "nvidia.com/mig-"

#: Device-plugin allocate-response annotations (surfaced on the pod by
#: the kubelet)
CHIPS_ANNOTATION = f"{GROUP}/chips"
SLICE_DEVICE_ANNOTATION = f"{GROUP}/slice-device"

# allocation lifecycle (api/types.py AllocationDetails.set_status): one
# reason per status an allocation enters
REASON_SLICE_CREATING = "SliceCreating"
REASON_SLICE_CREATED = "SliceCreated"
REASON_SLICE_UNGATED = "SliceUngated"
REASON_SLICE_FAILED = "SliceFailed"
REASON_SLICE_DELETED = "SliceDeleted"

#: allocation status -> the reason its transition records
TRANSITION_REASONS = {
    "creating": REASON_SLICE_CREATING,
    "created": REASON_SLICE_CREATED,
    "ungated": REASON_SLICE_UNGATED,
    "failed": REASON_SLICE_FAILED,
    "deleted": REASON_SLICE_DELETED,
}

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

# live KV session migration: a session exported off a replica
# (drain/rebalance) and the matching import+resume on its destination,
# both under the request's trace id so one trace shows the whole hop.
REASON_SESSION_EXPORTED = "SessionExported"
REASON_SESSION_IMPORTED = "SessionImported"

# device plugin: a chip's health mark flipped
REASON_CHIP_UNHEALTHY = "ChipUnhealthy"
REASON_CHIP_HEALED = "ChipHealed"

#: every reason the port's journal accepts without a warning
EVENT_REASONS = frozenset({
    *TRANSITION_REASONS.values(),
    REASON_DRAIN_BEGIN, REASON_DRAIN_END, REASON_SHED, REASON_DRAINED,
    REASON_PREEMPTED, REASON_RESUMED, REASON_SLO_MISSED,
    REASON_COMPILE_OBSERVED,
    REASON_SESSION_EXPORTED, REASON_SESSION_IMPORTED,
    REASON_CHIP_UNHEALTHY, REASON_CHIP_HEALED,
})
