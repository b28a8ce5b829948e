"""The flight-recorder ``reason`` catalog of the serving plane, of
allocations, of the controller and its repacker, of the device plugin,
of the node agent and of the kube layer, the ``TpuSlice`` resource's
names, the scheduling gate and finalizer, the label the handoff
ConfigMap carries, and the resources and annotations of the pods, the
device plugin, the agent and the leader lease.

A copy of the serving, allocation, controller, repacker, recovery,
chip-health, agent and kube reasons of ``instaslice_tpu/api/constants.py``
(the ones the scheduler, the profiler, the journal, ``api/types.py``,
``controller/``, ``deviceplugin/server.py``, ``agent/`` and ``kube/`` of
the port emit) and of its ``GROUP``, ``VERSION``, ``API_VERSION``,
``KIND``, ``PLURAL``, ``GATE_NAME``, ``LEGACY_GATE_NAME``, ``FINALIZER``,
``POD_RESOURCE_PREFIX``, ``POD_UID_LABEL`` and annotations (the sim
kubelet's ``DEVICE_PATHS_ANNOTATION`` and
``KUBELET_ENV_CHIPS_ANNOTATION`` among them), with the
reference's values: the port imports nothing of the JAX package. Its ``TPU_RESOURCE`` and
``TPU_PROFILE_RESOURCE_PREFIX`` become NVIDIA's resource names, the
ones InstaSlice's pods request (``samples/test-pod.yaml``) and
``topology/mig.py``'s ``parse_mig_profile`` reads. Every journal event names
its reason from HERE, so dashboards and validators keyed on the
reference's catalog read the port's events unchanged.
"""

#: API group of the ``TpuSlice`` resource and its labels
GROUP = "tpu.instaslice.dev"
VERSION = "v1alpha1"
API_VERSION = f"{GROUP}/{VERSION}"
KIND = "TpuSlice"
PLURAL = "tpuslices"

#: Scheduling gate and finalizer of the pods the controller grants
GATE_NAME = f"{GROUP}/accelerator"
FINALIZER = f"{GROUP}/accelerator"
#: The gate InstaSlice's own webhook sets, its spelling included: the
#: controller admits and ungates pods that carry it
LEGACY_GATE_NAME = "org.instaslice/accelarator"

#: Per-pod extended resource the node agent advertises on its Node (the
#: pod's handoff name follows the prefix): what pins a granted pod to
#: the node that realized its slice
POD_RESOURCE_PREFIX = f"{GROUP}/"
#: Trace id of a grant, on the Kubernetes Events that mirror its journal
#: events
TRACE_ID_ANNOTATION = f"{GROUP}/trace-id"
#: Handoff ConfigMap owner label (garbage collection + discovery)
POD_UID_LABEL = f"{GROUP}/pod-uid"

#: Extended resource of a whole GPU, advertised by the device plugin in
#: chips mode and by the slice manager for whole-GPU reservations
GPU_RESOURCE = "nvidia.com/gpu"
#: Per-profile MIG resources (``nvidia.com/mig-3g.40gb``) advertised by
#: the slice device-plugin manager and requested in pod limits
MIG_RESOURCE_PREFIX = "nvidia.com/mig-"

#: Pod annotations: the requested profile, a multi-host pod group and
#: its size, a stable handoff name, the degraded-slice marker and the
#: opt-in to eviction on it, the controller's error, the repacker's
#: opt-out, and the blocked request a pod was submitted for
PROFILE_ANNOTATION = f"{GROUP}/profile"
GROUP_ANNOTATION = f"{GROUP}/group"
GROUP_SIZE_ANNOTATION = f"{GROUP}/group-size"
HANDOFF_ANNOTATION = f"{GROUP}/handoff-name"
UNHEALTHY_ANNOTATION = f"{GROUP}/slice-unhealthy"
RESTART_ON_FAILURE_ANNOTATION = f"{GROUP}/restart-on-failure"
ERROR_ANNOTATION = f"{GROUP}/error"
REPACK_OPTOUT_ANNOTATION = f"{GROUP}/no-repack"
CAUSED_BY_ANNOTATION = f"{GROUP}/caused-by"

#: Device-plugin allocate-response annotations (surfaced on the pod by
#: the kubelet / the sim's kubelet emulator): the chips, the slice's
#: reservation handles, the granted device nodes and the chips of the
#: env the plugin injected
CHIPS_ANNOTATION = f"{GROUP}/chips"
SLICE_DEVICE_ANNOTATION = f"{GROUP}/slice-device"
DEVICE_PATHS_ANNOTATION = f"{GROUP}/device-paths"
KUBELET_ENV_CHIPS_ANNOTATION = f"{GROUP}/kubelet-env-chips"

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

# controller decisions (pod-scoped; mirrored as Kubernetes Events)
REASON_ADMITTED = "Admitted"
REASON_PLACED = "Placed"
REASON_NO_CAPACITY = "NoCapacity"
REASON_REJECTED = "Rejected"
REASON_RETRYING = "Retrying"
REASON_UNGATED = "Ungated"
REASON_DEGRADED = "SliceDegraded"
REASON_HEALED = "SliceHealed"
REASON_HEALTH_EVICTED = "HealthEvicted"

# repacker (controller/defrag.py): one migration is one drain, teardown
# and re-grant epoch under its own trace id
REASON_REPACK_PLANNED = "RepackPlanned"
REASON_REPACK_MIGRATING = "RepackMigrating"
REASON_REPACK_DONE = "RepackDone"
REASON_REPACK_FAILED = "RepackFailed"

# recovery: a restarted controller adopting what a dead one left, the
# repacker's watchdog rolling back a stuck migration, and the
# controller's rolling back an allocation stuck in ``creating``
REASON_CRASH_RECOVERED = "CrashRecovered"
REASON_MIGRATION_ABORTED = "MigrationAborted"
REASON_GRANT_DEADLINE = "GrantDeadlineExceeded"

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

# node agent (agent/): a part realized on the device, a reserve the
# device refused, a part released, and a device slice no CR epoch claims
# released at boot
REASON_REALIZED = "SliceRealized"
REASON_REALIZE_FAILED = "SliceRealizeFailed"
REASON_TORN_DOWN = "SliceTornDown"
REASON_ORPHAN_REAPED = "OrphanReaped"

# kube client resilience (kube/real.py): the circuit breaker opened, a
# retryable status backed off, a watch stream re-established
REASON_BREAKER_OPEN = "KubeBreakerOpen"
REASON_BACKOFF = "KubeBackoff"
REASON_WATCH_RECONNECT = "KubeWatchReconnect"

# partitions: the agent lost the apiserver at the transport level and
# serves its frozen device state (static mode) until a probe heals it;
# a write refused because its writer's lease was deposed
REASON_APISERVER_UNREACHABLE = "ApiServerUnreachable"
REASON_DEGRADED_ENTERED = "DegradedModeEntered"
REASON_DEGRADED_EXITED = "DegradedModeExited"
REASON_WRITE_FENCED = "WriteFenced"

# the router's gray-failure ejection of a slow-but-alive replica (latency
# EWMA past threshold) and its re-admission once the EWMA recovers
REASON_REPLICA_EJECTED = "ReplicaEjected"
REASON_REPLICA_READMITTED = "ReplicaReadmitted"

#: every reason the port's journal accepts without a warning
EVENT_REASONS = frozenset({
    *TRANSITION_REASONS.values(),
    REASON_ADMITTED, REASON_PLACED, REASON_NO_CAPACITY, REASON_REJECTED,
    REASON_RETRYING, REASON_UNGATED, REASON_DEGRADED, REASON_HEALED,
    REASON_HEALTH_EVICTED,
    REASON_REPACK_PLANNED, REASON_REPACK_MIGRATING, REASON_REPACK_DONE,
    REASON_REPACK_FAILED,
    REASON_CRASH_RECOVERED, REASON_MIGRATION_ABORTED, REASON_GRANT_DEADLINE,
    REASON_DRAIN_BEGIN, REASON_DRAIN_END, REASON_SHED, REASON_DRAINED,
    REASON_PREEMPTED, REASON_RESUMED, REASON_SLO_MISSED,
    REASON_COMPILE_OBSERVED,
    REASON_SESSION_EXPORTED, REASON_SESSION_IMPORTED,
    REASON_CHIP_UNHEALTHY, REASON_CHIP_HEALED,
    REASON_REALIZED, REASON_REALIZE_FAILED, REASON_TORN_DOWN,
    REASON_ORPHAN_REAPED,
    REASON_BREAKER_OPEN, REASON_BACKOFF, REASON_WATCH_RECONNECT,
    REASON_APISERVER_UNREACHABLE, REASON_DEGRADED_ENTERED,
    REASON_DEGRADED_EXITED, REASON_WRITE_FENCED,
    REASON_REPLICA_EJECTED, REASON_REPLICA_READMITTED,
})

#: Leader lease: its duration in ms, stamped for the standby electors
LEASE_DURATION_MS_ANNOTATION = f"{GROUP}/lease-duration-ms"
#: The lease epoch of the writer that landed a fenced write
WRITER_EPOCH_ANNOTATION = f"{GROUP}/writer-epoch"
