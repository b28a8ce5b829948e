"""Backend interface + inventory/reservation models.

A copy of ``instaslice_tpu/device/backend.py`` (the port imports nothing
of the JAX package), for a node with NVIDIA cards. The reference reduces
NVML's ``DeviceGetCount`` / profile enumeration /
``CreateGpuInstanceWithPlacement`` / ``CreateComputeInstance`` /
``Destroy`` to ``discover`` / ``reserve`` / ``release`` /
``list_reservations``, where on a TPU "create" is an exclusive chip
reservation plus env computation. The port keeps that interface and
puts the NVML calls back under it: a chip is a GPU (its index), a
whole-GPU reservation is a registry entry only, and a MIG slice is a GPU
instance and a compute instance made on one GPU at a start slot
(:mod:`~instaslice_tpu_torch.topology.mig`). A reservation carries the
device UUIDs it grants (``GPU-…`` or ``MIG-…``), which the handoff puts
in ``CUDA_VISIBLE_DEVICES``.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Optional, Tuple

from instaslice_tpu_torch.topology.mig import SLOTS


class DeviceError(Exception):
    """Device-layer failure. The agent turns these into allocation
    status=failed (the reference logged and carried on —
    instaslice_daemonset.go:172-189, flagged in SURVEY.md §5)."""


class ChipsBusy(DeviceError):
    """Requested chips overlap a live reservation."""


class SliceExists(DeviceError):
    """Slice uuid already reserved (idempotent-create signal)."""


class SliceNotFound(DeviceError):
    """Release of an unknown slice uuid."""


@dataclasses.dataclass(frozen=True)
class GpuInfo:
    """What discovery reads of one GPU (reference: the UUID -> model map
    and per-profile placements of ``discoverAvailableProfilesOnGpus``,
    instaslice_daemonset.go:588-664). ``mig_current``/``mig_pending``
    are None where the GPU has no MIG. ``profiles`` is NVML's GPU
    instance profile table (one dict a profile: ``name``, ``id``,
    ``slices``, ``memory_mb``, ``starts``, ``size``); ``profiles_error``
    the NVML error that refused it. ``mig_devices`` the MIG devices that
    exist (``uuid``, ``gi``, ``ci``)."""

    index: int
    uuid: str
    name: str
    memory_bytes: int
    power_limit_w: float
    mig_current: Optional[int] = None
    mig_pending: Optional[int] = None
    profiles: Tuple[dict, ...] = ()
    profiles_error: str = ""
    mig_devices: Tuple[dict, ...] = ()


@dataclasses.dataclass(frozen=True)
class NodeInventory:
    """What discovery reports about this host (reference:
    ``discoverAvailableProfilesOnGpus`` building MigGPUUUID + Migplacement,
    instaslice_daemonset.go:588-664)."""

    generation: str                 # "h100-80gb" ("" = no MIG catalog)
    chip_paths: Dict[int, str]      # GPU index → device path
    source: str = "fake"            # "nvml" | "fake"
    gpus: Tuple[GpuInfo, ...] = ()

    @property
    def chip_count(self) -> int:
        return len(self.chip_paths)


@dataclasses.dataclass(frozen=True)
class Reservation:
    """A live slice. ``chip_ids`` are GPU indices; ``profile`` is "" for
    whole GPUs, else the MIG profile made on ``chip_ids[0]`` at
    ``start`` as GPU instance ``gpu_instance`` and compute instance
    ``compute_instance``, spanning ``size`` memory slots (the catalog's
    for a request, NVML's placement for an instance found on the card,
    whose profile need not be in the catalog)."""

    slice_uuid: str
    chip_ids: tuple                 # sorted GPU indices
    device_uuids: tuple = ()        # GPU-… or MIG-…, in chip order
    profile: str = ""
    start: int = -1
    gpu_instance: int = -1
    compute_instance: int = -1
    size: int = 0

    @property
    def gpu(self) -> int:
        """The GPU of a MIG slice (-1 for whole GPUs)."""
        return self.chip_ids[0] if self.profile else -1

    @property
    def slots(self) -> Tuple[int, int]:
        """(start, size) of the memory slots held on each of its GPUs:
        all 8 for a whole GPU."""
        return (self.start, self.size) if self.profile else (0, SLOTS)

    def clashes(self, other: "Reservation") -> bool:
        """True when the two share a GPU and memory slots on it."""
        if not set(self.chip_ids) & set(other.chip_ids):
            return False
        a0, an = self.slots
        b0, bn = other.slots
        return a0 < b0 + bn and b0 < a0 + an


class DeviceBackend(abc.ABC):
    """One node's device access. Implementations must be idempotent and
    restart-safe: ``list_reservations`` after a process restart must still
    report every live reservation (the reference's in-memory
    ``cachedPreparedMig`` map loses this — instaslice_daemonset.go:87-93)."""

    name: str = ""

    @abc.abstractmethod
    def discover(self) -> NodeInventory: ...

    @abc.abstractmethod
    def reserve(self, slice_uuid: str, chip_ids: List[int],
                profile: str = "", start: int = -1) -> Reservation:
        """Exclusively reserve whole GPUs (``profile`` "") or a MIG
        ``profile`` on ``chip_ids[0]`` at slot ``start``. Raises
        :class:`ChipsBusy` on overlap, :class:`SliceExists` if the uuid
        is already reserved."""

    @abc.abstractmethod
    def release(self, slice_uuid: str) -> None:
        """Raises :class:`SliceNotFound` for unknown uuids."""

    @abc.abstractmethod
    def list_reservations(self) -> List[Reservation]: ...

    def dangling(self) -> List[Reservation]:
        """MIG instances on the device that no reservation records
        (``slice_uuid`` ""): made outside this backend, or left by a
        crash between create and record. Reported, never reaped."""
        return []

    def healthy(self) -> bool:
        try:
            self.list_reservations()
            return True
        except DeviceError:
            return False

    def chip_health(self) -> Dict[int, bool]:
        """Per-chip health: local chip id → healthy. Must cover the union
        of present chips and chips in live reservations — a reserved chip
        whose device node vanished (driver unbound a failed chip) is
        reported ``False``, not omitted. Empty dict = backend has no
        per-chip health signal (treated as all-healthy). The reference has
        no analog: SURVEY.md §5 flags "no health monitoring of slices" as
        a gap this rebuild must close."""
        return {}


class TracedBackend:
    """Span-emitting decorator for any :class:`DeviceBackend`: the
    state-changing device operations (discover/reserve/release) become
    ``device.<op>`` spans in the process tracer, inheriting the
    caller's ambient trace context — so a reserve issued inside the
    agent's ``agent.realize`` span (which is bound to the allocation's
    trace id) shows up as a child span of that grant's trace. The
    periodic read-only polls (``healthy``/``chip_health``/
    ``list_reservations``) are deliberately NOT spanned: they run every
    few seconds forever, and each would root a fresh single-span trace
    — flooding the span ring with noise unrelated to any grant.
    Exceptions pass through untouched (the span records them); unknown
    attributes (the untraced polls, backend-specific test helpers,
    ``name``) proxy to the inner backend."""

    def __init__(self, inner: DeviceBackend) -> None:
        self._inner = inner

    def __getattr__(self, name):  # passthrough (test helpers included)
        return getattr(self._inner, name)

    def _traced(self, op: str, fn, **attrs):
        from instaslice_tpu_torch.utils.trace import get_tracer

        with get_tracer().span(f"device.{op}", **attrs):
            return fn()

    def discover(self) -> NodeInventory:
        return self._traced("discover", self._inner.discover)

    def reserve(self, slice_uuid: str, chip_ids: List[int],
                profile: str = "", start: int = -1) -> Reservation:
        return self._traced(
            "reserve",
            lambda: self._inner.reserve(slice_uuid, chip_ids, profile, start),
            slice=slice_uuid, chips=len(chip_ids), profile=profile or "gpu",
        )

    def release(self, slice_uuid: str) -> None:
        return self._traced(
            "release", lambda: self._inner.release(slice_uuid),
            slice=slice_uuid,
        )

