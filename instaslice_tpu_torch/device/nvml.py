"""NVML backend: ctypes over NVIDIA's ``libnvidia-ml.so.1``.

The production device path on a node with NVIDIA cards, in place of the
reference's ``NativeBackend`` (ctypes over its C++ ``libtpuslice.so``)
and of InstaSlice's go-nvml calls (``instaslice_daemonset.go:149-194,
323-364, 588-748``):

- ``discover`` reads the GPU count and, per GPU, its index, device
  node (by its minor number), UUID, name,
  memory, power limit, MIG mode (current and pending), NVML's GPU
  instance profile table with each profile's possible placements where
  NVML answers, and the MIG devices that exist;
- ``reserve`` of whole GPUs is a registry entry only, and is refused on
  a GPU with MIG mode on (CUDA then enumerates its MIG devices, not the
  GPU, so a ``GPU-`` UUID would grant nothing); of a MIG profile it is ``nvmlDeviceCreateGpuInstanceWithPlacement`` at the start slot,
  then ``nvmlGpuInstanceCreateComputeInstance`` over the whole instance,
  then the MIG device's UUID, resolved by walking the GPU's MIG device
  handles; a refused call rolls back what was made and raises;
- ``release`` destroys the compute instance, then the GPU instance, then
  the record;
- the records live in the crash-safe registry
  (:mod:`~instaslice_tpu_torch.device.registry`), which maps live
  instances back to slice uuids; an instance with no record is reported
  by :meth:`NvmlBackend.dangling`, never destroyed.

Every failed NVML call raises :class:`NvmlError` (a ``DeviceError``)
carrying the call, the error's ``NVML_ERROR_*`` name and
``nvmlErrorString``. The struct layouts follow ``nvml.h`` of CUDA 12
(``struct_layout`` gives them; ``nvml_layout.c`` prints the header's for
the smoke to compare). Nothing changes MIG mode. The MIG catalog is
the one of the card's generation (:func:`generation_of`, read once when
the backend starts); a card without one is granted whole GPUs only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import logging
from typing import Dict, List, Optional

from instaslice_tpu_torch.device.backend import (
    ChipsBusy,
    DeviceBackend,
    DeviceError,
    GpuInfo,
    NodeInventory,
    Reservation,
)
from instaslice_tpu_torch.device.registry import (
    Registry,
    find_clash,
    make_request,
)
from instaslice_tpu_torch.topology.mig import (
    H100_80GB,
    compare_catalog,
    mig_catalog,
    parse_mig_profile,
)

log = logging.getLogger("instaslice_tpu_torch.device")

LIBRARY = "libnvidia-ml.so.1"
#: where the registry lives unless the caller names a directory
DEFAULT_REGISTRY = "/run/tpuslice-gpu"

#: nvmlReturn_t values by name (nvml.h)
NVML_ERRORS = {
    1: "NVML_ERROR_UNINITIALIZED", 2: "NVML_ERROR_INVALID_ARGUMENT",
    3: "NVML_ERROR_NOT_SUPPORTED", 4: "NVML_ERROR_NO_PERMISSION",
    5: "NVML_ERROR_ALREADY_INITIALIZED", 6: "NVML_ERROR_NOT_FOUND",
    7: "NVML_ERROR_INSUFFICIENT_SIZE", 8: "NVML_ERROR_INSUFFICIENT_POWER",
    9: "NVML_ERROR_DRIVER_NOT_LOADED", 10: "NVML_ERROR_TIMEOUT",
    11: "NVML_ERROR_IRQ_ISSUE", 12: "NVML_ERROR_LIBRARY_NOT_FOUND",
    13: "NVML_ERROR_FUNCTION_NOT_FOUND", 14: "NVML_ERROR_CORRUPTED_INFOROM",
    15: "NVML_ERROR_GPU_IS_LOST", 16: "NVML_ERROR_RESET_REQUIRED",
    17: "NVML_ERROR_OPERATING_SYSTEM",
    18: "NVML_ERROR_LIB_RM_VERSION_MISMATCH",
    19: "NVML_ERROR_IN_USE", 20: "NVML_ERROR_MEMORY", 21: "NVML_ERROR_NO_DATA",
    22: "NVML_ERROR_VGPU_ECC_NOT_ENABLED",
    23: "NVML_ERROR_INSUFFICIENT_RESOURCES",
    24: "NVML_ERROR_FREQ_NOT_SUPPORTED",
    25: "NVML_ERROR_ARGUMENT_VERSION_MISMATCH", 26: "NVML_ERROR_DEPRECATED",
    27: "NVML_ERROR_NOT_READY", 28: "NVML_ERROR_GPU_NOT_FOUND",
    29: "NVML_ERROR_INVALID_STATE", 999: "NVML_ERROR_UNKNOWN",
}
INVALID_ARGUMENT, NOT_SUPPORTED, NOT_FOUND = 2, 3, 6
#: NVML_GPU_INSTANCE_PROFILE_* indexes a profile query walks (0x0-0x9)
GI_PROFILES = range(10)
#: NVML_COMPUTE_INSTANCE_PROFILE_* of a compute instance over a whole GPU
#: instance of N compute slices
CI_PROFILE = {1: 0, 2: 1, 3: 2, 4: 3, 7: 4, 8: 5, 6: 6}
CI_ENGINE_SHARED = 0
_BUF = 96          # NVML_DEVICE_UUID_V2_BUFFER_SIZE, ..._NAME_V2_...


class NvmlError(DeviceError):
    """A failed NVML call: ``call``, ``code``, ``code_name`` and
    ``nvmlErrorString``'s text."""

    def __init__(self, call: str, code: int, text: str) -> None:
        self.call, self.code = call, code
        self.code_name = NVML_ERRORS.get(code, f"NVML_ERROR_{code}")
        super().__init__(f"{call}: {self.code_name} ({text})")


class Placement(ctypes.Structure):
    _fields_ = [("start", ctypes.c_uint), ("size", ctypes.c_uint)]


class Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class GpuInstanceProfileInfoV2(ctypes.Structure):
    """``nvmlGpuInstanceProfileInfo_v2_t``."""

    _fields_ = [("version", ctypes.c_uint), ("id", ctypes.c_uint),
                ("isP2pSupported", ctypes.c_uint),
                ("sliceCount", ctypes.c_uint),
                ("instanceCount", ctypes.c_uint),
                ("multiprocessorCount", ctypes.c_uint),
                ("copyEngineCount", ctypes.c_uint),
                ("decoderCount", ctypes.c_uint),
                ("encoderCount", ctypes.c_uint), ("jpegCount", ctypes.c_uint),
                ("ofaCount", ctypes.c_uint),
                ("memorySizeMB", ctypes.c_ulonglong),
                ("name", ctypes.c_char * _BUF)]


#: ``nvmlGpuInstanceProfileInfo_v2`` = NVML_STRUCT_VERSION(..., 2)
GI_PROFILE_INFO_V2 = ctypes.sizeof(GpuInstanceProfileInfoV2) | (2 << 24)


class GpuInstanceInfo(ctypes.Structure):
    """``nvmlGpuInstanceInfo_t``."""

    _fields_ = [("device", ctypes.c_void_p), ("id", ctypes.c_uint),
                ("profileId", ctypes.c_uint), ("placement", Placement)]


class ComputeInstanceProfileInfo(ctypes.Structure):
    """``nvmlComputeInstanceProfileInfo_t``."""

    _fields_ = [("id", ctypes.c_uint), ("sliceCount", ctypes.c_uint),
                ("instanceCount", ctypes.c_uint),
                ("multiprocessorCount", ctypes.c_uint),
                ("sharedCopyEngineCount", ctypes.c_uint),
                ("sharedDecoderCount", ctypes.c_uint),
                ("sharedEncoderCount", ctypes.c_uint),
                ("sharedJpegCount", ctypes.c_uint),
                ("sharedOfaCount", ctypes.c_uint)]


class ComputeInstanceInfo(ctypes.Structure):
    """``nvmlComputeInstanceInfo_t``."""

    _fields_ = [("device", ctypes.c_void_p), ("gpuInstance", ctypes.c_void_p),
                ("id", ctypes.c_uint), ("profileId", ctypes.c_uint),
                ("placement", Placement)]


STRUCTS = {
    "nvmlGpuInstancePlacement_t": Placement,
    "nvmlMemory_t": Memory,
    "nvmlGpuInstanceProfileInfo_v2_t": GpuInstanceProfileInfoV2,
    "nvmlGpuInstanceInfo_t": GpuInstanceInfo,
    "nvmlComputeInstanceProfileInfo_t": ComputeInstanceProfileInfo,
    "nvmlComputeInstanceInfo_t": ComputeInstanceInfo,
}


def struct_layout() -> dict:
    """Each struct's size and field offsets as ctypes lays them out, in
    the shape ``nvml_layout.c`` prints the header's."""
    out = {name: {"sizeof": ctypes.sizeof(s),
                  **{f: getattr(s, f).offset for f, _ in s._fields_}}
           for name, s in STRUCTS.items()}
    out["nvmlGpuInstanceProfileInfo_v2"] = GI_PROFILE_INFO_V2
    return out


_P = ctypes.POINTER
_U = ctypes.c_uint
_H = ctypes.c_void_p
#: every NVML entry point the backend calls, with its argument types
_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlDeviceGetCount_v2": [_P(_U)],
    "nvmlDeviceGetHandleByIndex_v2": [_U, _P(_H)],
    "nvmlDeviceGetIndex": [_H, _P(_U)],
    "nvmlDeviceGetMinorNumber": [_H, _P(_U)],
    "nvmlDeviceGetUUID": [_H, ctypes.c_char_p, _U],
    "nvmlDeviceGetName": [_H, ctypes.c_char_p, _U],
    "nvmlDeviceGetMemoryInfo": [_H, _P(Memory)],
    "nvmlDeviceGetPowerManagementLimit": [_H, _P(_U)],
    "nvmlDeviceGetMigMode": [_H, _P(_U), _P(_U)],
    "nvmlDeviceGetGpuInstanceProfileInfoV": [
        _H, _U, _P(GpuInstanceProfileInfoV2)],
    "nvmlDeviceGetGpuInstancePossiblePlacements_v2": [
        _H, _U, _P(Placement), _P(_U)],
    "nvmlDeviceCreateGpuInstanceWithPlacement": [
        _H, _U, _P(Placement), _P(_H)],
    "nvmlDeviceGetGpuInstanceById": [_H, _U, _P(_H)],
    "nvmlDeviceGetGpuInstances": [_H, _U, _P(_H), _P(_U)],
    "nvmlGpuInstanceGetInfo": [_H, _P(GpuInstanceInfo)],
    "nvmlGpuInstanceGetComputeInstanceProfileInfo": [
        _H, _U, _U, _P(ComputeInstanceProfileInfo)],
    "nvmlGpuInstanceCreateComputeInstance": [_H, _U, _P(_H)],
    "nvmlGpuInstanceGetComputeInstanceById": [_H, _U, _P(_H)],
    "nvmlComputeInstanceGetInfo_v2": [_H, _P(ComputeInstanceInfo)],
    "nvmlComputeInstanceDestroy": [_H],
    "nvmlGpuInstanceDestroy": [_H],
    "nvmlDeviceGetMaxMigDeviceCount": [_H, _P(_U)],
    "nvmlDeviceGetMigDeviceHandleByIndex": [_H, _U, _P(_H)],
    "nvmlDeviceGetGpuInstanceId": [_H, _P(_U)],
    "nvmlDeviceGetComputeInstanceId": [_H, _P(_U)],
}


#: the memory NVML reports of an H100 80GB lies in [75, 85) GiB (79.6
#: GiB); the H100 NVL's 94 GB (93.6 GiB) lies above it
_H100_80GB_GIB = (75, 85)


def generation_of(name: str, memory_bytes: int, profiles=()) -> str:
    """The MIG grid of a card by NVML's name and memory: the H100 80GB
    (SXM "HBM3" and PCIe alike), else "" (no catalog: whole GPUs only).
    ``profiles``, NVML's GPU instance profile table where it answered,
    must agree with the catalog (:func:`compare_catalog`): a card whose
    table names other profiles (an H100 NVL's 1g.12gb ... 7g.94gb) has
    another grid."""
    lo, hi = _H100_80GB_GIB
    if "H100" not in name or not lo * 2 ** 30 <= memory_bytes < hi * 2 ** 30:
        return ""
    if profiles and compare_catalog(profiles, H100_80GB):
        return ""
    return H100_80GB


class NvmlBackend(DeviceBackend):
    name = "nvml"

    def __init__(self, library_path: Optional[str] = None,
                 registry_dir: str = "") -> None:
        path = library_path or LIBRARY
        try:
            self._lib = ctypes.CDLL(path)
        except OSError as e:
            raise DeviceError(f"{path} did not load: {e}") from e
        for fn, args in _SIGNATURES.items():
            try:
                f = getattr(self._lib, fn)
            except AttributeError as e:
                raise DeviceError(f"{path} has no {fn}") from e
            f.argtypes, f.restype = args, ctypes.c_int
        self._lib.nvmlErrorString.argtypes = [ctypes.c_int]
        self._lib.nvmlErrorString.restype = ctypes.c_char_p
        self._call("nvmlInit_v2")
        self._registry = Registry(registry_dir or DEFAULT_REGISTRY)
        self.generation = self._read_generation()

    def close(self) -> None:
        """``nvmlShutdown``; the backend is unusable after it."""
        self._call("nvmlShutdown")

    # ----------------------------------------------------------- NVML

    def _call(self, fn: str, *args) -> None:
        rc = getattr(self._lib, fn)(*args)
        if rc != 0:
            text = self._lib.nvmlErrorString(rc)
            raise NvmlError(fn, rc, text.decode() if text else "")

    def _uint(self, fn: str, handle) -> int:
        v = ctypes.c_uint()
        self._call(fn, handle, ctypes.byref(v))
        return v.value

    def _text(self, fn: str, handle) -> str:
        buf = ctypes.create_string_buffer(_BUF)
        self._call(fn, handle, buf, _BUF)
        return buf.value.decode()

    def gpu_count(self) -> int:
        n = ctypes.c_uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    def _handle(self, index: int):
        h = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByIndex_v2", index, ctypes.byref(h))
        return h

    def _read_generation(self) -> str:
        """The MIG grid of the first GPU that answers (its profile table
        too where MIG is on), "" when none does."""
        for i in range(self.gpu_count()):
            try:
                h = self._handle(i)
                mem = Memory()
                self._call("nvmlDeviceGetMemoryInfo", h, ctypes.byref(mem))
                table = (self._profile_table(h)[0]
                         if self._mig_mode(h) == 1 else ())
                return generation_of(self._text("nvmlDeviceGetName", h),
                                     mem.total, table)
            except NvmlError:
                continue
        return ""

    def _mig_mode(self, h) -> Optional[int]:
        """Current MIG mode, None where the GPU has no MIG."""
        cur, pend = ctypes.c_uint(), ctypes.c_uint()
        try:
            self._call("nvmlDeviceGetMigMode", h, ctypes.byref(cur),
                       ctypes.byref(pend))
        except NvmlError as e:
            if e.code != NOT_SUPPORTED:
                raise
            return None
        return cur.value

    def _profile_info(self, h, nvml_profile: int) -> GpuInstanceProfileInfoV2:
        info = GpuInstanceProfileInfoV2(version=GI_PROFILE_INFO_V2)
        self._call("nvmlDeviceGetGpuInstanceProfileInfoV", h, nvml_profile,
                   ctypes.byref(info))
        return info

    def _placements(self, h, profile_id: int) -> List[Placement]:
        n = ctypes.c_uint(0)
        self._call("nvmlDeviceGetGpuInstancePossiblePlacements_v2", h,
                   profile_id, None, ctypes.byref(n))
        arr = (Placement * max(1, n.value))()
        self._call("nvmlDeviceGetGpuInstancePossiblePlacements_v2", h,
                   profile_id, arr, ctypes.byref(n))
        return list(arr[:n.value])

    def _profile_table(self, h):
        """NVML's GPU instance profiles and their placements; the error
        name of the first refusal when it answers none."""
        table, refused = [], ""
        for p in GI_PROFILES:
            try:
                info = self._profile_info(h, p)
                pls = self._placements(h, info.id)
            except NvmlError as e:
                refused = refused or e.code_name
                continue
            table.append({
                "nvml_profile": p, "name": info.name.decode(),
                "id": info.id, "slices": info.sliceCount,
                "instances": info.instanceCount,
                "memory_mb": info.memorySizeMB,
                "starts": [pl.start for pl in pls],
                "size": pls[0].size if pls else 0})
        return tuple(table), "" if table else refused

    def _mig_devices(self, h) -> List[dict]:
        """The MIG devices of GPU handle ``h``: UUID, GPU and compute
        instance ids."""
        out = []
        for j in range(self._uint("nvmlDeviceGetMaxMigDeviceCount", h)):
            mh = ctypes.c_void_p()
            try:
                self._call("nvmlDeviceGetMigDeviceHandleByIndex", h, j,
                           ctypes.byref(mh))
            except NvmlError as e:
                if e.code == NOT_FOUND:
                    continue
                raise
            out.append({
                "uuid": self._text("nvmlDeviceGetUUID", mh),
                "gi": self._uint("nvmlDeviceGetGpuInstanceId", mh),
                "ci": self._uint("nvmlDeviceGetComputeInstanceId", mh)})
        return out

    def _gpu(self, index: int) -> GpuInfo:
        h = self._handle(index)
        mem = Memory()
        self._call("nvmlDeviceGetMemoryInfo", h, ctypes.byref(mem))
        cur, pend = ctypes.c_uint(), ctypes.c_uint()
        try:
            self._call("nvmlDeviceGetMigMode", h, ctypes.byref(cur),
                       ctypes.byref(pend))
            mig = (cur.value, pend.value)
        except NvmlError as e:
            if e.code != NOT_SUPPORTED:
                raise
            mig = (None, None)
        table, refused = self._profile_table(h)
        return GpuInfo(
            index=self._uint("nvmlDeviceGetIndex", h),
            uuid=self._text("nvmlDeviceGetUUID", h),
            name=self._text("nvmlDeviceGetName", h),
            memory_bytes=mem.total,
            power_limit_w=self._uint(
                "nvmlDeviceGetPowerManagementLimit", h) / 1000.0,
            mig_current=mig[0], mig_pending=mig[1],
            profiles=table, profiles_error=refused,
            mig_devices=tuple(self._mig_devices(h)) if mig[0] == 1 else (),
        )

    # ------------------------------------------------------- backend

    def discover(self) -> NodeInventory:
        gpus = tuple(self._gpu(i) for i in range(self.gpu_count()))
        self._registry.save_inventory({g.index: g.uuid for g in gpus})
        return NodeInventory(
            generation=self.generation,
            chip_paths={g.index: self._device_node(g.index) for g in gpus},
            source="nvml",
            gpus=gpus,
        )

    def _device_node(self, index: int) -> str:
        """``/dev/nvidia<minor>``: the node's minor number is the
        driver's, which need not be NVML's index (a container may hold
        a host's third card alone)."""
        try:
            minor = self._uint("nvmlDeviceGetMinorNumber",
                               self._handle(index))
        except NvmlError as e:
            if e.code != NOT_SUPPORTED:
                raise
            minor = index
        return f"/dev/nvidia{minor}"

    def reserve(self, slice_uuid: str, chip_ids: List[int],
                profile: str = "", start: int = -1) -> Reservation:
        res = make_request(slice_uuid, chip_ids, profile, start,
                           self.generation)
        n = self.gpu_count()
        for c in res.chip_ids:
            if c >= n:
                raise DeviceError(f"chip {c} not on this host")
        return self._registry.reserve(
            res, self._realize, self._destroy if profile else None)

    def _realize(self, res: Reservation, live) -> Reservation:
        other = find_clash(
            res, [r for r in self.instances(live) if not r.slice_uuid])
        if other is not None:
            raise ChipsBusy(
                f"GPU {other.gpu} holds an unrecorded instance "
                f"{other.profile}@{other.start} (GPU instance "
                f"{other.gpu_instance}, "
                + (f"{other.device_uuids[0]})" if other.device_uuids
                   else "no compute instance)"))
        if not res.profile:
            # whole GPUs: the reads are the health check
            handles = [self._handle(c) for c in res.chip_ids]
            on = [c for c, h in zip(res.chip_ids, handles)
                  if self._mig_mode(h) == 1]
            if on:
                raise DeviceError(
                    f"GPUs {on} have MIG mode on: CUDA sees their MIG "
                    "devices, not the GPU, so such a GPU is granted only "
                    "by MIG slices")
            return dataclasses.replace(res, device_uuids=tuple(
                self._text("nvmlDeviceGetUUID", h) for h in handles))
        p = parse_mig_profile(res.profile, self.generation)
        h = self._handle(res.gpu)
        info = self._profile_info(h, p.nvml_profile)
        where = Placement(res.start, p.memory_slices)
        gi = ctypes.c_void_p()
        self._call("nvmlDeviceCreateGpuInstanceWithPlacement", h, info.id,
                   ctypes.byref(where), ctypes.byref(gi))
        try:
            gi_info = GpuInstanceInfo()
            self._call("nvmlGpuInstanceGetInfo", gi, ctypes.byref(gi_info))
            ci_prof = ComputeInstanceProfileInfo()
            self._call("nvmlGpuInstanceGetComputeInstanceProfileInfo", gi,
                       CI_PROFILE[info.sliceCount], CI_ENGINE_SHARED,
                       ctypes.byref(ci_prof))
            ci = ctypes.c_void_p()
            self._call("nvmlGpuInstanceCreateComputeInstance", gi,
                       ci_prof.id, ctypes.byref(ci))
            try:
                ci_info = ComputeInstanceInfo()
                self._call("nvmlComputeInstanceGetInfo_v2", ci,
                           ctypes.byref(ci_info))
                uuid = next(
                    (d["uuid"] for d in self._mig_devices(h)
                     if (d["gi"], d["ci"]) == (gi_info.id, ci_info.id)),
                    None)
                if uuid is None:
                    raise DeviceError(
                        f"no MIG device for GPU instance {gi_info.id}, "
                        f"compute instance {ci_info.id} on GPU {res.gpu}")
            except BaseException:
                self._rollback("nvmlComputeInstanceDestroy", ci)
                raise
        except BaseException:
            self._rollback("nvmlGpuInstanceDestroy", gi)
            raise
        return dataclasses.replace(
            res, device_uuids=(uuid,), gpu_instance=gi_info.id,
            compute_instance=ci_info.id)

    def _rollback(self, fn: str, handle) -> None:
        """Undo one create while an error is on its way out: a refused
        undo is logged, so that the error that caused it is the one
        raised."""
        try:
            self._call(fn, handle)
        except NvmlError as e:
            log.error("rollback failed, an instance is left: %s", e)

    def _destroy(self, res: Reservation) -> None:
        """Compute instance, then GPU instance; one already gone (NVML
        answers NOT_FOUND for its id) is skipped."""
        h = self._handle(res.gpu)
        gi, ci = ctypes.c_void_p(), ctypes.c_void_p()
        try:
            self._call("nvmlDeviceGetGpuInstanceById", h, res.gpu_instance,
                       ctypes.byref(gi))
        except NvmlError as e:
            if e.code == NOT_FOUND:
                return
            raise
        try:
            self._call("nvmlGpuInstanceGetComputeInstanceById", gi,
                       res.compute_instance, ctypes.byref(ci))
            self._call("nvmlComputeInstanceDestroy", ci)
        except NvmlError as e:
            if e.code != NOT_FOUND:
                raise
        self._call("nvmlGpuInstanceDestroy", gi)

    def release(self, slice_uuid: str) -> None:
        self._registry.release(
            slice_uuid, lambda r: self._destroy(r) if r.profile else None)

    def list_reservations(self) -> List[Reservation]:
        return self._registry.list()

    def instances(self, records=None) -> List[Reservation]:
        """Every GPU instance on the node's GPUs with MIG on, as a
        reservation: the slice uuid of its record in ``records`` (the
        registry's when None), or "" when none; its slots are NVML's
        placement, and a profile outside the catalog (1g.10gb+me) is
        named ``profile-<NVML profile id>``. The instances are listed
        per profile of NVML's table (``nvmlDeviceGetGpuInstances``), so
        one without a compute instance (left by a crash between the two
        creates, or made by ``nvidia-smi mig -cgi`` without ``-C``) is
        listed too, with ``compute_instance`` -1 and no UUID: NVML has a
        MIG device handle only for a compute instance."""
        if records is None:
            records = self._registry.list()
        recorded = {(r.gpu, r.gpu_instance): r.slice_uuid
                    for r in records if r.profile}
        by_id = {p.profile_id: p for p in mig_catalog(self.generation)
                 or ()}
        out = []
        for g in range(self.gpu_count()):
            h = self._handle(g)
            if self._mig_mode(h) != 1:
                continue
            cis = {d["gi"]: d for d in self._mig_devices(h)}
            for info in self._gpu_instances(h):
                p, d = by_id.get(info.profileId), cis.get(info.id)
                out.append(Reservation(
                    recorded.get((g, info.id), ""), (g,),
                    (d["uuid"],) if d else (),
                    p.name if p else f"profile-{info.profileId}",
                    info.placement.start, info.id, d["ci"] if d else -1,
                    info.placement.size))
        return sorted(out, key=lambda r: (r.gpu, r.gpu_instance))

    def _gpu_instances(self, h) -> List[GpuInstanceInfo]:
        """The GPU instances of GPU handle ``h``, each profile of NVML's
        table asked in turn (a profile NVML does not support is
        skipped)."""
        out = []
        for p in GI_PROFILES:
            try:
                info = self._profile_info(h, p)
            except NvmlError as e:
                if e.code not in (INVALID_ARGUMENT, NOT_SUPPORTED):
                    raise
                continue
            n = ctypes.c_uint(max(1, info.instanceCount))
            arr = (ctypes.c_void_p * n.value)()
            self._call("nvmlDeviceGetGpuInstances", h, info.id, arr,
                       ctypes.byref(n))
            for gi in arr[:n.value]:
                gi_info = GpuInstanceInfo()
                self._call("nvmlGpuInstanceGetInfo", ctypes.c_void_p(gi),
                           ctypes.byref(gi_info))
                out.append(gi_info)
        return out

    def dangling(self) -> List[Reservation]:
        return [r for r in self.instances() if not r.slice_uuid]

    def chip_health(self) -> Dict[int, bool]:
        """A GPU is healthy when its handle resolves by index and its
        UUID and memory reads succeed with the UUID discovery recorded
        for that index (a GPU that fell off the bus answers
        NVML_ERROR_GPU_IS_LOST; one that vanished is past the count). A
        reserved or once-discovered GPU that fails is reported False."""
        known = self._registry.load_inventory()
        ids = set(range(self.gpu_count())) | set(known)
        for r in self._registry.list():
            ids.update(r.chip_ids)
        out = {}
        for i in sorted(ids):
            try:
                h = self._handle(i)
                uuid = self._text("nvmlDeviceGetUUID", h)
                self._call("nvmlDeviceGetMemoryInfo", h,
                           ctypes.byref(Memory()))
                out[i] = known.get(i, uuid) == uuid
            except NvmlError:
                out[i] = False
        return out
