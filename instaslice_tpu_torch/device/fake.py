"""Fake GPU backend — the dgxa100 mock-server analog (SURVEY.md §4 tier 1:
go-nvml ships a mock DGX-A100 and the reference's only real unit test
monkeypatches nvml onto it).

A port of ``instaslice_tpu/device/fake.py``'s ``FakeTpuBackend`` to a
node of H100 80GB cards (or, with ``generation=""``, of cards without a
MIG catalog, granted whole only): whole GPUs, and MIG slices from the
fixed catalog (:mod:`~instaslice_tpu_torch.topology.mig`), each a fake GPU
instance and compute instance with a ``MIG-`` UUID. It keeps the
reference fake's test API (``inject_failures``, ``fail_chip``/
``heal_chip``, ``seed_dangling``, ``snapshot``/``restore``, ``calls``)
and holds the MIG create and destroy paths on a machine without a card:
``inject_failures("create")`` refuses the next create with an NVML error
name, as a card without MIG or root does. ``mig`` sets MIG mode per
GPU; as on the card, a GPU with MIG on is granted only by MIG slices.
With ``registry_dir`` the reservations live in the crash-safe registry
(so a second process sees them), else in memory; the fake instances
live in this process.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple, Union

from instaslice_tpu_torch.device.backend import (
    ChipsBusy,
    DeviceBackend,
    DeviceError,
    GpuInfo,
    NodeInventory,
    Reservation,
)
from instaslice_tpu_torch.device.registry import (
    MemoryRegistry,
    Registry,
    find_clash,
    make_request,
)
from instaslice_tpu_torch.topology.mig import H100_80GB, mig_catalog
from instaslice_tpu_torch.utils.lockcheck import named_lock


def fake_gpu_uuid(i: int) -> str:
    return f"GPU-{i:08x}-fa4e-4000-8000-{i:012x}"


class FakeGpuBackend(DeviceBackend):
    name = "fake"

    def __init__(
        self,
        gpu_count: int = 8,
        mig: Union[bool, Iterable[int]] = True,
        registry_dir: str = "",
        generation: str = H100_80GB,
    ) -> None:
        """``mig``: MIG mode on every GPU (True), on none (False), or on
        the GPU indices listed. ``generation`` "" is a card without a MIG
        catalog (an H100 NVL's 94 GB: ``generation_of`` gives it no
        grid), whose GPUs have no MIG and are granted whole only."""
        if generation not in ("", H100_80GB):
            raise ValueError(
                f"generation {generation!r}: the fake is an H100 80GB "
                "(h100-80gb) or a card without a MIG catalog ('')")
        if isinstance(mig, bool):
            mig = range(gpu_count) if mig and generation else ()
        if set(mig) and not generation:
            raise ValueError("a card without a MIG catalog has no MIG mode")
        table = tuple(
            {"name": f"MIG {p.name}", "id": p.profile_id,
             "slices": p.compute_slices, "memory_mb": p.memory_gb * 1000,
             "starts": list(p.starts), "size": p.memory_slices}
            for p in mig_catalog(H100_80GB))
        self._generation = generation
        self._mig_on = set(mig)
        self._inventory = NodeInventory(
            generation=generation,
            chip_paths={i: f"/dev/nvidia{i}" for i in range(gpu_count)},
            source="fake",
            gpus=tuple(self._gpu(i, table) for i in range(gpu_count)),
        )
        self._lock = named_lock("device.fake")
        self._registry = Registry(registry_dir) if registry_dir else \
            MemoryRegistry()
        #: the fake device's MIG state: (GPU, GPU instance id) -> the
        #: instance as a reservation without a slice uuid
        self._instances: Dict[Tuple[int, int], Reservation] = {}
        self._next_gi = 1
        # failure injection: op name → (remaining count, NVML error name)
        self._fail: Dict[str, List] = {}
        self._failed_chips: set = set()
        self.calls: Dict[str, int] = {
            "discover": 0, "reserve": 0, "release": 0, "list": 0,
            "health": 0, "create": 0, "destroy": 0,
        }

    # ------------------------------------------------------------ test API

    def inject_failures(self, op: str, count: int = 1,
                        nvml_error: str = "NVML_ERROR_UNKNOWN") -> None:
        """Make the next ``count`` calls of ``op`` raise DeviceError
        (op in discover|reserve|release|list|health, or create|destroy:
        the MIG instance calls, refused with ``nvml_error``)."""
        left = self._fail.get(op, [0, nvml_error])[0]
        self._fail[op] = [left + count, nvml_error]

    def fail_chip(self, chip_id: int) -> None:
        """Mark a GPU unhealthy (fallen off the bus, NVML_ERROR_GPU_IS_LOST
        analog). Live reservations keep holding it; new reserves touching
        it fail."""
        with self._lock:
            self._failed_chips.add(chip_id)

    def heal_chip(self, chip_id: int) -> None:
        with self._lock:
            self._failed_chips.discard(chip_id)

    def seed_dangling(self, slice_uuid: str, chip_ids: List[int],
                      profile: str = "", start: int = -1) -> None:
        """Pre-existing slice for adoption tests (reference:
        ``discoverDanglingSlices``, instaslice_daemonset.go:666-748):
        recorded as if an earlier agent had reserved it, its MIG
        instance made, no check applied."""
        res = make_request(slice_uuid, chip_ids, profile, start,
                           self._generation)
        with self._lock, self._registry.locked():
            self._registry._write(self._create(res) if profile else res)

    def snapshot(self) -> Dict[str, Reservation]:
        return {r.slice_uuid: r for r in self._registry.list()}

    def restore(self, snap: Dict[str, Reservation]) -> None:
        """Simulate agent restart against persisted device state: the
        records become ``snap``; the device's instances stay, so one made
        after the snapshot is reported by :meth:`dangling`."""
        with self._lock:
            self._registry.replace_all(snap.values())

    def _maybe_fail(self, op: str) -> None:
        left, err = self._fail.get(op, [0, ""])
        if left > 0:
            self._fail[op][0] -= 1
            raise DeviceError(f"injected {op} failure: {err}")

    # ------------------------------------------------------- fake device

    def _gpu(self, i: int, table) -> GpuInfo:
        if not self._generation:
            return GpuInfo(i, fake_gpu_uuid(i), "NVIDIA H100 NVL (fake)",
                           94 * 10 ** 9, 400.0, None, None, (),
                           "NVML_ERROR_NOT_SUPPORTED")
        on = i in self._mig_on
        return GpuInfo(i, fake_gpu_uuid(i), "NVIDIA H100 80GB HBM3 (fake)",
                       80 * 2 ** 30, 700.0, int(on), int(on),
                       table if on else (),
                       "" if on else "NVML_ERROR_NOT_SUPPORTED")

    def _realize(self, res: Reservation, live) -> Reservation:
        dead = [c for c in res.chip_ids if c in self._failed_chips]
        if dead:
            raise DeviceError(f"chips {dead} unhealthy")
        other = find_clash(res, self._unrecorded(live))
        if other is not None:
            raise ChipsBusy(
                f"GPU {other.gpu} holds an unrecorded instance "
                f"{other.profile}@{other.start} ({other.device_uuids[0]})")
        if not res.profile:
            on = sorted(set(res.chip_ids) & self._mig_on)
            if on:
                raise DeviceError(
                    f"GPUs {on} have MIG mode on: such a GPU is granted "
                    "only by MIG slices")
            return dataclasses.replace(res, device_uuids=tuple(
                fake_gpu_uuid(c) for c in res.chip_ids))
        return self._create(res)

    def _create(self, res: Reservation) -> Reservation:
        """CreateGpuInstanceWithPlacement + CreateComputeInstance."""
        self.calls["create"] += 1
        if res.gpu not in self._mig_on:
            raise DeviceError(
                f"MIG mode is off on GPU {res.gpu}: "
                "NVML_ERROR_INVALID_STATE")
        self._maybe_fail("create")
        gi, self._next_gi = self._next_gi, self._next_gi + 1
        made = dataclasses.replace(
            res, device_uuids=(f"MIG-{gi:08x}-fa4e-4000-8000-"
                               f"{res.gpu:012x}",),
            gpu_instance=gi, compute_instance=0)
        self._instances[(res.gpu, gi)] = dataclasses.replace(
            made, slice_uuid="")
        return made

    def _destroy(self, res: Reservation) -> None:
        """ComputeInstanceDestroy + GpuInstanceDestroy."""
        self.calls["destroy"] += 1
        self._maybe_fail("destroy")
        self._instances.pop((res.gpu, res.gpu_instance), None)

    # ------------------------------------------------------------- backend

    def discover(self) -> NodeInventory:
        with self._lock:
            self.calls["discover"] += 1
            self._maybe_fail("discover")
            return self._inventory

    def reserve(self, slice_uuid: str, chip_ids: List[int],
                profile: str = "", start: int = -1) -> Reservation:
        with self._lock:
            self.calls["reserve"] += 1
            self._maybe_fail("reserve")
            for c in chip_ids:
                if c not in self._inventory.chip_paths:
                    raise DeviceError(f"chip {c} not on this host")
            res = make_request(slice_uuid, chip_ids, profile, start,
                               self._generation)
            return self._registry.reserve(
                res, self._realize, self._destroy if profile else None)

    def release(self, slice_uuid: str) -> None:
        with self._lock:
            self.calls["release"] += 1
            self._maybe_fail("release")
            self._registry.release(
                slice_uuid,
                lambda r: self._destroy(r) if r.profile else None)

    def list_reservations(self) -> List[Reservation]:
        with self._lock:
            self.calls["list"] += 1
            self._maybe_fail("list")
            return self._registry.list()

    def _unrecorded(self, records) -> List[Reservation]:
        recorded = {(r.gpu, r.gpu_instance) for r in records if r.profile}
        return [r for k, r in sorted(self._instances.items())
                if k not in recorded]

    def dangling(self) -> List[Reservation]:
        return self._unrecorded(self._registry.list())

    def chip_health(self) -> Dict[int, bool]:
        with self._lock:
            self.calls["health"] += 1
            self._maybe_fail("health")
            ids = set(self._inventory.chip_paths)
            for r in self._registry.list():
                ids.update(r.chip_ids)
            return {i: i not in self._failed_chips for i in sorted(ids)}
