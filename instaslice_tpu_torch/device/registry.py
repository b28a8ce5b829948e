"""Crash-safe reservation registry: one file per reservation.

A Python port of the registry of the reference's C++ device shim
(``native/tpuslice/tpuslice.cpp:119-300``): ``<dir>/<uuid>.res`` holds
one reservation, written to ``<uuid>.res.tmp``, flushed with ``fsync``
and renamed into place, all under an exclusive ``fcntl.flock`` on
``<dir>/.lock`` so concurrent agents, plugins and processes serialize.
A process that starts after a crash lists every live reservation from
the files alone: what InstaSlice's in-memory ``cachedPreparedMig``
(``instaslice_daemonset.go:87-93``) lost on restart.

The port's records are JSON (the reference's held a chip-id list) since
a MIG slice also records its profile, start slot, GPU instance and
compute instance ids and the UUIDs it grants: the NVML backend maps live
instances back to slice uuids through them. ``.inventory`` keeps the
GPUs last discovered (index and UUID), so a GPU that vanished while
unreserved is still reported unhealthy.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import json
import os
import re
import threading
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

from instaslice_tpu_torch.device.backend import (
    ChipsBusy,
    DeviceError,
    Reservation,
    SliceExists,
    SliceNotFound,
)
from instaslice_tpu_torch.topology.mig import parse_mig_profile

_UUID_RE = re.compile(r"^[A-Za-z0-9_.-]{1,129}$")
_SUFFIX = ".res"


def check_request(slice_uuid: str, chip_ids) -> tuple:
    """The reference's argument checks (``tpuslice_reserve``): a
    non-empty uuid of ``[A-Za-z0-9_.-]``, a non-empty list of distinct
    non-negative chip ids. Returns the ids sorted."""
    if not slice_uuid or not chip_ids:
        raise DeviceError("empty slice uuid or chip list")
    if not _UUID_RE.match(slice_uuid):
        raise DeviceError(f"invalid slice uuid {slice_uuid!r}")
    ids = tuple(sorted(int(c) for c in chip_ids))
    if len(set(ids)) != len(ids) or ids[0] < 0:
        raise DeviceError(f"duplicate or negative chip ids in {chip_ids}")
    return ids


def check_mig(res: Reservation, generation: str):
    """A MIG request's checks: one GPU, a profile of the generation's
    catalog, one of its start slots. Returns the :class:`MigProfile`."""
    if len(res.chip_ids) != 1:
        raise DeviceError(
            f"a MIG slice is on one GPU, got {list(res.chip_ids)}")
    try:
        p = parse_mig_profile(res.profile, generation)
    except ValueError as e:
        raise DeviceError(str(e)) from e
    if res.start not in p.starts:
        raise DeviceError(f"{p.name} cannot start at slot {res.start} "
                          f"(starts {list(p.starts)})")
    return p


def make_request(slice_uuid: str, chip_ids, profile: str, start: int,
                 generation: str) -> Reservation:
    """The reservation a ``reserve`` asks for, checked
    (:func:`check_request`; :func:`check_mig` for a MIG profile, whose
    memory slots it takes from the catalog)."""
    res = Reservation(slice_uuid, check_request(slice_uuid, chip_ids),
                      profile=profile, start=start)
    if profile:
        res = dataclasses.replace(
            res, size=check_mig(res, generation).memory_slices)
    return res


def find_clash(res: Reservation, live) -> Optional[Reservation]:
    """The first live reservation ``res`` overlaps, or None."""
    for other in live:
        if res.clashes(other):
            return other
    return None


class Registry:
    """The reservation files under ``directory`` (created if missing)."""

    def __init__(self, directory) -> None:
        self.dir = Path(directory)
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
        except OSError as e:
            raise DeviceError(f"registry I/O failure: {e}") from e
        # flock excludes other open file descriptions (other processes
        # and other threads' opens alike); the mutex keeps this
        # process's threads from interleaving around it
        self._mu = threading.Lock()

    @contextlib.contextmanager
    def locked(self) -> Iterator[None]:
        with self._mu:
            try:
                fd = os.open(self.dir / ".lock", os.O_CREAT | os.O_RDWR,
                             0o644)
            except OSError as e:
                raise DeviceError(f"registry I/O failure: {e}") from e
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                yield
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
                os.close(fd)

    def _path(self, slice_uuid: str) -> Path:
        return self.dir / f"{slice_uuid}{_SUFFIX}"

    def _load(self) -> List[Reservation]:
        out = []
        for p in self.dir.glob(f"*{_SUFFIX}"):
            try:
                d = json.loads(p.read_text())
            except (OSError, ValueError):
                continue        # the C++ skipped a file it could not read
            d["chip_ids"] = tuple(d["chip_ids"])
            d["device_uuids"] = tuple(d["device_uuids"])
            out.append(Reservation(**d))
        return sorted(out, key=lambda r: r.slice_uuid)

    def _write(self, res: Reservation) -> None:
        final = self._path(res.slice_uuid)
        tmp = final.with_name(final.name + ".tmp")
        try:
            with open(tmp, "w") as f:
                json.dump(dataclasses.asdict(res), f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, final)
        except OSError as e:
            tmp.unlink(missing_ok=True)
            raise DeviceError(f"registry I/O failure: {e}") from e

    def list(self) -> List[Reservation]:
        with self.locked():
            return self._load()

    def reserve(self, res: Reservation,
                realize: Optional[Callable[[Reservation, list], Reservation]]
                = None,
                undo: Optional[Callable[[Reservation], None]] = None,
                ) -> Reservation:
        """Record ``res`` unless its uuid is live (:class:`SliceExists`,
        checked first, as the reference does for a retried reserve) or
        it overlaps a live reservation (:class:`ChipsBusy`). Under the
        same lock, ``realize(res, live)`` makes the slice on the device
        and returns it completed (instance ids, UUIDs): ``live`` is every
        record, read under the lock; if the record then cannot be
        written, ``undo`` takes the slice down again."""
        check_request(res.slice_uuid, res.chip_ids)
        with self.locked():
            live = self._load()
            if any(r.slice_uuid == res.slice_uuid for r in live):
                raise SliceExists(f"slice {res.slice_uuid} already reserved")
            other = find_clash(res, live)
            if other is not None:
                raise ChipsBusy(
                    f"chips {list(res.chip_ids)} overlap live reservation "
                    f"{other.slice_uuid}")
            if realize is not None:
                res = realize(res, live)
            try:
                self._write(res)
            except DeviceError:
                if undo is not None:
                    undo(res)
                raise
            return res

    def release(self, slice_uuid: str,
                teardown: Optional[Callable[[Reservation], None]] = None,
                ) -> Reservation:
        """Remove the record of ``slice_uuid`` (:class:`SliceNotFound`
        if there is none), after ``teardown`` has taken the slice down on
        the device under the same lock."""
        if not slice_uuid or not _UUID_RE.match(slice_uuid):
            raise DeviceError(f"invalid slice uuid {slice_uuid!r}")
        with self.locked():
            res = next((r for r in self._load()
                        if r.slice_uuid == slice_uuid), None)
            if res is None:
                raise SliceNotFound(f"slice {slice_uuid} not reserved")
            if teardown is not None:
                teardown(res)
            self._remove(slice_uuid)
            return res

    def _remove(self, slice_uuid: str) -> None:
        try:
            self._path(slice_uuid).unlink()
        except OSError as e:
            raise DeviceError(f"registry I/O failure: {e}") from e

    def replace_all(self, records) -> None:
        """Make ``records`` the whole registry (a simulated restart onto
        older persisted state)."""
        with self.locked():
            for r in self._load():
                self._remove(r.slice_uuid)
            for r in records:
                self._write(r)

    def save_inventory(self, uuids: Dict[int, str]) -> None:
        """The GPUs just discovered (index -> UUID), tmp + rename."""
        path = self.dir / ".inventory"
        tmp = path.with_name(".inventory.tmp")
        with self.locked():
            try:
                tmp.write_text(json.dumps(
                    {str(k): v for k, v in sorted(uuids.items())}))
                os.rename(tmp, path)
            except OSError:
                tmp.unlink(missing_ok=True)

    def load_inventory(self) -> Dict[int, str]:
        try:
            d = json.loads((self.dir / ".inventory").read_text())
        except (OSError, ValueError):
            return {}
        return {int(k): v for k, v in d.items()}


class MemoryRegistry(Registry):
    """The same checks and ordering over a dict, for a backend that
    keeps no files (the fake's default): nothing survives the process."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._records: Dict[str, Reservation] = {}
        self._inventory: Dict[int, str] = {}

    @contextlib.contextmanager
    def locked(self) -> Iterator[None]:
        with self._mu:
            yield

    def _load(self) -> List[Reservation]:
        return [self._records[u] for u in sorted(self._records)]

    def _write(self, res: Reservation) -> None:
        self._records[res.slice_uuid] = res

    def _remove(self, slice_uuid: str) -> None:
        del self._records[slice_uuid]

    def save_inventory(self, uuids: Dict[int, str]) -> None:
        self._inventory = dict(uuids)

    def load_inventory(self) -> Dict[int, str]:
        return dict(self._inventory)
