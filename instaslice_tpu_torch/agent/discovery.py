"""Boot-time node discovery — reference analog:
``discoverMigEnabledGpuWithSlices`` / ``discoverAvailableProfilesOnGpus`` /
``discoverDanglingSlices`` (``instaslice_daemonset.go:555-748``), which run
once per node (guarded by ``Status.Processed``) and create the per-node CR
named ``$NODE_NAME``.

Differences by design:
- the profile catalog is computed from generation topology constants, not
  queried per-device, so identical on every healthy node;
- dangling-slice adoption ALSO runs on every boot (not just first), so an
  agent restart re-syncs ``spec.prepared`` with the device registry — the
  reference's in-memory cache forgets (SURVEY.md §5 restart recovery).

A copy of ``instaslice_tpu/agent/discovery.py`` (the port imports
nothing of the JAX package), exact on a TPU generation. On a GPU grid
(:mod:`~instaslice_tpu_torch.agent.gpugrid`) the CR carries the grid's
generation (``nvidia-gpu`` for a card without a MIG catalog), one chip
per GPU (index -> device node), the grid's profiles plus the whole GPU
(``gpu``), host offset ``(0, 0, 0)`` and the node's name as its group;
a dangling reservation's part is keyed by its GPU (``gpu<i>``) and
boxed by its memory slots, and the device's MIG instances that no
reservation records (``DeviceBackend.dangling()``) are adopted too, as
foreign handles (their UUID, or ``mig-gpu<i>-gi<id>`` without one) that
the orphan sweep never reaps.
"""

from __future__ import annotations

import logging
from typing import Optional, Set

from instaslice_tpu_torch.agent.gpugrid import is_gpu_grid
from instaslice_tpu_torch.api import (
    PreparedDetails,
    PreparedPart,
    TpuSlice,
    TpuSliceSpec,
)
from instaslice_tpu_torch.api.constants import REASON_ORPHAN_REAPED
from instaslice_tpu_torch.device.backend import (
    DeviceBackend,
    DeviceError,
    NodeInventory,
    SliceNotFound,
)
from instaslice_tpu_torch.kube.client import KubeClient, NotFound, update_with_retry
from instaslice_tpu_torch.obs.journal import get_journal
from instaslice_tpu_torch.topology.grid import get_generation, id_to_coord
from instaslice_tpu_torch.topology.mig import (
    grid_generation,
    slot_box,
    whole_gpu,
)
from instaslice_tpu_torch.topology.placement import Box
from instaslice_tpu_torch.topology.profiles import profile_catalog

log = logging.getLogger("instaslice_tpu_torch.agent")


def _owned_alloc_id(suid: str) -> Optional[str]:
    """The allocation id a ``slice_uuid_for``-shaped reservation handle
    derives from, or None for a foreign (non-instaslice) handle."""
    if suid.startswith("sl-mh-"):
        return suid[len("sl-mh-"):]
    if suid.startswith("sl-"):
        return suid[len("sl-"):]
    return None


def _dangling_box(chip_ids, host_bounds, offset=(0, 0, 0)) -> str:
    """Bounding box of an adopted reservation's chips. ``offset`` shifts
    host-local coords into global torus coords (PreparedDetails.box and
    AllocationDetails.box are always global; PreparedPart.local_box is
    host-local)."""
    coords = [id_to_coord(c, host_bounds) for c in chip_ids]
    lo = tuple(min(c[i] for c in coords) + offset[i] for i in range(3))
    hi = tuple(max(c[i] for c in coords) + 1 + offset[i] for i in range(3))
    return Box(lo, tuple(hi[i] - lo[i] for i in range(3))).key()  # type: ignore[arg-type]


def build_tpuslice(
    node_name: str,
    namespace: str,
    inv: NodeInventory,
    backend: DeviceBackend,
) -> TpuSlice:
    """Fresh CR content from a device inventory."""
    if is_gpu_grid(inv.generation):
        return _build_gpu_grid(node_name, namespace, inv, backend)
    gen = get_generation(inv.generation)
    spec = TpuSliceSpec(
        generation=inv.generation,
        host_offset=inv.host_offset,
        torus_group=inv.torus_group or node_name,
        chips={str(i): p for i, p in sorted(inv.chip_paths.items())},
        profiles=[
            {"name": p.name, **p.attributes()}
            for p in profile_catalog(inv.generation)
        ],
    )
    ts = TpuSlice(name=node_name, namespace=namespace, spec=spec)
    _adopt_dangling(ts, backend, gen.host_bounds, node_name, inv.host_offset)
    ts.status.processed = True
    return ts


def _build_gpu_grid(node_name, namespace, inv, backend) -> TpuSlice:
    """:func:`build_tpuslice` on a GPU grid."""
    generation = grid_generation(inv.generation)
    catalog = profile_catalog(generation)
    whole = whole_gpu(generation)
    if whole not in catalog:
        catalog.append(whole)
    spec = TpuSliceSpec(
        generation=generation,
        host_offset=(0, 0, 0),
        torus_group=node_name,
        chips={str(i): p for i, p in sorted(inv.chip_paths.items())},
        profiles=[{"name": p.name, **p.attributes()} for p in catalog],
    )
    ts = TpuSlice(name=node_name, namespace=namespace, spec=spec)
    _adopt_gpu_grid(ts, backend, node_name)
    ts.status.processed = True
    return ts


def _sweep_orphans(ts: TpuSlice, backend) -> Set[str]:
    """Restart reconciliation, device side (docs/RECOVERY.md): slice
    handles shaped like ours (``sl-``/``sl-mh-``) whose allocation id
    exists in NO CR epoch are orphans — a crashed agent reserved them
    (or a stale dangling adoption outlived its record) and the durable
    truth never claimed them. They are reaped (released + journaled
    ``OrphanReaped``), never adopted: adopting would strand the chips
    occupied forever with no owner to ever tear them down. Foreign
    handles keep the reference's adopt-as-dangling behavior — they are
    not ours to kill. Removes matching stale dangling prepared entries
    from ``ts`` in place; returns the orphan handle set (the caller
    releases them AFTER the CR write lands, so a lost write never
    races a freed device)."""
    orphans: Set[str] = set()
    for suid in list(ts.spec.prepared):
        prep = ts.spec.prepared[suid]
        aid = _owned_alloc_id(suid)
        if aid is None or prep.pod_uuid:
            continue
        if aid not in ts.spec.allocations:
            del ts.spec.prepared[suid]
            orphans.add(suid)
    try:
        reservations = backend.list_reservations()
    except DeviceError as e:
        log.warning("orphan sweep: list_reservations failed: %s", e)
        return orphans
    for r in reservations:
        aid = _owned_alloc_id(r.slice_uuid)
        if aid is not None and aid not in ts.spec.allocations:
            orphans.add(r.slice_uuid)
    return orphans


def _reap_orphans(backend, node_name: str, orphans: Set[str]) -> None:
    for suid in sorted(orphans):
        try:
            backend.release(suid)
        except SliceNotFound:
            pass  # stale prepared entry with no live reservation
        except DeviceError as e:
            # the next boot's sweep retries; the CR no longer counts
            # the chips, so worst case is a transiently over-reserved
            # device registry, never a double-placement
            log.warning("%s: orphan release %s failed: %s",
                        node_name, suid, e)
            continue
        get_journal().emit(
            f"agent-{node_name}",
            reason=REASON_ORPHAN_REAPED,
            object_ref=f"slice/{suid}",
            message=(f"released orphaned device slice {suid}: no CR "
                     "epoch claims it"),
        )
        log.warning("%s: reaped orphaned device slice %s", node_name,
                    suid)


def _known_handles(ts, skip: Optional[Set[str]]) -> Set[str]:
    """The device handles ``ts.spec.prepared`` already records, and
    ``skip``."""
    return {
        part.device_handle or uid
        for uid, p in ts.spec.prepared.items()
        for part in p.parts.values()
    } | set(ts.spec.prepared) | (skip or set())


def _adopt_dangling(ts, backend, host_bounds, node_name,
                    host_offset=(0, 0, 0), skip: Optional[Set[str]] = None,
                    ) -> None:
    """Device reservations with no prepared record become dangling
    prepared entries (podUUID="") so the placement engine counts their
    chips as occupied (reference: instaslice_controller.go:312-320).
    ``skip`` excludes orphans the restart sweep is about to reap."""
    known = _known_handles(ts, skip)
    for r in backend.list_reservations():
        if r.slice_uuid in known:
            continue
        ts.spec.prepared[r.slice_uuid] = PreparedDetails(
            slice_uuid=r.slice_uuid,
            pod_uuid="",
            profile="",
            box=_dangling_box(r.chip_ids, host_bounds, host_offset),
            parts={
                node_name: PreparedPart(
                    node_name=node_name,
                    worker_id=0,
                    local_box=_dangling_box(r.chip_ids, host_bounds),
                    chip_ids=list(r.chip_ids),
                    device_handle=r.slice_uuid,
                )
            },
        )
        log.info(
            "adopted dangling reservation %s (chips %s)",
            r.slice_uuid, list(r.chip_ids),
        )


def _gpu_box(r) -> Box:
    """The grid box of a reservation's memory slots on its GPUs."""
    gpus = sorted(r.chip_ids)
    box = slot_box(gpus[0], *r.slots)
    return Box(box.anchor, (box.shape[0], gpus[-1] - gpus[0] + 1, 1))


def _adopt_gpu_grid(ts, backend, node_name,
                    skip: Optional[Set[str]] = None) -> None:
    """:func:`_adopt_dangling` on a GPU grid: the registry's unclaimed
    reservations, one part per GPU keyed ``gpu<i>``, and the device's
    MIG instances no reservation records, as foreign handles."""
    known = _known_handles(ts, skip)
    found = [(r.slice_uuid, r) for r in backend.list_reservations()]
    for r in backend.dangling():
        handle = (r.device_uuids[0] if r.device_uuids
                  else f"mig-gpu{r.gpu}-gi{r.gpu_instance}")
        found.append((handle, r))
    for handle, r in found:
        if handle in known:
            continue
        box = _gpu_box(r)
        parts = {}
        for g in sorted(r.chip_ids):
            local = Box((box.anchor[0], 0, 0), (box.shape[0], 1, 1))
            parts[f"gpu{g}"] = PreparedPart(
                node_name=node_name,
                worker_id=0,
                local_box=local.key(),
                chip_ids=[g],
                device_handle=handle,
            )
        ts.spec.prepared[handle] = PreparedDetails(
            slice_uuid=handle,
            pod_uuid="",
            profile="",
            box=box.key(),
            parts=parts,
        )
        log.info(
            "adopted dangling %s %s (GPUs %s, slots %s)",
            "reservation" if r.slice_uuid else "MIG instance", handle,
            list(r.chip_ids), list(r.slots),
        )


def discover_node(
    client: KubeClient,
    backend: DeviceBackend,
    node_name: str,
    namespace: str,
) -> TpuSlice:
    """Create or refresh this node's CR. Safe to run on every boot —
    and the restart-reconciliation entry point: device truth is swept
    against the CR's allocations, and orphaned slices (device has
    them, no CR epoch claims them) are reaped after the CR write
    lands (docs/RECOVERY.md)."""
    inv = backend.discover()
    fresh = build_tpuslice(node_name, namespace, inv, backend)
    orphans: Set[str] = set()
    try:
        client.get("TpuSlice", namespace, node_name)
    except NotFound:
        # NO sweep on the create path: a fresh CR carries no history,
        # so "no epoch claims it" is vacuous here — and the CR may be
        # missing because an operator deleted it under LIVE workloads
        # (etcd restore), where releasing their chips would turn a
        # control-plane object loss into data-plane disruption. Adopt
        # everything as dangling (the reference behavior); the NEXT
        # boot's refresh sweep reaps what still has no claiming epoch.
        created = client.create("TpuSlice", fresh.to_manifest())
        log.info(
            "created TpuSlice %s/%s: %d chips, %d profiles",
            namespace, node_name, inv.chip_count, len(fresh.spec.profiles),
        )
        return TpuSlice.from_manifest(created)

    def refresh(obj: dict) -> dict:
        ts = TpuSlice.from_manifest(obj)
        # inventory/catalog/topology refresh; allocations/prepared are the
        # controller's + steady-state reconciler's business
        ts.spec.generation = fresh.spec.generation
        ts.spec.host_offset = fresh.spec.host_offset
        ts.spec.torus_group = fresh.spec.torus_group
        ts.spec.chips = fresh.spec.chips
        ts.spec.profiles = fresh.spec.profiles
        orphans.clear()
        orphans.update(_sweep_orphans(ts, backend))
        if is_gpu_grid(inv.generation):
            _adopt_gpu_grid(ts, backend, node_name, skip=orphans)
        else:
            hb = get_generation(inv.generation).host_bounds
            _adopt_dangling(ts, backend, hb, node_name, inv.host_offset,
                            skip=orphans)
        ts.status.processed = True
        return ts.to_manifest()

    out = update_with_retry(client, "TpuSlice", namespace, node_name, refresh)
    _reap_orphans(backend, node_name, orphans)
    return TpuSlice.from_manifest(out)
