"""Placement engine: aligned boxes on the chip mesh + occupancy tracking.

A copy of ``instaslice_tpu/topology/placement.py`` (the port imports
nothing of the JAX package). One branch is added: on a MIG grid
(:mod:`~instaslice_tpu_torch.topology.mig`) a profile's anchors are its
catalog's start slots on each GPU instead of the aligned ones.

Reference analog: ``getStartIndexFromPreparedState``
(``internal/controller/instaslice_controller.go:303-384``)
builds an 8-slot boolean occupancy array per GPU from ``Prepared`` +
``Allocations`` and hand-rolls contiguity checks for sizes 1/2/4/8 — with
off-by-one bugs that make size-8 unplaceable (``:351,360,370``, SURVEY.md
§7 quirks). Here the same job is done in 2/3-D, generically:

- anchors are *aligned*: ``anchor[d] % shape[d] == 0`` on every axis, so
  placements tile the mesh exactly, never fragment it, and every granted
  box is a contiguous ICI rectangle;
- occupancy is a set of global chip coords derived from desired
  (``Allocations``) plus realized (``Prepared``) state, exactly mirroring
  the reference's two-source occupancy scan (``:306-329``);
- multi-host boxes decompose into whole per-host sub-rectangles, each of
  which one node agent realizes (new capability — the reference has no
  multi-node coordination, SURVEY.md §7).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from instaslice_tpu_torch.topology.grid import (
    Coord,
    Shape,
    TorusGroup,
    coord_to_id,
    volume,
)
from instaslice_tpu_torch.topology.profiles import TopologyProfile, orientations


@dataclasses.dataclass(frozen=True)
class Box:
    """Axis-aligned box [anchor, anchor+shape) in global mesh coords."""

    anchor: Coord
    shape: Shape

    @property
    def chip_count(self) -> int:
        return volume(self.shape)

    def coords(self) -> List[Coord]:
        out = []
        ax, ay, az = self.anchor
        sx, sy, sz = self.shape
        for z in range(az, az + sz):
            for y in range(ay, ay + sy):
                for x in range(ax, ax + sx):
                    out.append((x, y, z))
        return out

    def contains(self, c: Coord) -> bool:
        return all(
            self.anchor[i] <= c[i] < self.anchor[i] + self.shape[i]
            for i in range(3)
        )

    def overlaps(self, other: "Box") -> bool:
        return all(
            self.anchor[i] < other.anchor[i] + other.shape[i]
            and other.anchor[i] < self.anchor[i] + self.shape[i]
            for i in range(3)
        )

    def key(self) -> str:
        """Stable string key for CR serialization, e.g. ``2,0,0+2x2x1``."""
        a = ",".join(str(v) for v in self.anchor)
        s = "x".join(str(v) for v in self.shape)
        return f"{a}+{s}"

    @staticmethod
    def from_key(key: str) -> "Box":
        a_str, s_str = key.split("+")
        anchor = tuple(int(v) for v in a_str.split(","))
        shape = tuple(int(v) for v in s_str.split("x"))
        if len(anchor) != 3 or len(shape) != 3:
            raise ValueError(f"malformed box key {key!r}")
        return Box(anchor, shape)  # type: ignore[arg-type]


@dataclasses.dataclass(frozen=True)
class HostPart:
    """One host's share of a (possibly multi-host) placement.

    ``worker_id`` orders the hosts for ``TPU_WORKER_ID`` assignment;
    ``local_box`` is in the host's local coords so the node agent can map
    it to local chip ids (``TPU_VISIBLE_CHIPS``) without knowing the group.
    """

    node_name: str
    worker_id: int
    local_box: Box

    def local_chip_ids(self, host_bounds: Shape) -> List[int]:
        return sorted(
            coord_to_id(c, host_bounds) for c in self.local_box.coords()
        )


@dataclasses.dataclass(frozen=True)
class Placement:
    """A concrete grant: profile + global box + per-host decomposition."""

    profile: TopologyProfile
    group_id: str
    box: Box
    parts: Tuple[HostPart, ...]

    @property
    def node_names(self) -> List[str]:
        return [p.node_name for p in self.parts]

    def part_for(self, node_name: str) -> Optional[HostPart]:
        for p in self.parts:
            if p.node_name == node_name:
                return p
        return None


class Occupancy:
    """Set of occupied global chip coords in one torus group.

    Built from both desired and realized slices, mirroring the reference's
    dual scan of ``Allocations`` and ``Prepared``
    (instaslice_controller.go:306-329): an allocation holds its chips from
    the moment the controller writes it, even before any agent realizes it,
    so two in-flight pods can never be granted overlapping boxes.
    """

    def __init__(self, group: TorusGroup) -> None:
        self.group = group
        self._taken: Set[Coord] = set()
        self._boxes: Dict[str, Box] = {}  # owner key -> box

    @property
    def taken(self) -> FrozenSet[Coord]:
        return frozenset(self._taken)

    def free_chips(self) -> int:
        return self.group.chip_count - len(self._taken)

    def occupy(self, box: Box, owner: str = "") -> None:
        coords = box.coords()
        for c in coords:
            if any(c[i] >= self.group.bounds[i] or c[i] < 0 for i in range(3)):
                raise ValueError(f"box {box.key()} outside bounds {self.group.bounds}")
        clash = [c for c in coords if c in self._taken]
        if clash:
            raise ValueError(
                f"box {box.key()} overlaps occupied chips {sorted(clash)[:4]}"
            )
        self._taken.update(coords)
        if owner:
            self._boxes[owner] = box

    def block(self, coords: List[Coord]) -> None:
        """Mark chips unusable (unhealthy hardware) without overlap
        accounting: blocking a chip already inside a granted box is legal —
        the grant stands (its teardown is the health monitor's business),
        but no NEW placement may use the chip. Out-of-bounds coords are
        ignored (stale health data for a chip this group no longer maps)."""
        for c in coords:
            if all(0 <= c[i] < self.group.bounds[i] for i in range(3)):
                self._taken.add(c)

    def release(self, box: Box, owner: str = "") -> None:
        if owner:
            held = self._boxes.get(owner)
            if held is None:
                raise ValueError(
                    f"owner {owner!r} holds no box, refusing to release "
                    f"{box.key()} (stale/duplicate release?)"
                )
            if held != box:
                raise ValueError(
                    f"owner {owner!r} holds box {held.key()}, refusing to "
                    f"release mismatched box {box.key()}"
                )
        for c in box.coords():
            self._taken.discard(c)
        if owner:
            self._boxes.pop(owner, None)

    def fits(self, box: Box) -> bool:
        return (
            all(
                0 <= box.anchor[i]
                and box.anchor[i] + box.shape[i] <= self.group.bounds[i]
                for i in range(3)
            )
            and not any(c in self._taken for c in box.coords())
        )


def legal_anchors(bounds: Shape, shape: Shape) -> List[Coord]:
    """All aligned anchors for ``shape`` within ``bounds``.

    Alignment (anchor multiple of shape on every axis) is what the
    reference *discovers* from NVML as per-profile legal start indexes
    (instaslice_daemonset.go:637-648); on TPU it is a topological law —
    unaligned rectangles would strand chips that can never join an aligned
    slice.
    """
    out: List[Coord] = []
    for z in range(0, bounds[2] - shape[2] + 1, shape[2]):
        for y in range(0, bounds[1] - shape[1] + 1, shape[1]):
            for x in range(0, bounds[0] - shape[0] + 1, shape[0]):
                out.append((x, y, z))
    return out


def legal_placements(
    group: TorusGroup, profile: TopologyProfile
) -> List[Placement]:
    """Every legal placement of ``profile`` in ``group`` (ignoring
    occupancy), in scan order: all orientations x all aligned anchors.

    A placement is legal when its box fits the group bounds, every host it
    touches actually exists in the group (sparse groups are allowed — a
    drained node leaves a hole), and the box decomposes into whole per-host
    rectangles.
    """
    from instaslice_tpu_torch.topology.mig import mig_catalog

    gen = group.generation
    if profile.generation != gen.name:
        return []
    if mig_catalog(gen.name) is not None:
        # a MIG grid: the profile's start slots on each GPU (y), in the
        # x-fastest scan order of legal_anchors
        scan = [(profile.shape, [(s, y, 0) for y in range(group.bounds[1])
                                 for s in profile.starts])]
    else:
        scan = [(shape, legal_anchors(group.bounds, shape))
                for shape in orientations(gen, profile.shape)]
    placements: List[Placement] = []
    for shape, anchors in scan:
        for anchor in anchors:
            box = Box(anchor, shape)
            parts = _decompose(group, box)
            if parts is None:
                continue
            placements.append(
                Placement(
                    profile=profile,
                    group_id=group.group_id,
                    box=box,
                    parts=tuple(parts),
                )
            )
    return placements


def _decompose(group: TorusGroup, box: Box) -> Optional[List[HostPart]]:
    """Split a global box into per-host local sub-rectangles.

    Returns None if any host tile the box touches is missing from the
    group. Worker ids are assigned in host-offset order (z, y, x) —
    deterministic, so every agent and the controller agree on
    ``TPU_WORKER_ID`` without negotiation.
    """
    hb = group.generation.host_bounds
    touched: Dict[str, Box] = {}
    hosts_sorted = sorted(
        group.hosts.items(),
        key=lambda kv: (kv[1].host_offset[2], kv[1].host_offset[1], kv[1].host_offset[0]),
    )
    # Which host tiles does the box intersect?
    needed_tiles = set()
    for c in box.coords():
        needed_tiles.add((c[0] // hb[0] * hb[0], c[1] // hb[1] * hb[1], c[2] // hb[2] * hb[2]))
    offset_to_host = {ng.host_offset: name for name, ng in group.hosts.items()}
    for tile in needed_tiles:
        if tile not in offset_to_host:
            return None
    parts: List[HostPart] = []
    worker_id = 0
    for name, ng in hosts_sorted:
        off = ng.host_offset
        # Intersection of box with this host's tile, in global coords.
        lo = tuple(max(box.anchor[i], off[i]) for i in range(3))
        hi = tuple(
            min(box.anchor[i] + box.shape[i], off[i] + hb[i]) for i in range(3)
        )
        if any(lo[i] >= hi[i] for i in range(3)):
            continue
        local_anchor = tuple(lo[i] - off[i] for i in range(3))
        local_shape = tuple(hi[i] - lo[i] for i in range(3))
        parts.append(
            HostPart(
                node_name=name,
                worker_id=worker_id,
                local_box=Box(local_anchor, local_shape),  # type: ignore[arg-type]
            )
        )
        worker_id += 1
    return parts


def find_placements(
    group: TorusGroup,
    profile: TopologyProfile,
    occupancy: Occupancy,
) -> List[Placement]:
    """Legal placements whose boxes are currently free, in scan order."""
    return [
        p for p in legal_placements(group, profile) if occupancy.fits(p.box)
    ]
