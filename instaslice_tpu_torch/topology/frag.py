"""Fragmentation metrics over one torus group's occupancy.

The placement engine guarantees every *granted* box is a contiguous,
aligned ICI rectangle — but it says nothing about what the free space
looks like after churn. Under a mixed-profile workload the free chips
scatter: plenty of capacity by chip count, yet no aligned box large
enough for the next big request ("An Online Fragmentation-Aware GPU
Scheduler for Multi-Tenant MIG-based Clouds" calls this the
fragmentation gap; PAPERS.md). This module quantifies that gap:

- :func:`free_fit_boxes` — every currently-free aligned placement box,
  per catalog profile (the 2/3-D analog of the paper's per-profile
  "can still start" counts);
- :func:`frag_metrics` — the per-group summary (largest free box,
  per-profile fit counts, stranded-capacity fraction) behind the
  ``NoCapacity`` journal snapshot and the repacker's planning;
- :func:`weighted_free_capacity` — the chip-count-weighted survivor
  score :class:`~instaslice_tpu_torch.topology.policy.FragAwarePolicy`
  maximizes: taking a placement that destroys a free 2x2 box costs 4,
  one that only nibbles an already-broken quad costs 1.

Everything here is pure (grid + set arithmetic, no kube, no device),
and cheap enough to run inline: groups are <= 256 chips, so the
exhaustive box enumeration is a few hundred overlap checks.

A copy of ``instaslice_tpu/topology/frag.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from instaslice_tpu_torch.topology.grid import TorusGroup
from instaslice_tpu_torch.topology.placement import (
    Box,
    Occupancy,
    legal_placements,
)
from instaslice_tpu_torch.topology.profiles import TopologyProfile, profile_catalog


def free_fit_boxes(
    group: TorusGroup,
    occupancy: Occupancy,
    catalog: Optional[Sequence[TopologyProfile]] = None,
) -> List[Tuple[TopologyProfile, Box]]:
    """Every (profile, box) pair the group could still grant right now:
    all orientations x all aligned anchors of every catalog profile whose
    box is currently free."""
    taken = occupancy.taken
    if catalog is None:
        catalog = profile_catalog(group.generation.name, group.chip_count)
    out: List[Tuple[TopologyProfile, Box]] = []
    for p in catalog:
        for pl in legal_placements(group, p):
            if not any(c in taken for c in pl.box.coords()):
                out.append((p, pl.box))
    return out


def weighted_free_capacity(
    boxes: Sequence[Tuple[TopologyProfile, Box]],
    excluding: Optional[Box] = None,
) -> int:
    """Chip-count-weighted count of free placement boxes (optionally
    only those surviving a candidate placement ``excluding``). The
    weight makes losing a large contiguous box cost proportionally
    more than losing a 1x1 cell — the marginal-fragmentation score."""
    return sum(
        p.chip_count
        for p, b in boxes
        if excluding is None or not b.overlaps(excluding)
    )


@dataclasses.dataclass(frozen=True)
class FragMetrics:
    """One torus group's fragmentation summary."""

    group_id: str
    total_chips: int
    free_chips: int
    #: profile name -> number of currently-free placements of it
    fit_counts: Dict[str, int]
    #: largest catalog profile with at least one free placement
    #: ("" when nothing fits — total exhaustion or total fragmentation)
    largest_free_box: str
    largest_free_chips: int
    #: free chips covered by NO free placement of the largest placeable
    #: profile: capacity only smaller requests can ever use until a
    #: repack (or a release) reshapes the free space
    stranded_free_chips: int

    @property
    def stranded_fraction(self) -> float:
        return (
            self.stranded_free_chips / self.free_chips
            if self.free_chips else 0.0
        )


def frag_metrics(
    group: TorusGroup,
    occupancy: Occupancy,
    catalog: Optional[Sequence[TopologyProfile]] = None,
) -> FragMetrics:
    if catalog is None:
        catalog = profile_catalog(group.generation.name, group.chip_count)
    boxes = free_fit_boxes(group, occupancy, catalog)
    fit_counts: Dict[str, int] = {p.name: 0 for p in catalog}
    for p, _b in boxes:
        fit_counts[p.name] += 1
    largest: Optional[TopologyProfile] = None
    for p in catalog:  # catalog is sorted smallest-first
        if fit_counts[p.name]:
            largest = p
    free = occupancy.free_chips()
    if largest is None:
        stranded = free
    else:
        covered: set = set()
        for p, b in boxes:
            if p.name == largest.name:
                covered.update(b.coords())
        taken = occupancy.taken
        stranded = sum(
            1
            for c in _group_coords(group)
            if c not in taken and c not in covered
        )
    return FragMetrics(
        group_id=group.group_id,
        total_chips=group.chip_count,
        free_chips=free,
        fit_counts=fit_counts,
        largest_free_box=largest.name if largest else "",
        largest_free_chips=largest.chip_count if largest else 0,
        stranded_free_chips=stranded,
    )


def _group_coords(group: TorusGroup):
    """All chip coords the group's hosts actually own (sparse groups
    have holes the bounds-box iteration would miscount)."""
    hb = group.generation.host_bounds
    for ng in group.hosts.values():
        off = ng.host_offset
        for z in range(hb[2]):
            for y in range(hb[1]):
                for x in range(hb[0]):
                    yield (off[0] + x, off[1] + y, off[2] + z)


def snapshot_line(m: FragMetrics) -> str:
    """One-line operator rendering, used by the once-per-wait
    ``NoCapacity`` journal event so `tpuslice describe pod` can tell
    fragmentation ("free chips exist but scattered") from true
    exhaustion ("no free chips at all")."""
    if not m.free_chips:
        return f"0/{m.total_chips} chips free (exhausted)"
    if not m.largest_free_box:
        return (
            f"{m.free_chips}/{m.total_chips} chips free but NO aligned "
            "box fits (fully fragmented)"
        )
    return (
        f"{m.free_chips}/{m.total_chips} chips free, largest free box "
        f"{m.largest_free_box} x{m.fit_counts[m.largest_free_box]}"
        + (f", {m.stranded_free_chips} stranded"
           if m.stranded_free_chips else "")
    )
