"""Allocation policies — strategy interface over the placement engine.

Reference analog: the ``AllocationPolicy`` interface with a single real
implementation (``FirstFitPolicy.SetAllocationDetails``) and two empty
stubs (``internal/controller/instaslice_controller.go:
48-50,436-469``). Here every registered policy is real.

A copy of ``instaslice_tpu/topology/policy.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Type

from instaslice_tpu_torch.topology.grid import TorusGroup
from instaslice_tpu_torch.topology.placement import (
    Occupancy,
    Placement,
    find_placements,
    legal_placements,
)
from instaslice_tpu_torch.topology.profiles import TopologyProfile, profile_catalog


class AllocationPolicy(abc.ABC):
    """Choose a placement for a profile given current occupancy."""

    name: str = ""

    @abc.abstractmethod
    def choose(
        self,
        group: TorusGroup,
        profile: TopologyProfile,
        occupancy: Occupancy,
    ) -> Optional[Placement]:
        ...


class FirstFitPolicy(AllocationPolicy):
    """First free legal placement in scan order (x fastest, then y, z).

    Matches the reference's only working policy
    (instaslice_controller.go:436-453) but without its missing-``break``
    multi-node double-allocation bug — `choose` returns exactly one
    placement (SURVEY.md §7 quirks list).
    """

    name = "first-fit"

    def choose(self, group, profile, occupancy):
        cands = find_placements(group, profile, occupancy)
        return cands[0] if cands else None


class BestFitPolicy(AllocationPolicy):
    """Fragmentation-minimizing fit.

    Scores each candidate by how many legal placements of every catalog
    profile would survive after taking it; picks the max. Grids are tiny
    (<=256 chips) so exhaustive scoring is cheap — this replaces the
    reference's LeftToRight/RightToLeft stubs (:455-469) with a policy
    that measurably improves the bin-packing stress config (BASELINE.md).
    """

    name = "best-fit"

    def choose(self, group, profile, occupancy):
        cands = find_placements(group, profile, occupancy)
        if not cands:
            return None
        if len(cands) == 1:
            return cands[0]
        taken = occupancy.taken
        # Pre-filter to boxes that are still free; score each candidate by
        # how many of those would survive it (non-overlap is all that's
        # left to check per candidate).
        free_boxes: List = []
        for p in profile_catalog(group.generation.name, group.chip_count):
            for pl in legal_placements(group, p):
                if not any(c in taken for c in pl.box.coords()):
                    free_boxes.append(pl.box)

        def survivors(cand: Placement) -> int:
            return sum(1 for b in free_boxes if not b.overlaps(cand.box))

        return max(
            cands, key=lambda c: (survivors(c), [-v for v in c.box.anchor])
        )


class PackedFitPolicy(AllocationPolicy):
    """Corner-packing: prefer the placement closest to the grid origin,
    keeping the far corner maximally contiguous for large profiles."""

    name = "packed-fit"

    def choose(self, group, profile, occupancy):
        cands = find_placements(group, profile, occupancy)
        if not cands:
            return None
        return min(
            cands, key=lambda c: (sum(c.box.anchor), c.box.anchor[::-1])
        )


class FragAwarePolicy(AllocationPolicy):
    """Fragmentation-cost scoring: pick the candidate that preserves the
    most chip-count-weighted free capacity.

    :class:`BestFitPolicy` counts surviving free boxes; this policy
    weights each survivor by its chip count
    (:func:`~instaslice_tpu_torch.topology.frag.weighted_free_capacity`), so
    destroying a free 2x2 box costs 4x what nibbling an already-broken
    quad costs — small slices are steered into fragments and large
    contiguous boxes stay whole for large requests (the
    fragmentation-gradient scoring of the MIG fragmentation paper,
    PAPERS.md). Ties break toward the origin corner. Pairs with the
    repacker (``controller/defrag.py``), which recovers the capacity
    this policy alone cannot protect under churn."""

    name = "frag-aware"

    def choose(self, group, profile, occupancy):
        from instaslice_tpu_torch.topology.frag import (
            free_fit_boxes,
            weighted_free_capacity,
        )

        cands = find_placements(group, profile, occupancy)
        if not cands:
            return None
        if len(cands) == 1:
            return cands[0]
        boxes = free_fit_boxes(group, occupancy)
        return max(
            cands,
            key=lambda c: (
                weighted_free_capacity(boxes, excluding=c.box),
                [-v for v in c.box.anchor],
            ),
        )


class LeftToRightPolicy(AllocationPolicy):
    """Lowest anchor along the x axis (ties: y, then z) — the policy the
    reference declares but leaves as an empty stub
    (``LeftToRightPolicy.SetAllocationDetails``,
    instaslice_controller.go:455-461), implemented for real. Pairs with
    :class:`RightToLeftPolicy` to segregate long-lived and short-lived
    workloads at opposite ends of the torus."""

    name = "left-to-right"

    def choose(self, group, profile, occupancy):
        cands = find_placements(group, profile, occupancy)
        if not cands:
            return None
        return min(cands, key=lambda c: c.box.anchor)


class RightToLeftPolicy(AllocationPolicy):
    """Highest far-corner along the x axis (ties: y, then z) — the
    reference's other empty stub (instaslice_controller.go:463-469),
    implemented for real."""

    name = "right-to-left"

    def choose(self, group, profile, occupancy):
        cands = find_placements(group, profile, occupancy)
        if not cands:
            return None
        return max(
            cands,
            key=lambda c: tuple(
                c.box.anchor[i] + c.box.shape[i] for i in range(3)
            ),
        )


_REGISTRY: Dict[str, Type[AllocationPolicy]] = {
    p.name: p
    for p in (
        FirstFitPolicy,
        BestFitPolicy,
        FragAwarePolicy,
        PackedFitPolicy,
        LeftToRightPolicy,
        RightToLeftPolicy,
    )
}


def get_policy(name: str) -> AllocationPolicy:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"unknown allocation policy {name!r}; registered policies: "
            f"{', '.join(sorted(_REGISTRY))} (select with --policy or "
            "the TPUSLICE_PLACEMENT_POLICY env var)"
        ) from None


def policy_names() -> List[str]:
    return sorted(_REGISTRY)
