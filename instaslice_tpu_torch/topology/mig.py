"""MIG profiles of the NVIDIA H100 80GB: the card's form of
:mod:`~instaslice_tpu_torch.topology.profiles`.

InstaSlice names a MIG profile from its slice counts and memory
(``MigProfile``/``NewMigProfile``,
``internal/controller/instaslice_daemonset.go:751-793``), asks NVML for
each profile's legal start indexes on the GPU's 8 memory slots
(``discoverAvailableProfilesOnGpus``, ``:588-664``) and places first-fit
over an 8-slot occupancy array per GPU
(``getStartIndexFromPreparedState``,
``internal/controller/instaslice_controller.go:303-384``).

Here the same job runs on the placement engine the TPU generations use.
A node's GPUs form one grid: the x axis is a GPU's 8 memory slots, the
y axis the GPU index (each GPU one "host" of the grid, its tile
``(8, 1, 1)``). A MIG slice is a :class:`Box` of ``(memory slices, 1,
1)`` whose anchors are the profile's legal start slots on each GPU,
taken from the catalog below instead of from alignment
(:func:`~instaslice_tpu_torch.topology.placement.legal_placements`
branches on :func:`mig_catalog`). :class:`Occupancy`, the six policies
and :func:`frag_metrics` then apply unchanged; first-fit scans GPU 0's
starts, then GPU 1's, as InstaSlice's ``FirstFitPolicy`` does.

The catalog is a fixed copy of the "H100 MIG profiles" table and the
H100 placement figure of NVIDIA's *Multi-Instance GPU User Guide*
(section "Supported MIG Profiles", H100 80GB). ``nvml_profile`` is the
``NVML_GPU_INSTANCE_PROFILE_*`` index that NVML's profile queries take;
``profile_id`` the id NVML answers with (``nvidia-smi mig -lgip``), the
one its placement and create calls take. On a card with MIG on, the NVML
backend reads the same table and the smoke compares the two.

A card without that catalog (an H100 NVL, any other NVIDIA card: the
node inventory's generation ``""``) is placed on the grid
:data:`WHOLE_GPU_GRID`, the same 8 slots a GPU, whose one profile is the
whole GPU; :func:`grid_generation` names it, and :func:`whole_gpu` and
:func:`gpu_group` take ``""`` for it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

from instaslice_tpu_torch.topology.grid import (
    NodeGrid,
    TorusGroup,
    get_generation,
)
from instaslice_tpu_torch.topology.placement import Box
from instaslice_tpu_torch.topology.profiles import TopologyProfile

#: memory slots of one GPU (the x extent of its tile)
SLOTS = 8
#: compute slices of one GPU
COMPUTE_SLICES = 7
#: the generation name of the H100 80GB's MIG grid (in ``GENERATIONS``)
H100_80GB = "h100-80gb"
#: the profile name of a whole-GPU reservation (MIG off, or a workload
#: that takes the card): the 7g.80gb box, granted without a partition
WHOLE_GPU = "gpu"
#: the generation name of the grid of a card with no MIG catalog (the
#: node inventory's generation ""): its GPUs are granted whole only, its
#: catalog is :data:`WHOLE_GPU` alone
WHOLE_GPU_GRID = "nvidia-gpu"

_MIG_NAME_RE = re.compile(r"(\d+g\.\d+gb)")


@dataclasses.dataclass(frozen=True)
class MigProfile(TopologyProfile):
    """One GPU instance profile. ``shape`` is ``(memory_slices, 1, 1)``
    and ``starts`` the legal start slots; ``nvml_profile`` is None for
    :data:`WHOLE_GPU`, which no NVML call creates."""

    mig_name: str = ""
    compute_slices: int = 0
    memory_gb: int = 0
    starts: Tuple[int, ...] = ()
    nvml_profile: Optional[int] = None
    profile_id: Optional[int] = None

    @property
    def name(self) -> str:
        return self.mig_name

    @property
    def memory_slices(self) -> int:
        return self.shape[0]


def _profile(name, mem, compute, gb, starts, nvml_profile, profile_id):
    return MigProfile(
        generation=H100_80GB, shape=(mem, 1, 1), mig_name=name,
        compute_slices=compute, memory_gb=gb, starts=tuple(starts),
        nvml_profile=nvml_profile, profile_id=profile_id,
    )


#: the H100 80GB's GPU instance profiles, smallest first (by memory
#: slices, then compute slices); 1g.10gb+me (one per GPU, with the media
#: engines) is left out
H100_80GB_PROFILES: Tuple[MigProfile, ...] = (
    _profile("1g.10gb", 1, 1, 10, range(7), 0, 19),
    _profile("1g.20gb", 2, 1, 20, (0, 2, 4, 6), 9, 15),
    _profile("2g.20gb", 2, 2, 20, (0, 2, 4), 1, 14),
    _profile("3g.40gb", 4, 3, 40, (0, 4), 2, 9),
    _profile("4g.40gb", 4, 4, 40, (0,), 3, 5),
    _profile("7g.80gb", 8, 7, 80, (0,), 4, 0),
)

_WHOLE = _profile(WHOLE_GPU, SLOTS, COMPUTE_SLICES, 80, (0,), None, None)
# the whole GPU of a card whose compute and memory the grid does not fix
_WHOLE_ONLY = MigProfile(
    generation=WHOLE_GPU_GRID, shape=(SLOTS, 1, 1), mig_name=WHOLE_GPU,
    starts=(0,))

_CATALOGS: Dict[str, Tuple[MigProfile, ...]] = {
    H100_80GB: H100_80GB_PROFILES, WHOLE_GPU_GRID: (_WHOLE_ONLY,)}
_WHOLES = {H100_80GB: _WHOLE, WHOLE_GPU_GRID: _WHOLE_ONLY}


def grid_generation(inventory_generation: str) -> str:
    """The grid a node inventory's generation names: its own, or
    :data:`WHOLE_GPU_GRID` for a card without a MIG catalog (``""``)."""
    return inventory_generation or WHOLE_GPU_GRID


def mig_catalog(gen_name: str) -> Optional[Tuple[MigProfile, ...]]:
    """The profiles of a GPU grid (the H100 80GB's MIG profiles; the
    whole GPU alone on :data:`WHOLE_GPU_GRID`), or None for a
    generation that is not a GPU grid (every TPU generation)."""
    return _CATALOGS.get(gen_name)


def whole_gpu(gen_name: str = H100_80GB) -> MigProfile:
    """The whole-GPU profile of a GPU grid; ``""`` (a card without a MIG
    catalog) names :data:`WHOLE_GPU_GRID`."""
    gen_name = grid_generation(gen_name)
    if gen_name not in _WHOLES:
        raise KeyError(f"{gen_name!r} has no MIG catalog")
    return _WHOLES[gen_name]


def parse_mig_profile(name: str, gen_name: str = H100_80GB) -> MigProfile:
    """``nvidia.com/mig-3g.40gb``, ``MIG 3g.40gb`` or ``3g.40gb`` ->
    :class:`MigProfile` by InstaSlice's ``(\\d+g\\.\\d+gb)`` rule;
    ``gpu`` or ``nvidia.com/gpu`` -> :data:`WHOLE_GPU`. Raises ValueError
    for a name the rule does not match or the catalog does not hold
    (InstaSlice's ``extractProfileName`` returns "" there)."""
    # here, not at the top: api/ imports topology/
    from instaslice_tpu_torch.api.constants import (
        GPU_RESOURCE,
        MIG_RESOURCE_PREFIX,
    )

    catalog = mig_catalog(gen_name)
    if catalog is None:
        raise ValueError(f"generation {gen_name!r} has no MIG catalog")
    stripped = name.strip()
    if stripped in (WHOLE_GPU, GPU_RESOURCE):
        return whole_gpu(gen_name)
    m = _MIG_NAME_RE.search(stripped)
    if not m:
        raise ValueError(
            f"malformed MIG profile name {name!r} (want e.g. "
            f"'{MIG_RESOURCE_PREFIX}1g.10gb')")
    for p in catalog:
        if p.mig_name == m.group(1):
            return p
    raise ValueError(
        f"profile {m.group(1)!r} is not in the {gen_name} catalog: "
        f"{[p.mig_name for p in catalog]}")


def gpu_group(gpu_count: int, gen_name: str = H100_80GB,
              group_id: str = "") -> TorusGroup:
    """The grid of a node's ``gpu_count`` GPUs: bounds ``(8, n, 1)``,
    one host per GPU named ``gpu<index>``; ``""`` (a card without a MIG
    catalog) names :data:`WHOLE_GPU_GRID`."""
    gen = get_generation(grid_generation(gen_name))
    if gpu_count < 1:
        raise ValueError(f"gpu_count must be positive, got {gpu_count}")
    return TorusGroup(
        group_id=group_id or "gpus", generation=gen,
        bounds=(SLOTS, gpu_count, 1),
        hosts={f"gpu{g}": NodeGrid(gen, (0, g, 0), group_id)
               for g in range(gpu_count)},
    )


def slot_box(gpu: int, start: int, size: int) -> Box:
    """The grid box of memory slots ``[start, start + size)`` of ``gpu``."""
    return Box((start, gpu, 0), (size, 1, 1))


def box_gpu_start(box: Box) -> Tuple[int, int]:
    """(GPU index, start slot) of a placement's box."""
    return box.anchor[1], box.anchor[0]


def compare_catalog(read: Sequence[dict],
                    gen_name: str = H100_80GB) -> List[str]:
    """Differences between NVML's profile table (``read``: one dict per
    profile with ``name``, ``slices``, ``memory_mb``, ``id`` and
    ``starts``, as :meth:`NvmlBackend.discover` reports it) and the
    fixed catalog; empty when they agree."""
    out = []
    by_name = {}
    for r in read:
        m = _MIG_NAME_RE.search(r.get("name", ""))
        if m and "+me" not in r["name"]:
            by_name[m.group(1)] = r
    for p in mig_catalog(gen_name) or ():
        r = by_name.get(p.mig_name)
        if r is None:
            out.append(f"{p.mig_name}: not in NVML's table")
            continue
        want = {"slices": p.compute_slices, "id": p.profile_id,
                "starts": list(p.starts), "size": p.memory_slices}
        for key, val in want.items():
            if r.get(key) is not None and r[key] != val:
                out.append(f"{p.mig_name}: {key} {r[key]} (catalog {val})")
    return out
