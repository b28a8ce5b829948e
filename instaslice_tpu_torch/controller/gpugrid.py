"""The controller's rules for a GPU grid, in one place.

The reference's controller (``instaslice_tpu/controller/``) places on a
TPU generation's torus: a torus group's hosts are its member CRs, keyed
by the CR's name; an allocation's parts are keyed by the CRs that hold
them; chip ids are local chips of a host; and a request names its
generation (``v5e-2x2``). The node agent publishes a GPU node otherwise
(:mod:`~instaslice_tpu_torch.agent.gpugrid`,
:mod:`~instaslice_tpu_torch.agent.discovery`): one CR per node, its
``torusGroup`` the node's name, its generation a GPU grid
(``h100-80gb``, or ``nvidia-gpu`` for a card without a MIG catalog),
one chip a GPU, and every allocation on one GPU with one part keyed by
the grid's host ``gpu<i>``. The copied controller keeps the reference's
lines on every TPU generation and takes these rules where
:func:`is_gpu_grid` holds:

- **The group** of a GPU-grid CR is :func:`~instaslice_tpu_torch.topology.mig.gpu_group`
  of n GPUs, n one more than the highest GPU index in ``spec.chips``,
  with hosts ``gpu0..gpu<n-1>`` (:func:`build_group`). A GPU index
  missing from ``chips`` is blocked (:func:`blocked_coords`).
- **The holder** of every part is the CR named ``alloc.torus_group``
  (:func:`holders`): the fan-out writes, the fan-out repair, the
  status edges, the health read and the avoid sets, which hold CR
  (node) names only.
- **The in-flight overlay** matches its entries by group id
  (:func:`inflight_applies`): every node has a ``gpu0``.
- **Unhealthy chips are GPU indices**: they block that GPU's 8 slots
  (:func:`blocked_coords`), and health flags only the allocations on a
  failed GPU (:func:`dead_chips`).
- **An avoided node** blocks all of its GPUs (:func:`avoid_coords`).
- **A request** names no generation (``3g.40gb``, ``gpu``): it is read
  against each GPU group's own catalog, and a group whose catalog lacks
  it is skipped (:func:`group_profile`); a request's or an
  allocation's profile name is parsed by :func:`parse_profile`.
"""

from __future__ import annotations

import logging
from typing import Dict, FrozenSet, List, Optional

from instaslice_tpu_torch.agent.gpugrid import gpu_start, is_gpu_grid  # noqa: F401
from instaslice_tpu_torch.api.types import AllocationDetails, TpuSlice
from instaslice_tpu_torch.topology.grid import Coord, TorusGroup
from instaslice_tpu_torch.topology.mig import (
    H100_80GB,
    H100_80GB_PROFILES,
    SLOTS,
    WHOLE_GPU,
    gpu_group,
    parse_mig_profile,
    slot_box,
)
from instaslice_tpu_torch.topology.placement import Box
from instaslice_tpu_torch.topology.profiles import (
    TopologyProfile,
    parse_profile_name,
)

log = logging.getLogger("instaslice_tpu_torch.controller")

#: the profile names of the GPU grids' catalogs
_GPU_PROFILES = frozenset(p.name for p in H100_80GB_PROFILES) | {WHOLE_GPU}


def is_gpu_profile(name: str) -> bool:
    """True for a GPU grid's profile name (a MIG profile, ``3g.40gb``, or
    the whole GPU, ``gpu``), False for a TPU one (``v5e-2x2``)."""
    return name in _GPU_PROFILES


def parse_profile(name: str) -> TopologyProfile:
    """A request's or an allocation's profile by name: a TPU name through
    ``parse_profile_name``, a GPU one through the H100 80GB's catalog
    (:func:`group_profile` reads it against a group's own). Raises
    ValueError for a name neither rule takes."""
    if is_gpu_profile(name):
        return parse_mig_profile(name, H100_80GB)
    return parse_profile_name(name)


def group_profile(profile: TopologyProfile,
                  gen_name: str) -> Optional[TopologyProfile]:
    """``profile`` as a group of generation ``gen_name`` takes it, or
    None when the group cannot: on a TPU generation the profile itself
    where the generations match (the reference's filter); on a GPU grid
    a GPU request read against the grid's own catalog."""
    if is_gpu_grid(gen_name) and is_gpu_profile(profile.name):
        try:
            return parse_mig_profile(profile.name, gen_name)
        except ValueError:
            return None
    return profile if profile.generation == gen_name else None


def build_group(gid: str, members: List[TpuSlice]) -> Optional[TorusGroup]:
    """The grid of a GPU node's CR: ``gpu_group(n)`` with n one more
    than its highest GPU index. None (logged) for a group of more than
    one CR or a CR without GPUs: the agent publishes one CR a node."""
    if len(members) != 1:
        log.warning("GPU group %s has %d CRs (one a node); skipping",
                    gid, len(members))
        return None
    try:
        gpus = [int(c) for c in members[0].spec.chips]
        return gpu_group(max(gpus) + 1, members[0].spec.generation,
                         group_id=gid)
    except ValueError as e:
        log.warning("GPU group %s invalid: %s", gid, e)
        return None


def _gpu_coords(gpu: int) -> List[Coord]:
    return slot_box(gpu, 0, SLOTS).coords()


def blocked_coords(group: TorusGroup,
                   members: List[TpuSlice]) -> List[Coord]:
    """The slots a GPU group never places on: every slot of a GPU that
    its CR reports unhealthy (``status.unhealthyChips`` holds GPU
    indices) or that its ``chips`` do not list."""
    n = group.bounds[1]
    out: List[Coord] = []
    for ts in members:
        listed = {int(c) for c in ts.spec.chips}
        for gpu in range(n):
            if gpu in ts.status.unhealthy_chips or gpu not in listed:
                out.extend(_gpu_coords(gpu))
    return out


def avoid_coords(group: TorusGroup) -> List[Coord]:
    """Every slot of an avoided node: all of its GPUs."""
    return Box((0, 0, 0), group.bounds).coords()


def inflight_applies(group: TorusGroup, nodes: FrozenSet[str],
                     gid: str) -> bool:
    """Whether an in-flight entry (its placement's host names and group
    id) lands on ``group``: by group id on a GPU grid, where every node
    has a ``gpu0``; by host names on a TPU generation (the
    reference's rule)."""
    if is_gpu_grid(group.generation.name):
        return gid == group.group_id
    return bool(nodes & set(group.hosts))


def holders(alloc: AllocationDetails) -> List[str]:
    """The CRs that hold ``alloc``'s record: the CR named by each part on
    a TPU generation (the reference's rule), the node's CR
    (``alloc.torus_group``) on a GPU grid, whose part keys are its
    GPUs."""
    if is_gpu_profile(alloc.profile):
        return [alloc.torus_group]
    return list(alloc.parts)


def laggards(alloc: AllocationDetails) -> List[str]:
    """The nodes a grant stuck in ``creating`` is blamed on: its
    unrealized parts (else all of them) on a TPU generation, the
    reference's rule; the node's CR on a GPU grid."""
    if is_gpu_profile(alloc.profile):
        return holders(alloc)
    return sorted(set(alloc.parts) - set(alloc.realized_on)) or sorted(
        alloc.parts)


def dead_chips(alloc: AllocationDetails,
               slices: List[TpuSlice]) -> Dict[str, List[int]]:
    """Holder CR name -> the failed GPU indices ``alloc`` sits on, for an
    allocation on a GPU grid: its one GPU, where its holder reports it
    unhealthy."""
    gpu = gpu_start(alloc)[0]
    out: Dict[str, List[int]] = {}
    for ts in slices:
        if ts.name == alloc.torus_group and gpu in ts.status.unhealthy_chips:
            out[ts.name] = [gpu]
    return out
