"""The node agent's rules for a GPU grid, in one place.

The reference's agent (``instaslice_tpu/agent/``) runs on a TPU
generation's torus: a node is one host of the grid, an allocation's
part on it is keyed by the node's name, and its chips are the local
chip ids of the part's box. On a GPU grid
(:mod:`~instaslice_tpu_torch.topology.mig`: the H100 80GB's MIG grid, or
:data:`~instaslice_tpu_torch.topology.mig.WHOLE_GPU_GRID` for a card
without a MIG catalog) each GPU is a host named ``gpu<i>``, so the
copied agent keeps the reference's behaviour line for line on every TPU
generation and takes these rules where :func:`is_gpu_grid` holds:

- **The part.** The CR is per node and every allocation on the grid is
  on one GPU: the node's part is the allocation's one part, whatever its
  key (``gpu<i>``). That key is what ``pods_on_node``, ``realized_on``
  and ``prepared[...].parts`` are keyed by, so
  ``AllocationDetails.fully_realized()`` holds once this node realized
  it. A controller writes a GPU grid's allocations so: one part, keyed
  ``gpu<i>``, its box the MIG profile's (or the whole GPU's) slots.
- **Chip ids are GPU indices**, taken with the start slot from the
  allocation's box (:func:`~instaslice_tpu_torch.topology.mig.box_gpu_start`);
  ``AllocationDetails.local_chip_ids`` counts memory slots there and is
  never used.
- **The reserve** is ``reserve(suid, [gpu], profile, start)``, with
  profile ``""`` (and start -1) for the whole GPU.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from instaslice_tpu_torch.api.types import AllocationDetails
from instaslice_tpu_torch.topology.grid import get_generation
from instaslice_tpu_torch.topology.mig import (
    WHOLE_GPU,
    box_gpu_start,
    grid_generation,
    mig_catalog,
)


def is_gpu_grid(generation: str) -> bool:
    """True for a GPU grid's generation (a CR's, or an inventory's, where
    ``""`` is a card without a MIG catalog), False for a TPU one."""
    return mig_catalog(grid_generation(generation)) is not None


def part_key(alloc: AllocationDetails, node_name: str,
             generation: str) -> Optional[str]:
    """The key of this node's part of ``alloc``, or None when the node
    serves no part: the node's name on a TPU generation, the one part's
    key on a GPU grid."""
    if not is_gpu_grid(generation):
        return node_name if node_name in alloc.parts else None
    if len(alloc.parts) != 1:
        return None
    return next(iter(alloc.parts))


def gpu_start(alloc: AllocationDetails) -> Tuple[int, int]:
    """(GPU index, start slot) of an allocation on a GPU grid."""
    return box_gpu_start(alloc.global_box())


def chip_ids(alloc: AllocationDetails, node_name: str,
             generation: str) -> List[int]:
    """The chips this node reserves for ``alloc``: local chip ids on a
    TPU generation, the GPU index on a GPU grid."""
    if not is_gpu_grid(generation):
        return alloc.local_chip_ids(
            node_name, get_generation(generation).host_bounds)
    return [gpu_start(alloc)[0]]


def reserve_args(alloc: AllocationDetails) -> Tuple[str, int]:
    """(profile, start) of the reserve of an allocation on a GPU grid."""
    if alloc.profile == WHOLE_GPU:
        return "", -1
    return alloc.profile, gpu_start(alloc)[1]
