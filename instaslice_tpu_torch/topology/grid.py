"""TPU generations, host chip grids, and multi-host torus groups.

A copy of ``instaslice_tpu/topology/grid.py`` (the port imports nothing
of the JAX package), with one generation added: the MIG grid of the
H100 80GB (:mod:`~instaslice_tpu_torch.topology.mig`).

The reference's device model is a flat list of GPUs per node, each with 8
MIG slots (``api/v1alpha1/instaslice_types.go:64-98``: a
``MigGPUUUID`` map plus per-profile placement catalogs). A TPU node instead
exposes a *grid* of chips wired by ICI, and a node may be one tile of a
larger multi-host torus (e.g. a v5e-16 is a 4x4 mesh spanning two 2x4
hosts). This module models both levels:

- :class:`Generation` — per-TPU-generation constants (chips/host, host
  grid shape, HBM, cores).
- :class:`NodeGrid` — the chips owned by one node: local (x, y, z) coords
  and their local chip ids (the ids ``TPU_VISIBLE_CHIPS`` speaks).
- :class:`TorusGroup` — a set of hosts forming one contiguous physical
  mesh, against which multi-host placements are computed.

Coordinates are always 3-tuples ``(x, y, z)``; 2-D generations fix z=1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

Coord = Tuple[int, int, int]
Shape = Tuple[int, int, int]


def as3(dims: Sequence[int]) -> Shape:
    """Pad a 1/2/3-element dim sequence to a 3-tuple with trailing 1s."""
    d = tuple(int(x) for x in dims)
    if not 1 <= len(d) <= 3:
        raise ValueError(f"dims must have 1-3 elements, got {dims!r}")
    if any(x < 1 for x in d):
        raise ValueError(f"dims must be positive, got {dims!r}")
    return d + (1,) * (3 - len(d))  # type: ignore[return-value]


def volume(shape: Sequence[int]) -> int:
    v = 1
    for x in shape:
        v *= x
    return v


@dataclasses.dataclass(frozen=True)
class Generation:
    """Per-generation topology constants.

    ``host_bounds`` is the chip grid on a single host (the value that ends
    up in ``TPU_CHIPS_PER_HOST_BOUNDS``). ``dims`` is how many mesh axes
    the generation physically has (2 for v5e/v6e, 3 for v4/v5p) and
    controls profile-name rendering (``2x2`` vs ``2x2x1``).
    """

    name: str
    host_bounds: Shape  # chip grid per host
    dims: int  # 2 or 3
    hbm_gib_per_chip: int
    cores_per_chip: int
    max_slice_shape: Shape  # largest supported multi-host mesh

    @property
    def chips_per_host(self) -> int:
        return volume(self.host_bounds)

    def render_shape(self, shape: Sequence[int]) -> str:
        s = as3(shape)
        return "x".join(str(d) for d in s[: self.dims])


# The generation registry. host_bounds / max shapes follow public Cloud TPU
# topology documentation; the fake backend and tests use these as ground
# truth the same way the reference trusts NVML's profile enumeration
# (internal/controller/instaslice_daemonset.go:588-664).
GENERATIONS: Dict[str, Generation] = {
    g.name: g
    for g in [
        Generation("v4", as3((2, 2, 1)), 3, 32, 2, as3((8, 8, 8))),
        Generation("v5e", as3((2, 4)), 2, 16, 1, as3((16, 16))),
        Generation("v5p", as3((2, 2, 1)), 3, 95, 2, as3((16, 16, 12))),
        Generation("v6e", as3((2, 4)), 2, 32, 1, as3((16, 16))),
        # Not a TPU: the MIG grid of an NVIDIA H100 80GB, one GPU a
        # "host" of 8 memory slots of 10 GB (topology/mig.py, whose
        # catalog places it)
        Generation("h100-80gb", as3((8,)), 1, 10, 1, as3((8,))),
        # Not a TPU: the grid of a card with no MIG catalog (an H100 NVL,
        # any other NVIDIA card), granted only whole: one GPU a "host" of
        # the same 8 slots, whose one profile is the whole GPU
        # (topology/mig.py); its memory is the card's, not the grid's
        Generation("nvidia-gpu", as3((8,)), 1, 0, 1, as3((8,))),
    ]
}


def get_generation(name: str) -> Generation:
    try:
        return GENERATIONS[name]
    except KeyError:
        raise KeyError(
            f"unknown TPU generation {name!r}; known: {sorted(GENERATIONS)}"
        ) from None


def iter_coords(bounds: Shape) -> Iterator[Coord]:
    """Row-major iteration over all coords in [0, bounds). x fastest —
    matching libtpu's chip-id ordering (id = x + y*X + z*X*Y)."""
    for z in range(bounds[2]):
        for y in range(bounds[1]):
            for x in range(bounds[0]):
                yield (x, y, z)


def coord_to_id(coord: Coord, bounds: Shape) -> int:
    x, y, z = coord
    return x + y * bounds[0] + z * bounds[0] * bounds[1]


def id_to_coord(chip_id: int, bounds: Shape) -> Coord:
    x = chip_id % bounds[0]
    y = (chip_id // bounds[0]) % bounds[1]
    z = chip_id // (bounds[0] * bounds[1])
    return (x, y, z)


@dataclasses.dataclass(frozen=True)
class NodeGrid:
    """The chips one node owns, plus where that host sits in its torus.

    ``host_offset`` is the global coordinate of this host's (0,0,0) corner
    inside its :class:`TorusGroup` — the knob that lets the controller do
    multi-host placement, which the reference cannot do at all (SURVEY.md
    §7 "Multi-host slices ... the reference has no multi-node coordination").
    """

    generation: Generation
    host_offset: Coord = (0, 0, 0)
    torus_group: str = ""  # hosts with the same group id share a mesh

    @property
    def bounds(self) -> Shape:
        return self.generation.host_bounds

    @property
    def chip_count(self) -> int:
        return self.generation.chips_per_host

    def local_coords(self) -> List[Coord]:
        return list(iter_coords(self.bounds))

    def local_id(self, local_coord: Coord) -> int:
        return coord_to_id(local_coord, self.bounds)

    def global_coord(self, local_coord: Coord) -> Coord:
        return (
            self.host_offset[0] + local_coord[0],
            self.host_offset[1] + local_coord[1],
            self.host_offset[2] + local_coord[2],
        )

    def to_local(self, global_coord: Coord) -> Optional[Coord]:
        """Global→local, or None if the coord is not on this host."""
        lc = (
            global_coord[0] - self.host_offset[0],
            global_coord[1] - self.host_offset[1],
            global_coord[2] - self.host_offset[2],
        )
        b = self.bounds
        if all(0 <= lc[i] < b[i] for i in range(3)):
            return lc
        return None


@dataclasses.dataclass(frozen=True)
class TorusGroup:
    """A contiguous physical mesh formed by one or more hosts.

    ``bounds`` is the global chip-grid shape; ``hosts`` maps node name →
    :class:`NodeGrid`. The controller builds these from per-node
    ``TpuSlice`` CRs that share a ``torus_group`` id, then places profiles
    against the *global* grid (single-host profiles degenerate to the
    per-node case, which is the only case the reference supports).
    """

    group_id: str
    generation: Generation
    bounds: Shape
    hosts: Dict[str, NodeGrid]

    def __post_init__(self) -> None:
        hb = self.generation.host_bounds
        if any(self.bounds[i] % hb[i] != 0 for i in range(3)):
            raise ValueError(
                f"group bounds {self.bounds} not a whole multiple of host "
                f"bounds {hb}"
            )
        seen_offsets: Dict[Coord, str] = {}
        for name, ng in self.hosts.items():
            if ng.generation.name != self.generation.name:
                raise ValueError(
                    f"host {name} is {ng.generation.name} but group is "
                    f"{self.generation.name}"
                )
            off = ng.host_offset
            if any(off[i] % hb[i] != 0 for i in range(3)):
                raise ValueError(
                    f"host {name} offset {off} not aligned to host bounds {hb}"
                )
            if any(off[i] + hb[i] > self.bounds[i] for i in range(3)):
                raise ValueError(
                    f"host {name} at {off} exceeds group bounds {self.bounds}"
                )
            if off in seen_offsets:
                raise ValueError(
                    f"hosts {seen_offsets[off]} and {name} both claim "
                    f"offset {off}"
                )
            seen_offsets[off] = name

    @property
    def chip_count(self) -> int:
        return volume(self.bounds)

    def host_at(self, global_coord: Coord) -> Optional[str]:
        for name, ng in self.hosts.items():
            if ng.to_local(global_coord) is not None:
                return name
        return None

    def host_grid_shape(self) -> Shape:
        """How many hosts along each axis (TPU_HOST_BOUNDS for the full
        group)."""
        hb = self.generation.host_bounds
        return (
            self.bounds[0] // hb[0],
            self.bounds[1] // hb[1],
            self.bounds[2] // hb[2],
        )

    @staticmethod
    def single_host(
        node_name: str, generation: Generation, group_id: str = ""
    ) -> "TorusGroup":
        ng = NodeGrid(generation=generation, host_offset=(0, 0, 0),
                      torus_group=group_id or node_name)
        return TorusGroup(
            group_id=group_id or node_name,
            generation=generation,
            bounds=generation.host_bounds,
            hosts={node_name: ng},
        )
