"""Topology profiles — the TPU analog of MIG profiles (``1g.5gb`` etc.).

A copy of ``instaslice_tpu/topology/profiles.py`` (the port imports
nothing of the JAX package). One branch is added: the catalog of a MIG
grid is :func:`~instaslice_tpu_torch.topology.mig.mig_catalog`'s.

The reference builds canonical MIG profile names from slice counts and a
memory fraction (``MigProfile``/``NewMigProfile``,
``internal/controller/instaslice_daemonset.go:751-793``) and
discovers, per profile, a list of legal placement start indexes on the 8-slot
GPU (``:613-659``). The TPU equivalent of a profile is a *mesh shape*: a
``v5e-2x2`` profile is a 2x2 sub-rectangle of a v5e chip grid, and its
"legal placements" are the aligned anchors at which that rectangle can sit
so the slice has full internal ICI connectivity and never fragments the
grid (anchors are multiples of the profile shape along every axis, the 2/3-D
generalization of MIG's discovered start-index list).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Sequence, Tuple

from instaslice_tpu_torch.topology.grid import (
    Generation,
    Shape,
    as3,
    get_generation,
    volume,
)

_PROFILE_RE = re.compile(
    r"^(?P<gen>v\d+[a-z]*)-(?P<shape>\d+x\d+(?:x\d+)?)$"
)
_SHAPE_RE = re.compile(r"^\d+x\d+(?:x\d+)?$")


@dataclasses.dataclass(frozen=True)
class TopologyProfile:
    """A requestable sub-slice shape for one TPU generation.

    ``name`` is the canonical request string (``v5e-2x2``); pods ask for it
    through an extended-resource key / annotation the way reference pods ask
    for ``nvidia.com/mig-1g.5gb`` (``samples/test-pod.yaml``).
    """

    generation: str
    shape: Shape  # canonical shape, always 3 dims internally

    @property
    def name(self) -> str:
        gen = get_generation(self.generation)
        return f"{self.generation}-{gen.render_shape(self.shape)}"

    @property
    def chip_count(self) -> int:
        return volume(self.shape)

    def hosts_needed(self) -> int:
        gen = get_generation(self.generation)
        hb = gen.host_bounds
        best = None
        for shape in orientations(gen, self.shape):
            n = 1
            for i in range(3):
                # A profile axis either fits inside one host or spans
                # whole host multiples (enforced by shape validation).
                n *= max(1, shape[i] // hb[i])
            best = n if best is None else min(best, n)
        return best if best is not None else 1

    def hbm_gib(self) -> int:
        return self.chip_count * get_generation(self.generation).hbm_gib_per_chip

    def attributes(self) -> Dict[str, int]:
        """Flat attribute dict for the CR catalog (reference analog:
        ``MigProfile.Attributes``, instaslice_daemonset.go:786-793)."""
        return {
            "chips": self.chip_count,
            "x": self.shape[0],
            "y": self.shape[1],
            "z": self.shape[2],
            "hosts": self.hosts_needed(),
            "hbmGiB": self.hbm_gib(),
        }


def parse_profile_name(name: str) -> TopologyProfile:
    """Parse ``v5e-2x2`` / ``v4-2x2x2`` → :class:`TopologyProfile`.

    Raises ValueError for malformed names — unlike the reference's regex
    extraction which silently returns "" on no-match
    (``extractProfileName``, instaslice_controller.go:265-280).
    """
    m = _PROFILE_RE.match(name.strip())
    if not m:
        raise ValueError(f"malformed profile name {name!r} (want e.g. 'v5e-2x2')")
    gen = get_generation(m.group("gen"))
    shape = as3([int(d) for d in m.group("shape").split("x")])
    _validate_shape(gen, shape)
    # Canonicalize so every spelling of the same sub-host slice ('v5e-1x4'
    # vs 'v5e-4x1') maps to the one profile the catalog publishes.
    return TopologyProfile(
        generation=gen.name, shape=_canonical_shape(gen, shape)
    )


def parse_shape(gen_name: str, shape_str: str) -> TopologyProfile:
    """Parse a bare ``2x2`` shape string against a known generation."""
    if not _SHAPE_RE.match(shape_str.strip()):
        raise ValueError(f"malformed shape {shape_str!r} (want e.g. '2x2')")
    gen = get_generation(gen_name)
    shape = as3([int(d) for d in shape_str.strip().split("x")])
    _validate_shape(gen, shape)
    return TopologyProfile(
        generation=gen.name, shape=_canonical_shape(gen, shape)
    )


def _validate_shape(gen: Generation, shape: Shape) -> None:
    if not all(_is_pow2(d) for d in shape):
        raise ValueError(
            f"profile shape {shape} has non-power-of-two axis "
            f"(sub-slices must tile the mesh)"
        )
    hb = gen.host_bounds
    for i in range(3):
        d, h = shape[i], hb[i]
        # Each axis must either divide the host axis (sub-host) or be a
        # whole multiple of it (multi-host along that axis). Anything else
        # cannot be decomposed into whole-host tiles + aligned remainders.
        if d <= h:
            if h % d != 0:
                raise ValueError(
                    f"axis {i} of {shape} does not divide host bounds {hb}"
                )
        elif d % h != 0:
            raise ValueError(
                f"axis {i} of {shape} not a multiple of host bounds {hb}"
            )
        if d > gen.max_slice_shape[i]:
            raise ValueError(
                f"axis {i} of {shape} exceeds {gen.name} max "
                f"{gen.max_slice_shape}"
            )


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def profile_catalog(
    gen_name: str, max_chips: int | None = None
) -> List[TopologyProfile]:
    """All legal profiles for a generation, smallest first.

    This is the discovery-time catalog the node agent publishes into the
    ``TpuSlice`` CR, the analog of the reference's per-GPU
    ``Spec.Migplacement`` enumeration loop
    (``discoverAvailableProfilesOnGpus``, instaslice_daemonset.go:588-664) —
    except it is computed from the generation's topology constants instead
    of queried from a driver, so it is identical on every healthy node.
    """
    from instaslice_tpu_torch.topology.mig import mig_catalog

    gen = get_generation(gen_name)
    cap = max_chips if max_chips is not None else volume(gen.max_slice_shape)
    mig = mig_catalog(gen.name)
    if mig is not None:  # a MIG grid: its fixed catalog, smallest first
        return [p for p in mig if p.chip_count <= cap]
    seen: Dict[Shape, TopologyProfile] = {}
    axes: List[List[int]] = []
    for i in range(3):
        vals = [d for d in _pow2_up_to(gen.max_slice_shape[i])]
        axes.append(vals)
    for x in axes[0]:
        for y in axes[1]:
            for z in axes[2]:
                shape = (x, y, z)
                if volume(shape) > cap:
                    continue
                try:
                    _validate_shape(gen, shape)
                except ValueError:
                    continue
                # Canonicalize pure transposes of sub-host shapes? No —
                # 2x1 and 1x2 are distinct placements but the same profile
                # canonically; keep the sorted-descending form only when
                # both orientations are sub-host, to avoid a catalog with
                # duplicate chip counts per shape class.
                canon = _canonical_shape(gen, shape)
                if canon not in seen:
                    seen[canon] = TopologyProfile(gen.name, canon)
    return sorted(seen.values(), key=lambda p: (p.chip_count, p.shape))


def _canonical_shape(gen: Generation, shape: Shape) -> Shape:
    """Canonical orientation for a profile shape.

    Sub-host shapes (fit entirely inside one host) are canonicalized to
    descending order restricted to the generation's physical dims — e.g. on
    v5e both (1,2,1) and (2,1,1) mean "two adjacent chips" and render as
    ``2x1``; the placement engine tries both orientations anyway. Shapes
    with any multi-host axis keep their orientation: a 4x8 and an 8x4 span
    hosts differently and are genuinely different requests.
    """
    hb = gen.host_bounds
    if all(shape[i] <= hb[i] for i in range(3)):
        live = sorted(shape[: gen.dims], reverse=True)
        rest = shape[gen.dims :]
        cand = as3(tuple(live) + tuple(rest))
        try:
            _validate_shape(gen, cand)
            return cand
        except ValueError:
            return shape
    return shape


def _pow2_up_to(n: int) -> List[int]:
    out, v = [], 1
    while v <= n:
        out.append(v)
        v *= 2
    return out


def orientations(gen: Generation, shape: Shape) -> List[Shape]:
    """Distinct legal axis-permutations of a profile shape.

    If any permutation fits entirely inside one host, the shape is a
    *sub-host* profile and all such permutations are returned (rotations
    pack better — the 2/3-D analog of MIG profiles having several legal
    start indexes, instaslice_controller.go:330-340). Otherwise the shape
    is genuinely multi-host and is placement-orientation-fixed, because
    its per-host decomposition depends on orientation.
    """
    import itertools

    hb = gen.host_bounds
    out: List[Shape] = []
    for perm in itertools.permutations(range(3)):
        cand: Shape = (shape[perm[0]], shape[perm[1]], shape[perm[2]])
        if cand in out:
            continue
        try:
            _validate_shape(gen, cand)
        except ValueError:
            continue
        if all(cand[i] <= hb[i] for i in range(3)):
            out.append(cand)
    if out:
        return out
    # Multi-host shapes are orientation-fixed — but only a shape that is
    # itself legal may pass through. Echoing back an invalid shape would
    # re-admit it to the placement scan (caught only by downstream bounds
    # checks).
    _validate_shape(gen, shape)
    return [shape]
