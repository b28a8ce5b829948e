"""The slice's device mesh as a ``torch.distributed`` ``DeviceMesh`` (port
of ``instaslice_tpu/parallel/meshenv.py``).

:func:`_parse_bounds`, :class:`SliceTopology` and :func:`_factor` are
copies of the reference's (pure Python): the topology a worker reads from
the node agent's handoff env (``TPU_WORKER_ID``,
``TPU_CHIPS_PER_HOST_BOUNDS``, ``TPU_HOST_BOUNDS``,
``TPU_WORKER_HOSTNAMES``, ``TPU_SLICE_PROFILE``) and the rule that
scales a requested per-axis parallelism with ``-1`` wildcards to the
device count.

PyTorch is multi-controller: one process per rank. So where the
reference's :func:`slice_mesh` reshapes ``jax.devices()``, this one
builds a :class:`~torch.distributed.device_mesh.DeviceMesh` over the
process group's ranks with ``init_device_mesh``, in the reference's axis
order: ``model`` innermost (tensor parallelism's latency-bound
all-reduces on the most tightly coupled ranks), ``data`` outermost,
``seq`` between. :func:`initialize_distributed` starts that process
group.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

Shape3 = Tuple[int, int, int]

#: Canonical logical axes, outermost -> innermost.
DEFAULT_AXES = ("data", "seq", "model")


def _parse_bounds(val: str, default: Shape3) -> Shape3:
    if not val:
        return default
    parts = [int(p) for p in val.split(",") if p.strip()]
    parts += [1] * (3 - len(parts))
    return (parts[0], parts[1], parts[2])


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """The granted slice as seen from inside one worker pod."""

    worker_id: int
    num_workers: int
    chips_per_host: Shape3  # TPU_CHIPS_PER_HOST_BOUNDS
    host_bounds: Shape3  # TPU_HOST_BOUNDS (hosts along each axis)
    hostnames: Tuple[str, ...]
    profile: str = ""

    @property
    def slice_shape(self) -> Shape3:
        """Global chip-grid shape of the slice."""
        return (
            self.chips_per_host[0] * self.host_bounds[0],
            self.chips_per_host[1] * self.host_bounds[1],
            self.chips_per_host[2] * self.host_bounds[2],
        )

    @property
    def num_chips(self) -> int:
        x, y, z = self.slice_shape
        return x * y * z

    @property
    def chips_per_worker(self) -> int:
        x, y, z = self.chips_per_host
        return x * y * z

    @staticmethod
    def from_env(env: Optional[Dict[str, str]] = None) -> "SliceTopology":
        e = os.environ if env is None else env
        hostnames = tuple(
            h for h in e.get("TPU_WORKER_HOSTNAMES", "").split(",") if h
        )
        chips = _parse_bounds(
            e.get("TPU_CHIPS_PER_HOST_BOUNDS", ""), (1, 1, 1)
        )
        hosts = _parse_bounds(e.get("TPU_HOST_BOUNDS", ""), (1, 1, 1))
        return SliceTopology(
            worker_id=int(e.get("TPU_WORKER_ID", "0")),
            num_workers=max(1, len(hostnames))
            if hostnames
            else hosts[0] * hosts[1] * hosts[2],
            chips_per_host=chips,
            host_bounds=hosts,
            hostnames=hostnames,
            profile=e.get("TPU_SLICE_PROFILE", ""),
        )


def _factor(n: int, want: Sequence[int]) -> Tuple[int, ...]:
    """Scale the requested per-axis parallelism ``want`` (with -1 wildcards)
    to exactly ``n`` devices, preserving ratios where possible."""
    sizes = list(want)
    wild = [i for i, s in enumerate(sizes) if s == -1]
    fixed = math.prod(s for s in sizes if s != -1)
    if n % fixed != 0:
        raise ValueError(
            f"{n} devices not divisible by fixed axis product {fixed} "
            f"(requested {want})"
        )
    rest = n // fixed
    if not wild:
        if rest != 1:
            raise ValueError(
                f"axis product {fixed} != device count {n}; add a -1 axis"
            )
    else:
        # Spread `rest` over wildcards: last wildcard absorbs the remainder
        # so the innermost (model) axis stays densest.
        for i in wild[:-1]:
            sizes[i] = 1
        sizes[wild[-1]] = rest
    return tuple(sizes)


def initialize_distributed(topo: Optional[SliceTopology] = None, *,
                           backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           device="cuda") -> bool:
    """Start the default process group; True when this call started it.

    Rank and world size come from torchrun's ``RANK``/``WORLD_SIZE``
    where set, else from the topology (``worker_id``/``num_workers``:
    one process per worker). ``backend`` defaults to ``nccl`` for a CUDA
    ``device`` and ``gloo`` for the CPU; gloo on CUDA tensors is asked for
    by name. ``init_method`` defaults to ``env://`` (torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``); a caller with no launcher passes
    ``tcp://localhost:<port>`` or ``file://<path>``. On a CUDA device the
    process first selects its card, ``LOCAL_RANK`` where set.

    A group already started is left as it is (False). At world size 1 a
    group is started all the same (the mesh's collectives then issue
    nothing): a caller that wants no process group does not call this.
    """
    if dist.is_initialized():
        return False
    topo = topo or SliceTopology.from_env()
    rank = int(os.environ.get("RANK", topo.worker_id))
    world = int(os.environ.get("WORLD_SIZE", topo.num_workers))
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              if dev.index is None else dev.index)
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            rank=rank, world_size=world)
    return True


def slice_mesh(axes: Sequence[str] = DEFAULT_AXES,
               axis_sizes: Optional[Sequence[int]] = None,
               device="cuda",
               topo: Optional[SliceTopology] = None) -> DeviceMesh:
    """The slice's mesh over every rank of the default process group.

    ``axis_sizes`` may use ``-1`` for "whatever is left" (the last
    wildcard absorbs the remainder). By default ``data`` takes every rank
    but ``model`` gets ``gcd(n, chips_per_worker)`` (the ranks one worker
    holds), as the reference's default. Rank order is row-major over the
    axes, so the ranks of one ``model`` group are consecutive. Under
    gloo the mesh's groups are made gloo groups by name, whatever
    ``device`` is (``DeviceMesh`` would otherwise pick the device's
    default backend)."""
    if not dist.is_initialized():
        raise RuntimeError("slice_mesh needs a process group: call "
                           "initialize_distributed first")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("slice_mesh(device='cuda') but no card is "
                           "present; pass device='cpu'")
    n = dist.get_world_size()
    axes = tuple(axes)
    if axis_sizes is None:
        axis_sizes = [-1 if a == "data" else 1 for a in axes]
        if n > 1 and "model" in axes:
            topo = topo or SliceTopology.from_env()
            axis_sizes[axes.index("model")] = \
                math.gcd(n, topo.chips_per_worker) or 1
    sizes = _factor(n, axis_sizes)
    kw = {}
    if dist.get_backend() == "gloo":
        kw["backend_override"] = {a: "gloo" for a in axes}
    return init_device_mesh(dev.type, sizes, mesh_dim_names=axes, **kw)
