"""The collectives of the parallel train step, over one mesh axis each.

The reference has no counterpart: XLA's partitioner places its
collectives from the sharding annotations. PyTorch runs one process per
rank, so the port issues them itself:

- the conjugate tensor-parallel pair (Megatron's ``f`` and ``g``) as
  autograd functions over the ``model`` axis: :func:`copy_to` (identity
  forward, all-reduce backward) in front of a column-parallel product,
  :func:`reduce_from` (all-reduce forward, identity backward) behind a
  row-parallel one; :func:`gather_from` (all-gather forward, the rank's
  slice backward) for full logits;
- :func:`mean_over`: the mean over an axis of a value every rank's loss
  reads (the MoE load-balance means over ``data``), all-reduce and
  divide both ways;
- :func:`all_reduce_` in place with no autograd (gradient averaging, the
  clip norm, the vocab-parallel max), :func:`all_gather` and
  :func:`shard` for ZeRO-1 and for checkpoints;
- :func:`ring_shift`: every rank's block to the next rank of the axis
  (``lax.ppermute`` with the permutation ``j -> j + 1``), whose backward
  is the reverse rotation, as ``ppermute`` transposes: ring attention's
  K/V hops over ``seq`` and GPipe's stage-to-stage activations over
  ``pipe``.

On an axis of size 1 every op returns its input and issues nothing, so a
mesh of one rank computes exactly the meshless step. gloo runs each op
used here on CUDA tensors too (all-reduce by sum and max, fp32 and bf16,
and the all-gather, in the card's PyTorch 2.11), so two processes can
share one card over gloo with nothing staged by hand; gloo's
point-to-point ops take host tensors only, so :func:`ring_shift` stages a
CUDA tensor through host memory under gloo.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# all_gather_into_tensor is deprecated in favour of all_gather_single
# where the installed PyTorch has it
_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its process group (None at
    size 1), its size, this rank's index along it, and the group's
    backend name."""

    group: Optional[dist.ProcessGroup] = None
    size: int = 1
    rank: int = 0
    backend: str = ""


NO_AXIS = Axis()


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """The axes of a ("data", "seq", "model") mesh, and GPipe's ``pipe``
    (the reference's ("pipe", "data", "model") meshes); an axis the mesh
    lacks, or of size 1, is :data:`NO_AXIS`."""

    data: Axis = NO_AXIS
    seq: Axis = NO_AXIS
    model: Axis = NO_AXIS
    pipe: Axis = NO_AXIS

    def of(self, name: str) -> Axis:
        return getattr(self, name)


NO_MESH = MeshAxes()

#: the axis names a port mesh may carry
AXIS_NAMES = ("pipe", "data", "seq", "model")


def mesh_axes(mesh) -> MeshAxes:
    """:class:`MeshAxes` of a ``DeviceMesh`` (None: :data:`NO_MESH`)."""
    if mesh is None:
        return NO_MESH
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (slice_mesh), "
                        f"not {type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    unknown = set(names) - set(AXIS_NAMES)
    if unknown:
        raise ValueError(f"mesh axes {names}: {sorted(unknown)} are not "
                         f"among {AXIS_NAMES}")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    axes = {}
    for i, name in enumerate(names):
        size = mesh.size(i)
        if size > 1:
            group = mesh.get_group(name)
            axes[name] = Axis(group, size, mesh.get_local_rank(name),
                              dist.get_backend(group))
    return MeshAxes(**axes)


def all_reduce_(t: torch.Tensor, ax: Axis,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``ax`` in place (no autograd); returns ``t``."""
    if ax.size > 1:
        dist.all_reduce(t, op=op, group=ax.group)
    return t


def all_gather(t: torch.Tensor, ax: Axis, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order (no
    autograd); every rank's ``t`` has one shape."""
    if ax.size == 1:
        return t
    src = t.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((ax.size * src.shape[0], *src.shape[1:]))
    _gather_single(out, src, group=ax.group)
    return out.movedim(0, dim).contiguous()


def shard(t: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` along ``dim`` (a view)."""
    if ax.size == 1:
        return t
    n, rest = divmod(t.shape[dim], ax.size)
    if rest:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                         f"over {ax.size} ranks")
    return t.narrow(dim, ax.rank * n, n)


def _rotate(t: torch.Tensor, ax: Axis, shift: int) -> torch.Tensor:
    """Every rank's ``t`` sent ``shift`` ranks on along ``ax`` (cyclic);
    returns what the rank ``shift`` before this one sent. One send and
    one receive per rank; under gloo a CUDA tensor goes through host
    memory (gloo's point-to-point ops take host tensors only)."""
    n, r = ax.size, ax.rank
    dst = dist.get_global_rank(ax.group, (r + shift) % n)
    src = dist.get_global_rank(ax.group, (r - shift) % n)
    staged = t.detach().contiguous()
    if ax.backend == "gloo" and staged.is_cuda:
        staged = staged.cpu()
    got = torch.empty_like(staged)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, staged, dst, ax.group),
        dist.P2POp(dist.irecv, got, src, ax.group)])
    for req in reqs:
        req.wait()
    return got.to(t.device)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _rotate(x, ax, 1)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.ax, -1), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce_(x.contiguous().clone(), ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return shard(g, ctx.ax, ctx.dim).contiguous(), None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return all_reduce_(x.contiguous().clone(), ax) / ax.size

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.ax) / ctx.ax.size, \
            None


def copy_to(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``ax`` (the input
    of column-parallel products: each rank's product sees ``x`` whole and
    adds only its columns' part of ``x``'s gradient)."""
    return x if ax.size == 1 else _CopyTo.apply(x, ax)


def reduce_from(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``x`` summed over ``ax``; the gradient passes as it is (the output
    of row-parallel products: each rank holds a partial sum)."""
    return x if ax.size == 1 else _ReduceFrom.apply(x, ax)


def gather_from(x: torch.Tensor, ax: Axis, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``; the gradient is this
    rank's slice of the whole's."""
    return x if ax.size == 1 else _GatherFrom.apply(x, ax, dim % x.dim())


def mean_over(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The mean of the ranks' ``x`` over ``ax``, every rank's loss reading
    it: the gradient is the mean of the ranks' gradients, so that after
    the data-axis gradient average each rank's share is its own term's."""
    return x if ax.size == 1 else _MeanOver.apply(x, ax)


def ring_shift(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The block of the rank before this one along ``ax`` (rank ``j``'s
    ``x`` goes to rank ``j + 1 mod n``, ``lax.ppermute`` with the
    reference's ``perm``); the gradient goes back the other way round.
    Every rank of the axis must call it, and, under autograd, use its
    output, so that every rank's backward issues the reverse rotation."""
    return x if ax.size == 1 else _RingShift.apply(x, ax)


def shard_leaf(t: torch.Tensor, spec: Sequence[Optional[str]],
               axes: MeshAxes) -> torch.Tensor:
    """This rank's block of a full leaf laid out by ``spec`` (one axis
    name or None per dim): a contiguous copy, which holds no reference to
    ``t`` (``t`` itself where no axis of ``spec`` has more than one
    rank)."""
    out = t
    for dim, name in enumerate(spec):
        if name is not None:
            out = shard(out, axes.of(name), dim)
    return out if out is t else out.clone(
        memory_format=torch.contiguous_format)


def gather_leaf(t: torch.Tensor, spec: Sequence[Optional[str]],
                axes: MeshAxes) -> torch.Tensor:
    """The full leaf from this rank's block (collective over every axis
    ``spec`` names; every rank of the axis calls it)."""
    for dim, name in enumerate(spec):
        if name is not None:
            t = all_gather(t, axes.of(name), dim)
    return t
