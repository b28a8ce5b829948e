"""GPipe over a ``pipe`` mesh axis (port of
``instaslice_tpu/parallel/pipeline.py``).

The layer stack splits into P contiguous stages, one per rank of the
``pipe`` axis (stage ``s`` holds layers ``[s * L / P, (s + 1) * L / P)``),
and M micro-batches stream through them in ``M + P - 1`` ticks. The
schedule is the reference's, tick for tick: at tick ``t`` every stage
receives what the stage before it produced at tick ``t - 1``
(:func:`~instaslice_tpu_torch.parallel.collectives.ring_shift`, the
wrap-around edge included), stage 0 takes micro-batch ``min(t, M - 1)``
instead, every stage runs its layers, and stage ``P - 1`` finishes
micro-batch ``t - (P - 1)``. Warm-up and drain ticks compute on what
they hold, as the reference's do, and are masked out of the result and
of the aux term; running them keeps every rank's autograd graph the same
shape, so the backward's reverse hops line up on every stage. The
backward is autograd's: each hop's gradient goes back one stage, as
``ppermute`` transposes in the reference; a stage that is not the last
ties its last tick to its (zero) share of the output, so that its
backward walks back through all of its hops.

Tensor parallelism composes inside a stage (the blocks' ``model``
collectives run among the stage's ranks); ring attention does not (the
reference refuses it too).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from instaslice_tpu_torch.parallel.collectives import (
    MeshAxes,
    copy_to,
    reduce_from,
    ring_shift,
)

Params = Dict[str, Any]


def _unstack(stacked: Params):
    """The stage's stacked ``(L / P, ...)`` leaves as per-layer dicts."""
    def split(node):
        if isinstance(node, dict):
            parts = {k: split(v) for k, v in node.items()}
            n = len(next(iter(parts.values())))
            return [{k: parts[k][i] for k in parts} for i in range(n)]
        return node.unbind(0)

    return split(stacked)


class _ZerosTiedTo(torch.autograd.Function):
    """Zeros of ``shape`` whose graph reaches ``t`` (its gradient zero):
    a stage that is not the last gives the pipeline's output zeros, and
    through this its local graph still reaches its last tick, so that
    autograd walks back through every hop of the stage and each hop's
    backward receives the real gradient from the next stage."""

    @staticmethod
    def forward(ctx, t, shape):
        ctx.like = (t.shape, t.dtype, t.device)
        return t.new_zeros(shape)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return torch.zeros(shape, dtype=dtype, device=device), None


def pipeline_blocks(
    block_fn: Callable,
    stacked_params: Params,
    x: torch.Tensor,
    *,
    axes: MeshAxes,
    n_micro: int,
    axis_name: str = "pipe",
    remat: bool = True,
    remat_policy: str = "full",
):
    """Apply this stage's layers to ``x`` (B, S, D), pipelined over the
    ``axis_name`` axis of mesh ``axes``.

    ``stacked_params`` are this stage's layers, stacked ``(L / P, ...)``;
    ``block_fn(layer, x) -> (x, aux)`` is one layer. ``B`` must divide by
    ``n_micro``. Returns ``(out, aux)``: the (B, S, D) output of all L
    layers on every stage (the last stage's, summed over ``pipe`` from
    zeros elsewhere) and the aux scalars of the valid ticks, totalled
    over ``pipe`` and divided by ``L * M`` (``pipeline.py:88-100``: the
    mean of per-micro-batch terms; the reference's ``with_aux``). ``x`` enters through ``copy_to`` over
    ``pipe``: only stage 0 reads it, so its gradient is summed there and
    every stage holds the whole of it (the embedding behind it is
    replicated over ``pipe``). ``remat`` rematerializes each layer under
    ``remat_policy``, as the reference's stage body does."""
    from instaslice_tpu_torch.models.lm import _remat

    ax = axes.of(axis_name)
    P, s = ax.size, ax.rank
    layers = _unstack(stacked_params)
    n_layers = len(layers) * P
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro {n_micro}")
    M = n_micro
    x_mb = copy_to(x, ax).reshape((M, B // M) + tuple(x.shape[1:]))
    first_stage = torch.tensor(s == 0, device=x.device)

    def run_layers(h):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in layers:
            if remat:
                h, a = _remat(block_fn, remat_policy, layer, h)
            else:
                h, a = block_fn(layer, h)
            aux = aux + a
        return h, aux

    prev = torch.zeros_like(x_mb[0])
    outs = [None] * M
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for t in range(M + P - 1):
        recv = ring_shift(prev, ax)
        # stage 0 takes the micro-batch; the others what arrived (the
        # wrap-around edge's garbage reaches stage 0 and is dropped here,
        # its gradient zero)
        inp = torch.where(first_stage, x_mb[min(t, M - 1)], recv)
        out, aux_t = run_layers(inp)
        if s <= t < s + M:
            aux_acc = aux_acc + aux_t
        if s == P - 1 and t >= P - 1:
            outs[t - (P - 1)] = out
        prev = out
    acc = (torch.stack(outs) if s == P - 1
           else _ZerosTiedTo.apply(prev, x_mb.shape))
    return (reduce_from(acc, ax).reshape(x.shape),
            reduce_from(aux_acc, ax) / (n_layers * M))
