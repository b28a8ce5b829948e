"""The training step for one card (port of ``instaslice_tpu/models/train.py``).

fp32 master weights and optimizer state, compute in ``cfg.dtype`` (bf16
on the card): the reference's mixed-precision recipe. The step is the
reference's without the mesh: loss (chunked cross-entropy over the
final hidden states), gradients (optionally accumulated over
micro-batches in fp32), a global-norm clip, AdamW with an optional
warmup-cosine schedule. A mixture-of-experts model adds
``moe_aux_weight`` times its router load-balance term to the loss.
Autograd replaces ``jax.value_and_grad``; the flash-attention kernels
(B5 forward, B6 and B7 backward) run inside the model's attention.

Under a ("data", "seq", "model") ``DeviceMesh`` the step is SPMD, one
process per rank (``train.py:314-422`` with the partitioner's
collectives written out): each rank takes its ``data`` rows of the
batch (:func:`~instaslice_tpu_torch.models.data.data_rows`), holds its
``model`` shards of the params (:func:`~instaslice_tpu_torch.models.lm.
param_specs`: heads, FFN hidden dim or experts, vocabulary), computes the
vocab-parallel loss, averages the gradients over ``data``, clips by the
norm of the whole gradient, and with ``zero1`` updates only its ``data``
slice of each moment (ZeRO-1, ``state_shardings`` ``:153-214``) before
all-gathering the params. With ring attention each rank of ``seq`` runs
its block of every row and the gradients average over ``seq`` too. With
``n_micro`` over a ("pipe", "data", "model") mesh the forward is GPipe
and each rank holds its stage's layers. The step's math is the
one-process step's at every mesh shape, and a mesh of one rank runs
exactly the meshless step.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from instaslice_tpu_torch import resolve_device
from instaslice_tpu_torch.models.data import data_rows
from instaslice_tpu_torch.models.lm import (
    Spec,
    TpuLM,
    check_mesh,
    param_specs,
    ring_axis,
    unembed,
)
from instaslice_tpu_torch.parallel.collectives import (
    NO_AXIS,
    Axis,
    MeshAxes,
    all_gather,
    all_reduce_,
    copy_to,
    gather_leaf,
    mesh_axes,
    reduce_from,
    shard,
    shard_leaf,
)

Params = Dict[str, Any]

#: sequence-chunk length for the chunked cross-entropy (0 disables): the
#: live (B, chunk, V) fp32 logits stay a fraction of the full (B, S, V)
DEFAULT_LOSS_CHUNK = 512

#: Switch/GShard default weight for the MoE load-balance term
DEFAULT_MOE_AUX_WEIGHT = 0.01


def leaves(params: Params) -> List[torch.Tensor]:
    """The tensors of a params tree, in its (insertion) order."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in leaves(v)]
    return [params]


def leaf_paths(params: Params, prefix: str = "") -> List[str]:
    """Each leaf's path in the tree ("blocks/wq/a"), 1:1 with
    :func:`leaves`."""
    if isinstance(params, dict):
        return [p for k, v in params.items()
                for p in leaf_paths(v, f"{prefix}{k}/")]
    return [prefix[:-1]]


def map_tree(fn: Callable[[str, Any], Any], tree: Params,
             prefix: str = "") -> Params:
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, paths as
    :func:`leaf_paths` gives them."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def spec_at(specs: Params, path: str) -> Spec:
    """The :func:`~instaslice_tpu_torch.models.lm.param_specs` entry of
    the leaf at ``path`` (trees may order their keys differently)."""
    node = specs
    for k in path.split("/"):
        node = node[k]
    return node


def zero1_dim(spec: Spec, shape, dp: int) -> Optional[int]:
    """The dim ZeRO-1 shards a moment leaf over a ``data`` axis of ``dp``
    ranks (``instaslice_tpu/models/train.py:177-184 moment_spec``): the
    first dim that ``spec`` leaves unsharded and ``dp`` divides; None
    where none does (the leaf's moments stay replicated) or ``dp`` is 1."""
    if dp <= 1:
        return None
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    for i, ax in enumerate(parts):
        if ax is None and shape[i] % dp == 0 and shape[i] >= dp:
            return i
    return None


def _chunk_nll(embed_leaf, hc, tc, mc):
    logits = unembed(hc, embed_leaf, hc.dtype)             # fp32
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tc[..., None].long())[..., 0]
    return ((lse - gold) * mc).sum()


def _vocab_parallel_nll(embed_leaf, hc, tc, mc, tp: Axis):
    """:func:`_chunk_nll` against this rank's ``(V / tp, D)`` block of the
    embedding: the hidden states enter through :func:`copy_to` (each
    rank's logits give only its vocabulary's part of their gradient), the
    logits stay local; the row max (no gradient) is all-reduced by max,
    the sum of exponentials and the gold logit (each nonzero on the one
    rank whose block holds the target) by sum."""
    logits = unembed(copy_to(hc, tp), embed_leaf, hc.dtype)  # (.., V / tp)
    m = all_reduce_(logits.detach().amax(dim=-1), tp, dist.ReduceOp.MAX)
    sumexp = reduce_from(torch.exp(logits - m[..., None]).sum(-1), tp)
    lse = m + torch.log(sumexp)
    n = logits.shape[-1]
    local = tc.long() - tp.rank * n
    inside = (local >= 0) & (local < n)
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = reduce_from(torch.where(inside, gold, torch.zeros_like(gold)), tp)
    return ((lse - gold) * mc).sum()


def _chunked_xent(embed_leaf, hidden, targets, mask,
                  chunk: int, tp: Axis = NO_AXIS) -> torch.Tensor:
    """Summed next-token cross-entropy without the (B, S, V) logits
    (``train.py:51-87``): the sequence is padded to whole chunks (the
    padding masked), and each (B, chunk, V) block is unembedded and
    log-sum-exped under its own checkpoint, so the backward recomputes
    one block at a time. Chunk totals add in sequence order, as the
    reference's scan does. Under a ``model`` axis each block is
    :func:`_vocab_parallel_nll`; its recompute issues the forward's
    collectives again, in the same order on every rank."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    nll = _chunk_nll if tp.size == 1 else functools.partial(
        _vocab_parallel_nll, tp=tp)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        cols = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(nll, embed_leaf, hidden[:, cols],
                                   targets[:, cols], mask[:, cols],
                                   use_reentrant=False)
    return total


def loss_fn(model: TpuLM, params: Params, tokens: torch.Tensor,
            mesh=None, n_micro: int = 0, pipe_axis: str = "pipe",
            loss_chunk: int = DEFAULT_LOSS_CHUNK,
            moe_aux_weight: float = DEFAULT_MOE_AUX_WEIGHT) -> torch.Tensor:
    """Next-token cross-entropy (``train.py:94-150``): tokens (B, S)
    predict ``roll(tokens, -1)``, the last position has no target.
    ``loss_chunk`` > 0 takes the chunked loss, 0 the one-shot
    log-softmax over the full logits; ring attention always takes the
    one-shot loss, as the reference does. ``n_micro`` > 0 runs the
    forward as GPipe over the mesh's ``pipe_axis``. An MoE model with
    ``moe_aux_weight`` > 0 adds that weight times the layer-averaged
    load-balance term (without it top-k routing collapses onto a few
    experts and the capacity drops eat the batch).

    With ``mesh``, ``params`` are this rank's shards and ``tokens`` its
    rows; the loss is the mean over those rows (the data-axis gradient
    average makes it the whole batch's). Under a ``model`` axis the
    cross-entropy is vocab-parallel (:func:`_vocab_parallel_nll`), one
    chunk at a time or, at ``loss_chunk`` 0, over the whole sequence.
    Under ring attention over a ``seq`` axis of n ranks the rows arrive
    whole: the targets roll over the whole row, as the reference rolls
    its (S + 1)-wide row (each block's last target is the next block's
    first token, and only the last block masks its last position), then
    each rank keeps its block of tokens, targets and mask, and its loss
    is ``n`` times its block's share of the row's cross-entropy (plus the
    aux term, whole on every rank): the mean over ``seq`` of the ranks'
    losses is the row's loss, so the gradient average over ``seq`` sums
    the blocks' parts."""
    axes = mesh_axes(mesh)
    tp = axes.model
    cfg = model.cfg
    targets = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    count = mask.sum()
    sq = ring_axis(cfg, axes)
    if sq.size > 1:
        tokens, targets, mask = (shard(t, sq, 1)
                                 for t in (tokens, targets, mask))
    chunked = loss_chunk > 0 and not cfg.ring_attention
    want_aux = bool(cfg.n_experts) and moe_aux_weight > 0
    unembed_here = not chunked and tp.size == 1
    if n_micro:
        if mesh is None:
            raise ValueError("pipeline-parallel loss (n_micro > 0) needs "
                             "the mesh carrying the pipe axis")
        out = model.apply_pipelined(params, tokens, mesh=mesh,
                                    n_micro=n_micro, axis_name=pipe_axis,
                                    unembed=unembed_here,
                                    return_aux=want_aux)
    else:
        out = model.apply(params, tokens, mesh=mesh, unembed=unembed_here,
                          return_aux=want_aux)
    if want_aux:
        out, aux = out
    if chunked:
        total = _chunked_xent(params["embed"], out, targets, mask,
                              loss_chunk, tp)
    elif tp.size > 1:
        total = _vocab_parallel_nll(params["embed"], out, targets, mask, tp)
    else:
        logp = torch.log_softmax(out, dim=-1)
        nll = -logp.gather(-1, targets[..., None].long())[..., 0]
        total = (nll * mask).sum()
    xent = total * sq.size / count
    return xent + moe_aux_weight * aux if want_aux else xent


def warmup_cosine(peak: float, warmup_steps: int,
                  decay_steps: int) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(0, peak, max(warmup, 1),
    max(decay, warmup + 1), peak / 10)`` as a function of the update
    count: linear from 0, then cosine down to 10% of the peak."""
    warmup = max(warmup_steps, 1)
    span = max(decay_steps, warmup + 1) - warmup
    alpha = 0.1

    def lr(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        c = min(count - warmup, span)
        cos = 0.5 * (1.0 + math.cos(math.pi * c / span))
        return peak * ((1.0 - alpha) * cos + alpha)

    return lr


class Layout:
    """Where each leaf of a params tree lies on the mesh: its
    :func:`~instaslice_tpu_torch.models.lm.param_specs` entry (the
    ``model`` shards, and the ``pipe`` stage of a pipelined step's
    stacked leaves) or, for an adapter tree, its ``lora_specs`` entry
    (``specs``) and, with ``zero1``, the dim its moments are sliced
    along over ``data`` (:func:`zero1_dim`, from the leaf's shape on this
    rank). Built by ``make_train_step``'s ``init_fn`` for a mesh."""

    def __init__(self, cfg, axes: MeshAxes, params: Params,
                 zero1: bool = False, specs: Optional[Params] = None,
                 pipe_axis: str = ""):
        self.axes = axes
        if specs is None:
            specs = param_specs(cfg, pipe_axis)
        self.paths = leaf_paths(params)
        self.specs = [spec_at(specs, p) for p in self.paths]
        dp = axes.data.size if zero1 else 1
        self.zero_dims = [zero1_dim(sp, t.shape, dp)
                          for sp, t in zip(self.specs, leaves(params))]

    def split_over(self, i: int) -> Tuple[str, ...]:
        """The axes (of more than one rank) leaf ``i`` is split over."""
        return tuple(a for a in self.specs[i]
                     if a is not None and self.axes.of(a).size > 1)

    def n_blocks(self, i: int) -> int:
        """How many ranks' blocks make leaf ``i`` whole."""
        n = 1
        for a in self.split_over(i):
            n *= self.axes.of(a).size
        return n

    def shard(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of leaf ``i`` (a contiguous copy)."""
        return shard_leaf(full, self.specs[i], self.axes)

    def gather(self, i: int, local: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` whole from this rank's block (collective)."""
        return gather_leaf(local.detach(), self.specs[i], self.axes)

    def zero_slice(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO-1 slice of a leaf-``i``-shaped tensor (a view;
        ``t`` itself where the leaf is not sliced)."""
        zd = self.zero_dims[i]
        return t if zd is None else shard(t, self.axes.data, zd)

    def zero_gather(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s shape from the ranks' ZeRO-1 slices (collective)."""
        zd = self.zero_dims[i]
        return t if zd is None else all_gather(t, self.axes.data, zd)


class Optimizer:
    """The reference's ``make_optimizer`` chain (``train.py:217-245``):
    optional global-norm clip, then AdamW (b1 0.9, b2 0.95, eps 1e-8,
    weight decay 0.01 on every leaf, norm scales included, as optax
    decays them), at a constant rate or on :func:`warmup_cosine`.

    The clip is optax's ``clip_by_global_norm``: grads are scaled by
    ``max / norm`` only when ``norm >= max`` (``clip_grad_norm_`` adds
    1e-6 to the norm and would not match). The schedule reads the number
    of updates before this one, as optax's count does: the first update
    runs at lr 0 when warmup is on.

    With a :class:`Layout` the params are this rank's shards: the clip's
    norm adds the squares of each sharded leaf over the axes it is split
    over (``model``, ``pipe``) and counts the replicated ones once. A leaf the layout slices for
    ZeRO-1 is updated through a slice of its own: AdamW holds moments for
    the slice only, updates it from the same slice of the (data-averaged,
    clipped) gradient, and the ranks' slices are all-gathered into the
    leaf. AdamW's arithmetic is elementwise, so the sliced update is the
    whole one's bit for bit. :meth:`state_dict` is the one-process
    optimizer's, whatever the mesh."""

    def __init__(self, params: List[torch.Tensor], learning_rate: float,
                 grad_clip: float = 0.0, warmup_steps: int = 0,
                 decay_steps: int = 0, weight_decay: float = 0.01,
                 layout: Optional[Layout] = None):
        self.params = list(params)
        self.grad_clip = grad_clip
        self.layout = layout
        self.schedule = (warmup_cosine(learning_rate, warmup_steps,
                                       decay_steps)
                         if warmup_steps or decay_steps else None)
        #: what AdamW updates: each param, or its ZeRO-1 slice
        self.sliced = [i for i in range(len(self.params))
                       if layout is not None and layout.zero_dims[i]
                       is not None]
        self.updated = list(self.params)
        for i in self.sliced:
            self.updated[i] = layout.zero_slice(
                i, self.params[i].detach()).clone()
        self.adamw = torch.optim.AdamW(self.updated, lr=learning_rate,
                                       betas=(0.9, 0.95), eps=1e-8,
                                       weight_decay=weight_decay)
        self.count = 0
        #: the gradient's global norm at the last clip (0-dim tensor)
        self.grad_norm: Optional[torch.Tensor] = None

    def clip_(self) -> None:
        grads = [p.grad for p in self.params]
        sq = [(g.float() * g.float()).sum() for g in grads]
        lay = self.layout
        groups: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for i, q in enumerate(sq):
            groups.setdefault(lay.split_over(i) if lay is not None else (),
                              []).append(q)
        total = sum(groups.pop((), []))
        # each split leaf's squares summed over its axes, in a fixed order
        for names in sorted(groups):
            part = sum(groups[names])
            for name in names:
                part = all_reduce_(part, lay.axes.of(name))
            total = total + part
        norm = torch.sqrt(total)
        self.grad_norm = norm.detach()
        coef = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                           self.grad_clip / norm)
        for g in grads:
            g.mul_(coef.to(g.dtype))

    def step(self) -> None:
        """One update from the params' ``.grad``; the grads are dropped."""
        if self.grad_clip > 0:
            self.clip_()
        with torch.no_grad():
            for i in self.sliced:
                p, u = self.params[i], self.updated[i]
                u.copy_(self.layout.zero_slice(i, p))
                u.grad = self.layout.zero_slice(i, p.grad).contiguous()
        if self.schedule is not None:
            for group in self.adamw.param_groups:
                group["lr"] = self.schedule(self.count)
        self.adamw.step()
        with torch.no_grad():
            for i in self.sliced:
                self.params[i].copy_(self.layout.zero_gather(
                    i, self.updated[i]))
                self.params[i].grad = None
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1

    @staticmethod
    def _map_moments(sd: Dict[str, Any], fn) -> Dict[str, Any]:
        """``sd`` with each moment tensor of param ``i`` mapped by
        ``fn(i, tensor)`` (the 0-dim step counts kept)."""
        return {**sd, "state": {i: {k: fn(i, v) if v.dim() else v
                                    for k, v in st.items()}
                                for i, st in sd["state"].items()}}

    def state_dict(self) -> Dict[str, Any]:
        """AdamW's state with whole-leaf moments (collective under a
        mesh: the ZeRO-1 slices gather over ``data``, the ``model``
        shards over ``model``)."""
        sd, lay = self.adamw.state_dict(), self.layout
        if lay is not None:
            sd = self._map_moments(sd, lambda i, v: lay.gather(
                i, lay.zero_gather(i, v)))
        return {"adamw": sd, "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load a :meth:`state_dict` (of any mesh); under a mesh each
        moment is cut to this rank's block and ZeRO-1 slice."""
        sd, lay = state["adamw"], self.layout
        if lay is not None:
            sd = self._map_moments(sd, lambda i, v: lay.zero_slice(
                i, lay.shard(i, v)).clone())
        self.adamw.load_state_dict(sd)
        self.count = int(state["count"])


def accumulated_grads(loss_of: Callable, params: Params,
                      tokens: torch.Tensor, grad_accum: int) -> torch.Tensor:
    """Sets every leaf's ``.grad`` to the gradient of ``loss_of(params,
    tokens)`` and returns the loss (``train.py:248-284``). With
    ``grad_accum`` > 1 the batch splits into that many equal
    micro-batches whose grads are summed in fp32 and averaged."""
    ps = leaves(params)
    if grad_accum <= 1:
        loss = loss_of(params, tokens)
        for p, g in zip(ps, torch.autograd.grad(loss, ps)):
            p.grad = g
        return loss.detach()
    B = tokens.shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} not divisible by grad_accum="
                         f"{grad_accum}")
    sums: Optional[List[torch.Tensor]] = None
    loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for toks in tokens.reshape(grad_accum, B // grad_accum, -1):
        loss = loss_of(params, toks)
        grads = torch.autograd.grad(loss, ps)
        loss_sum = loss_sum + loss.detach()
        if sums is None:
            sums = [g.float() for g in grads]
        else:
            for s, g in zip(sums, grads):
                s.add_(g)
    inv = 1.0 / grad_accum
    for p, s in zip(ps, sums):
        p.grad = (s * inv).to(p.dtype)
    return loss_sum * inv


@dataclasses.dataclass
class TrainState:
    """Step counter, params (leaves with ``requires_grad``) and the
    optimizer. ``step_fn`` updates it in place (the reference donates the
    state to its jitted step) and returns it. Under a mesh the params are
    this rank's ``model`` shards and ``layout`` says where each lies
    (:func:`full_params` gathers them)."""
    step: int
    params: Params
    opt_state: Optimizer
    layout: Optional[Layout] = None


def full_params(state: TrainState) -> Params:
    """The whole params tree of ``state`` (collective under a mesh: every
    rank calls it; without one, the params themselves)."""
    lay = state.layout
    if lay is None:
        return state.params
    return map_tree(lambda path, t: lay.gather(lay.paths.index(path), t),
                    state.params)


def average_grads(params: Params, loss: torch.Tensor,
                  axes: MeshAxes) -> torch.Tensor:
    """Every leaf's ``.grad`` and the loss averaged over ``data`` and
    ``seq`` (each rank's loss is an estimate of the whole step's: its
    rows, or n times its block's share of them under ring attention);
    returns the averaged loss."""
    for ax in (axes.data, axes.seq):
        if ax.size > 1:
            for p in leaves(params):
                p.grad = all_reduce_(p.grad.contiguous(), ax) / ax.size
            loss = all_reduce_(loss.clone(), ax) / ax.size
    return loss


def make_train_step(
    model: TpuLM,
    *,
    learning_rate: float = 3e-4,
    loss_chunk: int = DEFAULT_LOSS_CHUNK,
    moe_aux_weight: float = DEFAULT_MOE_AUX_WEIGHT,
    grad_accum: int = 1,
    grad_clip: float = 0.0,
    warmup_steps: int = 0,
    decay_steps: int = 0,
    device="cuda",
    zero1: bool = False,
    n_micro: int = 0,
    pipe_axis: str = "pipe",
    mesh=None,
) -> Tuple[Callable, Callable]:
    """``(init_fn, step_fn)`` (``train.py:314-422``), on one device or,
    with ``mesh`` (a ``DeviceMesh`` of
    :func:`~instaslice_tpu_torch.parallel.slice_mesh`), SPMD over it.

    ``init_fn(seed=0, params=None) -> TrainState``: random weights from
    ``seed`` in ``cfg.param_dtype`` (fp32 masters) or, given ``params``,
    those (moved to the device); under a mesh each rank keeps its
    shards of the same whole tree. ``step_fn(state, tokens, *,
    local=False) -> (state, loss)``: tokens (B, S) int, the step's global
    batch, of which each rank takes its ``data`` rows (``local=True``:
    ``tokens`` are already this rank's rows, as
    :class:`~instaslice_tpu_torch.models.data.HostShardedTokens` reads
    them; whole rows, also under ring attention); the loss is the global
    batch's, a 0-dim tensor on the device (no host sync). ``zero1``
    slices the AdamW moments over ``data`` (see :class:`Optimizer`; a
    no-op without a ``data`` axis). ``n_micro`` > 0 runs GPipe over the
    mesh's ``pipe_axis`` with that many micro-batches, each rank holding
    its stage's layers (and their moments); a data rank then takes its
    share of each of the global batch's ``n_micro`` micro-batches. The
    reference's checks: ``n_micro`` needs a mesh with ``pipe_axis``, and
    does not combine with ``grad_accum``."""
    dev = resolve_device(device)
    axes = mesh_axes(mesh)
    if n_micro and (mesh is None
                    or pipe_axis not in (mesh.mesh_dim_names or ())):
        raise ValueError(
            f"n_micro={n_micro} but mesh has no {pipe_axis!r} axis (axes: "
            f"{None if mesh is None else mesh.mesh_dim_names})")
    if grad_accum > 1 and n_micro:
        raise ValueError(
            "grad_accum and n_micro are both micro-batching schemes; "
            "pipeline parallelism already accumulates over its "
            "microbatches — use one or the other")
    check_mesh(model.cfg, axes)
    if n_micro and model.cfg.n_layers % axes.of(pipe_axis).size:
        raise ValueError(
            f"{model.cfg.n_layers} layers not divisible by pipe axis size "
            f"{axes.of(pipe_axis).size}")
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"the mesh is over {mesh.device_type} devices, "
                         f"the step runs on {dev}")
    dp = axes.data

    def init_fn(seed: int = 0, params: Optional[Params] = None
                ) -> TrainState:
        if params is None:
            params = model.init(seed, device=dev)
        else:
            params = _to_device(params, dev)
        layout = None
        if mesh is not None:
            layout = Layout(model.cfg, axes, params, zero1,
                            pipe_axis=pipe_axis if n_micro else "")
            params = map_tree(
                lambda path, t: layout.shard(layout.paths.index(path), t),
                params)
        for p in leaves(params):
            p.requires_grad_(True)
        opt = Optimizer(leaves(params), learning_rate, grad_clip=grad_clip,
                        warmup_steps=warmup_steps, decay_steps=decay_steps,
                        layout=layout)
        return TrainState(step=0, params=params, opt_state=opt,
                          layout=layout)

    def loss_of(p, toks):
        return loss_fn(model, p, toks, mesh, n_micro=n_micro,
                       pipe_axis=pipe_axis, loss_chunk=loss_chunk,
                       moe_aux_weight=moe_aux_weight)

    def step_fn(state: TrainState, tokens: torch.Tensor, *,
                local: bool = False):
        tokens = torch.as_tensor(tokens).to(dev)
        if dp.size > 1 and not local:
            rows = data_rows(tokens.shape[0], dp.size, dp.rank,
                             max(grad_accum, n_micro, 1))
            tokens = tokens[torch.tensor(rows, device=dev)]
        loss = accumulated_grads(loss_of, state.params, tokens, grad_accum)
        loss = average_grads(state.params, loss, axes)
        state.opt_state.step()
        state.step += 1
        return state, loss

    return init_fn, step_fn


def _to_device(params: Params, dev: torch.device) -> Params:
    if isinstance(params, dict):
        return {k: _to_device(v, dev) for k, v in params.items()}
    return params.detach().to(dev).clone()
