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

Not ported, and raising ``NotImplementedError``: pipeline parallelism
(``n_micro``), ZeRO-1 (``zero1``), a device mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from instaslice_tpu_torch import resolve_device
from instaslice_tpu_torch.models.lm import TpuLM, unembed

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


def _chunk_nll(embed_leaf, hc, tc, mc):
    logits = unembed(hc, embed_leaf, hc.dtype)             # fp32
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tc[..., None].long())[..., 0]
    return ((lse - gold) * mc).sum()


def _chunked_xent(embed_leaf, hidden, targets, mask,
                  chunk: int) -> torch.Tensor:
    """Summed next-token cross-entropy without the (B, S, V) logits
    (``train.py:51-87``): the sequence is padded to whole chunks (the
    padding masked), and each (B, chunk, V) block is unembedded and
    log-sum-exped under its own checkpoint, so the backward recomputes
    one block at a time. Chunk totals add in sequence order, as the
    reference's scan does."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        cols = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_chunk_nll, embed_leaf, hidden[:, cols],
                                   targets[:, cols], mask[:, cols],
                                   use_reentrant=False)
    return total


def loss_fn(model: TpuLM, params: Params, tokens: torch.Tensor,
            loss_chunk: int = DEFAULT_LOSS_CHUNK,
            moe_aux_weight: float = DEFAULT_MOE_AUX_WEIGHT) -> torch.Tensor:
    """Next-token cross-entropy (``train.py:94-150``, no pipeline):
    tokens (B, S) predict ``roll(tokens, -1)``, the last position has no
    target. ``loss_chunk`` > 0 takes the chunked loss, 0 the one-shot
    log-softmax over the full logits. An MoE model with
    ``moe_aux_weight`` > 0 adds that weight times the layer-averaged
    load-balance term (without it top-k routing collapses onto a few
    experts and the capacity drops eat the batch)."""
    targets = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    chunked = loss_chunk > 0
    want_aux = bool(model.cfg.n_experts) and moe_aux_weight > 0
    out = model.apply(params, tokens, unembed=not chunked,
                      return_aux=want_aux)
    if want_aux:
        out, aux = out
    if chunked:
        xent = _chunked_xent(params["embed"], out, targets, mask,
                             loss_chunk) / mask.sum()
    else:
        logp = torch.log_softmax(out, dim=-1)
        nll = -logp.gather(-1, targets[..., None].long())[..., 0]
        xent = (nll * mask).sum() / mask.sum()
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


class Optimizer:
    """The reference's ``make_optimizer`` chain (``train.py:217-245``):
    optional global-norm clip, then AdamW (b1 0.9, b2 0.95, eps 1e-8,
    weight decay 0.01 on every leaf, norm scales included, as optax
    decays them), at a constant rate or on :func:`warmup_cosine`.

    The clip is optax's ``clip_by_global_norm``: grads are scaled by
    ``max / norm`` only when ``norm >= max`` (``clip_grad_norm_`` adds
    1e-6 to the norm and would not match). The schedule reads the number
    of updates before this one, as optax's count does: the first update
    runs at lr 0 when warmup is on."""

    def __init__(self, params: List[torch.Tensor], learning_rate: float,
                 grad_clip: float = 0.0, warmup_steps: int = 0,
                 decay_steps: int = 0, weight_decay: float = 0.01):
        self.params = list(params)
        self.grad_clip = grad_clip
        self.schedule = (warmup_cosine(learning_rate, warmup_steps,
                                       decay_steps)
                         if warmup_steps or decay_steps else None)
        self.adamw = torch.optim.AdamW(self.params, lr=learning_rate,
                                       betas=(0.9, 0.95), eps=1e-8,
                                       weight_decay=weight_decay)
        self.count = 0

    def clip_(self) -> None:
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
        coef = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                           self.grad_clip / norm)
        for g in grads:
            g.mul_(coef.to(g.dtype))

    def step(self) -> None:
        """One update from the params' ``.grad``; the grads are dropped."""
        if self.grad_clip > 0:
            self.clip_()
        if self.schedule is not None:
            for group in self.adamw.param_groups:
                group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
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
    state to its jitted step) and returns it."""
    step: int
    params: Params
    opt_state: Optimizer


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
    mesh=None,
) -> Tuple[Callable, Callable]:
    """``(init_fn, step_fn)`` for one device (``train.py:314-422``).

    ``init_fn(seed=0, params=None) -> TrainState``: random weights from
    ``seed`` in ``cfg.param_dtype`` (fp32 masters) or, given ``params``,
    those (moved to the device). ``step_fn(state, tokens) -> (state,
    loss)``: tokens (B, S) int; the loss is a 0-dim tensor on the device
    (no host sync)."""
    if zero1 or n_micro or mesh is not None:
        raise NotImplementedError(
            "zero1, pipeline parallelism (n_micro) and a device mesh are "
            "not ported: the train step runs on one card")
    dev = resolve_device(device)

    def init_fn(seed: int = 0, params: Optional[Params] = None
                ) -> TrainState:
        if params is None:
            params = model.init(seed, device=dev)
        else:
            params = _to_device(params, dev)
        for p in leaves(params):
            p.requires_grad_(True)
        opt = Optimizer(leaves(params), learning_rate, grad_clip=grad_clip,
                        warmup_steps=warmup_steps, decay_steps=decay_steps)
        return TrainState(step=0, params=params, opt_state=opt)

    def loss_of(p, toks):
        return loss_fn(model, p, toks, loss_chunk=loss_chunk,
                       moe_aux_weight=moe_aux_weight)

    def step_fn(state: TrainState, tokens: torch.Tensor):
        tokens = torch.as_tensor(tokens).to(dev)
        loss = accumulated_grads(loss_of, state.params, tokens, grad_accum)
        state.opt_state.step()
        state.step += 1
        return state, loss

    return init_fn, step_fn


def _to_device(params: Params, dev: torch.device) -> Params:
    if isinstance(params, dict):
        return {k: _to_device(v, dev) for k, v in params.items()}
    return params.detach().to(dev).clone()
