"""Sampling filters and log-probabilities (port of
``instaslice_tpu/serving/sampling.py``).

The engine applies them in the JAX package's order
(``engine.py:783-797``): repetition penalty, then temperature, then the
top-k / nucleus / min-p filters. :func:`speculative_accept` is the
reference's acceptance rule (``sampling.py:85-150``) with an explicit
``torch.Generator`` in place of the JAX key.
"""

from __future__ import annotations

import torch

_NEG = -1e9


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty) -> torch.Tensor:
    """HF/vLLM repetition penalty: for tokens already ``seen`` (..., V)
    bool, positive logits divide by ``penalty`` and negative ones
    multiply."""
    logits = logits.float()
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def filter_logits(logits: torch.Tensor, top_k: int = 0, top_p: float = 1.0,
                  min_p: float = 0.0) -> torch.Tensor:
    """Mask ``logits`` (..., V) outside the top-k / nucleus / min-p set
    to -1e9. ``top_k <= 0``, ``top_p >= 1`` and ``min_p <= 0`` are
    no-ops; the token crossing ``top_p`` is kept and the argmax always
    survives. Filters compose: top-k, then nucleus, then min-p."""
    logits = logits.float()
    neg = torch.full_like(logits, _NEG)
    V = logits.shape[-1]
    if top_k and 0 < top_k < V:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        idx = torch.arange(V, device=logits.device)
        drop_sorted = ((cum - probs) >= top_p) & (idx > 0)
        threshold = torch.where(
            drop_sorted, torch.full_like(sorted_logits, float("inf")),
            sorted_logits,
        ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, neg, logits)
    if min_p > 0.0:
        probs = torch.softmax(logits, dim=-1)
        floor = min_p * probs.amax(dim=-1, keepdim=True)
        logits = torch.where(probs < floor, neg, logits)
    return logits


def speculative_accept(draft: torch.Tensor, q_probs: torch.Tensor,
                       p_probs: torch.Tensor, generator: torch.Generator):
    """Standard speculative-sampling acceptance: token i of each row's
    draft is accepted with probability ``min(1, p_i(x_i) / q_i(x_i))``
    (``u * q < p``, no divide); at the first rejection the replacement is
    drawn from the normalized residual ``max(p_i - q_i, 0)`` (``p_i``
    itself where that residual is all zero, its limit as q -> p), and a
    fully accepted row draws its bonus token from ``p_k``. The emitted
    tokens are distributed exactly as k+1 ancestral samples from ``p``.

    ``draft`` (B, k) tokens sampled from ``q_probs`` (B, k, V);
    ``p_probs`` (B, k+1, V) is the target distribution at every position
    (post temperature and filters). Returns ``(accepted (B,), out (B,
    k+1), logprobs (B, k+1), final (B,))``: ``out[:, :accepted]`` is the
    accepted prefix, ``out[b, accepted[b]] = final[b]``, positions past it
    are unspecified; ``logprobs`` is ``log p`` at every position of
    ``out``. The uniforms, then the final draws, come from
    ``generator``."""
    B, k = draft.shape
    dev = draft.device
    rows = torch.arange(B, device=dev)
    draft = draft.long()
    u = torch.rand((B, k), generator=generator, device=dev)
    p_at = torch.gather(p_probs[:, :k], -1, draft[..., None])[..., 0]
    q_at = torch.gather(q_probs, -1, draft[..., None])[..., 0]
    acc = (u * q_at < p_at).to(torch.int64)
    accepted = torch.cumprod(acc, dim=1).sum(dim=1)            # (B,)
    q_pad = torch.cat([q_probs, torch.zeros_like(p_probs[:, :1])], dim=1)
    p_pos = p_probs[rows, accepted]                             # (B, V)
    q_pos = q_pad[rows, accepted]
    res = torch.clamp(p_pos - q_pos, min=0.0)
    norm = res.sum(dim=-1, keepdim=True)
    res = torch.where(norm > 0, res / torch.where(norm > 0, norm, 1.0),
                      p_pos)
    final = torch.multinomial(res, 1, generator=generator)[:, 0]
    out = torch.cat([draft, torch.zeros((B, 1), dtype=torch.int64,
                                        device=dev)], dim=1)
    out[rows, accepted] = final
    logprobs = torch.log(torch.clamp(
        torch.gather(p_probs, -1, out[..., None])[..., 0], min=1e-38))
    return accepted, out, logprobs, final


def token_logprob(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """log p(tok) under softmax(logits): logits (..., V), toks (...) ->
    fp32 (...)."""
    return torch.gather(torch.log_softmax(logits.float(), dim=-1), -1,
                        toks[..., None].long())[..., 0]


def sample(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``logits`` (B, V) from
    softmax(logits), with the caller's generator -> (B,) int64."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
