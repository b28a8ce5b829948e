"""Sampling filters and log-probabilities (port of
``instaslice_tpu/serving/sampling.py``).

The engine applies them in the JAX package's order
(``engine.py:783-797``): repetition penalty, then temperature, then the
top-k / nucleus / min-p filters. ``speculative_accept`` is not ported
yet (speculative decoding comes in a later slice).
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
