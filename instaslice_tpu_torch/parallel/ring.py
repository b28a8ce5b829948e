"""Ring attention over the ``seq`` mesh axis (port of
``instaslice_tpu/parallel/ring.py``).

Each rank of the ``seq`` axis holds a contiguous block of the sequence;
K/V blocks travel round the ring (:func:`~instaslice_tpu_torch.parallel.
collectives.ring_shift`, one hop a step, the reverse hop in the
backward) while an online softmax with fp32 accumulators folds each
block into the output, so a rank holds O(S / n) of the keys at a time.

Plain PyTorch, as the reference's is plain ``einsum``: no Pallas kernel
computes the ring there, so no hand-written kernel (B5-B7 included)
runs here.
"""

from __future__ import annotations

import torch

from instaslice_tpu_torch.parallel.collectives import Axis, ring_shift

_NEG = -1e9


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   ax: Axis, *, causal: bool = True) -> torch.Tensor:
    """Attention over a sequence split over ``ax`` (``ring.py:29-95``).

    q/k/v: (B, S_local, H, hd), this rank's block (rank ``r`` holds
    positions ``[r * S_local, (r + 1) * S_local)``; equal head counts:
    the caller repeats GQA's K/V). Returns the (B, S_local, H, hd) block
    of full attention over the whole sequence, in ``q``'s dtype, equal up
    to the order of the fp32 sums. After ``i`` hops a rank holds block
    ``(r - i) mod n``; ``n - 1`` hops bring every block past every rank
    (the reference's last hop, whose result it drops, is not made)."""
    n, my = ax.size, ax.rank
    B, S, H, hd = q.shape
    dev = q.device
    q32 = q.float() * hd ** -0.5
    q_pos = my * S + torch.arange(S, device=dev)
    o = torch.zeros((B, H, S, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, H, S), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    for i in range(n):
        if i:
            k_blk = ring_shift(k_blk, ax)
            v_blk = ring_shift(v_blk, ax)
        k_pos = ((my - i) % n) * S + torch.arange(S, device=dev)
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float())
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask, logits,
                                 torch.full_like(logits, _NEG))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        if causal:
            # exact zeros where masked (the first blocks need them)
            p = torch.where(mask, p, torch.zeros_like(p))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               v_blk.float())
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)
