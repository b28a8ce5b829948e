"""The split of B1 (decode attention) across the cache, on the CPU.

``csrc/flash_decode.cu`` splits each row's live prefix into chunks of P
positions, one block each, and combines the chunks' partials (acc, m,
l) in split order. ``ops/flash_decode.py`` describes both in plain
Python (``split_plan``, ``combine_partials``); the CUDA source's own plan
is held against this description on the card
(``tests/test_torch_cuda.py``). Here the description is held to what
the kernel must compute: the chunks cover ``[0, s_attn)`` exactly once,
and per-chunk plain partials, combined, equal the plain version and,
through ``merge_local``, the JAX package's Pallas kernel (interpret
mode), at lengths 0, 1, P - 1, P, P + 1, s_attn and past s_attn, with
the empty row exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaslice_tpu.ops import flash_decode as jfd
from instaslice_tpu_torch.ops import flash_decode as tfd

#: (B, Hkv, s_attn) of the engine's buckets at batch 8 with 8 KV heads,
#: and a few small and ragged ones
PLAN_SHAPES = [(8, 8, 256), (8, 8, 512), (8, 8, 1024), (8, 8, 2048),
               (1, 8, 1024), (1, 1, 1), (4, 2, 100), (3, 5, 4097),
               (32, 8, 8192)]


def _chunks(B, Hkv, s_attn):
    P, n = tfd.split_plan(B, Hkv, s_attn)
    return P, [(z * P, min((z + 1) * P, s_attn)) for z in range(n)]


@pytest.mark.parametrize("B,Hkv,s_attn", PLAN_SHAPES)
def test_chunks_cover_the_prefix_once(B, Hkv, s_attn):
    P, chunks = _chunks(B, Hkv, s_attn)
    assert P % tfd.SPLIT_TILE == 0
    assert P <= tfd.SPLIT_TILE * tfd.SPLIT_MAX_TILES
    cov = np.zeros(s_attn, np.int32)
    for lo, hi in chunks:
        assert lo < hi, "empty chunk in the plan"
        cov[lo:hi] += 1
    assert (cov == 1).all()
    # the grid stays within its target (up to the rounding of the last
    # chunk of each row) unless P is at its largest
    if P < tfd.SPLIT_TILE * tfd.SPLIT_MAX_TILES:
        assert B * Hkv * len(chunks) <= tfd.SPLIT_TARGET_BLOCKS + B * Hkv


def test_plan_fills_the_card_at_the_engine_buckets():
    """Batch 8 x 8 KV heads: 256 blocks at s_attn 256 and 512 at 1024,
    against the H100's 132 SMs (the unsplit grid was 64 blocks)."""
    assert tfd.split_plan(8, 8, 256) == (64, 4)
    assert tfd.split_plan(8, 8, 1024) == (128, 8)
    for s_attn in (256, 1024):
        P, n = tfd.split_plan(8, 8, s_attn)
        assert 132 <= 8 * 8 * n <= tfd.SPLIT_TARGET_BLOCKS


def _mk(B, Hkv, G, hd, S, seed):
    rng = np.random.default_rng(seed)
    L = 2
    k3 = rng.integers(-127, 128, (L, B, Hkv, S, hd), dtype=np.int8)
    v3 = rng.integers(-127, 128, (L, B, Hkv, S, hd), dtype=np.int8)
    ks3 = rng.uniform(0.01, 0.1, (L, B, Hkv, S)).astype(np.float32)
    vs3 = rng.uniform(0.01, 0.1, (L, B, Hkv, S)).astype(np.float32)
    q4 = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    k_loc = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    v_loc = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    return q4, (k3, ks3, v3, vs3), k_loc, v_loc


def _chunk_partials(q4, k3, ks3, v3, vs3, lengths, layer, s_attn):
    """Each chunk of the plan through the plain version on its own
    positions -> (B, Hkv, n_split, G, hd + 2) partials."""
    B, Hkv = q4.shape[:2]
    _, chunks = _chunks(B, Hkv, s_attn)
    live = lengths.clamp(0, s_attn)
    parts = []
    for lo, hi in chunks:
        o, m, l = tfd.quant_decode_attention_ref(
            q4, k3[..., lo:hi, :], ks3[..., lo:hi], v3[..., lo:hi, :],
            vs3[..., lo:hi], (live - lo).clamp(0, hi - lo).int(), layer,
            hi - lo)
        parts.append(torch.cat([o, m[..., None], l[..., None]], dim=-1))
    return torch.stack(parts, dim=2)


def _lengths(P, s_attn):
    """0, 1, P - 1, P, P + 1, s_attn, past s_attn, and one in between."""
    return [0, 1, P - 1, P, P + 1, s_attn, s_attn + 37, s_attn // 2 + 3]


#: (B = 8 rows for the 8 lengths, Hkv, G, hd, s_attn): P = 64, 128, 256
CASES = [(8, 2, 2, 16, 256), (8, 2, 4, 16, 512), (8, 8, 2, 16, 1024),
         (8, 8, 1, 16, 2048)]


def _case(B, Hkv, G, hd, s_attn, layer, seed):
    P, _ = tfd.split_plan(B, Hkv, s_attn)
    lens = np.asarray(_lengths(P, s_attn), np.int32)
    q4, cache, k_loc, v_loc = _mk(B, Hkv, G, hd, s_attn + 64, seed)
    t = [torch.from_numpy(c) for c in cache]
    return P, lens, q4, cache, t, k_loc, v_loc


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("B,Hkv,G,hd,s_attn", CASES)
def test_combined_chunks_equal_the_plain_version(B, Hkv, G, hd, s_attn,
                                                 layer):
    P, lens, q4, _, t, _, _ = _case(B, Hkv, G, hd, s_attn, layer,
                                    s_attn + layer)
    q = torch.from_numpy(q4)
    lengths = torch.from_numpy(lens)
    parts = _chunk_partials(q, *t, lengths, layer, s_attn)
    assert parts.shape == (B, Hkv, -(-s_attn // P), G, hd + 2)
    acc, m, l = tfd.combine_partials(parts)
    ro, rm, rl = tfd.quant_decode_attention_ref(q, *t, lengths, layer,
                                                s_attn)
    for got, want in ((acc, ro), (m, rm), (l, rl)):
        # fp32 both sides, the same terms grouped by chunk: acc sums up
        # to 2048 signed terms (measured at most 9.5e-7 of max|plain|)
        err = float((got[1:] - want[1:]).abs().max())
        assert err <= 2e-6 * float(want[1:].abs().max()), err
        # the empty row (length 0): the convention, bit for bit
        assert torch.equal(got[0], want[0])
    assert float(m[0].max()) == float(np.float32(-1e30))
    assert float(l[0].abs().max()) == 0.0 and float(acc[0].abs().max()) == 0


@pytest.mark.parametrize("B,Hkv,G,hd,s_attn", CASES)
def test_combined_chunks_match_the_jax_kernel(B, Hkv, G, hd, s_attn):
    """Through merge_local (raw ``l`` of an empty row differs by design
    between the packages); fp32 both sides, 2e-5 for the different
    softmax and summation orders."""
    layer = 1
    _, lens, q4, cache, t, k_loc, v_loc = _case(B, Hkv, G, hd, s_attn,
                                                layer, 7 * s_attn)
    lg_l = np.einsum("bkgd,bkd->bkg", q4 * hd ** -0.5, k_loc)
    jo, jm, jl = jfd.quant_decode_attention(
        jnp.asarray(q4), *(jnp.asarray(c) for c in cache), jnp.asarray(lens),
        jnp.int32(layer), s_attn)
    want = jfd.merge_local(jo, jm, jl, jnp.asarray(lg_l), jnp.asarray(v_loc))
    parts = _chunk_partials(torch.from_numpy(q4), *t, torch.from_numpy(lens),
                            layer, s_attn)
    got = tfd.merge_local(*tfd.combine_partials(parts),
                          torch.from_numpy(lg_l), torch.from_numpy(v_loc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # an empty prefix merges to the local value exactly
    np.testing.assert_array_equal(
        got[0].numpy(), np.broadcast_to(v_loc[0][:, None, :],
                                        got[0].shape))


def test_all_empty_partials_combine_to_the_empty_row_exactly():
    part = torch.zeros((2, 3, 5, 4, 18))
    part[..., 16] = -1e30
    acc, m, l = tfd.combine_partials(part)
    assert torch.equal(m, torch.full_like(m, -1e30))
    assert torch.equal(l, torch.zeros_like(l))
    assert torch.equal(acc, torch.zeros_like(acc))


def test_empty_splits_leave_the_live_ones_unchanged():
    """A row whose prefix ends inside split 0 has empty splits after it:
    combining adds exactly nothing to split 0's partial."""
    g = torch.Generator().manual_seed(3)
    part = torch.zeros((1, 1, 4, 2, 10))
    part[..., 8] = -1e30
    part[:, :, 0] = torch.randn((1, 1, 2, 10), generator=g)
    part[:, :, 0, :, 9] = part[:, :, 0, :, 9].abs()
    acc, m, l = tfd.combine_partials(part)
    assert torch.equal(acc, part[:, :, 0, :, :8])
    assert torch.equal(m, part[:, :, 0, :, 8])
    assert torch.equal(l, part[:, :, 0, :, 9])
