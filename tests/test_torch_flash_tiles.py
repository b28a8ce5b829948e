"""The tile schedules of the bf16 flash-attention kernels B5-B7, on the
CPU.

``ops/flash_attention.py`` describes in plain Python which tiles each
block of the warp-specialised kernels visits (``fwd_tiles``: 128-row
query tiles, two consumer warpgroups of 64 rows, over 128-key tiles;
``dq_tiles``: the same query tiles over 64-key tiles, each warpgroup up
to its own diagonal; ``dkv_tiles``: 128-key blocks, two warpgroups of
64 keys, over 64-row query tiles from the diagonal). The CUDA source's own schedule functions
are held against this description on the card
(``tests/test_torch_cuda.py``); here the description itself is held to
what attention needs: every (query, key) pair that the mask keeps is
computed exactly once, and no tile whose pairs are all masked (past S,
past kv_len, or above the causal diagonal) is visited.
"""

import numpy as np
import pytest

from instaslice_tpu_torch.ops import flash_attention as fa

SCHEDULES = {"fwd": fa.fwd_tiles, "dq": fa.dq_tiles,
             "dkv": fa.dkv_tiles}
#: S = 1 ... 300 in chunks (every tile edge of both kernels several
#: times over), and the training CLI's ragged row width
S_CHUNKS = [range(a, a + 50) for a in range(1, 300, 50)] + [[1025]]


def _coverage(S, KV, causal, tiles):
    """How many times each (query, key) pair is computed; fails on a tile
    with no pair the mask keeps."""
    cov = np.zeros((S, KV), np.int32)
    for (q_lo, q_hi), (k_lo, k_hi) in tiles:
        q_hi, k_hi = min(q_hi, S), min(k_hi, KV)
        assert q_lo < q_hi and k_lo < k_hi, "tile wholly past the end"
        keep = np.ones((q_hi - q_lo, k_hi - k_lo), bool)
        if causal:
            keep = (np.arange(k_lo, k_hi)[None, :]
                    <= np.arange(q_lo, q_hi)[:, None])
        assert keep.any(), f"fully masked tile {(q_lo, q_hi), (k_lo, k_hi)}"
        cov[q_lo:q_hi, k_lo:k_hi] += keep
    return cov


def _want(S, KV, causal):
    ones = np.ones((S, KV), np.int32)
    return np.tril(ones) if causal else ones


@pytest.mark.parametrize("chunk", S_CHUNKS,
                         ids=lambda c: f"S{c[0]}-{c[-1]}")
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kernel", sorted(SCHEDULES))
def test_every_unmasked_pair_once(kernel, causal, chunk):
    for S in chunk:
        tiles = SCHEDULES[kernel](S, S, causal)
        assert (_coverage(S, S, causal, tiles) == _want(S, S, causal)).all()


@pytest.mark.parametrize("KV", [1, 63, 77, 129, 300])
@pytest.mark.parametrize("kernel", sorted(SCHEDULES))
def test_non_causal_s_differs_from_kv(kernel, KV):
    for S in (1, 64, 65, 200, 257):
        tiles = SCHEDULES[kernel](S, KV, False)
        assert (_coverage(S, KV, False, tiles) == 1).all()


def test_main_shape_tile_counts():
    """S = 1024 causal: B5 visits 8 x 9 / 2 = 36 key tiles per 128-row
    block pair of warpgroups (72 warpgroup products per head); B7 visits,
    per 64-key warpgroup, the query tiles from its diagonal (16 + ... + 1
    = 136 per head)."""
    assert len(fa.fwd_tiles(1024, 1024, True)) == 72
    assert len(fa.dkv_tiles(1024, 1024, True)) == 136
    assert len(fa.fwd_tiles(1024, 1024, False)) == 2 * 8 * 8
    assert len(fa.dkv_tiles(1024, 1024, False)) == 2 * 8 * 16
    # B6: 64-row warpgroups over 64-key tiles up to their diagonals,
    # 1 + 2 + ... + 16 per head; all 16 x 16 when not causal
    assert len(fa.dq_tiles(1024, 1024, True)) == 136
    assert len(fa.dq_tiles(1024, 1024, False)) == 16 * 16


def test_causal_b7_starts_at_the_diagonal():
    """B7's query tiles (64 rows) are half its key blocks (128 keys): the
    block's first visited tile is k0 / 64, the first warpgroup's
    diagonal; the second warpgroup starts one tile later."""
    for kj in range(8):
        assert fa.dkv_wg_tiles(1024, 1024, True, kj, 0) == (2 * kj,
                                                            16 - 2 * kj)
        assert fa.dkv_wg_tiles(1024, 1024, True, kj, 1) == (2 * kj + 1,
                                                            15 - 2 * kj)


def test_causal_b5_takes_the_longest_tiles_first():
    counts = [fa.fwd_wg_tiles(1025, 1025, True, y, 0)[2] for y in range(9)]
    assert counts == sorted(counts, reverse=True) == list(range(9, 0, -1))
    # the last query tile of S = 1025 holds one row: its second
    # warpgroup's rows all lie past S
    assert fa.fwd_wg_tiles(1025, 1025, True, 0, 1)[2] == 0


def test_causal_b6_takes_the_longest_tiles_first():
    """B6 query block y holds rows from (nq - 1 - y) 128: its second
    warpgroup reaches one 64-key tile further than its first, and the
    blocks come longest first."""
    for y in range(8):
        qi = 7 - y
        assert fa.dq_wg_tiles(1024, 1024, True, y, 0) == (qi, 0, 2 * qi + 1)
        assert fa.dq_wg_tiles(1024, 1024, True, y, 1) == (qi, 0, 2 * qi + 2)
    # S = 1025: the last block holds one row, in its first warpgroup
    assert fa.dq_wg_tiles(1025, 1025, True, 0, 0) == (8, 0, 17)
    assert fa.dq_wg_tiles(1025, 1025, True, 0, 1) == (8, 0, 0)
