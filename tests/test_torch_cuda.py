"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a card (decided in a fixture, never at
import) and run on an H100 with ``python -m pytest -m cuda
tests/test_torch_cuda.py``. Shapes are small and deliberately ragged:
they reach the masked edges and layouts ``chip_smoke.py``'s 7B shapes
never do. Tolerances: fp32 sums of exact products in another order.
"""

import time

import pytest
import torch

from instaslice_tpu_torch.ops import flash_attention as fa
from instaslice_tpu_torch.ops import flash_decode as fd
from instaslice_tpu_torch.ops import quant_matmul as qm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _close(got, want, rel=2e-5):
    torch.cuda.synchronize()
    tol = rel * float(want.abs().max()) + 1e-5
    assert float((got - want).abs().max()) <= tol


def _close_tiles(got, want, cols, rel=1.5e-5):
    """Relative L2 error over the output and over its worst tile of
    ``cols`` channels (one block's channel tile): a dropped k tile, ring
    stage or channel tile shows there whatever the largest element is."""
    torch.cuda.synchronize()
    diff = (got - want).float()
    assert float(diff.norm() / want.norm()) <= rel
    pad = (0, -want.shape[1] % cols)
    d_t, w_t = (torch.nn.functional.pad(t, pad).reshape(
        t.shape[0], -1, cols).permute(1, 0, 2).reshape(-1, t.shape[0] * cols)
        for t in (diff, want.float()))
    worst = float((d_t.norm(dim=-1) / w_t.norm(dim=-1).clamp_min(1e-30)).max())
    assert worst <= rel, worst


#: row counts around every tile boundary of the tensor-core kernel
TC_MS = [1, 7, 8, 9, 100, 128, 255, 256]


@pytest.mark.parametrize("M,K,N", [(1, 128, 256), (8, 4096, 1024),
                                   (13, 300, 264), (40, 256, 100),
                                   (129, 512, 384)])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_w8a16_kn_kernels(dev, M, K, N, xdt):
    """B2 (every layer of a stack) and B4 on (K, N) weights, including
    N not a multiple of 8 (byte loads) and M past one row tile."""
    g = torch.Generator(device=dev).manual_seed(M * K + N)
    x = torch.randn((M, K), generator=g, device=dev).to(xdt)
    q3 = torch.randint(-127, 128, (3, K, N), generator=g, device=dev,
                       dtype=torch.int8)
    s3 = torch.rand((3, 1, N), generator=g, device=dev).to(torch.bfloat16)
    for li in range(3):
        _close(qm.quant_matmul_stacked(x, q3, s3, li),
               qm.quant_matmul_stacked_ref(x, q3, s3, li))
    _close(qm.quant_matmul(x, q3[1], s3[1]),
           qm.quant_matmul_ref(x, q3[1], s3[1]))


@pytest.mark.parametrize("K,N", [(4096, 1024),     # a 7B shape, K split
                                 (1000, 528),      # K tail, ragged tile
                                 (72, 16),         # one short stage
                                 (2048, 4112)])    # last channel tile of 16
@pytest.mark.parametrize("M", TC_MS)
def test_w8a16_kn_tensor_core_kernel(dev, M, K, N):
    """B2 and B4 with bf16 x on aligned rows (the tensor-core kernel):
    every row count around its tile boundaries, a K that is no multiple
    of the k tile, layers 0 / middle / last of a stack read in place,
    and two runs bit-equal (the K split sums in a fixed order)."""
    assert qm.route(torch.bfloat16, M, K, N, False) == "tc"
    g = torch.Generator(device=dev).manual_seed(M * K + N)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    q3 = torch.randint(-127, 128, (5, K, N), generator=g, device=dev,
                       dtype=torch.int8)
    s3 = torch.rand((5, 1, N), generator=g, device=dev).to(torch.bfloat16)
    cols = qm.tc_tile(M, False).ct
    for li in (0, 2, 4):
        got = qm.quant_matmul_stacked(x, q3, s3, li)
        want = qm.quant_matmul_stacked_ref(x, q3, s3, li)
        _close(got, want)
        _close_tiles(got, want, cols)
        assert torch.equal(got, qm.quant_matmul_stacked(x, q3, s3, li))
    got = qm.quant_matmul(x, q3[3], s3[3].float())
    _close(got, qm.quant_matmul_ref(x, q3[3], s3[3].float()))
    assert torch.equal(got, qm.quant_matmul(x, q3[3], s3[3].float()))


@pytest.mark.parametrize("M,K,N", [(8, 4096, 1000), (3, 130, 77),
                                   (17, 1500, 64)])
def test_w8a16_nk_kernel(dev, M, K, N):
    """B3 on (N, K) weights, including K not a multiple of 4."""
    g = torch.Generator(device=dev).manual_seed(K + N)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand((N, 1), generator=g, device=dev)
    _close(qm.quant_matmul_t(x, q, s), qm.quant_matmul_t_ref(x, q, s))


@pytest.mark.parametrize("K,N", [(4096, 1000),     # K split, ragged rows
                                 (208, 77),        # K tail under a stage
                                 (4112, 300)])     # K tail past the stages
@pytest.mark.parametrize("M", TC_MS)
def test_w8a16_nk_tensor_core_kernel(dev, M, K, N):
    """B3 with bf16 x and K % 16 == 0 (the tensor-core kernel) at every
    row count around its tile boundaries; fp32 x on the same weights
    takes the CUDA-core kernel; two runs bit-equal."""
    assert qm.route(torch.bfloat16, M, K, N, True) == "tc"
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand((N, 1), generator=g, device=dev)
    got = qm.quant_matmul_t(x, q, s)
    want = qm.quant_matmul_t_ref(x, q, s)
    _close(got, want)
    _close_tiles(got, want, qm.tc_tile(M, True).ct)
    assert torch.equal(got, qm.quant_matmul_t(x, q, s))
    _close(qm.quant_matmul_t(x.float(), q, s),
           qm.quant_matmul_t_ref(x.float(), q, s))


def test_planner_mirrors_the_kernel_tile_table(dev):
    """``tc_tile`` in Python and the tile table of the CUDA source agree
    at every row count."""
    import ctypes

    from instaslice_tpu_torch.ops import build
    lib = build.library("quant_matmul", qm._SIGNATURES)
    vals = [ctypes.c_int() for _ in range(6)]
    for transposed in (False, True):
        for M in range(1, 257):
            rc = lib.isl_qmm_tc_tile(int(transposed), M,
                                     *[ctypes.byref(v) for v in vals])
            assert rc == 0
            t = qm.tc_tile(M, transposed)
            assert [v.value for v in vals] == [t.ct, t.mpad, t.threads,
                                               t.smem, t.kt, t.stages]


@pytest.mark.parametrize("hd,G", [(64, 1), (64, 4), (128, 2), (128, 8)])
def test_decode_attention_kernel(dev, hd, G):
    """B1 at both head dims and every group size, staggered lengths
    (0 included) and s_attn below S, on a slot subset of a larger
    cache (a strided view, as the engine's single-slot prefill passes)."""
    g = torch.Generator(device=dev).manual_seed(hd * G)
    L, B_all, Hkv, S = 3, 6, 2, 200
    k3 = torch.randint(-127, 128, (L, B_all, Hkv, S, hd), generator=g,
                       device=dev, dtype=torch.int8)
    v3 = torch.randint(-127, 128, k3.shape, generator=g, device=dev,
                       dtype=torch.int8)
    ks3 = torch.rand(k3.shape[:-1], generator=g, device=dev) * 0.02
    vs3 = torch.rand(k3.shape[:-1], generator=g, device=dev) * 0.02
    view = (slice(None), slice(1, 5))                 # slots 1..4 of 6
    args = [t[view] for t in (k3, ks3, v3, vs3)]
    lengths = torch.tensor([0, 1, 70, 190], dtype=torch.int32, device=dev)
    q4 = torch.randn((4, Hkv, G, hd), generator=g, device=dev)
    for li in range(L):
        o, m, l = fd.quant_decode_attention(q4, *args, lengths, li, 160)
        ro, rm, rl = fd.quant_decode_attention_ref(q4, *args, lengths, li,
                                                   160)
        for got, want in ((o, ro), (m, rm), (l, rl)):
            _close(got[1:], want[1:])
            assert torch.equal(got[0], want[0])       # empty-row convention


def _decode_case(dev, hd, G, q_dtype, s_attn, lens, seed):
    """A (3, 10, 2, S, hd) cache of which slots 1, 3, ... are passed (a
    strided view whose batch stride is not Hkv S hd), queries and
    lengths for those slots."""
    g = torch.Generator(device=dev).manual_seed(seed)
    L, Hkv, S = 3, 2, s_attn + 40
    B = len(lens)
    k3 = torch.randint(-127, 128, (L, 2 * B + 1, Hkv, S, hd), generator=g,
                       device=dev, dtype=torch.int8)
    v3 = torch.randint(-127, 128, k3.shape, generator=g, device=dev,
                       dtype=torch.int8)
    ks3 = torch.rand(k3.shape[:-1], generator=g, device=dev) * 0.02
    vs3 = torch.rand(k3.shape[:-1], generator=g, device=dev) * 0.02
    view = (slice(None), slice(1, 2 * B + 1, 2))
    args = [t[view] for t in (k3, ks3, v3, vs3)]
    q4 = torch.randn((B, Hkv, G, hd), generator=g, device=dev).to(q_dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q4, args, lengths


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G", [(64, 2), (64, 8), (128, 1), (128, 4)])
@pytest.mark.parametrize("s_attn", [256, 1024])
def test_decode_attention_split_edges(dev, hd, G, q_dtype, s_attn):
    """B1 split across the cache: lengths 0, 1, P - 1, P, P + 1, s_attn
    and past s_attn, on a strided slot subset; the merged output within
    1e-5, the empty row bit-exact, one launch counted per call, and two
    runs bit-equal (the splits combine in a fixed order)."""
    B, Hkv = 8, 2
    P, n_split = fd.split_plan(B, Hkv, s_attn)
    assert n_split > 1
    lens = [0, 1, P - 1, P, P + 1, s_attn, s_attn + 30, 2 * P + 5]
    q4, args, lengths = _decode_case(dev, hd, G, q_dtype, s_attn, lens,
                                     hd + G + s_attn)
    before = fd.quant_decode_attention.launches
    o, m, l = fd.quant_decode_attention(q4, *args, lengths, 2, s_attn)
    assert fd.quant_decode_attention.launches == before + 1
    ro, rm, rl = fd.quant_decode_attention_ref(q4, *args, lengths, 2, s_attn)
    for got, want in ((o, ro), (m, rm), (l, rl)):
        _close(got[1:], want[1:], rel=1e-5)
        assert torch.equal(got[0], want[0])          # empty-row convention
    g = torch.Generator(device=dev).manual_seed(1)
    lg = torch.randn(m.shape, generator=g, device=dev)
    v_loc = torch.randn((B, Hkv, hd), generator=g, device=dev)
    merged = fd.merge_local(o, m, l, lg, v_loc)
    want = fd.merge_local(ro, rm, rl, lg, v_loc)
    torch.cuda.synchronize()
    assert float((merged - want).abs().max()) <= 1e-5
    o2, m2, l2 = fd.quant_decode_attention(q4, *args, lengths, 2, s_attn)
    assert torch.equal(o, o2) and torch.equal(m, m2) and torch.equal(l, l2)


def test_decode_attention_all_rows_empty(dev):
    """Every split of every row empty: the combine gives exactly
    (acc 0, m -1e30, l 0)."""
    q4, args, lengths = _decode_case(dev, 128, 4, torch.bfloat16, 512,
                                     [0] * 8, 3)
    o, m, l = fd.quant_decode_attention(q4, *args, lengths, 0, 512)
    torch.cuda.synchronize()
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.equal(l, torch.zeros_like(l))
    assert torch.equal(m, torch.full_like(m, -1e30))


@pytest.mark.parametrize("B,s_attn", [(8, 64), (1024, 256)])
def test_decode_attention_one_split(dev, B, s_attn):
    """A plan of one split (s_attn within one tile, or B Hkv large enough
    that P reaches s_attn): the combine passes the partial through, so
    the result is the plain version's within 1e-5 with the empty row
    bit-exact, and two runs are bit-equal."""
    P, n_split = fd.split_plan(B, 2, s_attn)
    assert n_split == 1
    lens = [0] + ([1, P - 1, s_attn, s_attn + 30, 17] * B)[:B - 1]
    q4, args, lengths = _decode_case(dev, 64, 4, torch.bfloat16, s_attn,
                                     lens, B + s_attn)
    o, m, l = fd.quant_decode_attention(q4, *args, lengths, 1, s_attn)
    ro, rm, rl = fd.quant_decode_attention_ref(q4, *args, lengths, 1, s_attn)
    for got, want in ((o, ro), (m, rm), (l, rl)):
        _close(got[1:], want[1:], rel=1e-5)
        assert torch.equal(got[0], want[0])          # empty-row convention
    o2, m2, l2 = fd.quant_decode_attention(q4, *args, lengths, 1, s_attn)
    assert torch.equal(o, o2) and torch.equal(m, m2) and torch.equal(l, l2)


def test_decode_split_plan_mirrors_the_kernel(dev):
    """``split_plan`` in Python and ``fd_plan`` of the CUDA source agree."""
    import ctypes

    from instaslice_tpu_torch.ops import build
    lib = build.library("flash_decode", fd._SIGNATURES)
    P, n = ctypes.c_int(), ctypes.c_int()
    for B in (1, 2, 3, 8, 16, 64):
        for Hkv in (1, 2, 8):
            for s_attn in [*range(1, 300, 7), 512, 1000, 1024, 2048, 4097,
                           8192]:
                assert lib.isl_fd_plan(B, Hkv, s_attn, ctypes.byref(P),
                                       ctypes.byref(n)) == 0
                assert (P.value, n.value) == fd.split_plan(B, Hkv, s_attn)


def test_wrappers_raise_on_bad_inputs(dev):
    x = torch.randn((4, 64), device=dev)
    q = torch.zeros((64, 32), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        qm.quant_matmul(x.t().contiguous().t(), q, torch.ones(32, device=dev))
    with pytest.raises(ValueError, match="CUDA device"):
        qm.quant_matmul(x, q.cpu(), torch.ones(32))
    before = qm.quant_matmul.launches
    qm.quant_matmul(x, q, torch.ones(32, device=dev))
    assert qm.quant_matmul.launches == before + 1


def _attn_inputs(dev, BH, S, KV, hd, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((BH, S, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((BH, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((BH, KV, hd), generator=g, device=dev).to(dtype)
    do = torch.randn((BH, S, hd), generator=g, device=dev).to(dtype)
    return q, k, v, do


#: bf16 outputs: relative L2 error of the tensor and of its worst 64-row
#: tile of one (batch, head), as chip_smoke.py holds them at full size
BF16_REL_L2, BF16_TILE_REL_L2 = 1e-2, 2e-2


def _close_attn(got, want, dtype):
    """fp32 (CUDA cores): the same fp32 products summed in another order
    (1e-4 of the output scale); bf16 (tensor cores): one bf16 rounding of
    the output, and of p or ds where they feed a product (2**-7 of the
    scale), and within the relative L2 bounds over the tensor and over
    every 64-row tile (causal rows shrink with their position, so the
    largest element alone says little of the late rows)."""
    torch.cuda.synchronize()
    rel = 1e-4 if dtype == torch.float32 else 2 ** -7
    got, want = got.detach().float(), want.detach().float()
    tol = rel * float(want.abs().max()) + 1e-6
    err = float((got - want).abs().max())
    assert err <= tol, (err, tol)
    if dtype != torch.bfloat16:
        return
    diff = got - want
    assert float(diff.norm() / want.norm()) <= BF16_REL_L2
    rows = got.reshape(-1, got.shape[-2], got.shape[-1])
    pad = -rows.shape[1] % 64
    tiles = [torch.nn.functional.pad(t.reshape(rows.shape), (0, 0, 0, pad))
             .reshape(rows.shape[0], -1, 64 * rows.shape[2])
             for t in (diff, want)]
    worst = float((tiles[0].norm(dim=-1)
                   / tiles[1].norm(dim=-1).clamp_min(1e-30)).max())
    assert worst <= BF16_TILE_REL_L2, worst


@pytest.mark.parametrize("BH,S,KV,hd,causal,dtype", [
    (3, 1, 1, 128, True, torch.float32),        # S below one tile
    (2, 100, 100, 128, True, torch.float32),    # ragged S
    (2, 129, 129, 128, False, torch.bfloat16),  # one row past a tile
    (2, 200, 77, 128, False, torch.float32),    # S != kv_len, full
    (4, 256, 256, 128, True, torch.bfloat16),   # several tiles, causal
])
def test_flash_kernels_match_plain(dev, BH, S, KV, hd, causal, dtype):
    """B5, B6 and B7 against their plain versions at ragged shapes, fp32
    and bf16: o, lse, dq, dk, dv."""
    q, k, v, do = _attn_inputs(dev, BH, S, KV, hd, dtype, S * 7 + KV)
    o, lse = fa.flash_fwd(q, k, v, causal)
    ro, rlse = fa.flash_fwd_ref(q, k, v, causal)
    _close_attn(o, ro, dtype)
    _close_attn(lse, rlse, torch.float32)
    delta = (do.float() * ro.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, rlse, delta, causal)
    _close_attn(dq, fa.flash_bwd_dq_ref(q, k, v, do, rlse, delta, causal),
                dtype)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, rlse, delta, causal)
    rdk, rdv = fa.flash_bwd_dkv_ref(q, k, v, do, rlse, delta, causal)
    _close_attn(dk, rdk, dtype)
    _close_attn(dv, rdv, dtype)


def test_flash_attention_grads_on_the_card(dev):
    """The autograd path (B5 forward, B6 + B7 backward) against autograd
    through the plain formulation, fp32, GQA-free (B, S, H, hd)."""
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((2, 130, 3, 128), generator=g, device=dev,
                           requires_grad=True) for _ in range(3))
    before = [fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches]
    out = fa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    ref = fa._xla_attention(q, k, v, True)
    rgrads = torch.autograd.grad((ref ** 2).sum(), (q, k, v))
    _close_attn(out, ref, torch.float32)
    for a, b in zip(grads, rgrads):
        _close_attn(a, b, torch.float32)
    assert [fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches] == [n + 1 for n in before]


def test_flash_wrappers_raise_on_bad_inputs(dev):
    q, k, v, do = _attn_inputs(dev, 2, 64, 64, 128, torch.float32, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                     v[..., :32].contiguous())
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_fwd(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="S == kv_len"):
        fa.flash_fwd(q[:, :10].contiguous(), k, v, causal=True)


# ---- B5-B7 on the warp-specialised wgmma path (bf16, hd 128)

#: around every tile edge of both kernels (64 and 128 rows), and the
#: training CLI's ragged row width
WG_SEQ = [1, 63, 64, 65, 127, 128, 129, 1025]


def _close_single_key(dx, rdx, other, v, do):
    """With one key (kv_len 1, or causal S 1) p = 1 and o = v, so ds = p
    (dp - delta) = do.v - do.o is zero in exact arithmetic: dk (and dq)
    on either side is nothing but the fp32 rounding of two hd-term dot
    products summed in different orders, and no relative bound of a zero
    tensor means anything. Both are held to the standard error bound of
    those sums, 2 hd 2**-24 sum|do v|, times sm max|q| (for dk; max|k|
    for dq)."""
    torch.cuda.synchronize()
    hd = other.shape[-1]
    dot = (do.float().abs() * v.float().abs()[:, :1]).sum(-1).max()
    bound = float(hd ** -0.5 * other.float().abs().max() * 2 * hd
                  * 2 ** -24 * dot)
    assert float(dx.float().abs().max()) <= bound
    assert float(rdx.float().abs().max()) <= bound


def _wg_kernels(q, k, v, do, causal):
    """B5, B6 and B7 on the card and their plain versions: (got, want)
    pairs of o, lse, dq, dk, dv (B6 and B7 fed the plain forward's lse
    and delta)."""
    o, lse = fa.flash_fwd(q, k, v, causal)
    ro, rlse = fa.flash_fwd_ref(q, k, v, causal)
    delta = (do.float() * ro.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, rlse, delta, causal)
    rdq = fa.flash_bwd_dq_ref(q, k, v, do, rlse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, rlse, delta, causal)
    rdk, rdv = fa.flash_bwd_dkv_ref(q, k, v, do, rlse, delta, causal)
    return (o, ro), (lse, rlse), (dq, rdq), (dk, rdk), (dv, rdv)


def _close_wg(q, k, v, do, single_key, pairs):
    (o, ro), (lse, rlse), (dq, rdq), (dk, rdk), (dv, rdv) = pairs
    _close_attn(o, ro, torch.bfloat16)
    _close_attn(lse, rlse, torch.float32)
    if single_key:
        _close_single_key(dq, rdq, k, v, do)
        _close_single_key(dk, rdk, q, v, do)
    else:
        _close_attn(dq, rdq, torch.bfloat16)
        _close_attn(dk, rdk, torch.bfloat16)
    _close_attn(dv, rdv, torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", WG_SEQ)
def test_wgmma_flash_kernels_at_tile_edges(dev, S, causal):
    """B5 (o, lse), B6 (dq) and B7 (dk, dv) against their plain
    versions, bf16, B*H = 3, at every row count around the kernels' tile
    edges."""
    q, k, v, do = _attn_inputs(dev, 3, S, S, 128, torch.bfloat16, S + 11)
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [f.launches for f in counters]
    pairs = _wg_kernels(q, k, v, do, causal)
    assert [f.launches for f in counters] == [n + 1 for n in before]
    _close_wg(q, k, v, do, S == 1, pairs)


@pytest.mark.parametrize("S,KV", [(200, 77), (64, 300), (1, 129), (129, 1),
                                  (1025, 130)])
def test_wgmma_flash_kernels_s_differs_from_kv(dev, S, KV):
    """Non-causal B5-B7 with S != kv_len: ragged key tiles in B5 and B6,
    ragged query tiles and key blocks in B7."""
    q, k, v, do = _attn_inputs(dev, 2, S, KV, 128, torch.bfloat16, S * KV)
    _close_wg(q, k, v, do, KV == 1, _wg_kernels(q, k, v, do, False))


@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_flash_kernels_rerun_bit_equal(dev, causal):
    """No atomics and a fixed order of sums: two runs are bit-equal."""
    q, k, v, do = _attn_inputs(dev, 4, 1025, 1025, 128, torch.bfloat16, 5)
    o1, lse1 = fa.flash_fwd(q, k, v, causal)
    o2, lse2 = fa.flash_fwd(q, k, v, causal)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)
    delta = (do.float() * o1.float()).sum(-1)
    dq1 = fa.flash_bwd_dq(q, k, v, do, lse1, delta, causal)
    dq2 = fa.flash_bwd_dq(q, k, v, do, lse1, delta, causal)
    assert torch.equal(dq1, dq2)
    dk1, dv1 = fa.flash_bwd_dkv(q, k, v, do, lse1, delta, causal)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse1, delta, causal)
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)


def test_wgmma_flash_wrappers_raise_on_bad_bf16_inputs(dev):
    """The bf16 kernels read through tensor maps: an input that is not
    contiguous or not 16-byte aligned raises, with no launch counted."""
    q, k, v, do = _attn_inputs(dev, 2, 64, 64, 128, torch.bfloat16, 2)
    lse = torch.zeros((2, 64), device=dev)
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [f.launches for f in counters]
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(q.shape)                    # 2 bytes off
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_fwd(shifted, k, v)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_bwd_dq(q, k, v, shifted, lse, lse)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_bwd_dkv(q, k, v, shifted, lse, lse)
    strided = k.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q, strided, v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_bwd_dq(q, strided, v, do, lse, lse)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_bwd_dkv(q, strided, v, do, lse, lse)
    assert [f.launches for f in counters] == before


def test_flash_tile_schedule_mirrors_the_kernels(dev):
    """``fwd_wg_tiles`` / ``dq_wg_tiles`` / ``dkv_wg_tiles`` in Python
    and the schedule functions the CUDA kernels run agree on every block
    and warpgroup, and so do the tile constants."""
    import ctypes

    from instaslice_tpu_torch.ops import build
    lib = build.library("flash_attention", fa._SIGNATURES)
    consts = (ctypes.c_int * 12)()
    assert lib.isl_flash_tile_consts(consts) == 0
    assert list(consts) == [fa.FWD_BLOCK_Q, fa.FWD_WG_Q, fa.FWD_TILE_K,
                            fa.FWD_STAGES, fa.DQ_BLOCK_Q, fa.DQ_WG_Q,
                            fa.DQ_TILE_K, fa.DQ_STAGES, fa.DKV_BLOCK_K,
                            fa.DKV_WG_K, fa.DKV_TILE_Q, fa.DKV_STAGES]
    out = [ctypes.c_int() for _ in range(3)]
    refs = [ctypes.byref(x) for x in out]
    shapes = [(S, S, c) for S in [*range(1, 301), 1024, 1025]
              for c in (True, False)]
    shapes += [(S, KV, False) for S in (1, 65, 200) for KV in (1, 77, 300)]
    for S, KV, causal in shapes:
        for y in range(-(-S // fa.FWD_BLOCK_Q)):
            for w in range(2):
                assert lib.isl_flash_tiles(0, S, KV, int(causal), y, w,
                                           *refs) == 0
                assert tuple(x.value for x in out) == fa.fwd_wg_tiles(
                    S, KV, causal, y, w), (S, KV, causal, y, w)
        for y in range(-(-S // fa.DQ_BLOCK_Q)):
            for w in range(2):
                assert lib.isl_flash_tiles(1, S, KV, int(causal), y, w,
                                           *refs) == 0
                assert tuple(x.value for x in out) == fa.dq_wg_tiles(
                    S, KV, causal, y, w), (S, KV, causal, y, w)
        for kj in range(-(-KV // fa.DKV_BLOCK_K)):
            for w in range(2):
                assert lib.isl_flash_tiles(2, S, KV, int(causal), kj, w,
                                           *refs) == 0
                assert (out[1].value, out[2].value) == fa.dkv_wg_tiles(
                    S, KV, causal, kj, w), (S, KV, causal, kj, w)


# ---- routing: shapes no kernel is built for take the plain formulation

def _routing_model(dev, **kw):
    from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM
    cfg = ModelConfig(vocab_size=256, n_layers=2, d_ff=256,
                      dtype=torch.float32, remat=False, **kw)
    return cfg, TpuLM(cfg).init(0, device="cpu")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_apply_with_grad_at_an_unbuilt_head_dim(dev, monkeypatch, caplog):
    """``TpuLM.apply`` ("auto" attention) and its grad at hd 64, which
    B5-B7 are not built for: the plain formulation on the card, no
    launch, the CPU's loss and grads, and one log line for the shape."""
    from instaslice_tpu_torch import ops
    from instaslice_tpu_torch.models import lm
    from instaslice_tpu_torch.models.lm import TpuLM
    monkeypatch.setattr(lm, "_plain_logged", set())
    caplog.set_level("WARNING", logger="instaslice_tpu_torch.models.lm")
    cfg, params = _routing_model(dev, d_model=256, n_heads=4)
    assert cfg.head_dim == 64 and not fa.kernel_built(64)
    toks = torch.randint(0, 256, (2, 48), generator=torch.Generator()
                         .manual_seed(1))
    out = {}
    ops.reset_launch_counts()
    for d in ("cpu", dev):
        p = {k: v.clone().requires_grad_(True)
             for k, v in _flat(_to(params, d)).items()}
        logits = TpuLM(cfg).apply(_unflat(p), toks.to(d))
        loss = torch.logsumexp(logits, -1).mean()
        loss.backward()
        out[str(d)] = (loss.detach().cpu(),
                       {k: v.grad.cpu() for k, v in p.items()})
    torch.cuda.synchronize()
    assert sum(ops.launch_counts().values()) == 0
    routes = [r.getMessage() for r in caplog.records
              if "no kernel is built" in r.getMessage()]
    assert len(routes) == 1 and "('hd', 64)" in routes[0]
    (l_cpu, g_cpu), (l_dev, g_dev) = out["cpu"], out[str(dev)]
    assert abs(float(l_dev - l_cpu)) <= 1e-5 * abs(float(l_cpu))
    for k in g_cpu:
        assert float((g_dev[k] - g_cpu[k]).norm()
                     / g_cpu[k].norm().clamp_min(1e-30)) <= 1e-4, k


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.mark.parametrize("n_heads,n_kv_heads,d_model", [
    (16, 1, 1024),    # hd 64, G 16: no B1 group
    (4, 2, 64),       # hd 16, G 2: no B1 head dim
])
def test_int8_decode_step_at_unbuilt_shapes(dev, n_heads, n_kv_heads,
                                            d_model, monkeypatch, caplog):
    """One int8-KV decode step (after a prefill) where B1 is not built
    for (hd, G): the grouped plain read of the cache on the card, no
    launch, the CPU's logits and greedy tokens, and one log line."""
    from instaslice_tpu_torch import ops
    from instaslice_tpu_torch.models import lm
    from instaslice_tpu_torch.models.lm import TpuLM
    from instaslice_tpu_torch.ops import flash_decode as fdec
    monkeypatch.setattr(lm, "_plain_logged", set())
    caplog.set_level("WARNING", logger="instaslice_tpu_torch.models.lm")
    cfg, params = _routing_model(dev, d_model=d_model, n_heads=n_heads,
                                 n_kv_heads=n_kv_heads)
    assert not fdec.kernel_built(cfg.head_dim, n_heads // n_kv_heads)
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, 256, (3, 20), generator=gen)
    lens = torch.tensor([0, 5, 11], dtype=torch.int32)
    logits = {}
    ops.reset_launch_counts()
    for d in ("cpu", dev):
        model = TpuLM(cfg)
        p = _to(params, d)
        cache = model.init_cache(3, 64, quant=True, device=d)
        lg, cache = model.apply_with_cache(p, prompt.to(d), cache,
                                           lens.to(d))
        nxt = lg[:, -1].argmax(-1)
        lg1, _ = model.apply_with_cache(p, nxt[:, None], cache,
                                        (lens + 20).to(d))
        logits[str(d)] = (nxt.cpu(), lg1[:, 0].cpu())
    torch.cuda.synchronize()
    assert sum(ops.launch_counts().values()) == 0
    routes = [r.getMessage() for r in caplog.records
              if "no kernel is built" in r.getMessage()]
    assert len(routes) == 1 and f"('G', {n_heads // n_kv_heads})" in routes[0]
    (t_cpu, l_cpu), (t_dev, l_dev) = logits["cpu"], logits[str(dev)]
    assert torch.equal(t_cpu, t_dev)
    assert float((l_dev - l_cpu).abs().max()) <= 1e-4 * float(
        l_cpu.abs().max())
    assert torch.equal(l_dev.argmax(-1), l_cpu.argmax(-1))


# ------------------------------------------ speculative decoding, migration

@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 8192), (8192, 2048)])
@pytest.mark.parametrize("M", [8, 40, 128, 256])
def test_w8a16_at_the_871m_draft_shapes(dev, M, K, N):
    """B2 at the 871M int8 projections, M = 8 (a draft step), 40 (the
    server's verify, 8 x (k + 1)), 128 and 256 (prefill chunks of one and
    two slots), and B3 at its unembedding (32000 x 2048): within the
    phase-2 tolerances of the plain versions, reruns bit-equal."""
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    q3 = torch.randint(-127, 128, (2, K, N), generator=g, device=dev,
                       dtype=torch.int8)
    s3 = torch.rand((2, 1, N), generator=g, device=dev).to(torch.bfloat16)
    for li in (0, 1):
        got = qm.quant_matmul_stacked(x, q3, s3, li)
        want = qm.quant_matmul_stacked_ref(x, q3, s3, li)
        _close(got, want)
        _close_tiles(got, want, qm.tc_tile(M, False).ct)
        assert torch.equal(got, qm.quant_matmul_stacked(x, q3, s3, li))
    if (K, N) != (2048, 2048):
        return
    q = torch.randint(-127, 128, (32000, K), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand((32000, 1), generator=g, device=dev)
    got = qm.quant_matmul_t(x, q, s)
    want = qm.quant_matmul_t_ref(x, q, s)
    _close(got, want)
    _close_tiles(got, want, qm.tc_tile(M, True).ct)
    assert torch.equal(got, qm.quant_matmul_t(x, q, s))


def _spec_engine(dev, **kw):
    """An int8 W+KV target at hd 128 and G 2 (B1 built) with a bf16 draft
    of the same weights, as the spec server builds it."""
    from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM
    from instaslice_tpu_torch.models.quant import quantize_params
    from instaslice_tpu_torch.serving import ServingEngine
    cfg = ModelConfig(vocab_size=1024, d_model=512, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=1024, dtype=torch.bfloat16,
                      remat=False)
    model = TpuLM(cfg)
    params = model.init(0, device=dev)
    return ServingEngine(model, quantize_params(params), kv_quant=True,
                         draft_model=model, draft_params=params, spec_k=4,
                         max_batch=4, max_len=256, prefill_len=32,
                         device=dev, **kw)


def test_spec_round_on_the_card_matches_plain_versions(dev, monkeypatch):
    """Admission and spec rounds (k = 4, then the k = 0 round, whose
    single-token verify runs B1) through the kernels, and the same with
    the plain versions in the kernels' place on the same card: equal
    tokens and accepted counts, logprobs within 5e-2 (bf16)."""
    from instaslice_tpu_torch import ops
    from instaslice_tpu_torch.models import lm, quant

    prompts = [[(7 * i + j) % 1000 + 1 for j in range(n)]
               for i, n in enumerate((40, 17, 64, 5))]

    def run():
        eng = _spec_engine(dev)
        for p in prompts:
            eng.add_request(p)
        eng.spec_step(k=4)
        eng.spec_step(k=0)
        return ([(r.generated, r.logprobs) for _, r in
                 sorted(eng.slots.items())], eng.spec_accepted)

    ops.reset_launch_counts()
    kern = run()
    counts = ops.launch_counts()
    assert counts["quant_matmul_stacked"] > 0 and counts["quant_matmul_t"] > 0
    assert counts["quant_decode_attention"] == 2    # the k = 0 round, L 2
    for mod, name in ((quant, "quant_matmul_stacked"),
                      (quant, "quant_matmul_t"),
                      (lm, "quant_decode_attention")):
        monkeypatch.setattr(mod, name, getattr(
            {"quant_matmul_stacked": qm, "quant_matmul_t": qm,
             "quant_decode_attention": fd}[name], f"{name}_ref"))
    ops.reset_launch_counts()
    plain = run()
    assert sum(ops.launch_counts().values()) == 0
    assert kern[1] == plain[1]
    for (gk, lk), (gp, lp) in zip(kern[0], plain[0]):
        assert gk == gp
        assert max(abs(a - b) for a, b in zip(lk, lp)) <= 5e-2


def test_session_export_import_on_the_card(dev):
    """A parked session (int8 target stripe, bf16 draft stripe) through the
    JSON wire into a second card engine: the resumed rows of both caches,
    the draft's included, equal the unmigrated engine's bit for bit, and
    it resumes with that engine's tokens, logprobs and accepted counts
    (the greedy chain alone would not see a lost draft stripe)."""
    import json

    prompt = [(5 * j) % 1000 + 1 for j in range(50)]
    src, dst = _spec_engine(dev), _spec_engine(dev)
    rid = src.add_request(prompt)
    src.decode_block(6)
    src.preempt_slot(0)
    blob = json.loads(json.dumps(src.export_session(rid)))
    assert blob["stripe"]["k"]["dtype"] == "int8"
    assert blob["draft_stripe"]["k"]["dtype"] == "bfloat16"
    assert blob["torch_rng"]["device"] == "cuda"
    rid2 = dst.import_session(blob)
    n = blob["length"]
    assert (src.resume_request(rid), dst.resume_request(rid2)) == (0, 0)
    for name in ("cache", "draft_cache"):
        for key, c in getattr(src, name).items():
            assert torch.equal(c[:, 0, :, :n],
                               getattr(dst, name)[key][:, 0, :, :n]), \
                (name, key)
    out = []
    for eng in (src, dst):
        a0 = eng.spec_accepted
        eng.decode_block(5)
        eng.spec_step(k=4)
        req = eng.slots[0]
        out.append((req.generated, req.logprobs, eng.spec_accepted - a0))
    assert out[0] == out[1]


# ------------------------------------------------------------- multi-LoRA

def _lora_setup(dev):
    """The spec engine's int8 model (hd 128, G 2: B1 built) and two
    rank-8 adapters on all six targets with ``b`` nonzero."""
    from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM
    from instaslice_tpu_torch.models.lora import LoraConfig, init_lora
    from instaslice_tpu_torch.models.quant import quantize_params
    cfg = ModelConfig(vocab_size=1024, d_model=512, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=1024, dtype=torch.bfloat16,
                      remat=False)
    lcfg = LoraConfig(rank=8, targets=("wq", "wk", "wv", "wo", "w_in",
                                       "w_out"))
    ads = []
    for i in (1, 2):
        ad = init_lora(i, cfg, lcfg, device=dev)
        g = torch.Generator(device=dev).manual_seed(50 + i)
        for ab in ad["blocks"].values():
            ab["b"] = torch.randn(ab["b"].shape, generator=g,
                                  device=dev) * 0.05
        ads.append(ad)
    model = TpuLM(cfg)
    return model, quantize_params(model.init(0, device=dev)), ads


def test_lora_single_adapter_path_against_the_gathered_path(dev):
    """Every row on one adapter (the base included): the single-adapter
    path's prefill and decode logits and cache against the gathered
    path's on the card, both through B1-B3 (launch counts equal)."""
    from instaslice_tpu_torch import ops
    from instaslice_tpu_torch.models.lora import stack_adapters
    model, params, ads = _lora_setup(dev)
    stack = stack_adapters(ads, model.cfg)
    toks = torch.randint(1, 1024, (3, 32), generator=torch.Generator()
                         .manual_seed(3)).to(dev)
    for aid in (0, 1, 2):
        outs = []
        for single in (False, True):
            cache = model.init_cache(3, 128, quant=True, device=dev)
            lens = torch.zeros(3, dtype=torch.int32, device=dev)
            aidx = torch.full((1 if single else 3,), aid, device=dev)
            ops.reset_launch_counts()
            lg, cache = model.apply_with_cache(
                params, toks, cache, lens, lora=stack, adapter_idx=aidx,
                single_adapter=single)
            lg1, cache = model.apply_with_cache(
                params, lg[:, -1].argmax(-1)[:, None], cache, lens + 32,
                lora=stack, adapter_idx=aidx, single_adapter=single)
            torch.cuda.synchronize()
            outs.append((lg, lg1, cache, ops.launch_counts()))
        (g0, g1, gc, gn), (s0, s1, sc, sn) = outs
        assert gn == sn and gn["quant_decode_attention"] == 2
        assert gn["quant_matmul_stacked"] == 6 * 2 * 2
        for a, b in ((g0, s0), (g1, s1)):
            assert float((a - b).abs().max()) <= 1e-3 * float(
                b.abs().max()), aid
        for k in gc:
            assert float((gc[k].float() - sc[k].float()).abs().max()) <= (
                1.0 if k in ("k", "v") else 1e-3 * float(
                    sc[k].float().abs().max())), (aid, k)


def test_lora_decode_step_launch_counts_on_the_card(dev, monkeypatch):
    """A mixed-adapter decode block (rows on adapters 0, 1, 2: the
    gathered path) launches B1-B3 as an engine without adapters does
    (counted on the card's trace: the block replays graphs captured at
    warm-up), and its tokens and logprobs equal the plain versions' run
    on the same card within bf16 (logprobs 5e-2)."""
    from instaslice_tpu_torch.models import lm, quant
    from instaslice_tpu_torch.serving import ServingEngine
    model, params, ads = _lora_setup(dev)
    prompts = [[(7 * i + j) % 1000 + 1 for j in range(n)]
               for i, n in enumerate((40, 17, 64))]

    def run(adapters):
        eng = ServingEngine(model, params, kv_quant=True, max_batch=4,
                            max_len=256, prefill_len=32, device=dev,
                            lora_adapters=ads if adapters else None)
        eng.warm_prefill_buckets()
        for i, p in enumerate(prompts):
            eng.add_request(p, adapter=i if adapters else 0)
        _, counts = _traced(lambda: eng.decode_block(4))
        return (counts, eng.gathered_rounds,
                [(r.generated, r.logprobs)
                 for _, r in sorted(eng.slots.items())])

    counts, gathered, kern = run(True)
    assert gathered == 1
    assert counts["quant_decode_attention"] == 2 * 4
    assert counts["quant_matmul_stacked"] == 6 * 2 * 4
    assert counts["quant_matmul_t"] == 4
    assert counts == run(False)[0]
    monkeypatch.setattr(quant, "quant_matmul_stacked",
                        qm.quant_matmul_stacked_ref)
    monkeypatch.setattr(quant, "quant_matmul_t", qm.quant_matmul_t_ref)
    monkeypatch.setattr(lm, "quant_decode_attention",
                        fd.quant_decode_attention_ref)
    counts, _, plain = run(True)
    assert sum(counts.values()) == 0
    for (gk, lk), (gp, lp) in zip(kern, plain):
        assert gk == gp
        assert max(abs(a - b) for a, b in zip(lk, lp)) <= 5e-2


# ----------------------------------------------- sliding window and int4

def _windowed_decode(dev, window, prompt_len, attend):
    """A windowed fp32 model (hd 128, G 2: B1 is built for it) with an
    int8 KV cache: a prefill of 3 rows at staggered offsets, then one
    decode step at ``attend``, on the CPU and on the card; the card's
    launch counts over the decode step."""
    from instaslice_tpu_torch import ops
    from instaslice_tpu_torch.models.lm import TpuLM
    cfg, params = _routing_model(dev, d_model=512, n_heads=4, n_kv_heads=2,
                                 window=window)
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, 256, (3, prompt_len), generator=gen)
    lens = torch.tensor([0, 5, 11], dtype=torch.int32)
    out = {}
    for d in ("cpu", dev):
        model = TpuLM(cfg)
        p = _to(params, d)
        cache = model.init_cache(3, 64, quant=True, device=d)
        lg, cache = model.apply_with_cache(p, prompt.to(d), cache,
                                           lens.to(d))
        nxt = lg[:, -1].argmax(-1)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        lg1, _ = model.apply_with_cache(p, nxt[:, None], cache,
                                        (lens + prompt_len).to(d),
                                        attend_len=attend)
        torch.cuda.synchronize()
        out[str(d)] = (lg1[:, 0].cpu(), ops.launch_counts())
    (l_cpu, _), (l_dev, counts) = out["cpu"], out[str(dev)]
    assert float((l_dev - l_cpu).abs().max()) <= 1e-4 * float(
        l_cpu.abs().max())
    assert torch.equal(l_dev.argmax(-1), l_cpu.argmax(-1))
    return cfg, counts


def test_windowed_decode_past_the_band_on_the_card(dev, monkeypatch, caplog):
    """Window 16 over a 64-position cache, rows at depths 20-31: each row
    reads its band of 15 positions, no B1 launch, no plain-route log line,
    and the CPU's logits."""
    from instaslice_tpu_torch.models import lm
    monkeypatch.setattr(lm, "_plain_logged", set())
    caplog.set_level("WARNING", logger="instaslice_tpu_torch.models.lm")
    cfg, counts = _windowed_decode(dev, 16, 20, 0)
    assert lm.window_band(cfg, 64, 64) == 15
    assert counts["quant_decode_attention"] == 0
    assert not [r for r in caplog.records
                if "no kernel is built" in r.getMessage()]


def test_windowed_decode_inside_the_band_takes_b1(dev):
    """Window 48, the decode step attending a 32-position bucket (no wider
    than window - 1): no band, B1 once per layer, the CPU's logits."""
    from instaslice_tpu_torch.models import lm
    cfg, counts = _windowed_decode(dev, 48, 16, 32)
    assert lm.window_band(cfg, 64, 32) == 0
    assert counts["quant_decode_attention"] == cfg.n_layers


def test_int4_dequantize_on_the_card_is_bit_equal(dev):
    """Int4 unpacking, dequantization (fp32 and bf16), one layer of a
    stacked leaf and an embedding gather on the card equal the CPU's bit
    for bit (integer nibble arithmetic, one fp32 product per element)."""
    from instaslice_tpu_torch.models.quant import embed_lookup, quantize_params
    gen = torch.Generator().manual_seed(4)
    tree = {"embed": torch.randn(300, 256, generator=gen),
            "blocks": {"w_in": torch.randn(3, 256, 640, generator=gen)
                       .to(torch.bfloat16)}}
    cpu = quantize_params(tree, bits=4)
    card = quantize_params(_to(tree, dev), bits=4)
    toks = torch.randint(0, 300, (2, 7), generator=gen)
    for name, leaf in (("embed", cpu["embed"]),
                       ("w_in", cpu["blocks"]["w_in"])):
        on = leaf.to(dev)
        other = card["embed"] if name == "embed" else card["blocks"]["w_in"]
        assert torch.equal(other.p.cpu(), leaf.p)
        assert torch.equal(other.s.cpu(), leaf.s)
        assert torch.equal(on._unpack().cpu(), leaf._unpack())
        for dt in (None, torch.bfloat16):
            assert torch.equal(on.dequantize(dt).cpu(), leaf.dequantize(dt))
    assert torch.equal(cpu["blocks"]["w_in"].to(dev).layer(2)
                       .dequantize(torch.bfloat16).cpu(),
                       cpu["blocks"]["w_in"].layer(2)
                       .dequantize(torch.bfloat16))
    assert torch.equal(embed_lookup(cpu["embed"].to(dev), toks.to(dev)).cpu(),
                       embed_lookup(cpu["embed"], toks))


# ------------------------------------------------------------ decode graphs

def _traced(fn, kn="quant_matmul_stacked"):
    """``fn()``'s result and the kernel launches the card's trace shows
    for it, by wrapper (``ops.trace_launch_counts``)."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from instaslice_tpu_torch import ops
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        # a last marker kernel, and time for CUPTI to hand over the
        # window's last records before the trace stops
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.25)
    names = Counter(e.name() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA)
    assert sum(n for k, n in names.items() if "spin_kernel" in k) == 1
    return out, ops.trace_launch_counts(names.items(), kn)


def test_graph_of_one_b1_and_one_b2_launch_replays_equal_to_eager(dev):
    """The kernels launch through their own CUDA runtime onto the stream
    they are handed: under capture that is the capture stream, and a
    graph holding one B1 and one B2 launch replays equal to the eager
    calls, on the inputs its addresses hold at replay. The wrappers count
    nothing under the capture (it records the launches), and the card's
    trace shows each replay's B1 and B2 kernel once."""
    g = torch.Generator(device=dev).manual_seed(5)
    L, B, Hkv, G, S, hd = 2, 4, 2, 2, 256, 128
    k3 = torch.randint(-127, 128, (L, B, Hkv, S, hd), generator=g,
                       device=dev, dtype=torch.int8)
    v3 = torch.randint(-127, 128, (L, B, Hkv, S, hd), generator=g,
                       device=dev, dtype=torch.int8)
    ks3 = torch.rand((L, B, Hkv, S), generator=g, device=dev) * 0.01
    vs3 = torch.rand((L, B, Hkv, S), generator=g, device=dev) * 0.01
    q4 = torch.randn((B, Hkv, G, hd), generator=g, device=dev)
    lens = torch.tensor([0, 17, 200, 256], dtype=torch.int32, device=dev)
    x = torch.randn((8, 512), generator=g, device=dev).to(torch.bfloat16)
    q3 = torch.randint(-127, 128, (L, 512, 384), generator=g, device=dev,
                       dtype=torch.int8)
    s3 = torch.rand((L, 1, 384), generator=g, device=dev).to(torch.bfloat16)

    def both():
        return (fd.quant_decode_attention(q4, k3, ks3, v3, vs3, lens, 1, S),
                qm.quant_matmul_stacked(x, q3, s3, 1))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = (fd.quant_decode_attention.launches,
          qm.quant_matmul_stacked.launches)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        (o, m, l), y = both()
    assert (fd.quant_decode_attention.launches,
            qm.quant_matmul_stacked.launches) == n0
    _, counts = _traced(lambda: (graph.replay(), graph.replay()))
    assert {k: n for k, n in counts.items() if n} == {
        "quant_decode_attention": 2, "quant_matmul_stacked": 2}
    for _ in range(2):
        q4.copy_(torch.randn(q4.shape, generator=g, device=dev))
        x.copy_(torch.randn(x.shape, generator=g, device=dev))
        graph.replay()
        (eo, em, el), ey = both()
        torch.cuda.synchronize()
        for a, b in ((o, eo), (m, em), (l, el), (y, ey)):
            assert torch.equal(a, b)


def test_sampler_and_one_hot_capture(dev):
    """The decode step's host-sync suspects capture as they are on this
    PyTorch: ``torch.multinomial`` (through ``sampling.sample`` with the
    engine's kind of generator, registered with the graph) and
    ``F.one_hot`` (the MoE dispatch, the gathered LoRA pick); two replays
    of the draw read the generator's advanced offset."""
    from instaslice_tpu_torch.serving import sampling
    gen = torch.Generator(device=dev).manual_seed(0)
    logits = torch.zeros((64, 1000), device=dev)
    idx = torch.randint(0, 8, (64,), device=dev)

    def body():
        return sampling.sample(logits, gen), torch.nn.functional.one_hot(
            idx, 8)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        toks, hot = body()
    graph.replay()
    first = toks.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(first, toks)
    assert torch.equal(hot, torch.nn.functional.one_hot(idx, 8))


def _graph_engine(dev, **kw):
    """The spec engine's int8 W+KV model (hd 128, G 2: B1-B3 built)
    without a draft, at a cache of three 256-position buckets. With the
    seeded weights the last token's own logit (its tied embedding's
    squared norm over the final norm) takes all the mass: logprob 0,
    every draw the argmax. The final norm's scale divided by d_model
    spreads the mass (top probability ~0.002), so logprobs and draws are
    comparisons that can fail."""
    from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM
    from instaslice_tpu_torch.models.quant import quantize_params
    from instaslice_tpu_torch.serving import ServingEngine
    cfg = ModelConfig(vocab_size=1024, d_model=512, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=1024, dtype=torch.bfloat16,
                      remat=False)
    model = TpuLM(cfg)
    params = model.init(0, device=dev)
    params["ln_f"]["scale"] = params["ln_f"]["scale"] / cfg.d_model
    return ServingEngine(model, quantize_params(params), kv_quant=True,
                         max_batch=4, max_len=768, prefill_len=32,
                         device=dev, **kw)


_GRAPH_PROMPTS = [[(7 * i + j) % 1000 + 1 for j in range(n)]
                  for i, n in enumerate((240, 17, 64, 5))]


def _run_blocks(eng, blocks, prompts=None, adapters=None):
    """The prompts admitted (request i on ``adapters[i]``), then decode
    blocks of the given lengths: per slot (tokens, logprobs), the
    launches on the card's trace and by the wrappers across the blocks,
    and the decode steps dispatched."""
    from instaslice_tpu_torch import ops
    prompts = prompts or _GRAPH_PROMPTS
    for i, p in enumerate(prompts):
        eng.add_request(p, adapter=adapters[i] if adapters else 0)
    ops.reset_launch_counts()
    steps0 = eng.decode_steps

    def run():
        for n in blocks:
            eng.decode_block(n)
    _, traced = _traced(run)
    return ([(r.generated, r.logprobs) for _, r in sorted(eng.slots.items())],
            traced, ops.launch_counts(), eng.decode_steps - steps0)


def test_decode_block_graphs_bit_equal_to_eager_and_counted(dev):
    """Greedy blocks whose 256-position bucket changes (the 240-token row
    crosses 256 in the second block, so its key is captured mid-stream)
    replay bit-equal to the eager route on the same card: tokens and
    logprobs. The card's trace holds every replayed step's kernels (B1
    layers x steps, B2 6 x layers x steps, B3 one a step) plus those of
    each lazy capture's warm-up step, which are the only launches the
    wrappers count; on the eager route trace and wrappers agree, and
    ``decode_steps`` counts the steps dispatched on both."""
    blocks, L = (8, 16, 4), 2

    def implied(steps):
        from instaslice_tpu_torch import ops
        return dict.fromkeys(ops.KERNEL_WRAPPERS, 0) | {
            "quant_decode_attention": L * steps,
            "quant_matmul_stacked": 6 * L * steps, "quant_matmul_t": steps}

    g_eng = _graph_engine(dev)
    g_out, g_traced, g_wrap, g_steps = _run_blocks(g_eng, blocks)
    e_out, e_traced, e_wrap, e_steps = _run_blocks(
        _graph_engine(dev, decode_graphs=False), blocks)
    assert g_out == e_out
    assert g_steps == e_steps == sum(blocks)
    assert e_traced == e_wrap == implied(sum(blocks))
    captures = len(g_eng._graphs)
    assert captures == 2
    assert g_wrap == implied(captures)
    assert g_traced == implied(sum(blocks) + captures)
    assert g_eng.graph_stats()["replays"]["decode_block"] == sum(blocks)


def _lora_engine(dev, **kw):
    """:func:`_graph_engine`'s model and weights serving two seeded rank-8
    adapters on (wq, wv) with B nonzero, so each adapter moves its rows."""
    from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM
    from instaslice_tpu_torch.models.lora import LoraConfig, init_lora
    from instaslice_tpu_torch.models.quant import quantize_params
    from instaslice_tpu_torch.serving import ServingEngine
    cfg = ModelConfig(vocab_size=1024, d_model=512, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=1024, dtype=torch.bfloat16,
                      remat=False)
    model = TpuLM(cfg)
    params = model.init(0, device=dev)
    params["ln_f"]["scale"] = params["ln_f"]["scale"] / cfg.d_model
    lcfg = LoraConfig(rank=8, alpha=16.0, targets=("wq", "wv"))
    adapters = []
    for i in range(2):
        ad = init_lora(100 + i, cfg, lcfg, device=dev)
        g = torch.Generator(device=dev).manual_seed(200 + i)
        for ab in ad["blocks"].values():
            ab["b"] = torch.randn(ab["b"].shape, generator=g,
                                  device=dev) * 0.05
        adapters.append(ad)
    return ServingEngine(model, quantize_params(params), kv_quant=True,
                         max_batch=4, max_len=768, prefill_len=32,
                         lora_adapters=adapters, lora_alphas=[16.0] * 2,
                         device=dev, **kw)


@pytest.mark.parametrize("adapters", [(2, 2, 2, 2), (0, 1, 2, 1)],
                         ids=["single", "gathered"])
def test_lora_graph_replays_bit_equal_to_eager(dev, adapters):
    """Every live row on one adapter takes the single-adapter step, mixed
    adapters the gathered one: each replays bit-equal to the eager route
    (tokens and logprobs), across a bucket change, and its key is the
    one its variant names."""
    g_eng = _lora_engine(dev)
    g_out, g_traced, _, _ = _run_blocks(g_eng, (8, 16), adapters=adapters)
    e_out, e_traced, _, _ = _run_blocks(
        _lora_engine(dev, decode_graphs=False), (8, 16), adapters=adapters)
    assert g_out == e_out
    assert g_traced["quant_decode_attention"] == e_traced[
        "quant_decode_attention"] + 2 * len(g_eng._graphs)
    variant = "single" if len(set(adapters)) == 1 else "gathered"
    assert {k[2] for k in g_eng._graphs} == {variant}


def test_graph_engine_keys_route_and_budget(dev):
    eng = _graph_engine(dev)
    _run_blocks(eng, (8, 16))
    assert eng.decode_route() == "cuda graphs"
    assert sorted(k[1] for k in eng._graphs) == [256, 512]
    st = eng.graph_stats()
    assert st["graphs"]["decode_block"] == 2 <= st["budget"]["decode_block"]
    assert st["capture_seconds"] > 0
    assert eng.compiled_programs()["decode_block"] == 2
    gib = eng.graph_pool_gib()
    assert gib is None or 0 < gib < 1
    assert _graph_engine(dev, decode_graphs=False).decode_route() == (
        "eager (decode_graphs=False)")


def test_sampled_replays_draw_afresh_and_match_eager(dev):
    """At temperature 0.8 two replays of one graph from the same decode
    state draw different tokens (the engine's generator is registered
    with the graph, so each replay reads its advanced offset), and a
    sampled block replays the eager route's draws from the same
    generator state."""
    eng = _graph_engine(dev, temperature=0.8, seed=3)
    for p in _GRAPH_PROMPTS[1:]:        # 16 steps in one bucket: one key
        eng.add_request(p)
    saved = eng._save_state()
    eng.decode_block(8)
    first = eng._blk_toks[:8].clone()
    for b, c in zip(eng._state_buffers(), saved[0]):
        b.copy_(c)
    eng.decode_block(8)
    assert len(eng._graphs) == 1
    assert not torch.equal(first, eng._blk_toks[:8])
    outs = []
    for graphs in (True, False):
        e = _graph_engine(dev, temperature=0.8, seed=3,
                          decode_graphs=graphs)
        outs.append(_run_blocks(e, (8, 8))[0])
    assert outs[0] == outs[1]


def test_blocks_after_recover_and_a_lazy_capture_equal_eager(dev):
    """A graph engine and an eager one, block for block: a key captured
    lazily with live slots leaves the stream as eager has it, and after
    ``recover()`` (caches and state zeroed in place, the graphs kept) a
    new admission's blocks equal eager's too."""
    engs = [_graph_engine(dev), _graph_engine(dev, decode_graphs=False)]
    outs = [_run_blocks(e, (8, 16))[0] for e in engs]
    assert outs[0] == outs[1]
    for e in engs:
        e.mark_cache_poisoned()
        e.recover()
    assert len(engs[0]._graphs) == 2
    outs = [_run_blocks(e, (4, 8))[0] for e in engs]
    assert outs[0] == outs[1]


def test_failed_capture_raises_and_poisons_with_no_fallback(dev):
    """A step that cannot be captured raises out of ``decode_block``: the
    cache is poisoned, no graph is stored, no token was produced eagerly,
    no decode step is counted and the wrappers count the warm-up's
    launches only (one step: B1 twice, B2 12 times, B3 once);
    ``recover()`` serves again."""
    from instaslice_tpu_torch import ops
    eng = _graph_engine(dev)
    ref = _graph_engine(dev, decode_graphs=False)
    for e in (eng, ref):
        for p in _GRAPH_PROMPTS:
            e.add_request(p)
    real = eng._decode_step

    def step(*a):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("refused inside a capture")
        real(*a)

    eng._decode_step = step
    before = [list(r.generated) for r in eng.slots.values()]
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="refused inside a capture"):
        eng.decode_block(4)
    assert eng.cache_poisoned() and eng._graphs == {}
    assert eng._pending_block is None and eng.decode_steps == 0
    assert {k: n for k, n in ops.launch_counts().items() if n} == {
        "quant_decode_attention": 2, "quant_matmul_stacked": 12,
        "quant_matmul_t": 1}
    assert [r.generated for r in eng.slots.values()] == before
    del eng._decode_step
    eng.recover()
    for e in (eng, ref):
        e.recover()
    outs = [_run_blocks(e, (4,))[0] for e in (eng, ref)]
    assert outs[0] == outs[1]


def test_world_size_one_nccl_step_is_bit_equal_to_the_meshless_step(
        dev, tmp_path, monkeypatch):
    """The parallel train step on a mesh of one rank over NCCL (a tiny
    config at hd 128, so B5-B7 run) against the meshless step on the same
    weights: 3 steps, losses and params bit-equal."""
    import torch.distributed as dist

    from instaslice_tpu_torch import ops
    from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM
    from instaslice_tpu_torch.models.train import leaves, make_train_step
    from instaslice_tpu_torch.parallel import (
        initialize_distributed,
        slice_mesh,
    )

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    cfg = ModelConfig(vocab_size=256, d_model=256, n_heads=2, n_layers=2,
                      d_ff=512, dtype=torch.bfloat16,
                      param_dtype=torch.float32, remat=False)
    toks = torch.randint(0, 256, (2, 64), device=dev,
                         generator=torch.Generator(dev).manual_seed(3))
    assert initialize_distributed(
        backend="nccl", init_method=f"file://{tmp_path / 'store'}",
        device=dev)
    try:
        mesh = slice_mesh(device="cuda")
        runs = []
        for m in (None, mesh):
            init_fn, step_fn = make_train_step(TpuLM(cfg), mesh=m,
                                               grad_clip=1.0, device=dev)
            state = init_fn(0)
            ops.reset_launch_counts()
            losses = []
            for _ in range(3):
                state, loss = step_fn(state, toks)
                losses.append(float(loss))
            assert ops.launch_counts()["flash_fwd"] == 2 * 3
            runs.append((losses, [p.detach() for p in leaves(state.params)]))
    finally:
        dist.destroy_process_group()
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_nvml_backend_agrees_with_torch(dev, tmp_path):
    """The NVML backend's count, names and UUIDs are torch.cuda's (NVML
    sees every GPU of the host, so the card's torch must see them all:
    no CUDA_VISIBLE_DEVICES), and each GPU's device node (by its minor
    number) exists."""
    import os

    from instaslice_tpu_torch.device import NvmlBackend, select_backend

    if os.environ.get("CUDA_VISIBLE_DEVICES"):
        pytest.skip("CUDA_VISIBLE_DEVICES hides GPUs from torch")
    b = select_backend("auto", registry_dir=str(tmp_path))
    assert isinstance(b, NvmlBackend)
    inv = b.discover()
    assert inv.chip_count == torch.cuda.device_count()
    assert all(os.path.exists(p) for p in inv.chip_paths.values())
    for g in inv.gpus:
        props = torch.cuda.get_device_properties(g.index)
        assert g.name == props.name
        assert g.uuid == f"GPU-{props.uuid}"
        assert g.memory_bytes == props.total_memory or \
            abs(g.memory_bytes - props.total_memory) < 2 ** 30
