"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a card (decided in a fixture, never at
import) and run on an H100 with ``python -m pytest -m cuda
tests/test_torch_cuda.py``. Shapes are small and deliberately ragged:
they reach the masked edges and layouts ``chip_smoke.py``'s 7B shapes
never do. Tolerances: fp32 sums of exact products in another order.
"""

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
