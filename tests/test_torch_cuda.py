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
