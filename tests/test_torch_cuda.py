"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip without a card (decided in a fixture, never at
import) and run on an H100 with ``python -m pytest -m cuda
tests/test_torch_cuda.py``. Shapes are small and deliberately ragged:
they reach the masked edges and layouts ``chip_smoke.py``'s 7B shapes
never do. Tolerances: fp32 sums of exact products in another order.
"""

import pytest
import torch

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
