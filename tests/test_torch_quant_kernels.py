"""Host side of the port's w8a16 kernels, on the CPU: the launch planner
of ``instaslice_tpu_torch/ops/quant_matmul.py`` as a pure function (tiles
and K splits of the tensor-core kernel), the routing by dtype and shape,
and the rule that CPU tensors take the plain versions and count no
launch. The kernels themselves run only on a card
(``tests/test_torch_cuda.py``); their arithmetic is held against the JAX
package in ``tests/test_torch_ops.py``.
"""

import math

import numpy as np
import pytest
import torch

from instaslice_tpu_torch.models import quant
from instaslice_tpu_torch.ops import quant_matmul as qm

#: (name, K, N, transposed) of the 7B int8 configuration
SHAPES_7B = [("wq", 4096, 4096, False), ("wk", 4096, 1024, False),
             ("w_in", 4096, 20480, False), ("w_out", 20480, 4096, False),
             ("embed", 4096, 32000, True)]
#: aligned but ragged against every tile: N or K off the channel and k
#: tiles, a K tail shorter than one stage
RAGGED = [("kn-small", 200, 48, False), ("kn-tail", 1000, 528, False),
          ("kn-wide", 136, 272, False), ("nk-rows", 208, 77, True),
          ("nk-tiny", 80, 3, True), ("nk-tail", 4112, 1000, True)]
#: (name, K, N, transposed) of the 871M int8 self-draft of the
#: speculative-decoding path
SHAPES_871M = [("wq", 2048, 2048, False), ("w_in", 2048, 8192, False),
               ("w_out", 8192, 2048, False), ("embed", 2048, 32000, True)]
#: 40: the verify forward of 8 slots at k = 4
MS = [1, 8, 40, 100, 128, 256]
SMS = 132


def _blocks(p: qm.Plan, N: int):
    return math.ceil(N / p.tile.ct) * p.splits


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("name,K,N,transposed",
                         SHAPES_7B + SHAPES_871M + RAGGED)
def test_plan_covers_k_and_n_exactly_once(name, K, N, transposed, M):
    """Every (k, channel) of the weight belongs to exactly one block, and
    every block's corner is 16-byte aligned as the cp.async copies
    assume."""
    p = qm.plan(torch.bfloat16, M, K, N, transposed, SMS)
    assert p.tile is not None and p.entry.endswith("_tc")
    k_cover = np.zeros(K, np.int32)
    for z in range(p.splits):
        k0, k1 = z * p.k_len, min(K, (z + 1) * p.k_len)
        assert k0 < k1, "no empty split"
        assert k0 % 16 == 0
        k_cover[k0:k1] += 1
    n_cover = np.zeros(N, np.int32)
    for j in range(math.ceil(N / p.tile.ct)):
        n0 = j * p.tile.ct
        assert n0 % 16 == 0
        n_cover[n0:min(N, n0 + p.tile.ct)] += 1
    assert (k_cover == 1).all() and (n_cover == 1).all()
    assert p.k_len % qm.TC_K_STEP == 0 and p.k_len % p.tile.kt == 0
    assert p.splits == math.ceil(K / p.k_len)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("M", list(range(1, 10)) + [16, 17, 33, 64, 65, 100,
                                                    128, 129, 255, 256])
def test_tile_holds_every_row_within_the_shared_memory_budget(M, transposed):
    t = qm.tc_tile(M, transposed)
    assert t.mpad >= M and t.mpad % 8 == 0
    assert t.ct % 32 == 0 and t.threads % 32 == 0 and t.threads <= 1024
    assert t.smem <= qm.SMEM_LIMIT
    assert t.stages >= 3, "at least two stages in flight"
    # what the CUDA source computes: stages x (weight stage + x stage)
    w = t.ct * t.kt if transposed else t.kt * (t.ct + 16)
    assert t.smem == t.stages * (w + t.mpad * (2 * t.kt + 16))


def test_tile_refuses_more_rows_than_the_kernel_takes():
    with pytest.raises(ValueError, match="M <= 256"):
        qm.tc_tile(257, False)


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("name,K,N,transposed", SHAPES_7B)
def test_plan_fills_the_sms_where_partial_sums_are_cheap(name, K, N,
                                                         transposed, M):
    """At least one block per SM wherever the K split that gets there
    writes partial sums worth under a tenth of the weight bytes (the
    decode row counts); at prefill row counts the partial sums weigh
    more than idle SMs and the planner may stop short."""
    p = qm.plan(torch.bfloat16, M, K, N, transposed, SMS)
    tiles = math.ceil(N / p.tile.ct)
    s_fill = math.ceil(SMS / tiles)
    reachable = s_fill <= K // qm.TC_K_STEP
    cheap = s_fill == 1 or 8 * s_fill * M * N <= K * N / 10
    if reachable and cheap:
        assert _blocks(p, N) >= SMS
    assert _blocks(p, N) >= min(SMS, tiles) // 2


@pytest.mark.parametrize("sms", [1, 108, 114, 132, 144])
def test_plan_is_a_pure_function_of_its_arguments(sms):
    for _, K, N, transposed in SHAPES_7B:
        a = qm.plan(torch.bfloat16, 8, K, N, transposed, sms)
        assert a == qm.plan(torch.bfloat16, 8, K, N, transposed, sms)
        assert a.splits >= 1 and a.k_len * a.splits >= K


def test_unembedding_needs_no_k_split():
    """32000 channels give enough tiles at every M: one pass, no second
    kernel."""
    for M in MS:
        assert qm.plan(torch.bfloat16, M, 4096, 32000, True, SMS).splits == 1


@pytest.mark.parametrize("dtype,M,K,N,transposed,want", [
    (torch.bfloat16, 8, 4096, 4096, False, "tc"),
    (torch.bfloat16, 1, 4096, 1024, False, "tc"),
    (torch.bfloat16, 256, 20480, 4096, False, "tc"),
    (torch.bfloat16, 128, 4096, 32000, True, "tc"),
    (torch.bfloat16, 8, 200, 48, False, "tc"),        # K % 8, N % 16
    (torch.bfloat16, 8, 80, 3, True, "tc"),           # K % 16, any N
    (torch.float32, 8, 4096, 4096, False, "masked"),  # fp32 x stays fp32
    (torch.float32, 128, 4096, 32000, True, "masked"),
    (torch.bfloat16, 8, 4096, 1000, False, "masked"),  # N % 16 != 0
    (torch.bfloat16, 8, 300, 256, False, "masked"),    # K % 8 != 0
    (torch.bfloat16, 8, 1500, 64, True, "masked"),     # K % 16 != 0
    (torch.bfloat16, 257, 4096, 4096, False, "masked"),
    (torch.bfloat16, 512, 4096, 32000, True, "masked"),
])
def test_routing_table(dtype, M, K, N, transposed, want):
    assert qm.route(dtype, M, K, N, transposed) == want
    p = qm.plan(dtype, M, K, N, transposed, SMS)
    assert (p.tile is not None) == (want == "tc")
    assert p.entry == {("tc", False): "isl_qmm_kn_tc",
                       ("tc", True): "isl_qmm_nk_tc",
                       ("masked", False): "isl_qmm_kn",
                       ("masked", True): "isl_qmm_nk"}[(want, transposed)]


@pytest.mark.parametrize("M,kernel", [(1, True), (256, True), (257, False),
                                      (1024, False)])
def test_qdot_sends_more_than_256_rows_to_matmul(monkeypatch, M, kernel):
    """``models/quant.py``: M <= 256 goes to the w8a16 wrappers, larger M
    dequantizes and runs ``torch.matmul`` (by shape, not as a fallback)."""
    calls = []
    for fn in ("quant_matmul", "quant_matmul_t", "quant_matmul_stacked"):
        real = getattr(quant, fn)
        monkeypatch.setattr(quant, fn, lambda *a, _f=real, _n=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    g = torch.Generator().manual_seed(M)
    x = torch.randn((M, 64), generator=g)
    leaf = quant.quantize_tensor(torch.randn((64, 32), generator=g))
    table = quant.quantize_tensor(torch.randn((48, 64), generator=g),
                                  reduce_axis=-1)
    stack = quant.quantize_tensor(torch.randn((2, 64, 32), generator=g))
    outs = [quant.qdot(x, leaf), quant.qdot(x, table, transpose_w=True),
            quant.qdot_stacked(x, stack, 1)]
    wants = [x @ leaf.dequantize(), x @ table.dequantize().t(),
             x @ stack.layer(1).dequantize()]
    for got, want in zip(outs, wants):
        # fp32 both ways; scale on the sum or on the weight: 1e-5
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert calls == (["quant_matmul", "quant_matmul_t",
                      "quant_matmul_stacked"] if kernel else [])


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_versions_and_count_no_launch(xdt):
    g = torch.Generator().manual_seed(3)
    x = torch.randn((8, 64), generator=g).to(xdt)
    q3 = torch.randint(-127, 128, (3, 64, 32), generator=g, dtype=torch.int8)
    s3 = torch.rand((3, 1, 32), generator=g)
    qt = torch.randint(-127, 128, (48, 64), generator=g, dtype=torch.int8)
    st = torch.rand((48, 1), generator=g)
    before = (qm.quant_matmul.launches, qm.quant_matmul_t.launches,
              qm.quant_matmul_stacked.launches)
    assert torch.equal(qm.quant_matmul_stacked(x, q3, s3, 2),
                       qm.quant_matmul_stacked_ref(x, q3, s3, 2))
    assert torch.equal(qm.quant_matmul(x, q3[1], s3[1]),
                       qm.quant_matmul_ref(x, q3[1], s3[1]))
    assert torch.equal(qm.quant_matmul_t(x, qt, st),
                       qm.quant_matmul_t_ref(x, qt, st))
    assert torch.equal(qm.quant_matmul(x, qt, st, transpose_w=True),
                       qm.quant_matmul_t_ref(x, qt, st))
    assert before == (qm.quant_matmul.launches, qm.quant_matmul_t.launches,
                      qm.quant_matmul_stacked.launches)
    # the plain version is exact int8 -> fp32, fp32 sums, scale on the sum
    want = (x.double() @ q3[2].double()) * s3[2].double().reshape(1, -1)
    torch.testing.assert_close(
        qm.quant_matmul_stacked(x, q3, s3, 2).double(), want, rtol=1e-5,
        atol=1e-4)


def test_cpu_wrappers_still_check_the_contraction():
    x = torch.zeros((4, 60))
    q = torch.zeros((64, 32), dtype=torch.int8)
    for call in (lambda: qm.quant_matmul(x, q, torch.ones(32)),
                 lambda: qm.quant_matmul_stacked(x, q[None],
                                                 torch.ones(1, 1, 32), 0),
                 lambda: qm.quant_matmul_t(x, q.t().contiguous(),
                                           torch.ones(32))):
        with pytest.raises(ValueError, match="contraction mismatch"):
            call()
