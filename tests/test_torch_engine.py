"""The port's ServingEngine held against the JAX package's on the CPU.

Both engines serve the same bridged int8 weights with an int8 KV cache
(fp32 compute, so greedy chains must agree token for token), both with
``radix_cache=False`` (the radix prefix cache is held in
``tests/test_torch_radix.py``), the JAX engine with its w8a16 kernel
opt-in. Sampling is held by distribution,
never token by token (a threefry stream and a Philox stream cannot
agree). The last test holds ``chip_smoke.py`` to its contract on a
machine without a card.
"""

import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instaslice_tpu.models.lm import TpuLM as JaxLM
from instaslice_tpu.serving import AdmissionRequest as JaxAdmission
from instaslice_tpu.serving import ServingEngine as JaxEngine
from instaslice_tpu.serving import sampling as jsampling
from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM
from instaslice_tpu_torch.serving import AdmissionRequest, ServingEngine
from instaslice_tpu_torch.serving import sampling as tsampling
from torch_port_util import both_params, configs, numpy_params

REPO = pathlib.Path(__file__).resolve().parents[1]
ENGINE = dict(max_batch=4, max_len=128, prefill_len=16, kv_quant=True)


def tv_distance(a, b) -> float:
    return 0.5 * float(np.abs(np.asarray(a) - np.asarray(b)).sum())


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = configs("fp32")
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 0), quantize=True)

    def make():
        return (JaxEngine(JaxLM(jcfg), jtree, radix_cache=False, **ENGINE),
                ServingEngine(TpuLM(tcfg), ttree, device="cpu",
                              radix_cache=False, **ENGINE))

    return make


def test_greedy_generate_and_burst_match_jax(engines, monkeypatch):
    """Mixed prompt lengths (one chunked past prefill_len) through
    generate, then an admission burst through the batched prefill and a
    decode block: identical greedy tokens, no leaked KV blocks."""
    monkeypatch.setenv("TPUSLICE_QUANT_KERNEL", "1")
    monkeypatch.delenv("TPUSLICE_DECODE_KERNEL", raising=False)
    jax.clear_caches()
    jeng, teng = engines()
    prompts = [[1, 2, 3], list(range(5, 30)), [7] * 9]
    want = jeng.generate(prompts, max_new_tokens=9, block_size=8)
    got = teng.generate(prompts, max_new_tokens=9, block_size=8)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert len({tuple(r.tokens) for r in got}) == 3
    np.testing.assert_allclose([r.logprobs for r in got],
                               [r.logprobs for r in want], atol=1e-4)
    assert teng.kv.used_blocks() == 0

    burst = [([11, 12, 13, 14], 1), (list(range(40, 80)), 1), ([3] * 20, 2)]
    jrids = jeng.add_requests([JaxAdmission(p, n=n) for p, n in burst])
    trids = teng.add_requests([AdmissionRequest(p, n=n) for p, n in burst])
    assert trids == jrids and teng.prefill_batches >= 1
    assert teng.decode_block(6) == jeng.decode_block(6)
    for slot in list(teng.slots):
        teng.finish_slot(slot)
    assert teng.kv.used_blocks() == 0 and teng.free_slots() == 4
    jax.clear_caches()


def test_greedy_repetition_penalty_matches_jax(monkeypatch):
    """The penalty runs before the (greedy) choice on both engines, at
    admission and inside decode blocks, over prompt and generated
    tokens."""
    monkeypatch.setenv("TPUSLICE_QUANT_KERNEL", "1")
    monkeypatch.delenv("TPUSLICE_DECODE_KERNEL", raising=False)
    jax.clear_caches()
    jcfg, tcfg = configs("fp32")
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 4), quantize=True)
    kw = dict(ENGINE, repetition_penalty=1.8)
    jeng = JaxEngine(JaxLM(jcfg), jtree, radix_cache=False, **kw)
    teng = ServingEngine(TpuLM(tcfg), ttree, device="cpu",
                         radix_cache=False, **kw)
    prompts = [[5, 5, 6, 7], list(range(20, 41))]
    want = jeng.generate(prompts, max_new_tokens=9, block_size=8)
    got = teng.generate(prompts, max_new_tokens=9, block_size=8)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    jax.clear_caches()


def test_split_decode_equals_decode_block(engines):
    """decode_block_start/finish (the overlap seam) is decode_block, and
    an admission while a block is in flight lands that block first."""
    _, a = engines()
    _, b = engines()
    for eng in (a, b):
        eng.add_request([1, 2, 3, 4])
    want = a.decode_block(5)
    assert b.decode_block_start(5)
    assert b.decode_block_finish() == want
    b.decode_block_start(3)
    b.add_request([9, 9])                      # drains the pending block
    assert b._pending_block is None
    assert len(b.slots[0].generated) == 1 + 5 + 3
    # step() attends the whole cache, decode_block a 256-bucket of it:
    # masked positions change nothing, so the chains agree
    _, c = engines()
    c.add_request([1, 2, 3, 4])
    longer = c.decode_block(6)
    assert [*want[0], a.step()[0]] == longer[0]
    assert a.kv_stats()["used"] == a.kv.blocks_for(4 + 1 + 6)


def test_sampler_marginal_matches_jax_filtered_distribution():
    """40k draws of the port's sampler from tempered, top-k / nucleus
    filtered logits land on the JAX package's filtered distribution:
    expected TV at N=40k over 8 tokens is ~0.006; a biased sampler
    lands far beyond 0.02."""
    logits = np.random.default_rng(0).standard_normal((1, 8)) * 1.5
    temp, top_k, top_p = 0.8, 6, 0.95
    exact = np.asarray(jax.nn.softmax(jsampling.filter_logits(
        jnp.asarray(logits / temp), top_k, top_p), axis=-1))[0]
    filt = tsampling.filter_logits(torch.from_numpy(logits / temp)
                                   .expand(40000, -1), top_k, top_p)
    gen = torch.Generator().manual_seed(1)
    toks = tsampling.sample(filt, gen).numpy()
    emp = np.bincount(toks, minlength=8) / len(toks)
    assert tv_distance(emp, exact) < 0.02
    assert emp[exact == 0].sum() == 0


def test_engine_first_token_marginal():
    """The engine's own sampling path: 1600 first tokens of forks of one
    prompt (temperature 0.7, top-k 5) against the exact filtered softmax
    of the prompt's logits. Expected TV over 5 tokens at N=1600 is
    ~0.02."""
    cfg = ModelConfig(vocab_size=16, d_model=32, n_heads=2, n_layers=1,
                      d_ff=64, dtype=torch.float32, remat=False)
    model = TpuLM(cfg)
    params = model.init(0, device="cpu")
    params["embed"] = params["embed"] * 0.3
    eng = ServingEngine(model, params, max_batch=16, max_len=32,
                        prefill_len=8, temperature=0.7, top_k=5, seed=3,
                        device="cpu")
    prompt = [1, 5, 9]
    logits = eng._prefill_chunks(0, prompt)[len(prompt) - 1]
    exact = torch.softmax(tsampling.filter_logits(logits / 0.7, 5), -1)
    counts = np.zeros(16)
    for _ in range(100):
        eng.add_request_n(prompt, 16)
        for slot in list(eng.slots):
            counts[eng.slots[slot].generated[0]] += 1
            eng.evict_slot(slot)
    assert tv_distance(counts / counts.sum(), exact.numpy()) < 0.06
    assert counts[exact.numpy() == 0].sum() == 0


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = ModelConfig(vocab_size=16, d_model=32, n_heads=2, n_layers=1,
                      d_ff=64)
    params = TpuLM(cfg).init(0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(TpuLM(cfg), params)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_to_run_without_a_card(alone, tmp_path):
    """No card: non-zero exit and no result line, both in the checkout
    and as a lone copy of the script (where the port is missing)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
