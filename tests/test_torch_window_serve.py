"""The port's serving engine with a sliding window against the JAX
package's on the CPU: greedy chains crossing the window (batched prefill
included), a radix hit, speculative rounds with a windowed draft, and
windowed sessions moved between the two engines (split from
``tests/test_torch_window.py``, which has the set-up)."""

import dataclasses
import json

import numpy as np
import pytest

from instaslice_tpu.models.lm import TpuLM as JaxLM
from instaslice_tpu.serving import AdmissionRequest as JaxAdmission
from instaslice_tpu.serving import ServingEngine as JaxEngine
from instaslice_tpu_torch.models.lm import TpuLM
from instaslice_tpu_torch.serving import AdmissionRequest, ServingEngine
from test_torch_model import TOLERANCE
from test_torch_window import _jax_kernel_opt_in  # noqa: F401  (autouse)
from test_torch_window import _serving_pair

WINDOW = 6
ENGINE = dict(max_batch=3, max_len=320, prefill_len=16)

def _engines(window, quantize, kv_quant, **kw):
    jcfg, tcfg, jt, tt = _serving_pair(window, quantize)
    opts = dict(ENGINE, kv_quant=kv_quant, **kw)
    return (JaxEngine(JaxLM(jcfg), jt, **opts),
            ServingEngine(TpuLM(tcfg), tt, device="cpu", **opts))


PROMPTS = [[3, 9, 4], list(range(20, 47)), [7, 1] * 9]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_windowed_engine_greedy_matches_jax(kv_quant):
    """Window 6, int8 weights: prompts of 3-27 tokens decoded 12 past
    them (every row crosses the window; a 27-token prompt takes two
    chunks) through generate, then a burst through the batched prefill
    and a decode block: the same greedy tokens as the JAX windowed
    engine (logprobs within the logits' tolerance), no leaked KV
    blocks."""
    jeng, teng = _engines(WINDOW, True, kv_quant, radix_cache=False)
    want = jeng.generate(PROMPTS, max_new_tokens=12, block_size=8)
    got = teng.generate(PROMPTS, max_new_tokens=12, block_size=8)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    np.testing.assert_allclose([r.logprobs for r in got],
                               [r.logprobs for r in want],
                               atol=TOLERANCE[("fp32", kv_quant)][0])
    assert teng.kv.used_blocks() == 0
    burst = [[5] * 20, list(range(60, 90))]
    jeng.add_requests([JaxAdmission(p) for p in burst])
    teng.add_requests([AdmissionRequest(p) for p in burst])
    assert teng.prefill_batches >= 1
    assert teng.decode_block(7) == jeng.decode_block(7)


def test_windowed_radix_hit_gives_the_cold_tokens():
    """A prompt whose first two 16-token chunks are cached: the hit skips
    them and decodes the cold engine's tokens."""
    _, tcfg, _, tt = _serving_pair(WINDOW, quantize=False)
    head = list(range(30, 62))
    prompt = head + [4, 8, 15, 16, 23]
    cold = ServingEngine(TpuLM(tcfg), tt, device="cpu", **ENGINE)
    want = cold.generate([prompt], max_new_tokens=10)[0].tokens
    eng = ServingEngine(TpuLM(tcfg), tt, device="cpu", **ENGINE)
    eng.generate([head + [99, 98, 97]], max_new_tokens=2)
    chunks0 = eng.prefill_dispatches
    got = eng.generate([prompt], max_new_tokens=10)[0].tokens
    assert eng.prefix_hits == 1 and eng.prefix_tokens_saved == 32
    assert eng.prefill_dispatches - chunks0 == 1
    assert got == want


def test_windowed_spec_engine_gives_the_plain_greedy_chain():
    """A 1-layer draft inheriting the window (``dataclasses.replace`` of
    the target's config, as ``build_engine`` makes it): the spec rounds'
    chain is the plain engine's, decoded past the window."""
    _, tcfg, _, tt = _serving_pair(WINDOW, quantize=False)
    plain = ServingEngine(TpuLM(tcfg), tt, device="cpu", **ENGINE)
    rid = plain.add_request([5, 9, 2, 7])
    plain.decode_block(15)
    want = plain.slots[0].generated[:16]
    dcfg = dataclasses.replace(tcfg, n_layers=1)
    assert dcfg.window == WINDOW
    spec = ServingEngine(TpuLM(tcfg), tt, draft_model=TpuLM(dcfg),
                         device="cpu", spec_k=3, **ENGINE)
    rid = spec.add_request([5, 9, 2, 7])
    while len(spec.slots[0].generated) < 16:
        spec.spec_step()
    assert spec.slots[0].generated[:16] == want and rid == 0
    assert spec.spec_proposed > 0


def _export(src, rid) -> dict:
    slot = next(s for s, r in src.slots.items() if r.request_id == rid)
    src.preempt_slot(slot)
    blob = json.loads(json.dumps(src.export_session(rid)))
    src.drop_parked(rid)
    return blob


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_windowed_sessions_cross_between_the_jax_and_port_engines(direction):
    """A windowed int8-KV session exported past the window resumes on the
    other engine with the unmigrated engine's greedy tokens (logprobs
    within 1e-5); an engine of another window refuses it with the
    reference's error."""
    jeng, teng = _engines(WINDOW, False, True)
    oracle, _ = _engines(WINDOW, False, True)
    oracle.add_request([5, 9, 2, 7])
    oracle.decode_block(15)
    want_t = list(oracle.slots[0].generated)
    want_l = list(oracle.slots[0].logprobs)
    src, dst = (jeng, teng) if direction == "jax_to_port" else (teng, jeng)
    rid = src.add_request([5, 9, 2, 7])
    src.decode_block(8)
    blob = _export(src, rid)
    assert blob["model"]["window"] == WINDOW
    assert blob["model"] == dst.model_signature()
    rid2 = dst.import_session(blob)
    dst.resume_request(rid2)
    dst.decode_block(7)
    req = next(r for r in dst.slots.values() if r.request_id == rid2)
    assert list(req.generated) == want_t
    np.testing.assert_allclose(req.logprobs, want_l, atol=1e-5, rtol=0)
    _, other = _engines(WINDOW + 1, False, True)
    with pytest.raises(ValueError, match="incompatible engine"):
        other.import_session(blob)
