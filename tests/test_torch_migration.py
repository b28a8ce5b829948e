"""The port's session migration, held against the JAX package on the CPU.

- The wire codec (``serving/kvcache.py``): tuple tags, int8 / fp32 /
  bfloat16 round trips, bfloat16 decoded with no ``ml_dtypes`` in the
  process, and the port's and the reference's encoders writing the same
  bytes for the same arrays.
- Engine to engine: port export -> port import -> resume continues the
  greedy chain exactly; a sampled session replays the source's stream bit
  for bit (its generator state rides the blob); a JAX engine's blob
  resumes on the port engine and a port blob on the JAX engine (the same
  seeded fp32 weights, int8 KV cache), continuing with the unmigrated JAX
  engine's greedy tokens and logprobs within 1e-5; version, signature and
  sampling mismatches are rejected; a malformed or late-failing payload
  gives back every block it allocated.
- Over HTTP: the reference ``Router`` in front of two port servers moves
  a live stream mid-stream, and a synchronous completion, off one replica
  onto the other token-identically; a failed export parks the session on
  its replica instead of stranding it; an import at another wire version
  is a 400; the ``serve.export`` crash point kills the replica's
  scheduler with the source copy still held and no client hung.
"""

import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from instaslice_tpu.models.lm import TpuLM as JaxLM
from instaslice_tpu.serving import ServingEngine as JaxEngine
from instaslice_tpu.serving import kvcache as jkv
from instaslice_tpu.serving.router import Router
from instaslice_tpu_torch import faults as tfaults
from instaslice_tpu_torch.models.lm import TpuLM
from instaslice_tpu_torch.serving import ServingEngine
from instaslice_tpu_torch.serving import kvcache as tkv
from instaslice_tpu_torch.serving.api_server import ApiServer
from torch_port_util import both_params, configs, numpy_params

ENGINE = dict(max_batch=4, max_len=96, prefill_len=8)
PROMPT = [5, 9, 2, 7]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = configs("fp32")
    return (jcfg, tcfg), both_params(jcfg, numpy_params(jcfg, 0),
                                     quantize=False)


def _port(weights, **kw):
    (_, tcfg), (_, tt) = weights
    return ServingEngine(TpuLM(tcfg), tt, device="cpu", **dict(ENGINE, **kw))


def _jax(weights, **kw):
    (jcfg, _), (jt, _) = weights
    return JaxEngine(JaxLM(jcfg), jt, **dict(ENGINE, **kw))


def _export(src, rid) -> dict:
    """Park ``rid`` and export it as the JSON that crosses the wire."""
    slot = next(s for s, r in src.slots.items() if r.request_id == rid)
    src.preempt_slot(slot)
    blob = json.loads(json.dumps(src.export_session(rid)))
    src.drop_parked(rid)
    return blob


def _resume(dst, blob, n):
    rid = dst.import_session(blob)
    dst.resume_request(rid)
    dst.decode_block(n)
    req = next(r for r in dst.slots.values() if r.request_id == rid)
    return list(req.generated), list(req.logprobs)


# ------------------------------------------------------------------ codec

def test_codec_round_trips_dtypes_and_tuples():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5)).astype(np.float32)
    tree = {
        "k": (torch.from_numpy(x), torch.arange(6, dtype=torch.int8)),
        "nested": [{"v": torch.from_numpy(x).to(torch.bfloat16)}],
        "np": np.ones((1, 2), np.int32),
        "scalar": 3,
    }
    back = tkv.wire_to_tree(json.loads(json.dumps(tkv.tree_to_wire(tree))))
    assert isinstance(back["k"], tuple)
    assert back["k"][0].dtype == torch.float32
    assert torch.equal(back["k"][0], tree["k"][0])
    assert torch.equal(back["k"][1], tree["k"][1])
    assert back["nested"][0]["v"].dtype == torch.bfloat16
    assert torch.equal(back["nested"][0]["v"], tree["nested"][0]["v"])
    assert back["np"].dtype == torch.int32 and back["np"].shape == (1, 2)
    assert back["scalar"] == 3


def test_bfloat16_decodes_without_ml_dtypes():
    """The card's machine has no ml_dtypes: the port reads a bfloat16
    wire (written here by the reference, through ml_dtypes) with it
    blocked from import."""
    import ml_dtypes

    x = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    wire = json.dumps(jkv.array_to_wire(x.astype(ml_dtypes.bfloat16)))
    code = (
        "import sys, json, torch; sys.modules['ml_dtypes'] = None\n"
        "from instaslice_tpu_torch.serving import kvcache\n"
        f"t = kvcache.wire_to_array(json.loads({wire!r}))\n"
        "assert 'ml_dtypes' not in sys.modules or "
        "sys.modules['ml_dtypes'] is None\n"
        "print(t.dtype, json.dumps(t.float().tolist()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, check=True).stdout.split(" ",
                                                                          1)
    assert out[0] == "torch.bfloat16"
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(np.array(json.loads(out[1])), want)


def test_port_and_reference_encoders_write_the_same_bytes():
    import ml_dtypes

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1, 3, 8, 4)).astype(np.float32)
    cases = [(x, x), (x.astype(np.int8), x.astype(np.int8)),
             (x.astype(ml_dtypes.bfloat16),
              torch.from_numpy(x).to(torch.bfloat16)),
             (np.array([7, 9], np.uint32), np.array([7, 9], np.uint32))]
    for ref_in, port_in in cases:
        ref = jkv.array_to_wire(ref_in)
        assert tkv.array_to_wire(port_in) == ref
        assert tkv.array_to_wire(torch.as_tensor(np.asarray(ref_in))
                                 if ref_in.dtype != ml_dtypes.bfloat16
                                 else port_in) == ref
        # and each side decodes the other's wire to the same values
        assert np.array_equal(
            np.asarray(jkv.wire_to_array(tkv.array_to_wire(port_in)),
                       np.float32),
            tkv.wire_to_array(ref).float().numpy())
    assert tkv.SESSION_WIRE_VERSION == jkv.SESSION_WIRE_VERSION


# ---------------------------------------------------------- engine level

def test_port_export_import_resume_is_greedy_identical(weights):
    oracle = _port(weights)
    r0 = oracle.add_request(list(PROMPT))
    oracle.decode_block(11)
    want = oracle.slots[0].generated
    src, dst = _port(weights), _port(weights)
    rid = src.add_request(list(PROMPT))
    src.decode_block(5)
    blob = _export(src, rid)
    assert blob["version"] == tkv.SESSION_WIRE_VERSION
    assert blob["rng"] is None and blob["torch_rng"]["device"] == "cpu"
    assert src.exported_total == 1 and not src.parked
    assert src.kv.used_blocks() == src.radix.pool_blocks()
    got, _ = _resume(dst, blob, 6)
    assert r0 == 0 and got == want and dst.imported_total == 1


def test_sampled_session_replays_the_source_stream(weights):
    """temperature > 0: the generator state rides the blob, so the
    migrated continuation equals the UNINTERRUPTED run on the source even
    on a destination built with another seed."""
    full = _port(weights, temperature=0.8, seed=3)
    rid = full.add_request(list(PROMPT))
    full.decode_block(12)
    want = (list(full.slots[0].generated), list(full.slots[0].logprobs))
    src = _port(weights, temperature=0.8, seed=3)
    dst = _port(weights, temperature=0.8, seed=99)
    rid = src.add_request(list(PROMPT))
    src.decode_block(5)
    got = _resume(dst, _export(src, rid), 7)
    assert got == want


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sessions_cross_between_the_jax_and_port_engines(weights,
                                                         direction):
    """The same seeded fp32 weights, an int8 KV cache on both sides: the
    session resumes on the other engine and continues with the
    unmigrated JAX engine's greedy tokens, logprobs within 1e-5."""
    oracle = _jax(weights, kv_quant=True)
    rid = oracle.add_request(list(PROMPT))
    oracle.decode_block(13)
    req = oracle.slots[0]
    want_t, want_l = list(req.generated), list(req.logprobs)
    if direction == "jax_to_port":
        src, dst = _jax(weights, kv_quant=True), _port(weights, kv_quant=True)
    else:
        src, dst = _port(weights, kv_quant=True), _jax(weights, kv_quant=True)
    rid = src.add_request(list(PROMPT))
    src.decode_block(6)
    blob = _export(src, rid)
    assert blob["model"] == dst.model_signature()
    assert blob["stripe"]["k"]["dtype"] == "int8"
    assert blob["stripe"]["k_s"]["dtype"] == "float32"
    got_t, got_l = _resume(dst, blob, 7)
    assert got_t == want_t
    np.testing.assert_allclose(got_l, want_l, atol=1e-5, rtol=0)


def test_mismatched_blobs_are_rejected(weights):
    src, dst = _port(weights), _port(weights)
    rid = src.add_request(list(PROMPT))
    src.decode_block(3)
    src.preempt_slot(next(iter(src.slots)))
    blob = src.export_session(rid)
    free0 = dst.kv.free_blocks()
    with pytest.raises(ValueError, match="wire version"):
        dst.import_session(dict(blob, version=tkv.SESSION_WIRE_VERSION + 1))
    with pytest.raises(ValueError, match="incompatible"):
        _port(weights, max_len=64).import_session(blob)
    with pytest.raises(ValueError, match="incompatible"):
        _port(weights, kv_quant=True).import_session(blob)
    with pytest.raises(ValueError, match="sampling"):
        _port(weights, temperature=1.5, seed=1).import_session(blob)
    with pytest.raises(ValueError, match="not parked"):
        src.export_session(rid + 7)
    assert dst.imported_total == 0 and dst.kv.free_blocks() == free0
    # an import is parked state: drop_parked gives every block back
    rid2 = dst.import_session(blob)
    assert dst.kv.free_blocks() < free0 and rid2 in dst.parked
    dst.drop_parked(rid2)
    assert dst.kv.free_blocks() == free0


def test_malformed_and_late_failing_payloads_release_their_blocks(weights):
    src, dst = _port(weights), _port(weights)
    rid = src.add_request(list(PROMPT))
    src.decode_block(3)
    src.preempt_slot(next(iter(src.slots)))
    blob = json.loads(json.dumps(src.export_session(rid)))
    free0 = dst.kv.free_blocks()
    stripe_k = blob["stripe"]["k"]
    bads = [
        {k: v for k, v in blob.items() if k != "stripe"},
        dict(blob, stripe={"__nd__": True, "dtype": "float32",
                           "shape": [2, 2], "data": "!!notb64!!"}),
        # a payload that decodes but does not fit the cache: caught
        # before registration, never inside the resume's cache write
        dict(blob, stripe=dict(blob["stripe"], k=dict(
            stripe_k, dtype="int32",
            shape=stripe_k["shape"][:-1] + [stripe_k["shape"][-1] // 4]))),
        dict(blob, stripe=dict(blob["stripe"], k=dict(
            stripe_k, shape=[1] + stripe_k["shape"][1:],
            data=tkv.array_to_wire(torch.zeros(
                [1] + stripe_k["shape"][1:]))["data"]))),
        dict(blob, length=blob["stripe"]["k"]["shape"][3] + 1),
        # late: the generator state is parsed after the stripes
        dict(blob, torch_rng={"device": "cpu", "state": {
            "__nd__": True, "dtype": "uint8", "shape": [4],
            "data": "!!notb64!!"}}),
        dict(blob, torch_rng={"device": "cpu", "state": tkv.array_to_wire(
            torch.zeros(4, dtype=torch.uint8))}),
    ]
    for bad in bads:
        with pytest.raises(ValueError):
            dst.import_session(bad)
        assert dst.kv.free_blocks() == free0
        assert not dst.parked and not dst._tables
    # no adapter key reads as the base model; a JAX key alone keeps the
    # destination's generator
    state = dst._gen.get_state().clone()
    ok = {k: v for k, v in blob.items() if k not in ("adapter",
                                                    "torch_rng")}
    ok["rng"] = jkv.array_to_wire(np.array([1, 2], np.uint32))
    rid2 = dst.import_session(ok)
    assert rid2 in dst.parked and torch.equal(dst._gen.get_state(), state)


# ------------------------------------------------------------- over HTTP

def _post(url, payload, timeout=120):
    req = urllib.request.Request(
        f"{url}/v1/completions", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _stream_tokens(url, payload, result, timeout=120):
    req = urllib.request.Request(
        f"{url}/v1/completions",
        data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    toks = []
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            buf = b""
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    result["error"] = "stream ended without [DONE]"
                    return
                buf += chunk
                while b"\n\n" in buf:
                    ev, buf = buf.split(b"\n\n", 1)
                    line = ev.decode().strip()
                    if not line.startswith("data: "):
                        continue
                    data = line[len("data: "):]
                    if data == "[DONE]":
                        result["tokens"] = toks
                        return
                    p = json.loads(data)
                    if "error" in p:
                        result["error"] = p["error"]
                        return
                    for c in p.get("choices", []):
                        toks.extend(c.get("token_ids") or [])
    except OSError as e:
        result["error"] = repr(e)


def _export_now(url) -> dict:
    req = urllib.request.Request(
        url + "/v1/sessions/export", data=b"{}",
        headers={"Content-Type": "application/json"}, method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=10).read())


def _wait_live(servers, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for s in servers:
            if s.scheduler.stats()["live_slots"]:
                return s
        time.sleep(0.01)
    raise AssertionError("no replica ever held a live slot")


def _oracle(weights, prompt, n):
    eng = _port(weights)
    [r] = eng.generate([list(prompt)], max_new_tokens=n)
    return r.tokens


@pytest.fixture()
def fleet(weights):
    servers = [ApiServer(_port(weights), block_size=4).start()
               for _ in range(2)]
    # eject_factor=0 turns off the router's gray-failure sweep
    # (router.py:1242-1243): it drains a replica whose polls answer slowly
    # under CPU load with migrate, a second exporter these tests do not
    # hold (they count the one export they make by hand)
    router = Router([s.url for s in servers], poll_interval=0.1,
                    eject_factor=0).start()
    yield router, servers
    router.stop()
    for s in servers:
        s.stop()


def _quiesced(servers):
    for s in servers:
        st = s.scheduler.stats()
        assert st["live_slots"] == 0 and st["parked"] == 0
        assert st["sessions"]["imports_pending"] == 0
        eng = s.scheduler.engine
        assert not eng._radix_locks
        assert eng.kv.used_blocks() == eng.radix.pool_blocks()


@pytest.mark.parametrize("mode", ["stream", "sync"])
def test_router_migrates_a_live_session_between_port_servers(weights,
                                                             fleet, mode):
    router, servers = fleet
    prompt = [7, 8, 9] if mode == "stream" else [3, 1, 4]
    oracle = _oracle(weights, prompt, 60)
    result: dict = {}
    body = {"prompt": prompt, "max_tokens": 60}
    if mode == "stream":
        t = threading.Thread(target=_stream_tokens,
                             args=(router.url, body, result))
    else:
        def go():
            result["code"], result["out"] = _post(router.url, body)
        t = threading.Thread(target=go)
    t.start()
    victim = _wait_live(servers)
    assert _export_now(victim.url)["migrated"] == 1
    t.join(timeout=120)
    assert "error" not in result, result
    if mode == "stream":
        assert result["tokens"] == oracle
    else:
        assert result["code"] == 200, result
        assert result["out"]["choices"][0]["token_ids"] == oracle
        assert result["out"]["usage"]["completion_tokens"] == 60
    assert router.migrations.get("resumed", 0) >= 1
    stats = [s.scheduler.stats() for s in servers]
    assert sum(s["sessions"]["exported"] for s in stats) == 1
    assert sum(s["sessions"]["imported"] for s in stats) == 1
    assert sum(s["sessions"]["migrated_in"] for s in stats) == 1
    _quiesced(servers)


def test_failed_export_parks_instead_of_stranding(weights, fleet):
    router, servers = fleet
    oracle = _oracle(weights, [9, 9, 1], 60)
    result: dict = {}
    t = threading.Thread(target=_stream_tokens, args=(
        router.url, {"prompt": [9, 9, 1], "max_tokens": 60}, result))
    t.start()
    victim = _wait_live(servers)

    def boom(rid):
        raise RuntimeError("injected export failure")

    victim.scheduler.engine.export_session = boom
    assert _export_now(victim.url)["migrated"] == 0
    t.join(timeout=120)
    assert "error" not in result, result
    assert result["tokens"] == oracle
    st = victim.scheduler.stats()
    assert st["sessions"]["migrated_out"] == 0
    assert st["sessions"]["migrate_preempts"] == 1
    _quiesced(servers)


def test_import_at_another_wire_version_is_http_400(fleet):
    _, servers = fleet
    req = urllib.request.Request(
        servers[0].url + "/v1/sessions/import",
        data=json.dumps({"session": {
            "version": tkv.SESSION_WIRE_VERSION + 7}}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400
    assert "wire version" in json.loads(ei.value.read())["error"]


def test_export_crash_point_kills_the_scheduler_with_the_source_held(
        weights):
    """``serve.export``: the blob exists, the source copy is not dropped
    yet; the scheduler thread dies there (as the process would), its
    clients get a terminal, none hangs."""
    srv = ApiServer(_port(weights), block_size=4).start()
    try:
        result: dict = {}
        t = threading.Thread(target=_stream_tokens, args=(
            srv.url, {"prompt": [7, 8, 9], "max_tokens": 60}, result, 30))
        t.start()
        _wait_live([srv])
        tfaults.set_crash_plan(tfaults.CrashPlan().arm("serve.export", 1))
        try:
            _export_now(srv.url)
        except OSError:
            pass                   # severed mid-request: the crash
        t.join(timeout=30)
        assert not t.is_alive(), "client hung on a dead scheduler"
        assert "tokens" not in result
        assert srv.scheduler.stop_flag.is_set()
        assert tfaults.get_crash_plan().stats()["serve.export"] == {
            "calls": 1, "fired": 1}
        eng = srv.scheduler.engine
        assert len(eng.parked) == 1 and eng.exported_total == 1
    finally:
        tfaults.set_crash_plan(None)
        try:
            srv.stop()
        except OSError:
            pass


def test_crash_plan_parses_the_environment(monkeypatch):
    monkeypatch.setenv("TPUSLICE_CRASH_AT", "serve.export:2, agent.x")
    tfaults.reset_crash_plan()
    try:
        plan = tfaults.get_crash_plan()
        assert plan.sites == {"serve.export": 2, "agent.x": 1}
        tfaults.maybe_crash("serve.export")
        with pytest.raises(tfaults.InjectedCrash, match="serve.export"):
            tfaults.maybe_crash("serve.export")
        tfaults.maybe_crash("serve.export")          # fires once only
    finally:
        monkeypatch.delenv("TPUSLICE_CRASH_AT")
        tfaults.reset_crash_plan()
    assert tfaults.get_crash_plan() is None
    with pytest.raises(ValueError, match="TPUSLICE_CRASH_AT"):
        tfaults.CrashPlan.from_env("serve.export:x")
    jax.clear_caches()
