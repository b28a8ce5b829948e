"""The port's HTTP server (``instaslice_tpu_torch.serving.api_server``)
held against the reference's on the CPU.

Both servers run in process on port 0, each over its own engine serving
the same bridged int8 weights with an int8 KV cache (fp32 compute, radix
prefix cache on): the reference ``ApiServer`` over the JAX engine (its
w8a16 Pallas kernels in interpret mode, the decode-kernel opt-in off as
in ``tests/test_torch_engine.py``), the port's over the port engine. One
seeded stream of completions (plain, streamed, stop sequences,
logprobs, ``n``, ``X-Tenant`` classes, a radix hit) is sent to each, one
request at a time so both schedulers see the same admissions: the same
tokens. ``/v1/stats`` has the same key structure; ``/v1/prefixes``
register/drop and ``/v1/drain`` answer alike. The reference
``tpuslice-loadgen`` then runs as its own process against the port
server and reports nothing hung.
"""

import json
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from instaslice_tpu.models.lm import TpuLM as JaxLM
from instaslice_tpu.serving import ServingEngine as JaxEngine
from instaslice_tpu.serving.api_server import ApiServer as JaxApiServer
from instaslice_tpu_torch.models.lm import TpuLM
from instaslice_tpu_torch.serving import ServingEngine
from instaslice_tpu_torch.serving.api_server import ApiServer
from torch_port_util import both_params, configs, numpy_params

ENGINE = dict(max_batch=3, max_len=96, prefill_len=16, kv_quant=True)
TENANTS = "gold:3:latency:5.0,bronze:1:best-effort"


def _call(url, path, body=None, method=None, headers=None):
    """(status, parsed JSON body or the raw SSE text)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url + path, data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            raw, code = resp.read().decode(), resp.status
    except urllib.error.HTTPError as e:
        raw, code = e.read().decode(), e.code
    if raw.startswith("data: "):
        return code, raw
    return code, json.loads(raw)


def _sse_tokens(raw: str) -> dict:
    """choice index -> (token ids, logprobs, finish reason) of a stream."""
    out = {}
    for line in raw.splitlines():
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        for ch in json.loads(line[len("data: "):])["choices"]:
            toks, lps, fin = out.setdefault(ch["index"], ([], [], [None]))
            toks += ch["token_ids"]
            lps += ch.get("logprobs") or []
            if ch["finish_reason"] is not None:
                fin[0] = ch["finish_reason"]
    return {i: (t, lp, f[0]) for i, (t, lp, f) in out.items()}


#: keys only the port's ``/v1/stats`` has (the decode attention route,
#: the decode route and its captured graphs)
PORT_ONLY = ("attention_route", "decode_graphs")


def _keyshape(obj):
    if isinstance(obj, dict):
        return {k: ("data-keyed" if k in ("compiled_programs",)
                    else _keyshape(v)) for k, v in obj.items()
                if k not in PORT_ONLY}
    return type(obj).__name__ if isinstance(obj, (list, dict)) else "leaf"


@pytest.fixture(scope="module")
def servers():
    mp = pytest.MonkeyPatch()
    mp.setenv("TPUSLICE_QUANT_KERNEL", "1")
    mp.delenv("TPUSLICE_DECODE_KERNEL", raising=False)
    jax.clear_caches()
    jcfg, tcfg = configs("fp32")
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 0), quantize=True)
    ref = JaxApiServer(JaxEngine(JaxLM(jcfg), jtree, **ENGINE),
                       tenants=TENANTS).start()
    port = ApiServer(ServingEngine(TpuLM(tcfg), ttree, device="cpu",
                                   **ENGINE), tenants=TENANTS).start()
    yield {"ref": ref.url, "port": port.url}
    port.stop()
    ref.stop()
    jax.clear_caches()
    mp.undo()


def _stream_of_completions(url) -> list:
    """The seeded stream; every answer, in order."""
    rng = np.random.default_rng(7)
    p = [rng.integers(1, 256, int(n)).tolist()
         for n in (20, 37, 9, 26, 15, 44)]
    out = []
    code, body = _call(url, "/v1/completions",
                       {"prompt": p[0], "max_tokens": 6})
    out.append((code, [c["token_ids"] for c in body["choices"]],
                [c["finish_reason"] for c in body["choices"]]))
    code, raw = _call(url, "/v1/completions",
                      {"prompt": p[1], "max_tokens": 6, "stream": True})
    out.append((code, _sse_tokens(raw)))
    code, body = _call(url, "/v1/completions",
                       {"prompt": p[2], "max_tokens": 5, "logprobs": True})
    lps = body["choices"][0].pop("logprobs")
    out.append((code, body["choices"], np.round(lps, 4).tolist()))
    # the last token of that answer as a stop sequence: the output
    # truncates before it
    toks = body["choices"][0]["token_ids"]
    code, body = _call(url, "/v1/completions",
                       {"prompt": p[2], "max_tokens": 5,
                        "stop": [[toks[-1]]]})
    out.append((code, body["choices"]))
    assert body["choices"][0]["finish_reason"] == "stop"
    assert body["choices"][0]["token_ids"] == toks[:toks.index(toks[-1])]
    code, body = _call(url, "/v1/completions",
                       {"prompt": p[3], "max_tokens": 4, "n": 2})
    out.append((code, body["choices"]))
    for tenant, prompt in (("gold", p[4]), ("bronze", p[5])):
        code, raw = _call(url, "/v1/completions",
                          {"prompt": prompt, "max_tokens": 5,
                           "stream": True, "logprobs": True},
                          headers={"X-Tenant": tenant})
        toks = _sse_tokens(raw)
        out.append((code, {i: (t, np.round(lp, 4).tolist(), f)
                           for i, (t, lp, f) in toks.items()}))
    # the head of the longest prompt again: a radix hit
    code, body = _call(url, "/v1/completions",
                       {"prompt": p[5][:32] + [3, 1, 4], "max_tokens": 5})
    out.append((code, body["choices"]))
    return out


def test_completion_stream_and_stats_match_the_reference(servers):
    want = _stream_of_completions(servers["ref"])
    got = _stream_of_completions(servers["port"])
    assert got == want
    assert all(r[0] == 200 for r in got)
    _, ref_stats = _call(servers["ref"], "/v1/stats")
    _, port_stats = _call(servers["port"], "/v1/stats")
    assert _keyshape(port_stats) == _keyshape(ref_stats)
    assert port_stats["engine"]["attention_route"] == "plain (cpu)"
    graphs = port_stats["engine"]["decode_graphs"]
    assert graphs["route"] == "eager (cpu)"
    assert graphs["graphs"] == {"decode_block": 0}
    assert graphs["budget"]["decode_block"] >= 1
    for key in ("hits", "misses", "inserted", "tokens_saved", "nodes",
                "tokens", "blocks", "digest"):
        assert port_stats["radix"][key] == ref_stats["radix"][key], key
    assert port_stats["radix"]["hits"] >= 1
    assert port_stats["kv"] == ref_stats["kv"]
    assert port_stats["kv"]["used"] == port_stats["radix"]["blocks"]
    assert port_stats["tokens_generated"] == ref_stats["tokens_generated"]


def _prefixes_and_drain(url) -> list:
    head = list(range(40, 72))
    out = [_call(url, "/v1/prefixes", {"tokens": head}),
           _call(url, "/v1/prefixes", {"tokens": head[:20]}),
           _call(url, "/v1/completions",
                 {"prompt": head + [9, 9], "max_tokens": 3}),
           _call(url, "/v1/prefixes", {"tokens": head}, method="DELETE"),
           _call(url, "/v1/prefixes", {"tokens": head}, method="DELETE"),
           _call(url, "/v1/drain", {"budget": 5}),
           _call(url, "/readyz"),
           _call(url, "/v1/completions", {"prompt": [1, 2], "max_tokens": 2}),
           _call(url, "/v1/drain", method="DELETE"),
           _call(url, "/readyz"),
           _call(url, "/v1/completions", {"prompt": [1, 2], "max_tokens": 2})]
    # error texts name the package; compare the codes and the keys there
    return [(code, sorted(body) if "error" in body else body)
            for code, body in out]


def test_prefixes_and_drain_answer_like_the_reference(servers):
    want = _prefixes_and_drain(servers["ref"])
    got = _prefixes_and_drain(servers["port"])
    assert got == want
    assert [c for c, _ in got] == [200, 400, 200, 200, 404, 200, 503, 503,
                                   200, 200, 200]


def test_reference_loadgen_drives_the_port_server(servers):
    res = subprocess.run(
        [sys.executable, "-m", "instaslice_tpu.serving.loadgen",
         "--url", servers["port"], "--requests", "8", "--concurrency", "4",
         "--prompt-len", "24", "--max-tokens", "5", "--vocab", "256",
         "--stream", "--seed", "3", "--timeout", "60",
         "--tenants", TENANTS],
        capture_output=True, text=True, timeout=180,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert res.returncode == 0, res.stdout + res.stderr
    assert report["outcomes"]["hung"] == 0
    assert report["outcomes"].get("ok") == 8, report["outcomes"]


def _session_routes(url) -> list:
    out = [_call(url, "/v1/sessions/export", {}),
           _call(url, "/v1/sessions/export", {"session_key": 5}),
           _call(url, "/v1/sessions/import", {}),
           _call(url, "/v1/completions", {"resume": 7}),
           _call(url, "/v1/drain", {"budget": 5, "migrate": True}),
           _call(url, "/v1/drain", method="DELETE")]
    return [(code, sorted(body) if "error" in body else body)
            for code, body in out]


def test_session_routes_answer_like_the_reference(servers):
    """With nothing in flight both servers export nothing, a resume of a
    rid never imported is refused alike, and a malformed import (no wire
    version) is the reference's 400."""
    want = _session_routes(servers["ref"])
    got = _session_routes(servers["port"])
    assert got == want
    assert got[0] == (200, {"migrated": 0})
    assert got[4][1]["migrated"] == 0
    bad = {"session": {"length": 4}}
    ref_code, _ = _call(servers["ref"], "/v1/sessions/import", bad)
    code, body = _call(servers["port"], "/v1/sessions/import", bad)
    assert code == ref_code == 400
    assert "wire version" in body["error"]


@pytest.mark.parametrize("flags,item", [
    (["--lora", "adapter"], "multi-LoRA"),
    (["--draft-n-layers", "1", "--draft-checkpoint", "EMPTY"],
     "orbax checkpoints are not read"),
    # --from-env serves stacked adapters over a tp mesh; adapter dirs
    # that hold no port checkpoint are refused before the process group
    (["--from-env", "--lora", "a", "--lora", "b"],
     "no multi-LoRA adapter checkpoint"),
    (["--checkpoint", "EMPTY"], "orbax checkpoints are not read"),
])
def test_unported_flags_refuse_before_anything_is_built(flags, item,
                                                        tmp_path,
                                                        monkeypatch):
    from instaslice_tpu_torch.serving import api_server
    if "--from-env" in flags:
        monkeypatch.setenv("WORLD_SIZE", "2")
    flags = [str(tmp_path) if f == "EMPTY" else f for f in flags]
    args = api_server.build_parser().parse_args(["--device", "cpu", *flags])
    with pytest.raises(SystemExit, match=item):
        api_server.build_engine(args)


def test_build_engine_restores_a_port_checkpoint(tmp_path, capsys):
    """A checkpoint of the port's training CLI serves: every weight of the
    engine is the checkpoint's, cast to the serving dtype."""
    import torch

    from instaslice_tpu_torch.cli import train_main
    from instaslice_tpu_torch.models.train import leaves
    from instaslice_tpu_torch.serving import api_server
    dims = ["--d-model", "64", "--n-heads", "2", "--n-layers", "2",
            "--d-ff", "128", "--vocab-size", "256"]
    assert train_main.main(["--device", "cpu", "--synthetic", "5000",
                            "--seq-len", "31", "--global-batch", "2",
                            "--steps", "2", "--checkpoint", str(tmp_path),
                            *dims]) == 0
    args = api_server.build_parser().parse_args(
        ["--device", "cpu", "--max-len", "64", "--prefill-len", "16",
         "--max-batch", "2", "--checkpoint", str(tmp_path), *dims])
    eng = api_server.build_engine(args)
    saved = torch.load(sorted(tmp_path.glob("step_*.pt"))[-1],
                       weights_only=True)["params"]
    got = leaves(eng.params)
    assert len(got) == len(saved)
    assert all(torch.equal(g, s.to(g.dtype)) for g, s in zip(got, saved))
    eng.add_request([1, 2, 3])
    assert len(eng.decode_block(2)) == 1


def _faulted_run(url) -> list:
    out = []
    for prompt in ([5, 6, 7], [8, 9, 10, 11], [12, 13], [5, 6, 7]):
        code, body = _call(url, "/v1/completions",
                           {"prompt": prompt, "max_tokens": 3})
        out.append((code, body["choices"][0]["token_ids"] if code == 200
                    else sorted(body)))
    _, stats = _call(url, "/v1/stats")
    out.append((stats["live_slots"], stats["kv"]["used"]
                == stats["radix"]["blocks"]))
    return out


def test_a_poisoned_prefill_recovers_like_the_reference(monkeypatch):
    """The same seeded fault plan (the second prefill dispatch fails and
    poisons the cache) on both servers: the failed request errors, the
    scheduler recovers the engine, later requests are served, nothing
    leaks; the port's answers are the reference's."""
    from instaslice_tpu.faults import FaultPlan as JaxFaultPlan
    from instaslice_tpu_torch.faults import FaultPlan

    monkeypatch.setenv("TPUSLICE_QUANT_KERNEL", "1")
    monkeypatch.delenv("TPUSLICE_DECODE_KERNEL", raising=False)
    jax.clear_caches()
    jcfg, tcfg = configs("fp32")
    jtree, ttree = both_params(jcfg, numpy_params(jcfg, 0), quantize=True)
    site = dict(at_calls=(2,), kinds=("poison",))
    ref = JaxApiServer(JaxEngine(JaxLM(jcfg), jtree, **ENGINE),
                       fault_plan=JaxFaultPlan(0).site("engine.prefill",
                                                       **site)).start()
    port = ApiServer(ServingEngine(TpuLM(tcfg), ttree, device="cpu",
                                   **ENGINE),
                     fault_plan=FaultPlan(0).site("engine.prefill",
                                                  **site)).start()
    try:
        want, got = _faulted_run(ref.url), _faulted_run(port.url)
    finally:
        port.stop()
        ref.stop()
        jax.clear_caches()
    assert got == want
    assert [r[0] for r in got[:4]] == [200, 500, 200, 200]
    assert got[0][1] == got[3][1] and got[4] == (0, True)
