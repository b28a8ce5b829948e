"""The port's load generator (``instaslice_tpu_torch/serving/loadgen.py``)
and the two fleet tools' console scripts.

- The port's ``run`` and the reference's, with the same seed and
  arguments against the same tiny port server (``device="cpu"``), issue
  the same requests in the same order, write the same recorded trace
  byte for byte (one request at a time, on a stepped clock, so the
  recorded arrival offsets are the script's), and report the same keys.
- ``_classify`` and ``_percentile`` equal the reference's on seeded
  inputs; record then replay regenerates the identical stream, and a
  trace at another version is refused.
- ``tpuslice-gpu-loadgen`` and ``tpuslice-gpu-router``, resolved from
  ``pyproject.toml``'s scripts, each run once as a process.
"""

import importlib.util
import json
import random
import re
import subprocess
import sys
import time
import tomllib
import urllib.request

import pytest
import torch

from instaslice_tpu.serving import loadgen as ref_loadgen
from instaslice_tpu_torch.models.lm import TpuLM
from instaslice_tpu_torch.serving import ServingEngine
from instaslice_tpu_torch.serving import loadgen
from instaslice_tpu_torch.serving.api_server import ApiServer
from torch_port_util import REPO, both_params, configs, numpy_params

ENGINE = dict(max_batch=4, max_len=96, prefill_len=8)
TENANTS = "gold:3:latency:2.0,bronze:1:best-effort"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def server():
    jcfg, tcfg = configs("fp32")
    tree = both_params(jcfg, numpy_params(jcfg, 0), quantize=False)[1]
    eng = ServingEngine(TpuLM(tcfg), tree, device="cpu", **ENGINE)
    with ApiServer(eng, block_size=4) as srv:
        yield srv


class SteppedClock:
    """``time`` for a loadgen module: ``monotonic`` advances a fixed step
    per call, so one worker's calls read the same values on every run."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        self.now += 0.001
        return self.now

    @staticmethod
    def sleep(s):
        time.sleep(s)


def _issued(mod, monkeypatch):
    """Record each request ``mod`` issues, then send it on."""
    seen = []
    real = mod._one_request

    def spy(url, prompt, max_tokens, stream, timeout, **kw):
        seen.append((list(prompt), max_tokens, stream, kw["adapter"],
                     kw["tenant"]))
        return real(url, prompt, max_tokens, stream, timeout, **kw)

    monkeypatch.setattr(mod, "_one_request", spy)
    monkeypatch.setattr(mod, "time", SteppedClock())
    return seen


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "sync"])
def test_requests_trace_and_report_keys_equal_the_reference(
        server, tmp_path, monkeypatch, stream):
    runs = {}
    for name, mod in (("ref", ref_loadgen), ("port", loadgen)):
        seen = _issued(mod, monkeypatch)
        path = tmp_path / f"{name}.jsonl"
        out = mod.run(server.url, 6, 1, 10, 4, 64, stream, 60.0, seed=5,
                      adapters=["", ""], tenants=TENANTS, jitter=0.5,
                      prefix_pool="2:16", record_trace=str(path))
        runs[name] = (seen, path.read_bytes(), out)
    (want_seen, want_trace, want), (seen, trace, out) = \
        runs["ref"], runs["port"]
    assert seen == want_seen and len(seen) == 6
    assert trace == want_trace
    assert _keys(out) == _keys(want)
    assert out["ok"] == want["ok"] == 6 and out["errors"] == 0
    assert out["prefix_pool"] == want["prefix_pool"]
    assert out["client_tokens"] == want["client_tokens"]
    assert set(out["tenants"]) == {"gold", "bronze"}


def test_smoke_fleet_step_expects_the_reference_report_keys(server):
    """``chip_smoke.py``'s fleet step holds the port's loadgen report to
    ``FLEET_LOADGEN_KEYS`` on the card, where the reference cannot run:
    they are the reference's keys for the same kind of run."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    seed = smoke.FLEET_LOADGEN[-1]
    for mod in (ref_loadgen, loadgen):
        out = mod.run(server.url, 4, 2, 6, 3, 64, True, 60.0, seed=seed)
        assert out["errors"] == 0
        assert set(out) == set(smoke.FLEET_LOADGEN_KEYS), mod.__name__


def test_classify_and_percentile_equal_the_reference():
    rng = random.Random(0)
    errs = [None, "HTTPError 429: shed", "HTTPError 503: draining",
            "TimeoutError: timed out", "replica stream died: x",
            "stream ended without [DONE]", "no routable replica (1 "
            "gray-ejected)", "ConnectionResetError: reset",
            "replica ejected", "boom"]
    for _ in range(500):
        args = (rng.choice(errs), rng.choice([None, 200, 400, 429, 503]),
                rng.randint(0, 3), rng.random() < 0.5)
        assert loadgen._classify(*args) == ref_loadgen._classify(*args)
    for n in range(12):
        xs = [rng.random() for _ in range(n)]
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            assert loadgen._percentile(xs, q) == \
                ref_loadgen._percentile(xs, q)
    assert loadgen.OUTCOMES == ref_loadgen.OUTCOMES
    assert loadgen.TRACE_VERSION == ref_loadgen.TRACE_VERSION


def test_record_then_replay_fires_the_identical_stream(server, tmp_path,
                                                       monkeypatch):
    seen = _issued(loadgen, monkeypatch)
    path = str(tmp_path / "t.jsonl")
    rec = loadgen.run(server.url, 6, 3, 10, 4, 64, False, 60.0, seed=5,
                      jitter=0.5, prefix_pool="2:16", tenants=TENANTS,
                      record_trace=path)
    recorded = sorted(map(repr, seen))
    seen.clear()
    rep = loadgen.run(server.url, 999, 3, 999, 999, 999, False, 60.0,
                      seed=777, replay_trace=path)
    assert rec["ok"] == rep["ok"] == 6 and rep["errors"] == 0
    assert sorted(map(repr, seen)) == recorded
    assert rep["trace"] == {"replayed": path, "requests": 6}
    assert rep["prefix_pool"] == rec["prefix_pool"]


def test_a_trace_at_another_version_is_refused(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text(json.dumps(
        {"trace_version": loadgen.TRACE_VERSION + 1, "vocab": 64})
        + "\n" + json.dumps({"i": 0}) + "\n")
    with pytest.raises(ValueError, match="version"):
        loadgen._read_trace(str(path))
    res = _script("tpuslice-gpu-loadgen", "--url", "http://127.0.0.1:9",
                  "--replay-trace", str(path))
    assert res.returncode == 1
    assert "version" in json.loads(res.stdout)["error"]


def _script_argv(name, *args):
    """The command line of a console script of ``pyproject.toml``."""
    with open(REPO / "pyproject.toml", "rb") as f:
        target = tomllib.load(f)["project"]["scripts"][name]
    mod, fn = target.split(":")
    return [sys.executable, "-c",
            f"import sys; from {mod} import {fn}; "
            f"sys.exit({fn}(sys.argv[1:]))", *args]


def _script(name, *args):
    """Run a console script of ``pyproject.toml`` as its own process."""
    return subprocess.run(_script_argv(name, *args), cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_loadgen_script_runs(server):
    res = _script("tpuslice-gpu-loadgen", "--url", server.url,
                  "--requests", "4", "--concurrency", "2", "--prompt-len",
                  "6", "--max-tokens", "3", "--vocab", "64", "--stream")
    assert res.returncode == 0, res.stdout + res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["ok"] == 4 and out["outcomes"]["ok"] == 4
    assert out["client_tokens"] == 12 and "ttft_p50" in out


def test_router_script_routes(server):
    proc = subprocess.Popen(
        _script_argv("tpuslice-gpu-router", "--host", "127.0.0.1",
                     "--port", "0", "--replica", server.url),
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        url = None
        deadline = time.monotonic() + 60
        while url is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            m = re.search(r"routing 1 replica\(s\) on (http://\S+)", line)
            url = m.group(1) if m else None
        assert url, "the router never said where it listens"
        req = urllib.request.Request(
            url + "/v1/completions",
            data=json.dumps({"prompt": [1, 2, 3], "max_tokens": 3})
            .encode(), headers={"Content-Type": "application/json"},
            method="POST")
        out = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert len(out["choices"][0]["token_ids"]) == 3
        stats = json.loads(urllib.request.urlopen(
            url + "/v1/stats", timeout=10).read())
        assert list(stats["replicas"]) == [server.url]
        assert stats["routed"] == {"least-loaded": 1}
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()

