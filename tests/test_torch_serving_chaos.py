"""The serving-plane chaos tier on the port's server
(``instaslice_tpu_torch/serving/api_server.py``) over a tiny CPU model:
the cases of the reference's ``tests/test_serving_chaos.py``.

- faults everywhere (a seeded ``FaultPlan`` over the engine's decode and
  prefill and the scheduler's rounds) plus a mid-run drain, beside a
  fault-wrapped ``SimCluster`` on H100 80GB nodes churning ``1g.10gb``
  pods: every request terminal (none hung), the metrics ledger equal to
  the requests sent, the journal's shed and drained events equal to the
  metrics', one drain cycle, chains legal, the same server serving after
  the faults stop, no GPU slot granted twice;
- the drain lifecycle and the bounded queue's 429: each answers, status
  for status, as the reference's server (its JAX engine) does over the
  same script;
- shutdown latency of the server and the sim;
- the loadgen's client percentiles reconciling with the server's
  histograms;
- the scheduler surviving injected round faults;
- the preempt ledger under faults (scheduler counters, journal events,
  engine totals and metrics equal; the KV pool reconciled).

The control lifts the admission bound (``max_queue=0``): the request
past it is no longer shed with 429, and the check misses.

Seeded by ``CHAOS_SEED`` (printed) like ``test_torch_chaos.py``.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from instaslice_tpu_torch.analysis import validate_events
from instaslice_tpu_torch.api.constants import (
    REASON_DRAIN_BEGIN,
    REASON_DRAIN_END,
    REASON_DRAINED,
    REASON_PREEMPTED,
    REASON_RESUMED,
    REASON_SHED,
)
from instaslice_tpu_torch.analysis import chaos_smoke as cs
from instaslice_tpu_torch.faults import FaultPlan
from instaslice_tpu_torch.metrics.metrics import ServingMetrics, render
from instaslice_tpu_torch.obs.journal import get_journal, reset_journal
from instaslice_tpu_torch.serving import loadgen
from instaslice_tpu_torch.serving.api_server import ApiServer
from instaslice_tpu_torch.sim import SimCluster

CHAOS_SEED = int(os.environ.get("CHAOS_SEED", "1234"))
VOCAB = 64
OUTCOME_LABELS = ("ok", "error", "timeout", "rejected", "shed", "drained")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _lockcheck():
    from instaslice_tpu_torch.utils import lockcheck

    yield
    if lockcheck.armed():
        assert not lockcheck.report()["cycles"], lockcheck.report()


def engine(max_batch=4, **kw):
    """The drives' tiny model (``analysis/drive.py``'s widths, seeded
    weights) in a CPU engine."""
    from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM, init_params
    from instaslice_tpu_torch.serving import ServingEngine

    cfg = ModelConfig(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2,
                      d_ff=64, dtype=torch.float32, remat=False)
    return ServingEngine(TpuLM(cfg), init_params(cfg, 0, device="cpu"),
                         device="cpu", max_batch=max_batch, max_len=64,
                         prefill_len=8, **kw)


def post(url, payload, path="/v1/completions", method="POST", timeout=60):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode()), dict(e.headers)


def get(url, path, timeout=10):
    try:
        with urllib.request.urlopen(url + path, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def outcome_counts(metrics) -> dict:
    out = {}
    for label in OUTCOME_LABELS:
        v = metrics.registry.get_sample_value(
            "tpuslice_serve_requests_total", {"outcome": label})
        if v:
            out[label] = int(v)
    return out


def ref_engine(max_batch):
    """The reference's JAX engine at the same widths (its own seeded
    weights: the scripts below compare status codes, not tokens)."""
    import jax
    import jax.numpy as jnp

    from instaslice_tpu.models.lm import ModelConfig, TpuLM
    from instaslice_tpu.serving import ServingEngine

    cfg = ModelConfig(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2,
                      d_ff=64, dtype=jnp.float32, remat=False)
    m = TpuLM(cfg)
    return ServingEngine(m, m.init(jax.random.key(0)), max_batch=max_batch,
                         max_len=64, prefill_len=8)


def _wait(pred, timeout):
    assert cs.wait_for(pred, timeout, 0.01), "condition never held"


# ------------------------------------------------------- faults everywhere


def test_faults_everywhere_plus_midrun_drain():
    print(f"chaos params: CHAOS_SEED={CHAOS_SEED}")
    reset_journal()
    eng = engine()
    plan = (FaultPlan(CHAOS_SEED)
            .site("engine.decode", probability=0.05,
                  kinds=("poison", "error", "delay"), max_fires=12,
                  at_calls={3, 9}, delay_s=0.02)
            .site("engine.prefill", probability=0.04,
                  kinds=("poison", "error"), max_fires=8)
            .site("scheduler.round", probability=0.005,
                  kinds=("error", "delay"), max_fires=10, delay_s=0.02))
    # the control plane's plan is armed once the cluster is up: faults in
    # __init__ hit the main thread, faults in the loops are under test
    cp_plan = FaultPlan(CHAOS_SEED + 1)
    metrics = ServingMetrics()
    sim = SimCluster(n_nodes=1, gpus_per_node=2, deletion_grace_seconds=0.1,
                     health_interval=0.1, fault_plan=cp_plan).start()
    cp_plan.site("kube.request", probability=0.04,
                 kinds=("http-503", "conn-reset", "http-429"), max_fires=60)
    cp_plan.site("kube.watch", probability=0.01, kinds=("disconnect",),
                 max_fires=20)
    cp_plan.site("device.reserve", probability=0.05, kinds=("error",),
                 max_fires=10)
    churn_stop = threading.Event()
    churned = []

    def churn():
        i = 0
        while not churn_stop.is_set():
            name = f"chaos-{i}"
            try:
                sim.submit(name, "1g.10gb")
                churned.append(name)
            except Exception as e:  # noqa: BLE001 - an injected flake
                print(f"submit {name}: {e}")
            if len(churned) >= 3 and i % 2:
                victim = churned.pop(0)
                try:
                    sim.delete_pod(victim)
                except Exception as e:  # noqa: BLE001 - an injected flake
                    print(f"delete {victim}: {e}")
            i += 1
            churn_stop.wait(0.4)

    n_requests = 60
    try:
        with ApiServer(eng, block_size=4, metrics=metrics,
                       request_timeout=20, max_queue=10,
                       drain_budget=5.0, fault_plan=plan) as srv:
            for _ in range(3):  # a fault may fire mid-warm-up
                code, out, _ = post(srv.url, {"prompt": [1, 2, 3],
                                              "max_tokens": 2})
                if code == 200:
                    break
            assert code == 200, out
            warm = outcome_counts(metrics)
            churner = threading.Thread(target=churn, daemon=True)
            churner.start()
            drain_log = []

            def mid_run_drain():
                pacer = threading.Event()
                pacer.wait(1.5)
                drain_log.append(post(srv.url, {"budget": 0.5},
                                      path="/v1/drain")[:2])
                drain_log.append(get(srv.url, "/readyz")[0])
                pacer.wait(1.5)
                drain_log.append(post(srv.url, {}, path="/v1/drain",
                                      method="DELETE")[:2])
                drain_log.append(get(srv.url, "/readyz")[0])

            drainer = threading.Thread(target=mid_run_drain, daemon=True)
            drainer.start()
            report = loadgen.run(srv.url, requests=n_requests,
                                 concurrency=8, prompt_len=8, max_tokens=8,
                                 vocab=VOCAB, stream=False, timeout=60,
                                 seed=CHAOS_SEED)
            drainer.join(timeout=30)
            assert not drainer.is_alive(), "drain thread stuck"
            churn_stop.set()
            churner.join(timeout=10)
            print("loadgen:", json.dumps(report))
            print("faults:", json.dumps(plan.stats()))
            (code, body), ready_draining, (code2, body2), ready = drain_log
            assert code == 200 and body["draining"], body
            assert ready_draining == 503 and ready == 200
            assert code2 == 200 and not body2["draining"], body2
            # 1. every request terminal
            assert report["outcomes"]["hung"] == 0, report
            assert sum(report["outcomes"].values()) == n_requests
            # 2. one metrics outcome per request
            counted = outcome_counts(metrics)
            assert sum(counted.values()) - sum(warm.values()) == \
                n_requests, (warm, counted)
            # 3. faults fired
            assert sum(s["fired"] for s in plan.stats().values()) > 0
            # 3b. the journal agrees with the metrics
            jc = get_journal().counts()
            assert jc.get(REASON_SHED, 0) == \
                counted.get("shed", 0) - warm.get("shed", 0), (jc, counted)
            assert jc.get(REASON_DRAINED, 0) == \
                counted.get("drained", 0) - warm.get("drained", 0)
            assert jc.get(REASON_DRAIN_BEGIN, 0) == 1
            assert jc.get(REASON_DRAIN_END, 0) == 1
            # 3c. chains legal under faults and churn
            errs = validate_events.check_chains(
                [e.to_dict() for e in get_journal().events()], strict=False)
            assert errs == [], errs
            # 3d. the journal is live on the serving plane
            code, out = get(srv.url,
                            f"/v1/debug/events?reason={REASON_DRAIN_BEGIN}")
            assert code == 200
            assert [e["reason"] for e in out["events"]] == \
                [REASON_DRAIN_BEGIN]
            # 4. recovery: faults off, the same server serves
            eng.fault_hook = None
            srv.scheduler.fault_hook = None
            for _ in range(3):
                code, out, _ = post(srv.url, {"prompt": [5, 9, 2, 7],
                                              "max_tokens": 4})
                assert code == 200, out
                assert len(out["choices"][0]["token_ids"]) == 4
            # 5. the control plane did not wedge
            phases = {}

            def settled():
                assert cs.no_double_grant(sim) == []
                phases.update({p: sim.pod_phase(p) for p in churned})
                return all(ph in ("Running", "Pending", "Gone")
                           for ph in phases.values())

            cs.wait_for(settled, 30, 0.2)
            bad = {p: ph for p, ph in phases.items()
                   if ph not in ("Running", "Pending", "Gone")}
            assert not bad, f"pods wedged under kube faults: {bad}"
    finally:
        churn_stop.set()
        sim.stop()


# ---------------------------------------------------- drain, bounded queue


def drain_script(srv, eng) -> list:
    """The drain lifecycle with no faults; the status codes seen."""
    out = [get(srv.url, "/readyz")[0]]
    results = {}
    t = threading.Thread(target=lambda: results.update(long=post(
        srv.url, {"prompt": [1, 2, 3], "max_tokens": 48})), daemon=True)
    t.start()
    _wait(lambda: eng.slots, 60)
    code, body, _ = post(srv.url, {"budget": 0.0}, path="/v1/drain")
    out.append(code)
    out.append(get(srv.url, "/readyz")[0])
    code, _, headers = post(srv.url, {"prompt": [4, 5], "max_tokens": 4})
    out.append((code, "Retry-After" in headers))
    t.join(timeout=30)
    out.append(("long hung", t.is_alive()))
    out.append(results["long"][0])
    out.append(("quiesced", srv.scheduler.drained.wait(10)))
    code, body, _ = post(srv.url, {}, path="/v1/drain", method="DELETE")
    out.append((code, body["draining"]))
    out.append(get(srv.url, "/readyz")[0])
    out.append(post(srv.url, {"prompt": [5, 9, 2, 7], "max_tokens": 4})[0])
    return out


def queue_script(srv, eng) -> list:
    """One request decoding, one queued behind it, a third past the
    bound; the codes seen."""
    results = []
    lock = threading.Lock()

    def fire(max_tokens):
        r = post(srv.url, {"prompt": [1, 2, 3], "max_tokens": max_tokens})
        with lock:
            results.append(r[0])

    t1 = threading.Thread(target=fire, args=(48,), daemon=True)
    t1.start()
    _wait(lambda: eng.slots, 60)
    t2 = threading.Thread(target=fire, args=(4,), daemon=True)
    t2.start()
    _wait(lambda: srv.scheduler.queue.qsize() or
          srv.scheduler._head is not None, 10)
    code, _, headers = post(srv.url, {"prompt": [7, 8], "max_tokens": 4})
    t1.join(timeout=60)
    t2.join(timeout=60)
    return [(code, "Retry-After" in headers), sorted(results)]


def run_script(script, ApiServer_, eng, **kw):
    with ApiServer_(eng, block_size=4, request_timeout=30, **kw) as srv:
        return script(srv, eng)


@pytest.fixture(scope="module")
def reference_codes():
    from instaslice_tpu.serving.api_server import ApiServer as RefServer

    return {
        "drain": run_script(drain_script, RefServer, ref_engine(1)),
        "queue": run_script(queue_script, RefServer, ref_engine(1),
                            max_queue=1),
    }


def test_drain_lifecycle_answers_as_the_reference(reference_codes):
    got = run_script(drain_script, ApiServer, engine(max_batch=1))
    assert got == reference_codes["drain"]
    assert got == [200, 200, 503, (503, True), ("long hung", False), 503,
                   ("quiesced", True), (200, False), 200, 200]


def test_bounded_queue_sheds_with_429_as_the_reference(reference_codes):
    got = run_script(queue_script, ApiServer, engine(max_batch=1),
                     max_queue=1)
    assert got == reference_codes["queue"]
    assert got == [(429, True), [200, 200]]


def test_control_no_admission_bound_never_sheds():
    got = run_script(queue_script, ApiServer, engine(max_batch=1),
                     max_queue=0)
    assert got[0] != (429, True), got


# ------------------------------------------------------- shutdown latency


def test_shutdown_latency():
    srv = ApiServer(engine(max_batch=2), block_size=4,
                    request_timeout=30).start()
    code, out, _ = post(srv.url, {"prompt": [1, 2, 3], "max_tokens": 2})
    assert code == 200, out
    t0 = time.monotonic()
    srv.stop()
    assert time.monotonic() - t0 < 3.0, "ApiServer.stop() paced on a sleep"
    sim = SimCluster(n_nodes=1, gpus_per_node=1, deletion_grace_seconds=0.1,
                     health_interval=0.1).start()
    try:
        sim.submit("shutdown-latency-pod", "1g.10gb")
        assert sim.wait_phase("shutdown-latency-pod", "Running", 20)
    finally:
        t0 = time.monotonic()
        sim.stop()
        dt = time.monotonic() - t0
    assert dt < 3.0, f"SimCluster.stop() took {dt:.2f} s"


# --------------------------------------------- client vs server histograms


def test_client_percentiles_reconcile_with_server_histograms():
    metrics = ServingMetrics()
    with ApiServer(engine(), block_size=4, metrics=metrics,
                   request_timeout=60) as srv:
        code, out, _ = post(srv.url, {"prompt": [1, 2, 3], "max_tokens": 2})
        assert code == 200, out

        def sample(name, labels=None):
            return metrics.registry.get_sample_value(name, labels or {}) \
                or 0.0

        names = [f"tpuslice_serve_{m}_seconds_{s}" for m in
                 ("ttft", "tpot", "request") for s in ("count", "sum")]
        warm = {n: sample(n) for n in names}
        n = 24
        report = loadgen.run(srv.url, requests=n, concurrency=4,
                             prompt_len=8, max_tokens=8, vocab=VOCAB,
                             stream=True, timeout=60, seed=CHAOS_SEED)
        assert report["outcomes"]["hung"] == 0 and report["ok"] == n

        def delta(name):
            return sample(name) - warm[name]

        for m in ("ttft", "tpot", "request"):
            assert delta(f"tpuslice_serve_{m}_seconds_count") == n, m
        ttft = delta("tpuslice_serve_ttft_seconds_sum") / n
        assert ttft <= report["ttft_mean"] + 0.25
        assert report["ttft_mean"] <= ttft + 2.0
        tpot = delta("tpuslice_serve_tpot_seconds_sum") / n
        assert 0.0 <= tpot <= report["tpot_p99"] + 0.25
        req = delta("tpuslice_serve_request_seconds_sum") / n
        assert abs(req - report["mean_latency"]) <= \
            0.5 + 0.5 * report["mean_latency"]
        assert sample("tpuslice_serve_step_seconds_count",
                      {"phase": "prefill"}) >= 1
        assert sample("tpuslice_serve_step_seconds_count",
                      {"phase": "decode"}) >= 1
        assert sample("tpuslice_serve_phase_seconds_total",
                      {"phase": "decode"}) > 0
        text = render(metrics)
        assert "tpuslice_serve_batch_occupancy" in text
        assert "tpuslice_serve_kv_cache_utilization" in text


# ------------------------------------------------------ round faults


def test_scheduler_survives_injected_round_faults():
    plan = FaultPlan(CHAOS_SEED).site(
        "scheduler.round", at_calls={1, 2, 3, 5, 8}, kinds=("error",))
    with ApiServer(engine(max_batch=2), block_size=4, request_timeout=30,
                   fault_plan=plan) as srv:
        for _ in range(3):
            code, out, _ = post(srv.url, {"prompt": [5, 9, 2, 7],
                                          "max_tokens": 4})
            assert code == 200, out
        assert srv.scheduler.is_alive()
        assert plan.stats()["scheduler.round"]["fired"] >= 3


# ------------------------------------------------------ preempt ledger


def test_preempt_ledger_reconciles_under_faults():
    print(f"chaos params: CHAOS_SEED={CHAOS_SEED}")
    reset_journal()
    eng = engine(max_batch=2, kv_block_size=8)
    plan = (FaultPlan(CHAOS_SEED)
            .site("engine.decode", probability=0.03,
                  kinds=("error", "delay"), max_fires=6, delay_s=0.02)
            .site("engine.prefill", probability=0.03, kinds=("error",),
                  max_fires=4))
    metrics = ServingMetrics()
    n = 30
    tenants = "gold:2:latency:1.0,bronze:1:best-effort"
    with ApiServer(eng, block_size=4, metrics=metrics, request_timeout=60,
                   fault_plan=plan, tenants=tenants,
                   preempt_margin=0.05) as srv:
        for _ in range(3):
            code, out, _ = post(srv.url, {"prompt": [1, 2, 3],
                                          "max_tokens": 2})
            if code == 200:
                break
        assert code == 200, out
        report = loadgen.run(srv.url, requests=n, concurrency=6,
                             prompt_len=8, max_tokens=24, vocab=VOCAB,
                             stream=False, timeout=60, seed=CHAOS_SEED,
                             jitter=0.7, tenants=tenants)
        stats = srv.scheduler.stats()
        print("sched:", json.dumps({k: stats[k] for k in (
            "preempted", "resumed", "parked_shed", "parked")}))
        assert report["outcomes"]["hung"] == 0, report
        assert sum(report["outcomes"].values()) == n
        jc = get_journal().counts()
        assert jc.get(REASON_PREEMPTED, 0) == stats["preempted"]
        assert jc.get(REASON_RESUMED, 0) == stats["resumed"]
        assert eng.preempted_total == stats["preempted"]
        assert eng.resumed_total == stats["resumed"]
        assert int(metrics.registry.get_sample_value(
            "tpuslice_serve_preemptions_total") or 0) == stats["preempted"]
        assert int(metrics.registry.get_sample_value(
            "tpuslice_serve_resumes_total") or 0) == stats["resumed"]
        assert stats["preempted"] == (stats["resumed"]
                                      + stats["parked_shed"]
                                      + stats["parked"])
        _wait(lambda: not eng.slots and not eng.parked, 10)
        assert eng.kv.used_blocks() == eng.radix.pool_blocks(), \
            eng.kv.stats()
        assert not eng._radix_locks
        srv.scheduler.control(lambda: eng.radix.reclaim(10 ** 9))
        assert eng.kv.used_blocks() == 0, eng.kv.stats()
        eng.fault_hook = None
        srv.scheduler.fault_hook = None
        code, out, _ = post(srv.url, {"prompt": [5, 9, 2, 7],
                                      "max_tokens": 4})
        assert code == 200, out
