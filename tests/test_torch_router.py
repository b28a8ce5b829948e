"""The port's fleet router (``instaslice_tpu_torch/serving/router.py``),
held against the reference's (``instaslice_tpu/serving/router.py``).

- **The policy.** Both ``Router``s are fed the same seeded replica stats
  (``Replica.adopt_stats``, or a poll through ``_poll_one`` with the
  HTTP call stubbed), the same prompts, tenants, sessions and exclusions,
  and must make the same ``route`` and ``migration_destinations``
  decisions: policy order, the longest prefix chain, KV pressure and
  tenant class, restart detection, breaker and draining, stale polls.
  Two controls put a wrong rule into the port and miss: ``prefix_match``
  returning 0, and the tenant classes' queue weights swapped.
- **Over HTTP.** Each router in turn fronts two tiny fp32 port servers
  (``device="cpu"``), built the same way for both, and runs one script:
  a routed completion against the oracle, a mid-stream and a synchronous
  migration token-identical, a failed export parking, the client's
  ``resume`` field stripped, an import at another wire version a 400, a
  gray-failure ejection and readmission driven through
  ``observe_latency`` with fixed samples (the journal reads
  ``ReplicaEjected`` then ``ReplicaReadmitted``; the ejected replica's
  drain exports the session that had just migrated onto it a second
  time), and ``remove_replica`` draining a live stream with no 503. Both
  routers' results and ``stats()`` counters must be equal.
"""

import json
import random
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from instaslice_tpu.obs.journal import get_journal as ref_journal
from instaslice_tpu.serving import router as ref_router
from instaslice_tpu_torch.api.constants import (
    REASON_REPLICA_EJECTED,
    REASON_REPLICA_READMITTED,
)
from instaslice_tpu_torch.models.lm import TpuLM
from instaslice_tpu_torch.obs.journal import get_journal
from instaslice_tpu_torch.serving import ServingEngine
from instaslice_tpu_torch.serving import kvcache as tkv
from instaslice_tpu_torch.serving import router as port_router
from instaslice_tpu_torch.serving.api_server import ApiServer
from torch_port_util import both_params, configs, numpy_params

GRANULE = 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chain_for(prompt, granule=GRANULE):
    """The hash chain a replica advertises for ``prompt`` (the port's
    granule hash: the servers behind either router are the port's)."""
    return [tkv.granule_hash(tuple(prompt[i * granule:(i + 1) * granule]))
            for i in range(len(prompt) // granule)]


def stats_for(queued=0, live=0, parked=0, kv_free=100, kv_total=100,
              max_batch=8, chains=(), replica_id="r", uptime=10.0,
              tenant_classes=None) -> dict:
    return {
        "replica_id": replica_id, "uptime_seconds": uptime,
        "queued": queued, "live_slots": live, "parked": parked,
        "max_batch": max_batch,
        "kv": {"free": kv_free, "total": kv_total},
        "radix": {"digest": {"granule": GRANULE,
                             "paths": [list(c) for c in chains]}},
        "tenant_classes": tenant_classes or {},
    }


def unstarted(mod, reps, **kw):
    """A router of ``mod`` that opens no socket to anything: replicas
    injected with their stats already adopted, polls stubbed."""
    r = mod.Router(port=0, hedge_after=0, **kw)
    r._srv.server_close()
    for rep in reps:
        r._replicas[rep.url] = rep
    return r


def fed(mod, url, **kw):
    rep = mod.Replica(url)
    rep.adopt_stats(stats_for(**kw))
    return rep


def _decide(r, mod, prompt, tenant="", session="", exclude=()):
    try:
        rep, policy = r.route(prompt, tenant, session, exclude=exclude)
    except mod.NoReplica:
        return "no-replica"
    return rep.url, policy


URLS = [f"http://127.0.0.1:{9 + i}" for i in range(4)]


def policy_script(mod, seed=0, n=150):
    """Every decision of the policy on one seeded sequence of stats,
    prompts, tenants and sessions. Returns the list of decisions."""
    out = []
    p16 = list(range(1, 17))
    p24 = list(range(1, 25))
    # 1. policy order: session beats prefix beats least-loaded
    idle = fed(mod, URLS[0], replica_id="a")
    cached = fed(mod, URLS[1], replica_id="b", chains=[chain_for(p16)],
                 queued=3)
    r = unstarted(mod, [idle, cached])
    out.append(_decide(r, mod, [99, 98, 97]))
    out.append(_decide(r, mod, p16))
    r.pin_session("conv", URLS[0])
    out.append(_decide(r, mod, p16, session="conv"))
    # 2. the longest advertised chain wins over load; a sub-granule
    # prompt matches nothing
    short = fed(mod, URLS[0], replica_id="a", chains=[chain_for(p24[:8])])
    long = fed(mod, URLS[1], replica_id="b", chains=[chain_for(p24)],
               queued=5)
    r = unstarted(mod, [short, long])
    out.append(_decide(r, mod, p24))
    out.append(_decide(r, mod, p24[:4]))
    # 3. KV pressure, then the tenant class's queue weight
    starved = fed(mod, URLS[0], replica_id="a", kv_free=5)
    roomy = fed(mod, URLS[1], replica_id="b", kv_free=95)
    out.append(_decide(unstarted(mod, [starved, roomy]), mod, [1, 2, 3]))
    classes = {"gold": "latency", "bronze": "best-effort"}
    queued = fed(mod, URLS[0], replica_id="a", queued=4,
                 tenant_classes=classes)
    busy = fed(mod, URLS[1], replica_id="b", live=5, kv_free=80)
    r = unstarted(mod, [queued, busy])
    for tenant in ("gold", "bronze", "", "nobody"):
        out.append(_decide(r, mod, [1, 2, 3], tenant=tenant))
    # 4. restart detection through a stubbed poll: a new nonce, or the
    # uptime going backwards, drops the replica's session affinities
    a = fed(mod, URLS[0], replica_id="one", uptime=50.0)
    b = fed(mod, URLS[1], replica_id="x")
    r = unstarted(mod, [a, b])
    for rid, up in (("one", 60.0), ("two", 1.0), ("two", 0.2)):
        r.pin_session("conv", URLS[0])
        r._hedged_stats = (lambda st: lambda rep: (200, st, 0.01))(
            stats_for(replica_id=rid, uptime=up, queued=9))
        r._poll_one(a)
        out.append(("restart", rid, up, a.replica_id, a.uptime))
        out.append(_decide(r, mod, [4, 5], session="conv"))
    # 5. an open breaker, then draining, drop out
    a = fed(mod, URLS[0], replica_id="a")
    b = fed(mod, URLS[1], replica_id="b", queued=2)
    r = unstarted(mod, [a, b])
    out.append(_decide(r, mod, [1]))
    for _ in range(a.breaker.threshold):
        a.breaker.fail()
    out.append(_decide(r, mod, [1]))
    b.draining = True
    out.append(_decide(r, mod, [1]))
    # 6. a stale poll drops out (the poll's clock moved back by hand)
    a = fed(mod, URLS[0], replica_id="a")
    b = fed(mod, URLS[1], replica_id="b", queued=6)
    r = unstarted(mod, [a, b], stale_after=3.0)
    out.append(_decide(r, mod, [1]))
    a.last_poll -= 10.0
    out.append(_decide(r, mod, [1]))
    # 7. migration destinations: prefix first, then load
    dcached = fed(mod, URLS[0], replica_id="a", chains=[chain_for(p16)],
                  queued=5)
    didle = fed(mod, URLS[1], replica_id="b")
    dsrc = fed(mod, URLS[2], replica_id="c")
    r = unstarted(mod, [dcached, didle, dsrc])
    out.append([d.url for d in r.migration_destinations(
        exclude=[URLS[2]], prompt=p16)])
    # 8. a seeded sweep over all of it at once
    rng = random.Random(seed)
    heads = [[rng.randrange(1, 64) for _ in range(32)] for _ in range(3)]
    for _ in range(n):
        reps = []
        for i in range(rng.randint(2, 4)):
            head = rng.choice(heads)
            chains = [chain_for(head[:GRANULE * rng.randint(1, 4)])
                      for _ in range(rng.randint(0, 2))]
            total = rng.choice((64, 100, 256))
            rep = fed(
                mod, URLS[i], replica_id=f"r{i}",
                queued=rng.randint(0, 6), live=rng.randint(0, 8),
                parked=rng.randint(0, 2), kv_free=rng.randint(0, total),
                kv_total=total, max_batch=rng.choice((4, 8)),
                chains=chains,
                tenant_classes=classes if rng.random() < 0.5 else {})
            rep.draining = rng.random() < 0.1
            rep.ejected = rng.random() < 0.1
            if rng.random() < 0.1:
                for _ in range(rep.breaker.threshold):
                    rep.breaker.fail()
            if rng.random() < 0.1:
                rep.last_poll -= 10.0
            reps.append(rep)
        r = unstarted(mod, reps)
        if rng.random() < 0.3:
            r.pin_session("s", rng.choice(reps).url)
        head = rng.choice(heads)
        prompt = head[:rng.randint(0, 32)] + [rng.randrange(1, 64)
                                              for _ in range(4)]
        tenant = rng.choice(("", "gold", "bronze"))
        exclude = [u.url for u in reps if rng.random() < 0.15]
        out.append(_decide(r, mod, prompt, tenant=tenant,
                           session=rng.choice(("", "s")), exclude=exclude))
        out.append([d.url for d in r.migration_destinations(
            exclude=exclude[:1], prompt=prompt)])
    return out


def test_route_decisions_equal_the_reference():
    want = policy_script(ref_router)
    got = policy_script(port_router)
    assert got == want
    assert got[:4] == [(URLS[0], "least-loaded"), (URLS[1], "prefix"),
                       (URLS[0], "session"), (URLS[1], "prefix")]
    policies = {d[1] for d in got if isinstance(d, tuple) and len(d) == 2}
    assert policies == {"session", "prefix", "least-loaded"}
    assert "no-replica" in got


def test_control_prefix_match_zero_misses(monkeypatch):
    want = policy_script(ref_router)
    monkeypatch.setattr(port_router.Replica, "prefix_match",
                        lambda self, prompt, want=None: 0)
    assert policy_script(port_router) != want


def test_control_tenant_weighting_swapped_misses(monkeypatch):
    want = policy_script(ref_router)
    real = port_router.Replica.load_score
    swap = {"latency": "standard", "standard": "latency"}

    def swapped(self, tenant_class="standard"):
        return real(self, swap.get(tenant_class, tenant_class))

    monkeypatch.setattr(port_router.Replica, "load_score", swapped)
    assert policy_script(port_router) != want


# ------------------------------------------------------------------ HTTP

ENGINE = dict(max_batch=4, max_len=512, prefill_len=8)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = configs("fp32")
    return tcfg, both_params(jcfg, numpy_params(jcfg, 0),
                             quantize=False)[1]


def _engine(weights):
    tcfg, tree = weights
    return ServingEngine(TpuLM(tcfg), tree, device="cpu", **ENGINE)


def _oracle(weights, prompt, n):
    [r] = _engine(weights).generate([list(prompt)], max_new_tokens=n)
    return r.tokens


def _post(url, payload, path="/v1/completions", timeout=120):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _stream(url, payload, result, timeout=120):
    req = urllib.request.Request(
        url + "/v1/completions",
        data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    toks = []
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            result["status"] = resp.status
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
    except urllib.error.HTTPError as e:
        result["error"] = f"HTTP {e.code}"
    except OSError as e:
        result["error"] = repr(e)


def _until(fn, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.01)
    return fn()


def _live(servers):
    return _until(lambda: next((s for s in servers
                                if s.scheduler.stats()["live_slots"]),
                               None))


def _in_flight(fn, *args):
    t = threading.Thread(target=fn, args=args)
    t.start()
    return t


def _join(t):
    t.join(timeout=120)
    assert not t.is_alive(), "client hung"


def _sessions(servers, key):
    return [s.scheduler.stats()["sessions"][key] for s in servers]


def _settle(router, n):
    """The outcome is counted after the response reaches the client, on
    the router's handler thread: wait until ``n`` are counted."""
    _until(lambda: sum(router.requests.values()) >= n, 10.0)


def _join_drains():
    for t in threading.enumerate():
        if t.name == "router-eject-drain":
            t.join(timeout=30)
            assert not t.is_alive()


def http_script(mod, journal, weights):
    """One script through a router of ``mod`` in front of two fresh port
    servers. The poll loop never runs (an hour's interval), so the
    replicas' stats stay those of the first poll and every decision is
    the script's, not the clock's. Returns (results, counters)."""
    servers = [ApiServer(_engine(weights), block_size=4).start()
               for _ in range(2)]
    router = mod.Router([s.url for s in servers], poll_interval=3600,
                        stale_after=3600, hedge_after=0).start()
    res = {}
    n = 0
    try:
        urls = {s.url: i for i, s in enumerate(servers)}
        # a routed completion against the oracle
        code, out = _post(router.url, {"prompt": [1, 2, 3, 4],
                                       "max_tokens": 10})
        res["routed"] = (code, out["choices"][0]["token_ids"]
                         == _oracle(weights, [1, 2, 3, 4], 10))
        n += 1
        # a mid-stream migration: exported off its replica, imported
        # into the peer and spliced into the client's one stream
        box = {}
        t = _in_flight(_stream, router.url,
                       {"prompt": [7, 8, 9], "max_tokens": 60}, box)
        victim = _live(servers)
        res["stream_moved"] = _post(victim.url, {},
                                    "/v1/sessions/export")[1]["migrated"]
        _join(t)
        res["stream"] = (box.get("error"),
                         box.get("tokens") == _oracle(weights, [7, 8, 9],
                                                      60))
        n += 1
        # a synchronous one: the terminal carries the blob
        box = {}
        t = _in_flight(lambda: box.update(zip(("code", "out"), _post(
            router.url, {"prompt": [3, 1, 4], "max_tokens": 60}))))
        victim = _live(servers)
        res["sync_moved"] = _post(victim.url, {},
                                  "/v1/sessions/export")[1]["migrated"]
        _join(t)
        res["sync"] = (box["code"],
                       box["out"]["choices"][0]["token_ids"]
                       == _oracle(weights, [3, 1, 4], 60),
                       box["out"]["usage"]["completion_tokens"])
        n += 1
        res["ledger"] = (_sessions(servers, "exported"),
                         _sessions(servers, "imported"))
        # a failed export parks the session on its replica
        box = {}
        t = _in_flight(_stream, router.url,
                       {"prompt": [9, 9, 1], "max_tokens": 60}, box)
        victim = _live(servers)

        def boom(rid):
            raise RuntimeError("injected export failure")

        victim.scheduler.engine.export_session = boom
        res["failed_moved"] = _post(victim.url, {},
                                    "/v1/sessions/export")[1]["migrated"]
        _join(t)
        del victim.scheduler.engine.export_session
        st = victim.scheduler.stats()["sessions"]
        res["parked"] = (urls[victim.url], box.get("error"),
                         box.get("tokens") == _oracle(weights, [9, 9, 1],
                                                      60),
                         st["migrated_out"], st["migrate_preempts"])
        n += 1
        # the client's resume field is the router's to mint: stripped,
        # this is a promptless completion
        code, out = _post(router.url, {"resume": 0})
        res["resume"] = (code, "prompt" in out.get("error", ""))
        n += 1
        # an import at another wire version is an answer: 400
        code, out = _post(servers[0].url, {"session": {
            "version": tkv.SESSION_WIRE_VERSION + 7}},
            "/v1/sessions/import")
        res["import"] = (code, "wire version" in out["error"])
        _settle(router, n)
        # gray failure: a stream moves to the peer, whose polls then read
        # slow; the sweep ejects it and its drain exports the session a
        # second time, back to the first replica
        seq0 = max([e.seq for e in journal.events()], default=0)
        exported0 = sum(_sessions(servers, "exported"))
        box = {}
        prompt = [5, 6, 7, 8]
        t = _in_flight(_stream, router.url,
                       {"prompt": prompt, "max_tokens": 400}, box)
        first = _live(servers)
        _post(first.url, {}, "/v1/sessions/export")
        (peer,) = [s for s in servers if s is not first]
        _until(lambda: peer.scheduler.stats()["live_slots"])
        reps = {rep.url: rep for rep in router.replicas()}
        for _ in range(router.eject_min_samples):
            reps[first.url].observe_latency(0.01)
            reps[peer.url].observe_latency(0.5)
        router._gray_sweep()
        ejected = [urls[u] for u, rep in reps.items() if rep.ejected]
        _join(t)
        _join_drains()
        res["gray"] = (ejected, box.get("error"),
                       box.get("tokens") == _oracle(weights, prompt, 400),
                       sum(_sessions(servers, "exported")) - exported0)
        for _ in range(60):
            for rep in reps.values():
                rep.observe_latency(0.01)
        router._gray_sweep()
        res["readmitted"] = [rep.ejected for rep in reps.values()]
        res["journal"] = [e.reason for e in journal.events(since_seq=seq0)
                          if e.component == "router"]
        n += 1
        _settle(router, n)
        # remove_replica drains a live stream onto the peer: no 503
        box = {}
        t = _in_flight(_stream, router.url,
                       {"prompt": [11, 12], "max_tokens": 60}, box)
        victim = _live(servers)
        out = router.remove_replica(victim.url)
        _join(t)
        res["removed"] = (out["removed"], out["migrated"], out["idle"],
                          box.get("status"), box.get("error"),
                          box.get("tokens") == _oracle(weights, [11, 12],
                                                       60),
                          len(router.replicas()))
        n += 1
        _settle(router, n)
        st = router.stats()
        counters = {k: st[k] for k in ("requests", "routed", "migrations",
                                       "hedges", "sessions")}
        counters["ejections"] = {urls[u]: c
                                 for u, c in st["ejections"].items()}
        for s in servers:
            q = s.scheduler.stats()
            assert q["live_slots"] == 0 and q["parked"] == 0
            assert q["sessions"]["imports_pending"] == 0
        return res, counters
    finally:
        router.stop()
        _join_drains()
        for s in servers:
            s.stop()


def test_http_script_equals_the_reference(weights):
    want = http_script(ref_router, ref_journal(), weights)
    got = http_script(port_router, get_journal(), weights)
    assert got == want
    res, counters = got
    assert res["routed"] == (200, True)
    assert res["stream_moved"] == res["sync_moved"] == 1
    assert res["stream"] == (None, True)
    assert res["sync"] == (200, True, 60)
    assert res["failed_moved"] == 0
    # replica 0 served all three streams: two moved out, three preempted
    assert res["parked"] == (0, None, True, 2, 3)
    assert res["resume"] == (400, True)
    assert res["import"] == (400, True)
    # the peer ejected; the session it had just taken in is exported a
    # second time by its drain and still reaches the client whole
    assert res["gray"] == ([1], None, True, 2)
    assert res["readmitted"] == [False, False]
    assert res["journal"] == [REASON_REPLICA_EJECTED,
                              REASON_REPLICA_READMITTED]
    assert res["removed"] == (True, 1, True, 200, None, True, 1)
    assert counters["migrations"] == {"resumed": 5}
    assert counters["ejections"] == {1: 1}
    assert counters["hedges"] == {"fired": 0, "won": 0}
