"""Serving load generator: end-to-end latency/TTFT against a live server.

The client half of the serving benchmark story (the engine-side numbers
— decode tokens/sec, MFU — live in ``chip_smoke.py``): drive a running
``tpuslice-gpu-serve`` endpoint with concurrent requests and report what a
CLIENT experiences — request latency percentiles, time-to-first-token
(streaming), aggregate token throughput, error counts. The vLLM
benchmark-client analog for a granted slice.

Run: ``tpuslice-gpu-loadgen --url http://host:8000 --requests 64
--concurrency 8 [--stream]`` (or ``python -m
instaslice_tpu_torch.serving.loadgen``). Prints ONE JSON line.

Open-loop vs closed-loop: this is closed-loop at fixed concurrency
(each worker thread fires its next request when the previous finishes)
— the right shape for measuring a single slice's capacity; arrival-rate
sweeps are the caller's loop.

A copy of ``instaslice_tpu/serving/loadgen.py`` over the port's nemesis,
lock checker and tenant grammar (the port imports nothing of the JAX
package). It holds no tensor: the server it drives is the port's, on the
card or the CPU, or the port's router in front of several. The request
stream, the recorded trace and the report's keys are the reference's.
"""

from __future__ import annotations

import argparse
import json
import random
import socket
import statistics
import sys
import threading
import time
import http.client
import urllib.error
import urllib.request
import uuid
from typing import List, Optional
from instaslice_tpu_torch.faults.netchaos import (NemesisPlan, get_nemesis,
                                                  set_nemesis)
from instaslice_tpu_torch.utils.lockcheck import named_lock


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    i = min(len(ys) - 1, max(0, int(round(q * (len(ys) - 1)))))
    return ys[i]


#: terminal-outcome classes a request can land in. The one that must
#: stay ZERO for a healthy server is "hung": the client's own timeout
#: expired, i.e. the server never produced a terminal response — the
#: exact failure mode the drain/shed machinery exists to eliminate.
#: "stream-truncated" is a mid-stream disconnect AFTER the first token
#: (a replica killed under the router, a severed proxy): its own class
#: so the crash-chaos tier can reconcile the ledger exactly — those
#: requests received real tokens, so lumping them into
#: "transport-error" (which promises zero delivery) would lie.
OUTCOMES = ("ok", "hedged-ok", "shed-429", "timeout-503",
            "stream-truncated", "transport-error", "replica-ejected",
            "hung")


#: in-band SSE error messages that mean "the stream was CUT", not "the
#: server terminated with an error": the raw upstream-died signature
#: plus the router's relayed forms (serving/router.py writes these when
#: the replica it was proxying dies mid-stream) — a router-side
#: mid-stream disconnect must classify exactly like a direct one
_TRUNCATION_SIGNATURES = (
    "stream ended without [DONE]",
    "replica stream died",
    "replica stream ended early",
)


def _classify(err: Optional[str], code: Optional[int],
              tokens: int = 0, hedged: bool = False) -> str:
    """Outcome class for one finished request. 429 = the server shed
    load (backpressure working as designed); 503 = a terminal timeout/
    drain response; a client-side timeout means the request HUNG —
    no terminal response ever arrived. A severed stream after >= 1
    delivered token — a transport failure (code None), or an in-band
    truncation signature relayed by the router — is
    "stream-truncated" (the crash-chaos signature of a killed
    replica). Clean in-band terminal errors after tokens (an engine
    recovery losing the slot) stay "transport-error": the server was
    alive and said so. The report's ``status_counts`` breakdown
    separates terminal server responses from genuine transport
    failures (code None).

    Partition-era classes: ``hedged`` marks a request that succeeded
    only via the client-side hedge retry (first attempt hit a
    transport fault before any token); a 503 whose body names
    gray-ejected replicas classifies "replica-ejected" — the router
    shrank its pool, which is distinct from ordinary shed/timeout."""
    if err is None:
        return "hedged-ok" if hedged else "ok"
    if "gray-ejected" in err or "replica ejected" in err:
        return "replica-ejected"
    if code == 429:
        return "shed-429"
    if code == 503:
        return "timeout-503"
    if code is None and (
        "timed out" in err or "TimeoutError" in err
    ):
        return "hung"
    if tokens > 0 and (
        code is None
        or any(sig in err for sig in _TRUNCATION_SIGNATURES)
    ):
        return "stream-truncated"
    return "transport-error"


def _one_request(url: str, prompt: List[int], max_tokens: int,
                 stream: bool, timeout: float, adapter: str = "",
                 trace_id: str = "", tenant: str = ""):
    """Returns (latency_s, ttft_s or None, tokens, error or None,
    http_code or None). ``trace_id`` rides the ``X-Trace-Id`` header,
    so every loadgen request is findable in the server's
    ``/v1/debug/trace`` ring / ``TPUSLICE_TRACE_FILE`` dump; ``tenant``
    rides ``X-Tenant`` — the SLO scheduler's routing key."""
    body = {"prompt": prompt, "max_tokens": max_tokens}
    if adapter:
        body["adapter"] = adapter
    if stream:
        body["stream"] = True
    headers = {"Content-Type": "application/json"}
    if trace_id:
        headers["X-Trace-Id"] = trace_id
    if tenant:
        headers["X-Tenant"] = tenant
    req = urllib.request.Request(
        url + "/v1/completions",
        data=json.dumps(body).encode(),
        headers=headers,
        method="POST",
    )
    t0 = time.monotonic()
    # initialized OUTSIDE the try: a mid-stream failure must report the
    # tokens already delivered (outcome classification distinguishes a
    # truncated stream from a request that never got anything)
    ttft = None
    toks = 0
    try:
        plan = get_nemesis()
        if plan is not None:
            # the --nemesis-seed arm: injected latency counts against
            # the measured request, partitions/drops raise here (a
            # PartitionError is a ConnectionError → transport-error /
            # hedge-retry path)
            plan.before_request("loadgen", "server")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            if not stream:
                out = json.loads(r.read())
                dt = time.monotonic() - t0
                toks = sum(len(c["token_ids"]) for c in out["choices"])
                return dt, None, toks, None, r.status
            buf = b""
            while True:
                chunk = r.read1(65536)
                if not chunk:
                    return (time.monotonic() - t0, ttft, toks,
                            "stream ended without [DONE]", r.status)
                buf += chunk
                while b"\n\n" in buf:
                    event, buf = buf.split(b"\n\n", 1)
                    line = event.decode().strip()
                    if not line.startswith("data: "):
                        continue
                    data = line[len("data: "):]
                    if data == "[DONE]":
                        return (time.monotonic() - t0, ttft, toks, None,
                                r.status)
                    payload = json.loads(data)
                    if "error" in payload:
                        return (time.monotonic() - t0, ttft, toks,
                                payload["error"], r.status)
                    got = payload["choices"][0]["token_ids"]
                    if got and ttft is None:
                        ttft = time.monotonic() - t0
                    toks += len(got)
    except urllib.error.HTTPError as e:
        # carry the server's error BODY, not just the status line —
        # "unknown adapter 'x' (serving: ...)" beats "400 Bad Request"
        try:
            body = json.loads(e.read().decode())
            # a proxy's error body can be valid JSON that is not an
            # object — .get() on it would kill the worker thread
            detail = body.get("error", "") if isinstance(body, dict) else ""
        except (ValueError, OSError, http.client.HTTPException):
            # body unreadable / truncated / not JSON
            detail = ""
        msg = f"HTTPError {e.code}: {detail or e.reason}"
        return time.monotonic() - t0, None, 0, msg, e.code
    except (socket.timeout, TimeoutError) as e:
        # the client deadline expired with NO terminal response: the
        # request is HUNG — the one outcome a robust server must never
        # produce (classified separately so runs can assert on it)
        return (time.monotonic() - t0, ttft, toks,
                f"TimeoutError: {e or 'timed out'}", None)
    except Exception as e:  # slicelint: disable=broad-except
        # ACCOUNT for every failure (IncompleteRead from a dropped
        # body, JSONDecodeError from a proxy's HTML error page,
        # ConnectionResetError from a killed replica mid-stream, …);
        # an uncaught exception would kill the worker thread silently
        # and the run would report fewer requests with zero errors.
        # Tokens already streamed ride along so classification can
        # tell a truncated stream from a dead-on-arrival request.
        return (time.monotonic() - t0, ttft, toks,
                f"{type(e).__name__}: {e}", None)


def parse_prefix_pool(spec: str):
    """``N:L`` → (pool size, prefix length) for ``--prefix-pool``."""
    try:
        n_s, l_s = spec.split(":", 1)
        n, length = int(n_s), int(l_s)
    except ValueError:
        raise ValueError(
            f"prefix-pool spec {spec!r}: want N:L (e.g. '4:64')"
        ) from None
    if n < 1 or length < 1:
        raise ValueError(f"prefix-pool spec {spec!r}: N and L must "
                         "be >= 1")
    return n, length


#: bump on ANY change to the trace JSONL layout — replay REJECTS other
#: versions (a half-understood trace would silently change the replayed
#: request stream, which defeats the point of replaying one)
TRACE_VERSION = 1


def _write_trace(path: str, vocab: int, pool_entries, records) -> None:
    """One header line (version, vocab, shared prefix pool entries),
    then one line per request sorted by arrival time."""
    with open(path, "w") as f:
        f.write(json.dumps({
            "trace_version": TRACE_VERSION,
            "vocab": vocab,
            "pool": pool_entries,
        }) + "\n")
        for rec in sorted(records, key=lambda r: r["t"]):
            f.write(json.dumps(rec) + "\n")


def _read_trace(path: str):
    """Returns (vocab, pool entries or None, request records)."""
    with open(path) as f:
        header = json.loads(f.readline())
        ver = header.get("trace_version")
        if ver != TRACE_VERSION:
            raise ValueError(
                f"trace {path!r} has version {ver!r}; this loadgen "
                f"replays v{TRACE_VERSION} — re-record it"
            )
        records = [json.loads(line) for line in f if line.strip()]
    if not records:
        raise ValueError(f"trace {path!r} holds zero requests")
    return int(header["vocab"]), header.get("pool"), records


def _prompt_from(pseed: int, plen: int, vocab: int) -> List[int]:
    """The per-request prompt tail, regenerable from its recorded seed
    (the trace carries seeds, not token streams)."""
    prng = random.Random(pseed)
    return [prng.randrange(1, vocab) for _ in range(plen)]


def run(url: str, requests: int, concurrency: int, prompt_len: int,
        max_tokens: int, vocab: int, stream: bool, timeout: float,
        seed: int = 0, adapters: List[str] = (),
        tenants=None, jitter: float = 0.0,
        prefix_pool: str = "", record_trace: str = "",
        replay_trace: str = "",
        nemesis_seed: Optional[int] = None) -> dict:
    """``adapters``: multi-LoRA names assigned round-robin across
    requests ("" rides the base model) — load-tests the batched
    per-request adapter path.

    ``tenants``: a ``{name: TenantSpec}`` dict (or the spec string the
    server's ``--tenants`` takes — ONE grammar, serving/scheduler.py):
    requests draw a tenant by weight (seeded), send it in ``X-Tenant``,
    and the report gains per-tenant TTFT/TPOT p50/p95/p99 plus an
    **SLO-attainment fraction** — ok requests whose TTFT met the
    tenant's target (streaming; sync runs use total latency, the
    conservative stand-in).

    ``prefix_pool`` (``"N:L"``): organic prefix sharing — each prompt's
    HEAD is drawn (seeded, uniform) from N shared L-token prefixes and
    its TAIL is a fresh random draw of the usual ``prompt_len``/jitter
    length, the traffic shape the server's radix prefix cache exists
    for (common system prompts across tenants, nothing registered).
    The report gains a ``prefix_pool`` block with the client-side
    reuse fraction: requests whose prefix was already issued at least
    once earlier in the run — the ceiling on the server's hit rate.

    ``record_trace`` / ``replay_trace`` (paths, mutually exclusive):
    the bench-reproducibility satellite. Recording writes one JSONL
    line per request — arrival offset, tenant, prompt seed + length,
    budget, pool pick — under a versioned header carrying the shared
    prefix-pool entries; replaying reconstructs the IDENTICAL request
    stream (prompts regenerated from their seeds) and paces each
    request at its recorded arrival offset, so two bench arms see the
    same traffic instead of merely the same distribution.

    ``nemesis_seed``: the partition-chaos arm. Installs a seeded
    :class:`NemesisPlan` on the loadgen→server edge (added latency
    with jitter, a drop window, a brief mid-run partition; all timed
    so the run ends healed) and arms a single client-side hedge retry
    for requests that hit a transport fault before any token was
    delivered — successes via the hedge classify "hedged-ok". Leaves
    any pre-installed global plan (a test's) alone."""
    from instaslice_tpu_torch.serving.scheduler import parse_tenant_specs

    if record_trace and replay_trace:
        raise ValueError("record_trace and replay_trace are exclusive")
    nemesis_installed = False
    if nemesis_seed is not None and get_nemesis() is None:
        plan = NemesisPlan(seed=nemesis_seed)
        nrng = random.Random(f"loadgen-nemesis:{nemesis_seed}")
        plan.latency("loadgen", "server",
                     delay=0.002 + nrng.random() * 0.01,
                     jitter=0.005)
        plan.drop("loadgen", "server", p=0.05,
                  start=0.5 + nrng.random(), duration=2.0)
        plan.partition("loadgen", "server",
                       start=2.0 + nrng.random() * 2.0,
                       duration=0.5)
        set_nemesis(plan.start())
        nemesis_installed = True
    rng = random.Random(seed)
    if isinstance(tenants, str):
        tenants = parse_tenant_specs(tenants) if tenants else None
    # per-run nonce in every trace id: two runs with the same seed
    # against one long-lived server must not reuse ids, or the
    # documented `--trace` drill-down would merge unrelated requests'
    # spans from the server's ring (stays within TRACE_ID_SAFE)
    run_id = uuid.uuid4().hex[:6]
    if not 0.0 <= jitter < 1.0:
        raise ValueError(f"jitter must be in [0, 1), got {jitter}")
    pool = None
    pool_spec = None
    picks: List[Optional[int]] = [None] * requests
    arrivals: List[Optional[float]] = []
    if replay_trace:
        vocab, pool_entries, records = _read_trace(replay_trace)
        requests = len(records)
        tenant_of = [str(r.get("tenant", "")) for r in records]
        plens = [int(r["prompt_len"]) for r in records]
        budgets = [int(r["max_tokens"]) for r in records]
        pseeds = [int(r["pseed"]) for r in records]
        picks = [r.get("pick") for r in records]
        arrivals = [float(r["t"]) for r in records]
        if pool_entries:
            pool = [[int(t) for t in e] for e in pool_entries]
            pool_spec = {"n": len(pool),
                         "len": len(pool[0]) if pool else 0}
    else:
        tenant_of = [""] * requests
        if tenants:
            names = sorted(tenants)
            weights = [tenants[n].weight for n in names]
            tenant_of = rng.choices(names, weights=weights, k=requests)
        # mixed sequence lengths (seeded): each request draws its
        # prompt length and budget from [ceil(x*(1-jitter)), x] — the
        # scenario paged KV accounting and budget-trimmed rounds exist
        # for. 0 keeps the historical fixed-shape behavior.
        plens = [
            rng.randint(max(1, int(prompt_len * (1 - jitter))),
                        prompt_len)
            if jitter else prompt_len
            for _ in range(requests)
        ]
        budgets = [
            rng.randint(max(1, int(max_tokens * (1 - jitter))),
                        max_tokens)
            if jitter else max_tokens
            for _ in range(requests)
        ]
        # per-request prompt SEEDS (not token streams) so a recorded
        # trace stays compact and replay regenerates identical prompts
        pseeds = [rng.randrange(2 ** 31) for _ in range(requests)]
        if prefix_pool:
            pool_n, pool_len = parse_prefix_pool(prefix_pool)
            # the pool rides its OWN derived seed, independent of the
            # request count: a warm-up run and a measured run with the
            # same seed must share the same prefixes, or "warming the
            # prefix cache" warms the wrong cache (found the hard way
            # — the master rng's state at this point depends on every
            # per-request draw above)
            pool_rng = random.Random(
                f"{seed}:prefix-pool:{pool_n}:{pool_len}:{vocab}"
            )
            pool = [
                [pool_rng.randrange(1, vocab)
                 for _ in range(pool_len)]
                for _ in range(pool_n)
            ]
            picks = [rng.randrange(pool_n) for _ in range(requests)]
            pool_spec = {"n": pool_n, "len": pool_len}
    prompts = [
        ((pool[picks[i]] if pool is not None and picks[i] is not None
          else []) + _prompt_from(pseeds[i], plens[i], vocab))
        for i in range(requests)
    ]
    prefix_reused = 0
    if pool_spec is not None:
        # reuse fraction in issue order: a request reuses when its
        # prefix was issued by ANY earlier request — the organic-
        # sharing ceiling the server-side hit counter reconciles under
        seen_picks: set = set()
        for pk in picks:
            if pk is None:
                continue
            if pk in seen_picks:
                prefix_reused += 1
            seen_picks.add(pk)
    lat: List[float] = []
    ttfts: List[float] = []
    tpots: List[float] = []
    errors: List[str] = []
    outcomes = {k: 0 for k in OUTCOMES}
    status_counts: dict = {}
    tokens = [0]
    # per-tenant ledgers (tenant name → list); populated only when a
    # tenant mix is configured
    t_lat: dict = {}
    t_ttft: dict = {}
    t_tpot: dict = {}
    t_outcomes: dict = {}
    lock = named_lock("loadgen.results")
    it = iter(range(requests))
    #: fire-time offset per request (what a recorded trace's ``t`` is);
    #: replay paces on the RECORDED offsets instead
    fired: List[float] = [0.0] * requests

    def worker():
        while True:
            with lock:
                i = next(it, None)
            if i is None:
                return
            if arrivals:
                # replay: hold the request until its recorded arrival
                # offset (workers pull in t-sorted order, so this never
                # reorders the stream)
                delay = arrivals[i] - (time.monotonic() - t0)
                if delay > 0:
                    # replay pacing, not a poll: the nap is the
                    # recorded inter-arrival gap itself, and loadgen
                    # has no shutdown path to interrupt (the process
                    # IS the run)
                    time.sleep(delay)  # slicelint: disable=sleep-in-loop
            fired[i] = round(time.monotonic() - t0, 4)
            dt, ttft, toks, err, code = _one_request(
                url, prompts[i], budgets[i], stream, timeout,
                adapter=adapters[i % len(adapters)] if adapters else "",
                trace_id=f"lg-{seed}-{run_id}-{i}",
                tenant=tenant_of[i],
            )
            hedged = False
            if (nemesis_seed is not None and err is not None
                    and code is None and toks == 0
                    and "TimeoutError" not in err):
                # hedge retry (nemesis arm only): the first attempt
                # died in transport before ANY token was delivered, so
                # re-issuing is safe — no output can be double-counted.
                # A success via the hedge classifies "hedged-ok".
                dt, ttft, toks, err2, code = _one_request(
                    url, prompts[i], budgets[i], stream, timeout,
                    adapter=(adapters[i % len(adapters)]
                             if adapters else ""),
                    trace_id=f"lg-{seed}-{run_id}-{i}-hedge",
                    tenant=tenant_of[i],
                )
                hedged = err2 is None
                err = err2
            with lock:
                outcome = _classify(err, code, toks, hedged=hedged)
                outcomes[outcome] += 1
                key = str(code) if code is not None else "none"
                status_counts[key] = status_counts.get(key, 0) + 1
                t = tenant_of[i]
                if t:
                    t_outcomes.setdefault(t, {k: 0 for k in OUTCOMES})
                    t_outcomes[t][outcome] += 1
                if err is None:
                    lat.append(dt)
                    tokens[0] += toks
                    if t:
                        t_lat.setdefault(t, []).append(dt)
                    if ttft is not None:
                        ttfts.append(ttft)
                        if t:
                            t_ttft.setdefault(t, []).append(ttft)
                        if toks > 1:
                            # the client-observed mean inter-token gap
                            # over the decode phase — the number the
                            # server-side TPOT histogram must reconcile
                            # with (chaos tier cross-check)
                            tpots.append((dt - ttft) / (toks - 1))
                            if t:
                                t_tpot.setdefault(t, []).append(
                                    (dt - ttft) / (toks - 1)
                                )
                else:
                    errors.append(err)

    t0 = time.monotonic()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, concurrency))]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join()
    finally:
        if nemesis_installed:
            # the arm is per-run: leave the process's global plan slot
            # the way we found it (empty)
            set_nemesis(None)
    wall = max(time.monotonic() - t0, 1e-9)
    out = {
        "metric": "serve_request_p50_latency",
        "value": round(_percentile(lat, 0.5), 4),
        "unit": "seconds",
        "requests": requests,
        "concurrency": concurrency,
        "ok": len(lat),
        "errors": len(errors),
        "outcomes": outcomes,
        "status_counts": status_counts,
        "p95_latency": round(_percentile(lat, 0.95), 4),
        "p99_latency": round(_percentile(lat, 0.99), 4),
        "mean_latency": round(statistics.mean(lat), 4) if lat else 0.0,
        "client_tokens_per_sec": round(tokens[0] / wall, 1),
        # the raw token total behind the rate: the number the fleet
        # telemetry aggregator's tpuslice_serve_tokens_total rollup
        # must reconcile with EXACTLY (make telemetry-smoke)
        "client_tokens": tokens[0],
        "stream": stream,
        # every request carried X-Trace-Id "<prefix><i>": paste one
        # into `tpuslice-gpu trace-summary --url ... --trace <prefix><i>`
        # to see where its time went server-side
        "trace_id_prefix": f"lg-{seed}-{run_id}-",
    }
    if adapters:
        out["adapters"] = list(adapters)
    if nemesis_seed is not None:
        out["nemesis"] = {"seed": nemesis_seed,
                          "hedged_ok": outcomes["hedged-ok"],
                          "replica_ejected": outcomes["replica-ejected"]}
    if record_trace:
        _write_trace(record_trace, vocab,
                     pool if pool is not None else None, [
                         {"i": i, "t": fired[i],
                          "tenant": tenant_of[i], "pseed": pseeds[i],
                          "prompt_len": plens[i],
                          "max_tokens": budgets[i], "pick": picks[i]}
                         for i in range(requests)
                     ])
        out["trace"] = {"recorded": record_trace, "requests": requests}
    if replay_trace:
        out["trace"] = {"replayed": replay_trace, "requests": requests}
    if pool_spec is not None:
        out["prefix_pool"] = {
            **pool_spec,
            "reused": prefix_reused,
            "reused_fraction": round(prefix_reused / requests, 4)
            if requests else 0.0,
        }
    if tenants:
        per_tenant = {}
        for name in sorted(tenants):
            spec = tenants[name]
            oks = t_lat.get(name, [])
            ttl = t_ttft.get(name, [])
            tpl = t_tpot.get(name, [])
            entry = {
                "class": spec.tenant_class,
                "weight": spec.weight,
                "requests": sum(
                    t_outcomes.get(name, {}).values()
                ),
                "ok": len(oks),
                "outcomes": t_outcomes.get(
                    name, {k: 0 for k in OUTCOMES}
                ),
                "latency_p50": round(_percentile(oks, 0.5), 4),
                "latency_p95": round(_percentile(oks, 0.95), 4),
                "latency_p99": round(_percentile(oks, 0.99), 4),
                "ttft_p50": round(_percentile(ttl, 0.5), 4),
                "ttft_p95": round(_percentile(ttl, 0.95), 4),
                "ttft_p99": round(_percentile(ttl, 0.99), 4),
                "tpot_p50": round(_percentile(tpl, 0.5), 5),
                "tpot_p95": round(_percentile(tpl, 0.95), 5),
                "tpot_p99": round(_percentile(tpl, 0.99), 5),
            }
            if spec.ttft_slo > 0:
                # attainment over ok requests: TTFT when measured
                # (streaming), else total latency — the conservative
                # stand-in (latency >= ttft always)
                measured = ttl if stream else oks
                entry["ttft_slo"] = spec.ttft_slo
                entry["slo_attainment"] = round(
                    sum(1 for x in measured if x <= spec.ttft_slo)
                    / len(measured), 4
                ) if measured else 0.0
            if spec.tpot_slo > 0:
                entry["tpot_slo"] = spec.tpot_slo
                entry["tpot_attainment"] = round(
                    sum(1 for x in tpl if x <= spec.tpot_slo)
                    / len(tpl), 4
                ) if tpl else 0.0
            per_tenant[name] = entry
        out["tenants"] = per_tenant
    if stream:
        out["ttft_p50"] = round(_percentile(ttfts, 0.5), 4)
        out["ttft_p95"] = round(_percentile(ttfts, 0.95), 4)
        out["ttft_p99"] = round(_percentile(ttfts, 0.99), 4)
        out["ttft_mean"] = (round(statistics.mean(ttfts), 4)
                            if ttfts else 0.0)
        # client-side per-output-token latency (decode-phase mean gap
        # per request, percentiles across requests)
        out["tpot_p50"] = round(_percentile(tpots, 0.5), 5)
        out["tpot_p95"] = round(_percentile(tpots, 0.95), 5)
        out["tpot_p99"] = round(_percentile(tpots, 0.99), 5)
    if errors:
        out["first_error"] = errors[0][:200]
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpuslice-gpu-loadgen")
    ap.add_argument("--url", required=True,
                    help="server base url, e.g. http://127.0.0.1:8000")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-tokens", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=32000,
                    help="random prompt ids drawn from [1, vocab)")
    ap.add_argument("--stream", action="store_true",
                    help="SSE mode: also report time-to-first-token")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--adapters", default="",
                    help="comma-separated multi-LoRA adapter names "
                         "assigned round-robin across requests (an "
                         "empty entry rides the base model, e.g. "
                         "',billing,support')")
    ap.add_argument("--prefix-pool", default="",
                    help="N:L — organic prefix sharing: each prompt's "
                         "head is drawn (seeded) from N shared L-token "
                         "prefixes, its tail is a fresh --prompt-len "
                         "draw; the report gains the client-side "
                         "prefix reuse fraction (the radix-cache "
                         "workload shape)")
    ap.add_argument("--jitter", type=float, default=0.0,
                    help="mixed sequence lengths: each request draws "
                         "prompt-len and max-tokens from "
                         "[x*(1-jitter), x] (seeded); 0 = fixed shapes")
    ap.add_argument("--tenants", default="",
                    help="multi-tenant scenario: comma-separated "
                         "name:weight:class[:ttft_slo[:tpot_slo]] — "
                         "the SAME grammar tpuslice-gpu-serve --tenants "
                         "takes. Requests draw a tenant by weight "
                         "(seeded) and send it via X-Tenant; the "
                         "report gains per-tenant TTFT/TPOT p50/p95/"
                         "p99 and an SLO-attainment fraction")
    ap.add_argument("--record-trace", default="", metavar="FILE",
                    help="write the request stream (JSONL: arrival "
                         "offset, tenant, prompt seed + length, "
                         "budget, pool pick under a versioned header) "
                         "so a later --replay-trace run fires the "
                         "IDENTICAL stream")
    ap.add_argument("--replay-trace", default="", metavar="FILE",
                    help="replay a recorded trace: prompts regenerated "
                         "from their recorded seeds, each request "
                         "paced at its recorded arrival offset "
                         "(--requests/--prompt-len/--max-tokens/"
                         "--jitter/--prefix-pool come from the trace "
                         "and are ignored)")
    ap.add_argument("--sweep", default="",
                    help="comma-separated concurrency levels (e.g. "
                         "'1,2,4,8'): run --requests at EACH level and "
                         "report the capacity curve in one JSON "
                         "(overrides --concurrency)")
    ap.add_argument("--nemesis-seed", type=int, default=None,
                    help="partition-chaos arm: install a seeded "
                         "network-fault plan on the loadgen→server "
                         "edge (latency, a drop window, a brief timed "
                         "partition) and hedge-retry zero-token "
                         "transport failures once; the report gains "
                         "hedged-ok / replica-ejected outcome counts")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    adapters = ([a.strip() for a in args.adapters.split(",")]
                if args.adapters else [])
    if args.tenants:
        from instaslice_tpu_torch.serving.scheduler import parse_tenant_specs

        try:
            tenants = parse_tenant_specs(args.tenants)
        except ValueError as e:
            # scripted callers parse stdout JSON — never a traceback
            print(json.dumps({"error": f"bad --tenants: {e}"}))
            return 1
    else:
        tenants = None
    if args.prefix_pool:
        try:
            parse_prefix_pool(args.prefix_pool)
        except ValueError as e:
            # scripted callers parse stdout JSON — never a traceback
            print(json.dumps({"error": f"bad --prefix-pool: {e}"}))
            return 1
    if args.record_trace and args.replay_trace:
        # scripted callers parse stdout JSON — never a traceback
        print(json.dumps({"error": "--record-trace and --replay-trace "
                                   "are exclusive"}))
        return 1
    if args.replay_trace and args.sweep:
        print(json.dumps({"error": "--replay-trace replays ONE "
                                   "recorded stream; --sweep draws "
                                   "fresh ones per level"}))
        return 1
    if args.sweep:
        try:
            levels = [int(x) for x in args.sweep.split(",")
                      if x.strip()]
        except ValueError:
            levels = []
        if not levels or any(c < 1 for c in levels):
            # scripted callers parse stdout JSON — never a traceback
            print(json.dumps({"error": f"bad --sweep {args.sweep!r}"}))
            return 1
        curve = []
        for c in levels:
            r = run(args.url, args.requests, c, args.prompt_len,
                    args.max_tokens, args.vocab, args.stream,
                    args.timeout, seed=args.seed, adapters=adapters,
                    tenants=tenants, jitter=args.jitter,
                    prefix_pool=args.prefix_pool)
            curve.append(r)
        errors = sum(r["errors"] for r in curve)
        hung = sum(r["outcomes"]["hung"] for r in curve)
        # headline = the level with the best aggregate throughput; the
        # knee of the curve is visible in the per-level entries
        best = max(curve, key=lambda r: r["client_tokens_per_sec"])
        print(json.dumps({
            "metric": "serve_capacity_sweep",
            "value": best["client_tokens_per_sec"],
            "unit": "tokens/s",
            "best_concurrency": best["concurrency"],
            "levels": curve,
            "errors": errors,
            "hung": hung,
        }))
        # exit 2 is reserved for the unforgivable outcome: a request
        # that never got a terminal response (server robustness bug, as
        # opposed to explicit shed/timeout errors, which are exit 1)
        return 2 if hung else (1 if errors else 0)
    try:
        out = run(args.url, args.requests, args.concurrency,
                  args.prompt_len, args.max_tokens, args.vocab,
                  args.stream, args.timeout, seed=args.seed,
                  adapters=adapters, tenants=tenants,
                  jitter=args.jitter, prefix_pool=args.prefix_pool,
                  record_trace=args.record_trace,
                  replay_trace=args.replay_trace,
                  nemesis_seed=args.nemesis_seed)
    except (ValueError, OSError) as e:
        # bad/missing/mismatched trace file: scripted callers parse
        # stdout JSON — never a traceback
        print(json.dumps({"error": f"trace: {e}"}))
        return 1
    print(json.dumps(out))
    return 2 if out["outcomes"]["hung"] else (1 if out["errors"] else 0)


if __name__ == "__main__":
    sys.exit(main())
