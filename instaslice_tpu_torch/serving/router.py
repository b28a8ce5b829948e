"""Fleet serving tier: prefix/SLO-aware HTTP router over engine replicas.

One ``ApiServer`` owns one engine, so adding a slice added zero serving
capacity to any endpoint — this front-end turns N independent replicas
into ONE ``/v1/*`` endpoint whose aggregate tok/s scales with replica
count while prefix-affine routing *improves* TTFT (a request routed to
the replica whose radix cache already holds its prefix skips the
prefill every other replica would pay). The spirit is the
multi-replica/disaggregated serving layouts PAPERS.md surveys
(ParvaGPU's right-sized spatial shares; Flex-MIG's one-job-many-slices
composition), built on pieces the serving plane already exports:

- **Feedback, not configuration**: replicas are polled over
  ``/v1/stats`` (queue depth, free KV blocks, hashed radix hot-prefix
  digest, spec acceptance, ``replica_id`` + ``uptime_seconds``). A
  restarted replica (new nonce / clock reset) is detected and its
  affinity state discarded — its radix cache and sessions died with it.
- **Routing policy, in order** (docs/SERVING.md "Fleet router &
  session migration"):

  1. *session affinity* — ``X-Session-Id`` (or ``"session"`` field)
     pins a multi-turn conversation to the replica whose radix cache
     holds its history;
  2. *prefix-cache affinity* — the prompt's granule-hash chain is
     walked against each replica's advertised digest (a router-side
     shadow index; hashes only, tokens never leave a replica), longest
     match wins, ties break toward least load;
  3. *least-loaded* — queue depth + batch occupancy weighted by KV
     pressure, with latency-class tenants penalizing queues harder.

- **Per-replica circuit breaking** reuses the kube transport's
  :class:`~instaslice_tpu_torch.kube.real.CircuitBreaker` (same
  threshold/half-open-probe semantics); a broken replica drops out of
  routing until its cooldown probe.
- **Live KV session migration** makes the fleet elastic without perf
  cliffs: removing a replica drains it with ``{"migrate": true}`` —
  every in-flight session's terminal response carries its exported KV
  stripe (``text_completion.migration``), and the proxy thread already
  holding both connections imports it into a peer
  (``/v1/sessions/import`` → ``{"resume": rid}``) and splices the
  resumed stream, so the client sees one continuous completion: no
  503, no re-prefill, token-identical. The same primitive rebalances a
  hot replica mid-stream (``POST /v1/rebalance``).

Run via ``tpuslice-gpu-router --replica http://host:8000 ...`` or
embed :class:`Router`. The router is stateless beyond affinity maps —
killing it loses no session state (replicas own the KV), which is the
property that lets it front "millions of users" without itself becoming
the thing that needs migrating.

A copy of ``instaslice_tpu/serving/router.py`` over the port's kube
breaker, radix granule hash, journal, tracer, profiler, lock checker and
nemesis (the port imports nothing of the JAX package). It holds no
tensor: the replicas behind it are the port's servers, on the card or
the CPU. Its behaviour is the reference's, quirks included: a session
that has just migrated onto a replica whose polls then read slow leaves
again with that replica's gray-failure drain, a second export
(:meth:`Router._gray_sweep`).
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from instaslice_tpu_torch.api.constants import (
    REASON_REPLICA_EJECTED,
    REASON_REPLICA_READMITTED,
)
from instaslice_tpu_torch.faults.netchaos import get_nemesis
from instaslice_tpu_torch.kube.real import CircuitBreaker, CircuitOpen
from instaslice_tpu_torch.obs.journal import debug_events_payload, get_journal
from instaslice_tpu_torch.obs.profiler import (
    debug_profile_payload,
    get_profiler,
)
from instaslice_tpu_torch.serving.kvcache import granule_hash
from instaslice_tpu_torch.utils.guards import guarded_by, unguarded
from instaslice_tpu_torch.utils.lockcheck import (
    debug_locks_payload,
    named_lock,
)
from instaslice_tpu_torch.utils.trace import TRACE_ID_SAFE, \
    debug_trace_payload, get_tracer, new_trace_id

log = logging.getLogger("instaslice_tpu_torch.serving.router")

#: transport failures that count against a replica's breaker
_TRANSPORT_EXC = (urllib.error.URLError, ConnectionError, TimeoutError,
                  OSError)


def _retry_after_seconds(headers) -> Optional[float]:
    """Parse a Retry-After header (delta-seconds form, like
    kube/real.py honors)."""
    raw = headers.get("Retry-After") if headers is not None else None
    if not raw:
        return None
    try:
        return max(0.0, float(raw))
    except ValueError:
        return None


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


def want_hashes(prompt: List[int], granule: int) -> List[str]:
    """The prompt's whole-granule hash chain at one granule size —
    what :meth:`Replica.prefix_match` walks the advertised chains
    against."""
    if granule <= 0 or not prompt:
        return []
    n = len(prompt) // granule
    return [
        granule_hash(tuple(prompt[i * granule:(i + 1) * granule]))
        for i in range(n)
    ]


class NoReplica(RuntimeError):
    """No routable replica: every replica is dead, draining, or
    circuit-broken — the router's 503."""


class Replica:
    """One engine replica as the router sees it: last polled stats,
    the shadow prefix index built from its advertised radix digest,
    and its circuit breaker."""

    #: smoothing factor for the poll-latency EWMA (mean + variance)
    EWMA_ALPHA = 0.3

    def __init__(self, url: str, breaker_threshold: int = 3,
                 breaker_cooldown: float = 2.0) -> None:
        self.url = url.rstrip("/")
        self.breaker = CircuitBreaker(breaker_threshold,
                                      breaker_cooldown, name=self.url)
        self.stats: dict = {}
        self.replica_id = ""
        self.uptime = -1.0
        self.last_poll = 0.0          # monotonic; 0 = never
        self.draining = False         # router-side: no NEW routes
        #: gray-failure ejection (docs/RECOVERY.md "Partitions & gray
        #: failures"): latency EWMA past threshold with a 100% success
        #: rate — unroutable like draining, but the router keeps
        #: polling and re-admits when the EWMA recovers
        self.ejected = False
        # poll-latency EWMA (mean + variance → p95 estimate): the gray-
        # failure signal the breaker cannot see (it only counts errors)
        self.lat_mean = 0.0
        self.lat_var = 0.0
        self.lat_samples = 0
        # stats-poll failure backoff (capped decorrelated jitter,
        # Retry-After honored — satellite of the nemesis PR: fixed-
        # interval re-polls stampede a just-healed replica)
        self.poll_backoff = 0.0
        self.poll_next = 0.0          # monotonic; 0 = poll freely
        self.retry_after_hint: Optional[float] = None
        #: shadow prefix index: advertised hot paths as granule-hash
        #: chains, plus the granule size they were cut at
        self.granule = 0
        self.chains: List[List[str]] = []

    def alive(self, now: float, stale_after: float) -> bool:
        """Routable: polled recently, not circuit-broken, not marked
        draining or gray-ejected by the router."""
        return (bool(self.stats) and not self.draining
                and not self.ejected
                and not self.breaker.is_open()
                and now - self.last_poll <= stale_after)

    def observe_latency(self, dt: float) -> None:
        """Fold one successful round-trip latency into the EWMA."""
        if self.lat_samples == 0:
            self.lat_mean = dt
            self.lat_var = 0.0
        else:
            a = self.EWMA_ALPHA
            d = dt - self.lat_mean
            self.lat_mean += a * d
            # exponentially weighted variance (West 1979 form)
            self.lat_var = (1.0 - a) * (self.lat_var + a * d * d)
        self.lat_samples += 1

    def lat_p95(self) -> float:
        """p95 estimate from the EWMA: mean + 1.645 sigma."""
        return self.lat_mean + 1.645 * math.sqrt(max(0.0, self.lat_var))

    def adopt_stats(self, stats: dict) -> bool:
        """Fold a fresh ``/v1/stats`` poll in; returns True when the
        replica RESTARTED since the last poll (new ``replica_id`` or
        ``uptime_seconds`` moved backwards) — its radix cache and any
        imported sessions are gone, so the router must drop affinity
        state pointing at it."""
        rid = str(stats.get("replica_id", ""))
        uptime = float(stats.get("uptime_seconds", 0.0))
        restarted = bool(
            self.replica_id and rid and (
                rid != self.replica_id or uptime < self.uptime
            )
        )
        self.replica_id = rid or self.replica_id
        self.uptime = uptime
        self.stats = stats
        self.last_poll = time.monotonic()
        digest = (stats.get("radix") or {}).get("digest") or {}
        self.granule = int(digest.get("granule", 0) or 0)
        self.chains = [list(c) for c in digest.get("paths", [])]
        return restarted

    def prefix_match(self, prompt: List[int],
                     want: Optional[List[str]] = None) -> int:
        """Longest advertised-prefix match in GRANULES (0 = none):
        hash the prompt's whole granules exactly like the replica does
        and walk each advertised chain. ``want`` takes the precomputed
        hash chain (:func:`want_hashes`) — the router computes it ONCE
        per request instead of per candidate replica (hashing a long
        prompt per replica per attempt is pure wasted proxy-path CPU)."""
        if not self.granule or not self.chains or not prompt:
            return 0
        if want is None:
            want = want_hashes(prompt, self.granule)
        if not want:
            return 0
        best = 0
        for chain in self.chains:
            k = 0
            while k < len(chain) and k < len(want) \
                    and chain[k] == want[k]:
                k += 1
            best = max(best, k)
        return best

    def load_score(self, tenant_class: str = "standard") -> float:
        """Least-loaded ordering key: waiting work + batch occupancy,
        weighted by KV pressure (a replica whose pool is nearly gone
        will shed or preempt next — route around it before it does).
        Latency-class requests penalize queue depth harder: their TTFT
        *is* the queue."""
        s = self.stats
        maxb = max(1, int(s.get("max_batch", 1)))
        queued = float(s.get("queued", 0))
        occupancy = (float(s.get("live_slots", 0))
                     + float(s.get("parked", 0))) / maxb
        kv = s.get("kv") or {}
        total = max(1, int(kv.get("total", 1)))
        kv_pressure = 1.0 - float(kv.get("free", 0)) / total
        queue_w = 2.0 if tenant_class == "latency" else 1.0
        return queue_w * queued / maxb + occupancy + kv_pressure

    def to_dict(self) -> dict:
        s = self.stats
        return {
            "url": self.url,
            "replica_id": self.replica_id,
            "uptime_seconds": self.uptime,
            "draining": self.draining,
            "ejected": self.ejected,
            "latency_p95_s": round(self.lat_p95(), 6),
            "latency_samples": self.lat_samples,
            "breaker_open": self.breaker.is_open(),
            "age_s": round(time.monotonic() - self.last_poll, 3)
            if self.last_poll else None,
            "queued": s.get("queued"),
            "live_slots": s.get("live_slots"),
            "parked": s.get("parked"),
            "kv_free": (s.get("kv") or {}).get("free"),
            "advertised_paths": len(self.chains),
        }


class _RouterHandler(BaseHTTPRequestHandler):
    router: "Router" = None  # type: ignore[assignment]

    def log_message(self, *a):  # quiet
        pass

    def _send(self, code: int, payload: dict,
              retry_after: Optional[float] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", str(max(1, int(retry_after))))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> dict:
        n = int(self.headers.get("Content-Length", "0") or 0)
        req = json.loads(self.rfile.read(n).decode() or "{}")
        if not isinstance(req, dict):
            raise ValueError("body must be a JSON object")
        return req

    # ------------------------------------------------------------- GET

    def do_GET(self):
        r = type(self).router
        if self.path.startswith("/healthz"):
            self._send(200, {"status": "ok"})
        elif self.path.startswith("/readyz"):
            now = time.monotonic()
            n = sum(1 for rep in r.replicas()
                    if rep.alive(now, r.stale_after))
            if n:
                self._send(200, {"status": "ok", "replicas": n})
            else:
                self._send(503, {"status": "no routable replica"})
        elif self.path.startswith("/v1/stats"):
            self._send(200, r.stats())
        elif self.path.startswith("/metrics"):
            # the router's OWN registry in Prometheus exposition text —
            # the federation scrape target (obs/telemetry.py)
            from instaslice_tpu_torch.metrics.metrics import render

            body = render(r.metrics).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.startswith("/v1/debug/trace"):
            # debug parity with the replicas (serving/api_server.py):
            # router-side routing/migration spans, live
            qs = urllib.parse.parse_qs(
                urllib.parse.urlsplit(self.path).query
            )
            try:
                self._send(200, debug_trace_payload(qs))
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except LookupError as e:
                self._send(404, {"error": str(e)})
        elif self.path.startswith("/v1/debug/events"):
            qs = urllib.parse.parse_qs(
                urllib.parse.urlsplit(self.path).query
            )
            try:
                self._send(200, debug_events_payload(qs))
            except ValueError as e:
                self._send(400, {"error": str(e)})
        elif self.path.startswith("/v1/debug/profile"):
            # router-side profiler ring: proxy/migration lane events
            # (no scheduler rounds — the replicas own those)
            qs = urllib.parse.parse_qs(
                urllib.parse.urlsplit(self.path).query
            )
            try:
                self._send(200, debug_profile_payload(qs))
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except LookupError as e:
                self._send(404, {"error": str(e)})
        elif self.path.startswith("/v1/debug/locks"):
            self._send(200, debug_locks_payload())
        elif self.path.rstrip("/").startswith("/v1/models"):
            # passthrough to any alive replica (they are identical)
            try:
                rep = r.pick_any()
                code, payload = r.http_json("GET", rep,
                                            self.path, None)
                self._send(code, payload)
            except NoReplica as e:
                self._send(503, {"error": str(e)})
        else:
            self._send(404, {"error": f"no route {self.path}"})

    # ------------------------------------------------------------ POST

    def do_POST(self):
        r = type(self).router
        if self.path.startswith("/v1/completions"):
            self._completions()
            return
        if self.path.startswith("/v1/replicas"):
            try:
                url = str(self._read_body().get("url", ""))
                if not url:
                    raise ValueError("body must carry {\"url\": ...}")
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})
                return
            r.add_replica(url)
            self._send(200, {"added": url,
                             "replicas": len(r.replicas())})
            return
        if self.path.startswith("/v1/rebalance"):
            try:
                body = self._read_body()
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})
                return
            out = r.rebalance(n=int(body.get("n", 1)))
            self._send(200, out)
            return
        self._send(404, {"error": f"no route {self.path}"})

    def do_DELETE(self):
        r = type(self).router
        if self.path.startswith("/v1/replicas"):
            try:
                body = self._read_body()
                url = str(body.get("url", ""))
                if not url:
                    raise ValueError("body must carry {\"url\": ...}")
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})
                return
            out = r.remove_replica(
                url, migrate=bool(body.get("migrate", True)),
                budget=body.get("budget"),
            )
            self._send(200, out)
            return
        self._send(404, {"error": f"no route {self.path}"})

    # ----------------------------------------------------- completions

    def _completions(self) -> None:
        r = type(self).router
        try:
            body = self._read_body()
        except (ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
            return
        header = self.headers.get("X-Trace-Id")
        tid = (header if header and TRACE_ID_SAFE.match(header)
               else new_trace_id())
        tenant = self.headers.get("X-Tenant") or body.get("tenant") \
            or ""
        session_id = self.headers.get("X-Session-Id") \
            or body.get("session") or ""
        # protocol fields are the ROUTER'S to mint, never a client's:
        # a forwarded {"resume": rid} would claim whatever imported
        # session happens to be awaiting resume on a replica — another
        # user's in-flight conversation
        body.pop("resume", None)
        prompt = body.get("prompt")
        prompt = prompt if isinstance(prompt, list) else []
        stream = bool(body.get("stream", False))
        ctx = _ProxyContext(r, self, body, tid, str(tenant),
                            str(session_id), stream)
        try:
            ctx.run(prompt)
        except NoReplica as e:
            r.count_request("no-replica")
            self._send(503, {"error": str(e)}, retry_after=1.0)
        except (BrokenPipeError, ConnectionError, OSError):
            # the CLIENT went away mid-proxy: nothing to send
            r.count_request("client-gone")
            self.close_connection = True


class _ProxyContext:
    """One proxied completion: routing, forwarding, retry-before-
    first-token, and mid-stream migration stitching. Lives on the
    handler thread that owns the client connection — the thread that
    sees a migration terminal is exactly the thread that imports the
    session into the destination and splices the streams."""

    def __init__(self, router: "Router", handler: _RouterHandler,
                 body: dict, trace_id: str, tenant: str,
                 session_id: str, stream: bool) -> None:
        self.r = router
        self.h = handler
        self.body = body
        self.trace_id = trace_id
        self.tenant = tenant
        self.session_id = session_id
        self.stream = stream
        self.session_key = f"sk-{uuid.uuid4().hex[:16]}"
        self.tokens_forwarded = 0
        self.headers_sent = False
        self.errored = False        # a terminal error already counted
        self.tried: List[str] = []
        self.hops = 0               # migrations this request survived
        #: tokens recovered from a migration blob when the import path
        #: fell back to re-prefill (sync mode accumulates, stream emits)
        self._prefix_tokens: List[int] = []

    # ------------------------------------------------------- plumbing

    def _headers(self) -> dict:
        h = {"Content-Type": "application/json",
             "X-Session-Key": self.session_key,
             "X-Trace-Id": self.trace_id}
        if self.tenant:
            h["X-Tenant"] = self.tenant
        return h

    def _open(self, rep: Replica, payload: dict,
              timeout: Optional[float] = None):
        """POST a completion to ``rep``; returns the live response
        object (streaming reads follow). Breaker-audited. ``timeout``
        overrides the default socket deadline (migration hops use the
        shorter ``migrate_timeout`` so a wedged destination falls back
        to a survivor instead of holding the client)."""
        rep.breaker.check()
        req = urllib.request.Request(
            rep.url + "/v1/completions",
            data=json.dumps(payload).encode(),
            headers=self._headers(), method="POST",
        )
        try:
            self.r.maybe_nemesis(rep)
            resp = urllib.request.urlopen(
                req, timeout=timeout or self.r.request_timeout
            )
        except urllib.error.HTTPError:
            raise                       # terminal HTTP status: not a
        except _TRANSPORT_EXC:          # breaker event
            self.r.breaker_fail(rep)
            raise
        rep.breaker.ok()
        return resp

    # ------------------------------------------------------ main flow

    def run(self, prompt: List[int]) -> None:
        payload = dict(self.body)
        t0 = time.perf_counter()
        for attempt in range(self.r.max_retries + 1):
            try:
                rep, policy = self.r.route(
                    prompt, self.tenant, self.session_id,
                    exclude=self.tried,
                )
            except NoReplica:
                if not self.headers_sent:
                    raise       # handler sends the clean 503
                break           # mid-stream: terminal error below
            get_tracer().record(
                "router.route", (time.perf_counter() - t0) * 1e3,
                trace_id=self.trace_id, replica=rep.url,
                policy=policy, attempt=attempt,
            )
            get_profiler().event(
                "proxy", "route",
                dur_ms=(time.perf_counter() - t0) * 1e3,
                replica=rep.url, policy=policy, attempt=attempt,
                trace_id=self.trace_id,
            )
            self.r.count_routed(policy)
            self.tried.append(rep.url)
            try:
                resp = self._open(rep, payload)
            except urllib.error.HTTPError as e:
                if e.code in (429, 503) and not self.tokens_forwarded \
                        and attempt < self.r.max_retries:
                    e.read()
                    continue        # shed/draining: try a peer
                self._relay_http_error(e)
                return
            except _TRANSPORT_EXC as e:
                if not self.tokens_forwarded \
                        and attempt < self.r.max_retries:
                    continue
                self.r.count_request("transport-error")
                self._client_error(502, f"replica {rep.url}: {e}")
                return
            except CircuitOpen:
                continue
            with resp:
                if self.stream:
                    done = self._relay_stream(rep, resp)
                else:
                    done = self._relay_sync(rep, resp)
            if done:
                if not self.errored:
                    if self.session_id:
                        self.r.pin_session(self.session_id,
                                           self.tried[-1])
                    self.r.count_request("ok" if self.hops == 0
                                         else "ok-migrated")
                return
        self.r.count_request("no-replica")
        if not self.headers_sent:
            self.h._send(503, {"error": "no replica accepted the "
                                        "request"}, retry_after=1.0)
        else:
            self._write_event({"error": "no replica accepted the "
                                        "request"})
            self._write_event("[DONE]")

    # ------------------------------------------------------ sync path

    def _relay_sync(self, rep: Replica, resp) -> bool:
        payload = json.loads(resp.read())
        if payload.get("object") == "text_completion.migration":
            return self._continue_session(rep, payload["session"])
        # merge tokens a migration FALLBACK already accumulated
        if self._prefix_tokens:
            for c in payload.get("choices", []):
                c["token_ids"] = self._prefix_tokens + c["token_ids"]
            usage = payload.get("usage")
            if usage:
                usage["completion_tokens"] = (
                    usage.get("completion_tokens", 0)
                    + len(self._prefix_tokens)
                )
        self.h._send(resp.status, payload)
        self.headers_sent = True
        return True

    # ---------------------------------------------------- stream path

    def _begin_stream(self) -> None:
        if self.headers_sent:
            return
        self.h.send_response(200)
        self.h.send_header("Content-Type", "text/event-stream")
        self.h.send_header("Cache-Control", "no-cache")
        self.h.send_header("X-Trace-Id", self.trace_id)
        self.h.end_headers()
        self.headers_sent = True

    def _write_event(self, payload) -> None:
        data = payload if isinstance(payload, str) else json.dumps(
            payload
        )
        self.h.wfile.write(f"data: {data}\n\n".encode())
        self.h.wfile.flush()

    def _relay_stream(self, rep: Replica, resp) -> bool:
        """Forward SSE events verbatim; a migration terminal hands off
        to :meth:`_continue_session` (the [DONE] after it is consumed,
        not forwarded — the CLIENT's stream continues on the
        destination's events). Returns False to ask :meth:`run` for a
        re-route: a streaming request sheds IN-BAND (the replica sent
        its SSE headers before admission, so a drain/shed arrives as
        an error event, not a 503) — with zero tokens forwarded a peer
        can still serve the whole request."""
        self._begin_stream()
        buf = b""
        plan = get_nemesis()
        while True:
            try:
                chunk = resp.read1(65536)
            except _TRANSPORT_EXC as e:
                self.r.breaker_fail(rep)
                self._client_error(502, f"replica stream died: {e}")
                return True         # client already has a terminal
            if plan is not None and chunk:
                # nemesis slow-transfer throttling on the stream edge
                plan.throttle_sleep("router", f"replica:{rep.url}",
                                    len(chunk))
            if not chunk:
                # upstream ended without [DONE]: surface, don't hang
                self._write_event({"error": "replica stream ended "
                                            "early"})
                self._write_event("[DONE]")
                return True
            buf += chunk
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                line = event.decode().strip()
                if not line.startswith("data: "):
                    continue
                data = line[len("data: "):]
                if data == "[DONE]":
                    self._write_event("[DONE]")
                    return True
                payload = json.loads(data)
                if payload.get("object") == \
                        "text_completion.migration":
                    return self._continue_session(
                        rep, payload["session"]
                    )
                if "error" in payload and "choices" not in payload:
                    if not self.tokens_forwarded:
                        # in-band shed (drain/queue-full on a stream
                        # that was never admitted): retry on a peer
                        # instead of relaying a failure the fleet can
                        # absorb
                        log.info("re-routing in-band stream error "
                                 "from %s: %s", rep.url,
                                 payload["error"])
                        return False
                    self._write_event(payload)
                    self._write_event("[DONE]")
                    return True
                for c in payload.get("choices", []):
                    self.tokens_forwarded += len(
                        c.get("token_ids") or []
                    )
                self._write_event(payload)

    # ------------------------------------------------------ migration

    def _continue_session(self, source: Replica, blob: dict) -> bool:
        """The session left ``source`` mid-decode — import it into a
        peer and splice the resumed response into the client's, so the
        client sees ONE continuous completion. Falls back to
        re-prefill (prompt + generated tokens as a fresh prompt) when
        no peer accepts the import; the radix cache usually makes even
        that cheap."""
        self.hops += 1
        t0 = time.perf_counter()
        dests = self.r.migration_destinations(
            exclude=[source.url], prompt=blob.get("prompt") or []
        )
        for dest in dests:
            try:
                code, imp = self.r.http_json(
                    "POST", dest, "/v1/sessions/import",
                    {"session": blob},
                    timeout=self.r.migrate_timeout,
                )
                if code != 200:
                    continue
                payload = {"resume": imp["rid"], "stream": self.stream}
                resp = self._open(dest, payload,
                                  timeout=self.r.migrate_timeout)
                # the hop timeout bounded the handshake; the RESUMED
                # stream gets the normal request deadline back — a
                # migrated session legitimately parked/queued on its
                # destination between tokens is not a wedged hop
                try:
                    resp.fp.raw._sock.settimeout(
                        self.r.request_timeout
                    )
                except AttributeError:
                    log.debug("could not widen resumed-stream timeout")
            except (urllib.error.HTTPError, *_TRANSPORT_EXC,
                    CircuitOpen) as e:
                log.warning("migration to %s failed: %s", dest.url, e)
                continue
            get_tracer().record(
                "router.migrate",
                (time.perf_counter() - t0) * 1e3,
                trace_id=self.trace_id, source=source.url,
                dest=dest.url, mode="resume",
                tokens_in=len(blob.get("generated", [])),
            )
            get_profiler().event(
                "migrate", "resume",
                dur_ms=(time.perf_counter() - t0) * 1e3,
                source=source.url, dest=dest.url,
                trace_id=self.trace_id,
            )
            self.r.count_migration("resumed")
            self.r.note_migrated_trace(self.trace_id)
            self.tried.append(dest.url)
            if self.session_id:
                self.r.pin_session(self.session_id, dest.url)
            with resp:
                if self.stream:
                    return self._relay_stream(dest, resp)
                return self._relay_sync(dest, resp)
        # ---- fallback: re-prefill the full history on any replica —
        # slower (a prefill the migration existed to skip) but the
        # request still terminates cleanly with the right tokens
        return self._fallback_reprefill(source, blob, t0)

    def _fallback_reprefill(self, source: Replica, blob: dict,
                            t0: float) -> bool:
        generated = [int(t) for t in blob.get("generated", [])]
        sent = int(blob.get("sent", 0))
        remaining = int(blob.get("remaining_budget", 0))
        if self.stream:
            self._begin_stream()
            held = generated[sent:]
            if held:
                # tokens the source decoded but never streamed ride a
                # synthetic delta — the client must not lose them
                self._write_event({
                    "object": "text_completion",
                    "choices": [{"index": 0, "token_ids": held,
                                 "finish_reason": None}],
                })
                self.tokens_forwarded += len(held)
        else:
            self._prefix_tokens = generated
        if remaining < 1:
            if self.stream:
                self._write_event({
                    "object": "text_completion",
                    "choices": [{"index": 0, "token_ids": [],
                                 "finish_reason": "max_new_tokens"}],
                })
                self._write_event("[DONE]")
            else:
                self.h._send(200, {
                    "object": "text_completion",
                    "choices": [{"index": 0,
                                 "token_ids": generated,
                                 "finish_reason": "max_new_tokens"}],
                    "usage": {"prompt_tokens":
                              len(blob.get("prompt", [])),
                              "completion_tokens": len(generated)},
                })
                self.headers_sent = True
            self.r.count_migration("fallback")
            return True
        payload = {
            "prompt": [int(t) for t in blob.get("prompt", [])]
            + generated,
            "max_tokens": remaining,
            "stream": self.stream,
        }
        # the continuation must keep the ORIGINAL request's semantics:
        # stop sequences, adapter, and logprobs ride the client body
        # (a re-prefill that silently switched to the base model or
        # decoded past a stop would return wrong tokens with a 200)
        for key in ("stop", "adapter", "logprobs"):
            if key in self.body:
                payload[key] = self.body[key]
        for attempt in range(self.r.max_retries + 1):
            try:
                dest, _policy = self.r.route(
                    payload["prompt"], self.tenant, "",
                    exclude=[source.url] if attempt == 0 else [],
                )
                resp = self._open(dest, payload)
            except (NoReplica, urllib.error.HTTPError,
                    *_TRANSPORT_EXC, CircuitOpen) as e:
                log.warning("re-prefill fallback attempt failed: %s",
                            e)
                continue
            get_tracer().record(
                "router.migrate",
                (time.perf_counter() - t0) * 1e3,
                trace_id=self.trace_id, source=source.url,
                dest=dest.url, mode="reprefill",
                tokens_in=len(generated),
            )
            get_profiler().event(
                "migrate", "reprefill",
                dur_ms=(time.perf_counter() - t0) * 1e3,
                source=source.url, dest=dest.url,
                trace_id=self.trace_id,
            )
            self.r.count_migration("fallback")
            with resp:
                if self.stream:
                    return self._relay_stream(dest, resp)
                return self._relay_sync(dest, resp)
        self.r.count_migration("lost")
        self._client_error(502, "session migration failed and no "
                                "replica accepted the re-prefill")
        return True

    # --------------------------------------------------------- errors

    def _relay_http_error(self, e) -> None:
        try:
            payload = json.loads(e.read().decode())
        except (ValueError, OSError):
            payload = {"error": str(e.reason)}
        outcome = {429: "shed", 503: "unavailable"}.get(
            e.code, "upstream-error"
        )
        self.r.count_request(outcome)
        if self.headers_sent:
            self._write_event({"error": payload.get("error",
                                                    str(e.reason))})
            self._write_event("[DONE]")
            return
        self.h._send(e.code, payload,
                     retry_after=1.0 if e.code in (429, 503) else None)
        self.headers_sent = True

    def _client_error(self, code: int, msg: str) -> None:
        self.errored = True
        if self.headers_sent:
            self._write_event({"error": msg})
            self._write_event("[DONE]")
            return
        self.h._send(code, {"error": msg})
        self.headers_sent = True


class Router:
    """The fleet front-end (module docstring has the full story).

    ``replicas``: initial replica base URLs. ``poll_interval`` paces
    the stats poll loop; ``stale_after`` is how long a replica may go
    unpolled before it stops being routable; ``kv_weight`` scales KV
    pressure in the load score (via :meth:`Replica.load_score`).
    ``metrics``: a :class:`~instaslice_tpu_torch.metrics.metrics.
    RouterMetrics` (defaulted)."""

    #: stats-poll failure backoff (capped decorrelated jitter; the
    #: kube/real.py policy at router scale)
    poll_backoff_base = 0.05
    poll_backoff_cap = 2.0
    retry_after_cap = 30.0

    # ---- thread model (slicecheck-verified): replica table, session
    # affinity, and the counters are shared between the poll loop, the
    # HTTP handler threads, and admin calls — all under router.state
    _replicas: guarded_by("router.state")
    _sessions: guarded_by("router.state")
    requests: guarded_by("router.state")
    routed: guarded_by("router.state")
    migrations: guarded_by("router.state")
    ejections: guarded_by("router.state")
    hedges: guarded_by("router.state")

    def __init__(self, replicas=(), host: str = "127.0.0.1",
                 port: int = 0, poll_interval: float = 0.25,
                 stale_after: float = 3.0, request_timeout: float = 300.0,
                 max_retries: int = 2, session_ttl: float = 600.0,
                 breaker_threshold: int = 3,
                 breaker_cooldown: float = 2.0, metrics=None,
                 migrate_timeout: Optional[float] = None,
                 eject_factor: float = 3.0,
                 readmit_factor: float = 1.5,
                 eject_min_samples: int = 8,
                 eject_floor_s: float = 0.02,
                 hedge_after: float = 0.5) -> None:
        self.poll_interval = poll_interval
        self.stale_after = stale_after
        self.request_timeout = request_timeout
        self.max_retries = max_retries
        self.session_ttl = session_ttl
        # gray-failure ejection knobs (docs/RECOVERY.md "Partitions &
        # gray failures"): a replica whose poll-latency EWMA p95 exceeds
        # eject_factor × the fleet median (of the OTHER routable
        # replicas) is ejected even at 100% success; re-admitted at
        # readmit_factor × median (hysteresis). eject_floor_s guards
        # microsecond-scale fleets from noise ejections;
        # eject_factor <= 0 disables the sweep. hedge_after is the
        # hedged-retry delay for idempotent stats polls (second request
        # fired if the first hasn't answered; first result wins);
        # <= 0 disables hedging.
        self.eject_factor = eject_factor
        self.readmit_factor = readmit_factor
        self.eject_min_samples = eject_min_samples
        self.eject_floor_s = eject_floor_s
        self.hedge_after = hedge_after
        # self-healing watchdog (docs/RECOVERY.md): bound on EACH
        # migration hop (import POST + resume handshake). Without it a
        # destination that accepted the import and then wedged (crashed
        # scheduler thread) would hold the client the full
        # request_timeout; with it the hop times out, the next survivor
        # is tried, and the re-prefill fallback terminates the request
        # with the right tokens. The orphaned import on the wedged
        # replica is swept engine-side after its import TTL.
        # 0 (or negative) = disabled: hops get the full
        # request_timeout — normalized HERE so every consumer sees one
        # semantic (a raw 0 reaching urlopen would mean non-blocking
        # sockets and instantly failing imports).
        from instaslice_tpu_torch.utils.envutil import env_float

        if migrate_timeout is None:
            migrate_timeout = env_float(
                "TPUSLICE_ROUTER_MIGRATE_TIMEOUT", 15.0)
        if migrate_timeout <= 0:
            migrate_timeout = request_timeout
        self.migrate_timeout = migrate_timeout
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self._lock = named_lock("router.state")
        self._replicas: Dict[str, Replica] = {}
        #: session affinity: session id → (replica url, last-used ts)
        self._sessions: Dict[str, Tuple[str, float]] = {}
        # counters (also exported via RouterMetrics)
        self.requests: Dict[str, int] = {}
        self.routed: Dict[str, int] = {}
        self.migrations: Dict[str, int] = {}
        #: gray-failure accounting: replica url → ejection count, and
        #: hedged stats polls fired / won (won = the hedge answered
        #: while the primary was still in flight)
        self.ejections: Dict[str, int] = {}
        self.hedges: Dict[str, int] = {"fired": 0, "won": 0}
        #: trace ids of requests that survived ≥1 migration — the
        #: bench's oracle-comparison hook (bounded ring)
        self.migrated_traces: List[str] = []
        if metrics is None:
            from instaslice_tpu_torch.metrics.metrics import RouterMetrics

            metrics = RouterMetrics()
        self.metrics = metrics
        for url in replicas:
            self.add_replica(url)
        handler = type("BoundRouterHandler", (_RouterHandler,),
                       {"router": self})
        self._srv = ThreadingHTTPServer((host, port), handler)
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="router-http",
            daemon=True,
        )
        self._stop = threading.Event()
        self._poller = threading.Thread(
            target=self._poll_loop, name="router-poll", daemon=True
        )

    # ---------------------------------------------------------- lifecycle

    @property
    def url(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "Router":
        self.poll_now()
        self._poller.start()
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._srv.shutdown()
        self._srv.server_close()
        self._poller.join(timeout=5)
        self._thread.join(timeout=5)

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ replicas

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def add_replica(self, url: str) -> Replica:
        rep = Replica(url, self.breaker_threshold,
                      self.breaker_cooldown)
        with self._lock:
            existing = self._replicas.get(rep.url)
            if existing is not None:
                existing.draining = False
                return existing
            self._replicas[rep.url] = rep
            n = len(self._replicas)
        self.metrics.replicas.set(n)
        self._poll_one(rep)
        return rep

    def remove_replica(self, url: str, migrate: bool = True,
                       budget: Optional[float] = None,
                       deadline_s: float = 30.0) -> dict:
        """Drain-without-503 replica removal: mark the replica
        undroutable, drain it with ``migrate`` so every in-flight
        session leaves through its own response (the proxy threads
        import them into peers), wait for quiesce, drop it from the
        pool. The replica process itself is the operator's to stop."""
        url = url.rstrip("/")
        with self._lock:
            rep = self._replicas.get(url)
        if rep is None:
            return {"removed": False, "error": f"unknown replica {url}"}
        rep.draining = True
        body = {"migrate": migrate}
        if budget is not None:
            body["budget"] = budget
        migrated = 0
        pause = 0.0
        for _attempt in range(3):
            try:
                code, out = self.http_json("POST", rep, "/v1/drain",
                                           body)
            except _TRANSPORT_EXC as e:
                log.warning("drain of %s failed (%s): removing anyway",
                            url, e)
                break
            if code == 200:
                migrated = int(out.get("migrated", 0))
                break
            if code not in (429, 503):
                break
            # pushed back: honor Retry-After with jittered backoff
            pause = self._next_backoff(pause, rep.retry_after_hint)
            if self._stop.wait(pause):
                break
        # wait for the replica to go idle (its exported sessions are
        # resumed elsewhere by the proxy threads; queued requests shed
        # and retried by their own handlers). Jittered pacing, not a
        # fixed tick: N concurrent removals re-polling in lockstep is
        # exactly the stampede the backoff policy exists to break.
        deadline = time.monotonic() + deadline_s
        idle = False
        pause = 0.0
        while time.monotonic() < deadline:
            try:
                _code, s = self.http_json("GET", rep, "/v1/stats",
                                          None)
                if not (s.get("live_slots") or s.get("queued")
                        or s.get("parked")):
                    idle = True
                    break
            except _TRANSPORT_EXC:
                idle = True            # it already went away
                break
            pause = self._next_backoff(
                min(pause, 0.2), rep.retry_after_hint
            )
            if self._stop.wait(pause):
                break
        with self._lock:
            self._replicas.pop(url, None)
            self._sessions = {
                sid: (u, ts) for sid, (u, ts) in self._sessions.items()
                if u != url
            }
            n = len(self._replicas)
        self.metrics.replicas.set(n)
        return {"removed": True, "migrated": migrated, "idle": idle,
                "replicas": n}

    # ------------------------------------------------------------- polling

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            self.poll_now()
            self._gray_sweep()
            self._sweep_sessions()

    def poll_now(self) -> None:
        for rep in self.replicas():
            self._poll_one(rep)

    def _next_backoff(self, prev: float,
                      retry_after: Optional[float] = None) -> float:
        """Capped decorrelated-jitter backoff, stretched to honor a
        server Retry-After — the kube/real.py ``_backoff_sleep`` policy
        without the sleep (poll pacing owns the wait)."""
        delay = min(
            self.poll_backoff_cap,
            random.uniform(self.poll_backoff_base,
                           max(prev, self.poll_backoff_base) * 3),
        )
        if retry_after is not None:
            delay = max(delay, min(retry_after, self.retry_after_cap))
        return delay

    def _note_poll_failure(self, rep: Replica,
                           retry_after: Optional[float]) -> None:
        rep.poll_backoff = self._next_backoff(rep.poll_backoff,
                                              retry_after)
        rep.poll_next = time.monotonic() + rep.poll_backoff

    def _poll_one(self, rep: Replica) -> None:
        if rep.breaker.is_open():
            return
        if time.monotonic() < rep.poll_next:
            return  # backing off a recent failure (jittered, not fixed)
        try:
            code, stats, lat = self._hedged_stats(rep)
        except _TRANSPORT_EXC as e:
            log.debug("poll of %s failed: %s", rep.url, e)
            self.breaker_fail(rep)
            self._note_poll_failure(rep, None)
            return
        if code != 200:
            # 429/503 push back: honor Retry-After before re-polling
            self._note_poll_failure(
                rep,
                rep.retry_after_hint if code in (429, 503) else None,
            )
            return
        rep.poll_backoff = 0.0
        rep.poll_next = 0.0
        rep.breaker.ok()
        rep.observe_latency(lat)
        self.metrics.replica_latency.labels(replica=rep.url).set(
            rep.lat_p95()
        )
        if rep.adopt_stats(stats):
            log.warning("replica %s RESTARTED: dropping its session "
                        "affinities", rep.url)
            with self._lock:
                self._sessions = {
                    sid: (u, ts)
                    for sid, (u, ts) in self._sessions.items()
                    if u != rep.url
                }

    def _hedged_stats(self, rep: Replica):
        """GET /v1/stats with one hedged retry: if the primary hasn't
        answered within ``hedge_after`` seconds a second (idempotent)
        request races it and the first result wins — a gray replica's
        slow answer can't stall the poll loop's view of it. Returns
        (code, payload, winner_latency_s)."""
        if self.hedge_after <= 0:
            t0 = time.perf_counter()
            code, payload = self.http_json("GET", rep, "/v1/stats",
                                           None)
            return code, payload, time.perf_counter() - t0
        box: dict = {}
        done = threading.Event()

        def primary():
            t0 = time.perf_counter()
            try:
                code, payload = self.http_json("GET", rep, "/v1/stats",
                                               None)
                box["first"] = (code, payload,
                                time.perf_counter() - t0)
            except _TRANSPORT_EXC as e:
                box["exc"] = e
            done.set()

        th = threading.Thread(target=primary, name="router-poll-first",
                              daemon=True)
        th.start()
        if done.wait(self.hedge_after):
            if "exc" in box:
                raise box["exc"]
            return box["first"]
        with self._lock:
            self.hedges["fired"] += 1
        t0 = time.perf_counter()
        try:
            code, payload = self.http_json("GET", rep, "/v1/stats",
                                           None)
            hedge = (code, payload, time.perf_counter() - t0)
        except _TRANSPORT_EXC:
            # hedge died too: fall back to whatever the primary does
            done.wait(self.request_timeout)
            if "first" in box:
                return box["first"]
            raise
        if done.is_set() and "first" in box:
            return box["first"]  # primary got there first after all
        with self._lock:
            self.hedges["won"] += 1
        self.count_request("hedged-ok")
        return hedge

    # ------------------------------------------------- gray-failure eject

    def _gray_sweep(self) -> None:
        """Eject replicas whose latency EWMA p95 degrades past
        ``eject_factor`` × the fleet median even at 100% success (the
        gray failure a circuit breaker never sees), drain their
        sessions through the live-migration path, and re-admit at
        ``readmit_factor`` × median once the EWMA recovers
        (hysteresis). Never ejects below 2 routable peers."""
        if self.eject_factor <= 0:
            return
        seasoned = [r for r in self.replicas()
                    if r.lat_samples >= self.eject_min_samples
                    and not r.breaker.is_open() and not r.draining]
        healthy = [r for r in seasoned if not r.ejected]
        for rep in seasoned:
            others = [h.lat_p95() for h in healthy if h is not rep]
            if not others:
                continue
            med = _median(others)
            p95 = rep.lat_p95()
            if not rep.ejected:
                if (len(healthy) >= 2
                        and p95 > max(self.eject_floor_s,
                                      self.eject_factor * med)):
                    self._eject(rep, p95, med)
                    healthy.remove(rep)
            elif p95 <= max(self.eject_floor_s,
                            self.readmit_factor * med):
                self._readmit(rep, p95, med)
                healthy.append(rep)

    def _eject(self, rep: Replica, p95: float, med: float) -> None:
        rep.ejected = True
        with self._lock:
            self.ejections[rep.url] = self.ejections.get(rep.url, 0) + 1
            # its radix cache will be cold-ish on return and its
            # sessions are about to migrate out: drop the affinities now
            self._sessions = {
                sid: (u, ts) for sid, (u, ts) in self._sessions.items()
                if u != rep.url
            }
        self.metrics.replica_ejections.inc()
        log.warning(
            "replica %s gray-EJECTED: latency p95 %.4fs > %.1fx fleet "
            "median %.4fs (success rate untouched); draining sessions",
            rep.url, p95, self.eject_factor, med,
        )
        get_journal().emit(
            "router",
            reason=REASON_REPLICA_EJECTED,
            object_ref=f"replica/{rep.url}",
            message=(f"latency p95 {p95:.4f}s vs fleet median "
                     f"{med:.4f}s; sessions draining via migration"),
        )
        # drain (migrate) off the poll thread: a gray replica answers
        # SLOWLY, and the sweep must not stall behind it
        threading.Thread(
            target=self._drain_ejected, args=(rep,),
            name="router-eject-drain", daemon=True,
        ).start()

    def _drain_ejected(self, rep: Replica) -> None:
        pause = 0.0
        for _ in range(3):
            try:
                code, _out = self.http_json(
                    "POST", rep, "/v1/drain", {"migrate": True},
                    timeout=self.migrate_timeout,
                )
            except _TRANSPORT_EXC as e:
                log.warning("drain of ejected %s failed: %s",
                            rep.url, e)
                return
            if code not in (429, 503):
                return
            pause = self._next_backoff(pause, rep.retry_after_hint)
            if self._stop.wait(pause):
                return

    def _readmit(self, rep: Replica, p95: float, med: float) -> None:
        try:
            # lift the replica-side drain so it admits again
            self.http_json("DELETE", rep, "/v1/drain", {})
        except _TRANSPORT_EXC as e:
            log.warning("undrain of %s failed (%s); retrying next "
                        "sweep", rep.url, e)
            return
        rep.ejected = False
        log.info("replica %s re-admitted: latency p95 %.4fs back "
                 "within %.1fx fleet median %.4fs", rep.url, p95,
                 self.readmit_factor, med)
        get_journal().emit(
            "router",
            reason=REASON_REPLICA_READMITTED,
            object_ref=f"replica/{rep.url}",
            message=(f"latency p95 {p95:.4f}s recovered vs fleet "
                     f"median {med:.4f}s"),
        )

    def _sweep_sessions(self) -> None:
        now = time.monotonic()
        with self._lock:
            self._sessions = {
                sid: (u, ts) for sid, (u, ts) in self._sessions.items()
                if now - ts <= self.session_ttl
            }

    # ------------------------------------------------------------- routing

    def route(self, prompt: List[int], tenant: str = "",
              session_id: str = "",
              exclude=()) -> Tuple[Replica, str]:
        """Pick a replica for a fresh completion; returns (replica,
        policy) where policy names which rule fired: ``session`` /
        ``prefix`` / ``least-loaded``. Raises :class:`NoReplica`."""
        now = time.monotonic()
        tenant_class = self._tenant_class(tenant)
        cands = [rep for rep in self.replicas()
                 if rep.alive(now, self.stale_after)
                 and rep.url not in exclude]
        if not cands:
            ejected = sum(1 for rep in self.replicas() if rep.ejected)
            raise NoReplica(
                "no routable replica (all dead, draining, "
                "circuit-broken, or already tried"
                + (f"; {ejected} gray-ejected" if ejected else "")
                + ")"
            )
        # 1. session affinity: a multi-turn follow-up goes back to the
        # replica whose radix cache holds its history
        if session_id:
            with self._lock:
                hit = self._sessions.get(session_id)
            if hit is not None:
                for rep in cands:
                    if rep.url == hit[0]:
                        self.pin_session(session_id, rep.url)
                        return rep, "session"
        # 2. prefix-cache affinity via the shadow index (the prompt's
        # granule hashes computed once per distinct granule size, not
        # once per replica)
        want_by_g: Dict[int, List[str]] = {}
        best, best_match = None, 0
        for rep in cands:
            if rep.granule not in want_by_g:
                want_by_g[rep.granule] = want_hashes(prompt,
                                                    rep.granule)
            m = rep.prefix_match(prompt, want_by_g[rep.granule])
            if m > best_match or (
                m == best_match and m > 0 and best is not None
                and rep.load_score(tenant_class)
                < best.load_score(tenant_class)
            ):
                best, best_match = rep, m
        if best is not None and best_match > 0:
            return best, "prefix"
        # 3. least-loaded weighted by KV pressure + tenant class
        rep = min(cands, key=lambda c: c.load_score(tenant_class))
        return rep, "least-loaded"

    def _tenant_class(self, tenant: str) -> str:
        if not tenant:
            return "standard"
        for rep in self.replicas():
            cls = (rep.stats.get("tenant_classes") or {}).get(tenant)
            if cls:
                return cls
        return "standard"

    def pick_any(self) -> Replica:
        now = time.monotonic()
        for rep in self.replicas():
            if rep.alive(now, self.stale_after):
                return rep
        raise NoReplica("no routable replica")

    def migration_destinations(self, exclude=(),
                               prompt=None) -> List[Replica]:
        """Import destinations for a migrating session, best first:
        prefix affinity over the session's prompt, then least load."""
        now = time.monotonic()
        cands = [rep for rep in self.replicas()
                 if rep.alive(now, self.stale_after)
                 and rep.url not in exclude]
        want_by_g: Dict[int, List[str]] = {}
        for rep in cands:
            if rep.granule not in want_by_g:
                want_by_g[rep.granule] = want_hashes(prompt or [],
                                                     rep.granule)
        cands.sort(key=lambda c: (
            -c.prefix_match(prompt or [], want_by_g[c.granule]),
            c.load_score(),
        ))
        return cands

    def pin_session(self, session_id: str, url: str) -> None:
        with self._lock:
            self._sessions[session_id] = (url, time.monotonic())

    # ----------------------------------------------------------- rebalance

    def rebalance(self, n: int = 1) -> dict:
        """Move up to ``n`` sessions off the most loaded replica: its
        scheduler exports them through their in-flight responses, and
        the proxy threads import each into the least-loaded peer —
        live, mid-stream, no client-visible interruption."""
        now = time.monotonic()
        cands = [rep for rep in self.replicas()
                 if rep.alive(now, self.stale_after)]
        if len(cands) < 2:
            return {"requested": 0, "error": "need >= 2 replicas"}
        hot = max(cands, key=lambda c: c.load_score())
        try:
            _code, out = self.http_json(
                "POST", hot, "/v1/sessions/export", {"limit": n}
            )
        except _TRANSPORT_EXC as e:
            return {"requested": 0, "error": str(e)}
        return {"requested": int(out.get("migrated", 0)),
                "replica": hot.url}

    # ---------------------------------------------------------- accounting

    def maybe_nemesis(self, rep: Replica) -> None:
        """Consult the global nemesis plan on the router→replica edge
        (``router>replica:<url>`` — partitions raise a connection
        error the breaker/retry machinery already handles; latency
        rules sleep, which is exactly how a gray replica is
        injected)."""
        plan = get_nemesis()
        if plan is not None:
            plan.before_request("router", f"replica:{rep.url}")

    def breaker_fail(self, rep: Replica) -> None:
        """Record a transport failure against ``rep``'s breaker and —
        when THIS failure opened the circuit — log and count it. Every
        failure site goes through here (poll loop and request path
        alike), or opens caused by live traffic would be invisible to
        ``tpuslice_router_breaker_open_total``."""
        if rep.breaker.fail():
            log.warning("replica %s circuit OPEN", rep.url)
            self.metrics.breaker_opens.inc()

    def count_request(self, outcome: str) -> None:
        with self._lock:
            self.requests[outcome] = self.requests.get(outcome, 0) + 1
        self.metrics.requests.labels(outcome=outcome).inc()

    def count_routed(self, policy: str) -> None:
        with self._lock:
            self.routed[policy] = self.routed.get(policy, 0) + 1
        self.metrics.routed.labels(policy=policy).inc()

    def count_migration(self, outcome: str) -> None:
        with self._lock:
            self.migrations[outcome] = (
                self.migrations.get(outcome, 0) + 1
            )
        self.metrics.migrations.labels(outcome=outcome).inc()

    def note_migrated_trace(self, trace_id: str) -> None:
        with self._lock:
            self.migrated_traces.append(trace_id)
            del self.migrated_traces[:-256]

    def stats(self) -> dict:
        now = time.monotonic()
        reps = self.replicas()
        with self._lock:
            out = {
                "replicas": {rep.url: rep.to_dict() for rep in reps},
                "routable": sum(
                    1 for rep in reps
                    if rep.alive(now, self.stale_after)
                ),
                "sessions": len(self._sessions),
                "requests": dict(self.requests),
                "routed": dict(self.routed),
                "migrations": dict(self.migrations),
                "ejections": dict(self.ejections),
                "hedges": dict(self.hedges),
                "migrated_traces": list(self.migrated_traces),
            }
        return out

    # ------------------------------------------------------------ plumbing

    def http_json(self, method: str, rep: Replica, path: str,
                  body: Optional[dict], timeout: float = 10.0):
        """One JSON round-trip to a replica (control-plane calls:
        stats polls, drains, imports). Breaker-audited; HTTP error
        statuses return (code, payload) rather than raising — a 400
        from an import is an ANSWER (version mismatch), not a
        transport failure."""
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            rep.url + path, data=data,
            headers={"Content-Type": "application/json"},
            method=method,
        )
        try:
            self.maybe_nemesis(rep)
            with urllib.request.urlopen(req, timeout=timeout) as r:
                rep.retry_after_hint = None
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            # surface the server's pushback hint so poll/drain backoff
            # can honor it (kube/real.py does the same for 429/503)
            rep.retry_after_hint = _retry_after_seconds(e.headers)
            try:
                return e.code, json.loads(e.read().decode() or "{}")
            except ValueError:
                return e.code, {}
        except _TRANSPORT_EXC:
            self.breaker_fail(rep)
            raise


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpuslice-gpu-router")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--replica", action="append", default=[],
                    metavar="URL",
                    help="engine replica base URL (repeatable); more "
                         "can join later via POST /v1/replicas")
    ap.add_argument("--poll-interval", type=float, default=0.25,
                    help="seconds between /v1/stats polls per replica")
    ap.add_argument("--stale-after", type=float, default=3.0,
                    help="unpolled seconds before a replica stops "
                         "being routable")
    ap.add_argument("--request-timeout", type=float, default=300.0)
    ap.add_argument("--max-retries", type=int, default=2,
                    help="re-route attempts before any token was "
                         "forwarded (shed/dead replicas)")
    ap.add_argument("--session-ttl", type=float, default=600.0,
                    help="seconds of inactivity before a session "
                         "affinity entry expires")
    ap.add_argument("--migrate-timeout", type=float, default=None,
                    help="seconds each migration hop (session import + "
                         "resume handshake) may take before the next "
                         "survivor / the re-prefill fallback is tried; "
                         "0 disables (hops get the full request "
                         "timeout) (env: "
                         "TPUSLICE_ROUTER_MIGRATE_TIMEOUT; default 15)")
    ap.add_argument("--eject-factor", type=float, default=3.0,
                    help="gray-failure ejection: eject a replica whose "
                         "latency-EWMA p95 exceeds this multiple of "
                         "the fleet median (<= 0 disables)")
    ap.add_argument("--readmit-factor", type=float, default=1.5,
                    help="re-admit an ejected replica once its p95 "
                         "falls back within this multiple of the "
                         "fleet median (hysteresis)")
    ap.add_argument("--hedge-after", type=float, default=0.5,
                    help="seconds before an idempotent stats poll is "
                         "hedged with a second request (first result "
                         "wins; <= 0 disables)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="Prometheus /metrics port (0 = off)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if not args.replica:
        log.warning("starting with ZERO replicas — add them via "
                    "POST /v1/replicas {\"url\": ...}")
    router = Router(
        replicas=args.replica, host=args.host, port=args.port,
        poll_interval=args.poll_interval, stale_after=args.stale_after,
        request_timeout=args.request_timeout,
        max_retries=args.max_retries, session_ttl=args.session_ttl,
        migrate_timeout=args.migrate_timeout,
        eject_factor=args.eject_factor,
        readmit_factor=args.readmit_factor,
        hedge_after=args.hedge_after,
    ).start()
    if args.metrics_port:
        from instaslice_tpu_torch.metrics.metrics import start_metrics_server

        start_metrics_server(router.metrics, args.metrics_port,
                             host=args.host)
    log.info("routing %d replica(s) on %s", len(router.replicas()),
             router.url)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        router.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
