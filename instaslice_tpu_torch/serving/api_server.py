"""Minimal OpenAI-style HTTP front-end for :class:`ServingEngine`.

A single process that serves continuous-batched completions from one
card over HTTP, behind the reference's ``/v1/*`` contract.

- ``POST /v1/completions`` with ``{"prompt": [token ids], "max_tokens":
  N, "temperature": T}`` → ``{"choices": [{"token_ids": [...],
  "finish_reason": ...}]}``. Token-id prompts (vLLM supports the same)
  keep the server tokenizer-free — the tokenizer belongs to the client
  model stack, not the slice operator. Add ``"stream": true`` for
  server-sent events: one ``data:`` chunk of fresh token ids per decode
  block, a final chunk with finish reason + usage, ``data: [DONE]``;
  a client that disconnects mid-stream has its slot evicted.
  ``"stop"`` takes token-id sequence(s); output truncates before the
  earliest match (streaming holds back a stop-window of tokens so a
  boundary-spanning match never over-delivers). ``"logprobs": true``
  adds each token's log-probability under the distribution it was
  sampled from (post temperature/top-k/top-p), 1:1 with ``token_ids``
  in both sync and streaming responses. ``"n": k`` returns k parallel
  samples (one prefill, KV-stripe forks; indexed choices; streaming
  chunks carry their choice index).
- ``GET /healthz`` → liveness; ``GET /v1/stats`` → engine counters
  (including the ``radix`` prefix-cache block: hits/misses/inserted/
  evicted, cached nodes/tokens/blocks).
- Prefix reuse is AUTOMATIC (the radix prefix cache, docs/SERVING.md):
  every completed prompt seeds the cache and later prompts sharing a
  prefix skip that prefill. ``POST /v1/prefixes`` with ``{"tokens":
  [token ids]}`` additionally PINS a prefix up front (pre-inserted,
  eviction-exempt; length must be a multiple of the prefill chunk;
  capped at the engine's ``max_prefixes``) — deprecated as an
  optimization step, kept one release. ``DELETE /v1/prefixes`` with
  the same body un-pins it.

One scheduler thread owns the engine (the engine is not thread-safe by
design — device dispatch is serialized anyway). The decision loop lives
in :mod:`instaslice_tpu_torch.serving.scheduler`: continuous batching
(admit/evict at every decode-block boundary, blocks trimmed to the
smallest remaining budget), tenant priority classes + weighted fair
share (``X-Tenant`` header / ``"tenant"`` field, policy via
``--tenants`` / ``TPUSLICE_TENANTS``), SLO-aware preemption of
best-effort requests (parked KV, cheap resume), per-request budgets,
eviction of requests whose client already got a 503, and delivery to
waiting HTTP threads.

A copy of ``instaslice_tpu/serving/api_server.py`` over the port's
engine and scheduler: the port imports nothing of the JAX package. The
handler, the server and the flags are the reference's, plus
``--device`` (default the card); :func:`build_engine` makes the model
on the device from a seeded init (or a port checkpoint; the draft of
``--draft-*`` likewise from ``--draft-checkpoint``), merges one
``--lora`` adapter into the weights or serves several batched, and
serves ``--window`` (sliding-window attention) and ``--quantize-bits 4``
(group-wise int4 weights over an int8 KV cache), and refuses the flags
whose paths are not ported yet (an orbax checkpoint). ``--from-env``
serves tensor-parallel over every rank of the process group, stacked
``--lora`` adapters included (:func:`build_engine`,
:func:`split_ranks`): rank 0 answers HTTP through
:class:`~instaslice_tpu_torch.serving.distributed.DistributedEngine` and
the other ranks replay its op stream on ``--oplog-port``. The TPU host lock (``utils/tpulock.py``) is a
rule of the TPU host's runtime and is not copied. Run via
``tpuslice-gpu-serve`` or
``python -m instaslice_tpu_torch.serving.api_server``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import queue
import signal
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from instaslice_tpu_torch.obs.journal import debug_events_payload
from instaslice_tpu_torch.obs.profiler import (
    debug_profile_payload,
    get_profiler,
)
from instaslice_tpu_torch.utils.lockcheck import debug_locks_payload
from instaslice_tpu_torch.serving.engine import ServingEngine
from instaslice_tpu_torch.serving.scheduler import (
    Draining,
    Pending,
    QueueFull,
    Scheduler,
)
from instaslice_tpu_torch.utils.trace import (
    TRACE_ID_SAFE,
    debug_trace_payload,
    new_trace_id,
)

log = logging.getLogger("instaslice_tpu_torch.serving.api")


def _mint_trace_id(header: Optional[str]) -> str:
    """The serving plane's trace admission point: honor a well-formed
    client ``X-Trace-Id`` (cross-service propagation; the shared
    ``TRACE_ID_SAFE`` shape — header content must not leak into JSONL
    trace files or exemplar labels unsanitized), mint otherwise."""
    if header and TRACE_ID_SAFE.match(header):
        return header
    return new_trace_id()


def _env_float(name: str, default: float) -> float:
    """One definition of each env-tunable default, shared by the
    library constructor and the CLI parser so they cannot drift."""
    return float(os.environ.get(name, str(default)))


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _env_flag(name: str, default: bool = True) -> bool:
    return os.environ.get(
        name, "1" if default else "0"
    ).lower() not in ("0", "false", "no")


#: the decision loop lives in serving/scheduler.py (continuous
#: batching, tenant classes, weighted fair share, SLO preemption); the
#: old private names stay importable — tests and embedders constructed
#: _Scheduler/_Pending directly
_Pending = Pending
_Scheduler = Scheduler


class _Handler(BaseHTTPRequestHandler):
    scheduler: _Scheduler = None  # type: ignore[assignment]
    request_timeout: float = 300.0
    #: live client sockets, tracked so ApiServer.kill() can sever them
    #: the way a dying process's RSTs would (crash-chaos tier); bound
    #: per server via the BoundHandler subclass
    connections: Optional[set] = None
    connections_lock = None

    def log_message(self, *a):  # quiet
        pass

    def setup(self) -> None:
        super().setup()
        if self.connections is not None:
            with self.connections_lock:
                self.connections.add(self.connection)

    def finish(self) -> None:
        if self.connections is not None:
            with self.connections_lock:
                self.connections.discard(self.connection)
        try:
            super().finish()
        except (OSError, ValueError):
            pass  # socket already severed by kill()

    def _send(self, code: int, payload: dict,
              retry_after: Optional[float] = None,
              trace_id: str = "") -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            # ceil to whole seconds: Retry-After is delta-seconds
            self.send_header("Retry-After", str(max(1, int(retry_after))))
        if trace_id:
            # echo the request's trace id (minted or client-supplied):
            # the client can pull the full trace from /v1/debug/trace —
            # on EVERY terminal response, 429s and 500s included
            self.send_header("X-Trace-Id", trace_id)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.startswith("/healthz"):
            self._send(200, {"status": "ok"})
        elif self.path.startswith("/readyz"):
            # readiness flips with the drain state: a draining replica
            # must leave the Service endpoints BEFORE its requests stop
            # (the kube rolling-restart contract)
            if type(self).scheduler.draining.is_set():
                self._send(503, {"status": "draining"})
            else:
                self._send(200, {"status": "ok"})
        elif self.path.startswith("/v1/stats"):
            self._send(200, type(self).scheduler.stats())
        elif self.path.startswith("/metrics"):
            # the replica's OWN registry in Prometheus exposition text
            # — the federation scrape target (obs/telemetry.py); ""
            # when prometheus_client is absent, so scrapers degrade
            # instead of erroring
            from instaslice_tpu_torch.metrics.metrics import render

            body = render(type(self).scheduler.metrics).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.startswith("/v1/debug/trace"):
            self._debug_trace()
        elif self.path.startswith("/v1/debug/events"):
            self._debug_events()
        elif self.path.startswith("/v1/debug/profile"):
            self._debug_profile()
        elif self.path.startswith("/v1/debug/locks"):
            # lockcheck's live view (utils/lockcheck.py): per-thread
            # held locks, the acquisition-order graph, long holds —
            # the hung-replica triage surface
            self._send(200, debug_locks_payload())
        elif self.path.rstrip("/").startswith("/v1/models"):
            # OpenAI-client compatibility probe: one entry describing
            # the engine's model and serving limits ("created"/
            # "owned_by" are standard Model fields strict clients
            # validate)
            eng = type(self).scheduler.engine
            cfg = eng.model.cfg
            entry = {
                "id": f"tpuslice-lm-{cfg.n_layers}x{cfg.d_model}",
                "object": "model",
                "created": 0,
                "owned_by": "tpuslice",
                "max_model_len": eng.max_len,
                "config": {
                    "d_model": cfg.d_model,
                    "n_layers": cfg.n_layers,
                    "n_heads": cfg.n_heads,
                    "n_kv_heads": cfg.kv_heads,
                    "d_ff": cfg.d_ff,
                    "vocab_size": cfg.vocab_size,
                },
            }
            # multi-LoRA: each adapter lists as its own model entry
            # (the OpenAI-ecosystem convention — clients pick adapters
            # from the model list), flagged with "parent" = the base
            adapters = [
                {
                    "id": name,
                    "object": "model",
                    "created": 0,
                    "owned_by": "tpuslice",
                    "parent": entry["id"],
                    "adapter": True,
                }
                for name in sorted(
                    getattr(eng, "adapter_names", {}) or {}
                )
            ]
            tail = self.path.rstrip("/")[len("/v1/models"):]
            if not tail:
                self._send(200, {"object": "list",
                                 "data": [entry] + adapters})
            elif tail == "/" + entry["id"]:
                self._send(200, entry)     # retrieve-model route
            elif any(tail == "/" + a["id"] for a in adapters):
                self._send(200, next(
                    a for a in adapters if tail == "/" + a["id"]
                ))
            else:
                self._send(404, {"error": f"no model {tail[1:]!r}"})
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def _debug_trace(self) -> None:
        """``GET /v1/debug/trace``: the process tracer's live view —
        per-span-name summaries, the slowest traces (root spans by
        duration), and the most recent spans. ``?trace_id=X`` returns
        every ring span of one trace in start order (the drill-down a
        response's ``X-Trace-Id`` header points at); ``?n=`` bounds the
        recent/slowest lists (default 20)."""
        qs = urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.path).query
        )
        try:
            payload = debug_trace_payload(qs)
        except ValueError as e:
            self._send(400, {"error": str(e)})
            return
        except LookupError as e:
            self._send(404, {"error": str(e)})
            return
        self._send(200, payload)

    def _debug_events(self) -> None:
        """``GET /v1/debug/events``: the process flight recorder's live
        view (obs/journal.py) — filter with ``?reason=`` / ``?object=``
        / ``?trace_id=`` / ``?component=`` / ``?since_seq=``; ``?n=``
        bounds the returned tail (default 100)."""
        qs = urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.path).query
        )
        try:
            payload = debug_events_payload(qs)
        except ValueError as e:
            self._send(400, {"error": str(e)})
            return
        self._send(200, payload)

    def _debug_profile(self) -> None:
        """``GET /v1/debug/profile``: the continuous profiler's live
        view (obs/profiler.py) — armed state, per-segment p50/p95
        summaries, recent round records and timeline events; ``?n=``
        bounds the recent lists (default 20) and ``?rid=X`` returns
        one request's latency waterfall (engine rid or trace id)."""
        qs = urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.path).query
        )
        try:
            payload = debug_profile_payload(qs)
        except ValueError as e:
            self._send(400, {"error": str(e)})
            return
        except LookupError as e:
            self._send(404, {"error": str(e)})
            return
        self._send(200, payload)

    def do_POST(self):
        if self.path.startswith("/v1/prefixes"):
            self._prefix_request("register")
            return
        if self.path.startswith("/v1/sessions/export"):
            self._sessions_export()
            return
        if self.path.startswith("/v1/sessions/import"):
            self._sessions_import()
            return
        if self.path.startswith("/v1/drain"):
            try:
                body = self._read_body()
                budget = body.get("budget")
                budget = None if budget is None else float(budget)
                migrate = bool(body.get("migrate", False))
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})
                return
            sched = type(self).scheduler
            sched.drain(budget)
            migrated = 0
            if migrate:
                # drain-without-503: in-flight sessions leave through
                # their own responses as migration terminals (the
                # router imports them elsewhere); queued requests shed
                # with the usual drain 503 the router retries
                try:
                    migrated = sched.control(sched.migrate_out)
                except Exception as e:  # noqa: BLE001
                    # the drain itself stands; report the partial state
                    log.warning("drain-migrate failed: %s", e)
                    self._send(500, {"error": f"migrate failed: {e}",
                                     "draining": True})
                    return
            self._send(200, {
                "draining": True,
                "budget": (sched.drain_budget if budget is None
                           else budget),
                "migrated": migrated,
            })
            return
        if not self.path.startswith("/v1/completions"):
            self._send(404, {"error": f"no route {self.path}"})
            return
        # HTTP admission is the serving plane's trace admission point:
        # the id is minted (or accepted from X-Trace-Id) BEFORE parsing,
        # so even a 400 is traceable and echoes the id back
        tid = _mint_trace_id(self.headers.get("X-Trace-Id"))
        try:
            req = self._read_body()
            if req.get("resume") is not None:
                # continuation of an imported session (fleet live
                # migration): no prompt, no sampling config — the
                # session blob carried all of that; the scheduler binds
                # this pending to the parked engine state and resumes
                # the decode with zero re-prefill
                self._resume_completion(req, tid)
                return
            try:
                prompt = self._token_list(req, "prompt")
            except ValueError:
                raise ValueError(
                    "prompt must be a list of token ids (the server is "
                    "tokenizer-free; tokenize client-side)"
                ) from None
            max_tokens = int(req.get("max_tokens", 16))
            if max_tokens < 1:
                raise ValueError("max_tokens must be >= 1")
            stop = ServingEngine._normalize_stop(req.get("stop"))
            n = int(req.get("n", 1))
            max_batch = type(self).scheduler.engine.max_batch
            if not 1 <= n <= max_batch:
                raise ValueError(
                    f"n must be in [1, {max_batch}] (the engine's "
                    "slot count) on this server"
                )
            eng = type(self).scheduler.engine
            adapter = 0
            want_adapter = req.get("adapter")
            if want_adapter is not None:
                names = getattr(eng, "adapter_names", {})
                if want_adapter not in names:
                    merged = getattr(eng, "merged_adapter", "")
                    if merged and want_adapter == merged:
                        raise ValueError(
                            f"adapter {merged!r} was MERGED into the "
                            "weights at startup (single --lora): it is "
                            "always active — omit the adapter field"
                        )
                    have = (sorted(names) if names
                            else "none — start with two or more "
                                 "--lora dirs")
                    raise ValueError(
                        f"unknown adapter {want_adapter!r} "
                        f"(serving: {have})"
                    )
                adapter = names[want_adapter]
            # sampling config is engine-level (slots share one compiled
            # decode program); reject mismatching per-request values
            # instead of silently ignoring them
            for key, have in (("temperature", eng.temperature),
                              ("top_k", eng.top_k),
                              ("top_p", eng.top_p),
                              ("min_p", eng.min_p),
                              ("repetition_penalty",
                               eng.repetition_penalty)):
                want = req.get(key)
                if want is not None and float(want) != float(have):
                    raise ValueError(
                        f"{key} is engine-level on this server "
                        f"(running with {key}={have}); restart "
                        f"tpuslice-serve with --{key.replace('_', '-')}"
                    )
            # tenant is routing metadata for the SLO scheduler: the
            # header wins (proxies inject it), the body field is the
            # curl-friendly spelling; unknown tenants ride the default
            # class — never a 400
            tenant = (self.headers.get("X-Tenant")
                      or req.get("tenant") or "")
            if not isinstance(tenant, str) or len(tenant) > 64:
                raise ValueError(
                    "tenant must be a string of <= 64 chars"
                )
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)}, trace_id=tid)
            return
        pending = _Pending(prompt, max_tokens,
                           stream=bool(req.get("stream", False)),
                           stop=stop,
                           want_logprobs=bool(req.get("logprobs", False)),
                           n=n, adapter=adapter, trace_id=tid,
                           tenant=tenant,
                           session_key=self._session_key())
        self._run_completion(pending)

    def _session_key(self) -> str:
        """The fleet router's per-request handle (``X-Session-Key``):
        a targeted session export selects by it, and the export blob
        echoes it back so the router matches blobs to streams. Opaque
        here; bounded so a hostile client can't bloat pending state."""
        key = self.headers.get("X-Session-Key") or ""
        return key if len(key) <= 128 else ""

    def _resume_completion(self, req: dict, tid: str) -> None:
        try:
            rid = int(req["resume"])
        except (ValueError, TypeError):
            self._send(400, {"error": "resume must be an imported "
                                      "session rid (int)"},
                       trace_id=tid)
            return
        pending = _Pending([], 0, stream=bool(req.get("stream", False)),
                           trace_id=tid, resume_rid=rid,
                           session_key=self._session_key())
        self._run_completion(pending)

    def _run_completion(self, pending: "_Pending") -> None:
        """Submit → await → terminal response; shared by fresh
        admissions and migrated-session resumes."""
        tid = pending.trace_id
        if not self._submit_or_shed(pending):
            return
        if pending.stream_q is not None:
            self._stream_response(pending)
            return
        if not self._await_or_timeout(pending):
            self._send(503, {"error": "request timed out in queue"},
                       trace_id=tid)
            return
        if pending.migrated is not None:
            # the session left this replica mid-decode: the terminal
            # response IS the handoff — the router imports the blob
            # into another replica and finishes the completion there
            self._send(200, {
                "object": "text_completion.migration",
                "session": pending.migrated,
            }, trace_id=tid)
            return
        if pending.error:
            # shed/drained requests get a clean 503 (retry elsewhere);
            # client mistakes are 400s; an engine-side failure that
            # killed the request is the server's fault
            if pending.shed:
                # pressure sheds (kv blocks, parked timeout) hint one
                # decode round; drain sheds hint the drain budget
                self._send(503, {"error": pending.error},
                           retry_after=(pending.retry_after
                                        or type(self)
                                        .scheduler.drain_budget),
                           trace_id=tid)
            else:
                self._send(500 if pending.server_fault else 400,
                           {"error": pending.error}, trace_id=tid)
            return
        choices = []
        for idx in sorted(pending.results):
            r = pending.results[idx]
            choice = {
                "index": idx,
                "token_ids": r.tokens,
                "finish_reason": r.finished_reason or "stop",
            }
            if pending.want_logprobs:
                choice["logprobs"] = r.logprobs
            choices.append(choice)
        self._send(200, {
            "object": "text_completion",
            "choices": choices,
            "usage": {
                # pending.prompt, not a handler local: a resumed
                # migration binds its prompt from the imported session
                "prompt_tokens": len(pending.prompt),
                "completion_tokens": sum(
                    len(r.tokens) for r in pending.results.values()
                ),
            },
        }, trace_id=tid)


    def _submit_or_shed(self, pending: _Pending) -> bool:
        """Submit to the scheduler; on shed, send the terminal response
        (429 queue-full with Retry-After / 503 draining) and return
        False — the backpressure contract: a client NEVER waits on a
        request the server already knows it cannot serve."""
        sched = type(self).scheduler
        try:
            sched.submit(pending)
            return True
        except QueueFull as e:
            # shed at admission still gets its root span: a 429 must be
            # traceable from /v1/debug/trace, not just counted
            sched._record_request_span(pending, "shed")
            self._send(429, {"error": "admission queue full; retry"},
                       retry_after=e.retry_after,
                       trace_id=pending.trace_id)
            return False
        except Draining:
            sched._record_request_span(pending, "drained")
            self._send(503, {"error": "server draining"},
                       retry_after=sched.drain_budget,
                       trace_id=pending.trace_id)
            return False

    def _await_or_timeout(self, pending: _Pending) -> bool:
        """Wait for completion; on expiry flag the timeout UNDER the
        pending's lock so the scheduler cannot complete-and-count-ok in
        the same instant. Returns True when the result was delivered —
        including the race window where delivery landed between the
        wait expiring and the flag: then the tokens exist and were
        counted ok, so the client gets them instead of a lying 503."""
        if pending.done.wait(type(self).request_timeout):
            return True
        pending.flag_timeout()
        # flag_timeout is a no-op when delivery landed in the window:
        # then the tokens exist and were counted ok — return them
        return not pending.timed_out

    def _stream_response(self, pending: _Pending) -> None:
        """Server-sent events: one ``data:`` chunk of token ids per
        decode block as the scheduler produces them, a final chunk with
        the finish reason + usage, then ``data: [DONE]``. A broken
        socket or stalled stream marks the request timed out, and the
        scheduler evicts its slot — streaming clients get disconnect
        cancellation for free."""
        deadline = time.monotonic() + type(self).request_timeout
        broken = False

        def write(payload) -> None:
            # bound every blocking socket write by the remaining
            # deadline: a connected client that stops READING would
            # otherwise block this thread forever once the send buffer
            # fills (BaseHTTPRequestHandler sets no socket timeout),
            # leaking the handler and never tripping eviction
            self.connection.settimeout(
                max(deadline - time.monotonic(), 0.001)
            )
            data = payload if isinstance(payload, str) else json.dumps(
                payload
            )
            self.wfile.write(f"data: {data}\n\n".encode())
            self.wfile.flush()

        try:
            # inside the try: a client that disconnects before the
            # headers flush must still be flagged for slot eviction
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            if pending.trace_id:
                self.send_header("X-Trace-Id", pending.trace_id)
            self.end_headers()
            finals = 0
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError
                try:
                    item = pending.stream_q.get(timeout=min(remaining, 5))
                except queue.Empty:
                    continue
                if isinstance(item, str):          # pre-admission error
                    write({"error": item})
                    write("[DONE]")
                    return
                if item["kind"] == "migrated":
                    # mid-stream handoff: the terminal event carries
                    # the exported session blob; the router (the only
                    # intended consumer) imports it elsewhere and
                    # splices the resumed stream — a plain client would
                    # see a clean stream end
                    write({"object": "text_completion.migration",
                           "session": item["session"]})
                    write("[DONE]")
                    return
                if item["kind"] == "final":
                    r = item["result"]
                    finals += 1
                    event = {
                        "object": "text_completion",
                        "choices": [{
                            "index": item["index"],
                            "token_ids": [],
                            "finish_reason": r.finished_reason or "stop",
                        }],
                    }
                    if finals == pending.n:
                        # usage only on the LAST final chunk: earlier
                        # choices' totals would be partial snapshots
                        # (list() snapshots atomically under the GIL
                        # against the scheduler's concurrent inserts)
                        event["usage"] = {
                            "prompt_tokens": len(r.prompt),
                            "completion_tokens": sum(
                                len(x.tokens)
                                for x in list(pending.results.values())
                            ),
                        }
                    write(event)
                    if finals == pending.n:        # all choices done
                        write("[DONE]")
                        return
                    continue
                chunk = {
                    "index": item["index"],
                    "token_ids": item["tokens"],
                    "finish_reason": None,
                }
                if pending.want_logprobs:
                    chunk["logprobs"] = item["logprobs"]
                write({
                    "object": "text_completion",
                    "choices": [chunk],
                })
        except (BrokenPipeError, ConnectionError, TimeoutError, OSError):
            # client hung up or the stream stalled past the deadline:
            # flag for the scheduler's eviction sweep; the socket is in
            # an unknown state, so don't let the handler reuse it
            pending.flag_timeout()
            broken = True
            self.close_connection = True
        finally:
            # clean stream (the try exits via return): undo the
            # shrinking per-write deadline, or a keep-alive follow-up
            # request on this socket would inherit a residual timeout
            # on all its reads/writes
            if not broken:
                self.connection.settimeout(None)

    def do_DELETE(self):
        if self.path.startswith("/v1/prefixes"):
            self._prefix_request("drop")
        elif self.path.startswith("/v1/drain"):
            type(self).scheduler.undrain()
            self._send(200, {"draining": False})
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def _read_body(self) -> dict:
        """Parse the request body as a JSON object (raises ValueError)."""
        n = int(self.headers.get("Content-Length", "0") or 0)
        req = json.loads(self.rfile.read(n).decode() or "{}")
        if not isinstance(req, dict):
            raise ValueError("body must be a JSON object")
        return req

    @staticmethod
    def _token_list(req: dict, key: str) -> List[int]:
        """Extract a list-of-token-ids field (raises ValueError)."""
        tokens = req.get(key)
        if (not isinstance(tokens, list)
                or not all(isinstance(t, int) for t in tokens)):
            raise ValueError(f"{key} must be a list of token ids")
        return tokens

    def _prefix_request(self, op: str) -> None:
        """POST /v1/prefixes {"tokens": [...]} — prefill once, reuse for
        every prompt that starts with it; DELETE with the same body
        frees the stored stripe (``ServingEngine.register_prefix`` /
        ``drop_prefix``, run on the scheduler thread)."""
        try:
            tokens = self._token_list(self._read_body(), "tokens")
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
            return
        pending = _Pending(tokens, 0, prefix_op=op)
        if not self._submit_or_shed(pending):
            return
        if not self._await_or_timeout(pending):
            self._send(503, {"error": "request timed out in queue"})
            return
        if pending.error:
            code = (503 if pending.shed
                    else 404 if "no such prefix" in pending.error
                    else 400)
            self._send(code, {"error": pending.error})
            return
        key = "registered" if op == "register" else "dropped"
        self._send(200, {key: len(tokens)})

    # --------------------------------------------- session migration

    def _sessions_export(self) -> None:
        """``POST /v1/sessions/export`` — trigger live migration of
        in-flight sessions OFF this replica (drain-without-503 replica
        removal, hot-replica rebalancing). Body: ``{"session_key":
        "sk-..."}`` targets one proxied request, ``{"limit": N}``
        bounds the count, ``{}`` exports everything eligible. The
        blobs themselves ride each session's own in-flight response as
        ``text_completion.migration`` terminals; this returns only the
        count."""
        try:
            body = self._read_body()
            key = body.get("session_key")
            if key is not None and not isinstance(key, str):
                raise ValueError("session_key must be a string")
            limit = int(body.get("limit", 0))
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
            return
        sched = type(self).scheduler
        try:
            moved = sched.control(
                lambda: sched.migrate_out(session_key=key, limit=limit)
            )
        except Exception as e:  # noqa: BLE001 - surfaced as HTTP 500
            log.warning("session export failed: %s", e)
            self._send(500, {"error": f"export failed: {e}"})
            return
        self._send(200, {"migrated": moved})

    def _sessions_import(self) -> None:
        """``POST /v1/sessions/import`` with ``{"session": <blob>}`` —
        materialize an exported session as parked state on this
        replica; the follow-up ``{"resume": rid}`` completion continues
        the decode with zero re-prefill. 400 on wire-version / model-
        signature mismatch (the versioned-format rejection contract)."""
        try:
            body = self._read_body()
            blob = body.get("session")
            if not isinstance(blob, dict):
                raise ValueError('body must carry {"session": {...}}')
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
            return
        sched = type(self).scheduler
        try:
            rid = sched.import_session(blob)
        except ValueError as e:
            self._send(400, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 - surfaced as HTTP 500
            log.warning("session import failed: %s", e)
            self._send(500, {"error": f"import failed: {e}"})
            return
        self._send(200, {"rid": rid,
                         "tokens": len(blob.get("generated", []))})


class ApiServer:
    """HTTP server + scheduler around an engine.

    ``request_timeout`` defaults from ``TPUSLICE_REQUEST_TIMEOUT`` (then
    300 s); ``max_queue`` from ``TPUSLICE_MAX_QUEUE`` (then 0 =
    unbounded); ``drain_budget`` from ``TPUSLICE_DRAIN_BUDGET`` (then
    30 s). ``fault_plan`` (a :class:`instaslice_tpu_torch.faults.FaultPlan`)
    wires the engine's dispatch hook and the scheduler's round hook —
    the whole serving data plane runs under the one seeded plan."""

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0, block_size: int = 16, metrics=None,
                 request_timeout: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 drain_budget: Optional[float] = None,
                 fault_plan=None, tenants=None,
                 mode: Optional[str] = None,
                 preempt_margin: Optional[float] = None,
                 overlap: Optional[bool] = None):
        if request_timeout is None:
            request_timeout = _env_float("TPUSLICE_REQUEST_TIMEOUT", 300)
        if max_queue is None:
            max_queue = _env_int("TPUSLICE_MAX_QUEUE", 0)
        if drain_budget is None:
            drain_budget = _env_float("TPUSLICE_DRAIN_BUDGET", 30)
        if preempt_margin is None:
            preempt_margin = _env_float("TPUSLICE_PREEMPT_MARGIN", 0.5)
        sched_hook = None
        if fault_plan is not None:
            from instaslice_tpu_torch.faults import (
                engine_fault_hook,
                scheduler_fault_hook,
            )

            engine.fault_hook = engine_fault_hook(fault_plan, engine)
            sched_hook = scheduler_fault_hook(fault_plan)
        self.scheduler = _Scheduler(engine, block_size=block_size,
                                    metrics=metrics, max_queue=max_queue,
                                    drain_budget=drain_budget,
                                    fault_hook=sched_hook,
                                    tenants=tenants, mode=mode,
                                    preempt_margin=preempt_margin,
                                    overlap=overlap)
        from instaslice_tpu_torch.utils.lockcheck import named_lock

        self._conns: set = set()
        self._conns_lock = named_lock("serve.conns")
        handler = type("BoundHandler", (_Handler,),
                       {"scheduler": self.scheduler,
                        "request_timeout": request_timeout,
                        "connections": self._conns,
                        "connections_lock": self._conns_lock})
        self._srv = ThreadingHTTPServer((host, port), handler)
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="serve-http", daemon=True
        )
        #: an InjectedCrash on the scheduler thread kills the whole
        #: replica: sever clients mid-stream, no drain, no terminals
        self.scheduler.on_fatal = self.kill

    @property
    def url(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ApiServer":
        self.scheduler.start()
        self._thread.start()
        return self

    def drain(self, budget: Optional[float] = None) -> None:
        """Graceful-degradation entry point (SIGTERM, POST /v1/drain):
        readiness flips to 503, admission stops, in-flight requests get
        ``budget`` seconds, the rest are evicted with a clean 503."""
        self.scheduler.drain(budget)

    def undrain(self) -> None:
        self.scheduler.undrain()

    def wait_drained(self, timeout: float) -> bool:
        return self.scheduler.drained.wait(timeout)

    def stop(self) -> None:
        self.scheduler.stop_flag.set()
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5)

    def kill(self) -> None:
        """Abrupt process-death emulation (crash-chaos tier,
        docs/RECOVERY.md): no drain, no terminal responses. The
        scheduler stops dead (in-flight engine state is abandoned),
        the listener closes, and every live client connection is
        severed — streaming clients observe a truncated stream
        (loadgen outcome ``stream-truncated``), sync clients a dropped
        connection. What a fresh replica can recover is exactly the
        durable truth a real crash leaves: nothing in this process."""
        import socket as _socket

        self.scheduler.stop_flag.set()
        try:
            self._srv.shutdown()
            self._srv.server_close()
        except OSError:
            log.warning("kill: listener close raised", exc_info=True)
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            try:
                conn.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass  # already closing
            try:
                conn.close()
            except OSError:
                pass
        self._thread.join(timeout=5)

    def __enter__(self) -> "ApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpuslice-gpu-serve")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--request-timeout", type=float,
                    default=_env_float("TPUSLICE_REQUEST_TIMEOUT", 300),
                    help="seconds before a queued/decoding request 503s "
                         "and its slot is evicted back to the batch "
                         "(env: TPUSLICE_REQUEST_TIMEOUT)")
    ap.add_argument("--max-queue", type=int,
                    default=_env_int("TPUSLICE_MAX_QUEUE", 0),
                    help="admission queue bound: past it new requests "
                         "are shed with 429 + Retry-After instead of "
                         "queueing into a timeout (0 = unbounded; env: "
                         "TPUSLICE_MAX_QUEUE)")
    ap.add_argument("--drain-budget", type=float,
                    default=_env_float("TPUSLICE_DRAIN_BUDGET", 30),
                    help="seconds in-flight requests get to finish "
                         "after SIGTERM / POST /v1/drain before "
                         "eviction with a clean 503 (env: "
                         "TPUSLICE_DRAIN_BUDGET)")
    ap.add_argument("--tenants", default=os.environ.get(
                        "TPUSLICE_TENANTS", ""),
                    help="multi-tenant SLO policy: comma-separated "
                         "name:weight:class[:ttft_slo[:tpot_slo]] "
                         "(class in latency/standard/best-effort; SLOs "
                         "in seconds, 0 = none). Requests pick a "
                         "tenant via the X-Tenant header or the "
                         "\"tenant\" field; unknown tenants ride the "
                         "standard class at weight 1 (env: "
                         "TPUSLICE_TENANTS)")
    ap.add_argument("--sched-mode", default=None,
                    choices=["continuous", "fixed"],
                    help="continuous (default): per-step admission, "
                         "fair share, SLO preemption; fixed: the naive "
                         "fixed-decode-round FIFO baseline the serving "
                         "bench measures against (env: "
                         "TPUSLICE_SCHED_MODE)")
    ap.add_argument("--preempt-margin", type=float,
                    default=_env_float("TPUSLICE_PREEMPT_MARGIN", 0.5),
                    help="preempt a best-effort slot once a latency-"
                         "class request has waited this fraction of "
                         "its TTFT SLO (env: TPUSLICE_PREEMPT_MARGIN)")
    ap.add_argument("--no-batched-prefill", action="store_true",
                    help="disable the multi-slot batched prefill "
                         "program (admission bursts prefill one slot "
                         "at a time)")
    ap.add_argument("--no-adapter-fastpath", action="store_true",
                    help="disable the single-adapter decode variant "
                         "(every round pays the per-row one-hot LoRA "
                         "gather even when the batch shares one "
                         "adapter)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="fully synchronous decode dispatch (no "
                         "host/device overlap; also "
                         "TPUSLICE_ENGINE_OVERLAP=0)")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="paged KV-cache block size in tokens "
                         "(serving/kvcache.py): admission, preemption "
                         "and the kv_blocks_* gauges account in these "
                         "units")
    ap.add_argument("--spec-k", type=int,
                    default=_env_int("TPUSLICE_SPEC_K", 4),
                    help="speculative decoding: max draft tokens per "
                         "round (the adaptive-k ladder's top rung; "
                         "needs a draft model — see --draft-n-layers). "
                         "Lossless at any temperature: greedy stays "
                         "bit-identical, sampling is rejection-sampled "
                         "to the target distribution (env: "
                         "TPUSLICE_SPEC_K)")
    ap.add_argument("--no-spec", action="store_true",
                    help="ignore any configured draft model and serve "
                         "plain decode rounds (the no-spec baseline "
                         "arm)")
    ap.add_argument("--draft-checkpoint", default="",
                    help="checkpoint dir of the port's own format for "
                         "the speculative DRAFT model's params (shape "
                         "set by the "
                         "--draft-* dims); omitted with "
                         "--draft-n-layers set = random-init draft "
                         "(testing only — acceptance will be noise)")
    ap.add_argument("--draft-n-layers", type=int, default=0,
                    help="draft model depth; 0 (default) = no draft, "
                         "speculative decoding off")
    ap.add_argument("--draft-d-model", type=int, default=0,
                    help="draft model width (0 = same as --d-model)")
    ap.add_argument("--draft-n-heads", type=int, default=0,
                    help="draft attention heads (0 = same as --n-heads)")
    ap.add_argument("--draft-d-ff", type=int, default=0,
                    help="draft FF width (0 = same as --d-ff)")
    ap.add_argument("--no-radix-cache", action="store_true",
                    default=not _env_flag("TPUSLICE_RADIX_CACHE"),
                    help="disable the automatic radix prefix cache "
                         "(completed prompts no longer seed prefix "
                         "reuse; register_prefix/POST /v1/prefixes "
                         "exact-match pinning still works; env: "
                         "TPUSLICE_RADIX_CACHE=0)")
    ap.add_argument("--no-radix-decoded", action="store_true",
                    default=not _env_flag("TPUSLICE_RADIX_DECODED"),
                    help="insert only each completion's PROMPT into "
                         "the radix cache, not its decoded tokens "
                         "(decoded insertion is what lets a multi-turn "
                         "follow-up reuse the previous turn's whole "
                         "history; env: TPUSLICE_RADIX_DECODED=0)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="Prometheus /metrics port (0 = off)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--prefill-len", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=2048)
    ap.add_argument("--n-heads", type=int, default=16)
    ap.add_argument("--n-kv-heads", type=int, default=0,
                    help="grouped-query attention: KV heads shared by "
                         "n-heads/n-kv-heads query heads each (0 = "
                         "multi-head); shrinks the KV cache by the "
                         "group factor")
    ap.add_argument("--n-layers", type=int, default=16)
    ap.add_argument("--d-ff", type=int, default=8192)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window attention: each position "
                         "attends only the last N (0 = full causal)")
    ap.add_argument("--vocab-size", type=int, default=32000)
    ap.add_argument("--checkpoint", default="",
                    help="checkpoint dir of the port's own format "
                         "(step_*.pt, from instaslice_tpu_torch.cli."
                         "train_main) to restore params from")
    ap.add_argument("--lora", action="append", default=[],
                    metavar="DIR[:ALPHA]",
                    help="LoRA adapter checkpoint dir (from tpuslice-"
                         "train --lora-rank); rank and targets are read "
                         "from the adapter tree itself, alpha from the "
                         ":ALPHA suffix (default --lora-alpha). Given "
                         "ONCE, the adapter merges into the weights "
                         "(zero runtime cost). Given MULTIPLE times, "
                         "the engine serves all of them batched "
                         "(multi-LoRA): requests pick one via "
                         "\"adapter\": \"<dir basename>\" (omitted = "
                         "base model)")
    ap.add_argument("--lora-alpha", type=float, default=16.0,
                    help="default alpha for adapters without a :ALPHA "
                         "suffix (alpha is a training-time choice, not "
                         "recoverable from the tree)")
    ap.add_argument("--quantize", action="store_true",
                    help="serve quantized weights + int8 KV cache")
    ap.add_argument("--quantize-bits", type=int, default=None,
                    choices=[8, 4],
                    help="weight quantization width: 8 = per-channel "
                    "int8 (the default with --quantize), 4 = "
                    "group-wise packed int4 (capacity tier: ~4x "
                    "smaller than bf16 — 13B-class on one 16 GB "
                    "chip). Giving this EXPLICITLY implies --quantize")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; sampling config is engine-level "
                    "(one compiled program per setting)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--min-p", type=float, default=0.0,
                    help="keep tokens with prob >= min-p x the top "
                         "token's prob (entropy-adaptive filter)")
    ap.add_argument("--repetition-penalty", type=float, default=1.0,
                    help="HF-style: penalize tokens already in the "
                         "prompt or generated so far (1.0 = off)")
    ap.add_argument("--from-env", action="store_true",
                    help="build the TP mesh from the granted slice's "
                    "handoff env (TPU_* vars) instead of one device")
    ap.add_argument("--oplog-port", type=int, default=8478,
                    help="--from-env: TCP port of the driver/follower op "
                         "stream (rank 0 serves HTTP and broadcasts; the "
                         "other ranks replay)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu "
                         "(the plain versions of the kernels)")
    ap.add_argument("--profile", action="store_true",
                    help="arm the continuous profiler (round anatomy "
                         "ring + engine timeline events; GET "
                         "/v1/debug/profile, tpuslice profile/"
                         "waterfall). Equivalent to TPUSLICE_PROFILE=1; "
                         "overhead is bounded by the profile-smoke "
                         "gate (docs/OBSERVABILITY.md \"Profiling\")")
    return ap


def _refuse_unported(args) -> None:
    """Exit non-zero on a checkpoint directory that holds no checkpoint
    of the port's own format."""
    from instaslice_tpu_torch.models.checkpoint import TrainCheckpointer

    def missing(path: str) -> bool:
        # checked before the checkpointer, which would create the dir
        return (not os.path.isdir(path)
                or TrainCheckpointer(path).latest_step() is None)

    for flag, path in (("--checkpoint", args.checkpoint),
                       ("--draft-checkpoint", args.draft_checkpoint)):
        if path and missing(path):
            raise SystemExit(
                f"{flag} {path}: no checkpoint of the port's own format "
                "(step_*.pt, written by instaslice_tpu_torch.cli."
                "train_main) there; orbax checkpoints are not read")
    for spec in args.lora:
        path = _lora_spec(spec, args.lora_alpha)[0]
        if missing(path):
            raise SystemExit(
                f"--lora {path}: no multi-LoRA adapter checkpoint of the "
                "port's own format (step_*.pt, written by instaslice_tpu_"
                "torch.cli.train_main --lora-rank) there")


def _restore_params(path: str, params) -> None:
    """Copy the params of the latest port checkpoint under ``path`` into
    ``params`` (same model; each tensor cast to the serving dtype)."""
    from instaslice_tpu_torch.models.checkpoint import TrainCheckpointer

    try:
        TrainCheckpointer(path).restore_params(params, cast=True)
    except ValueError as e:
        raise SystemExit(f"checkpoint {path}: {e}") from None


def _lora_spec(spec: str, default_alpha: float):
    """``DIR[:ALPHA]`` -> (dir, alpha)."""
    path, _, alpha_s = spec.rpartition(":")
    if path and alpha_s.replace(".", "", 1).isdigit():
        return path, float(alpha_s)
    return spec, default_alpha


def _load_adapters(args):
    """The ``--lora`` adapters as (trees, alphas, names): each tree
    rebuilt from its port checkpoint's leaf paths (rank and targets are
    the tree's own), named by its directory's basename
    (``api_server.py:1156-1186``)."""
    from instaslice_tpu_torch.models.checkpoint import TrainCheckpointer

    adapters, alphas, names = [], [], []
    for spec in args.lora:
        path, alpha = _lora_spec(spec, args.lora_alpha)
        try:
            lora = TrainCheckpointer(path).load_tree()
        except ValueError:
            lora = None
        blocks = lora.get("blocks") if isinstance(lora, dict) else None
        if not blocks or not all(
                isinstance(ab, dict) and set(ab) == {"a", "b"}
                for ab in blocks.values()):
            raise SystemExit(
                f"{path} is not a LoRA adapter checkpoint "
                "(expected a {'blocks': {target: {'a', 'b'}}} tree — a "
                "full-model checkpoint belongs in --checkpoint)")
        name = os.path.basename(os.path.normpath(path))
        if name in names:
            raise SystemExit(
                f"two --lora dirs share the basename {name!r}; "
                "adapter names must be unique")
        names.append(name)
        alphas.append(alpha)
        adapters.append(lora)
    return adapters, alphas, names


def _serving_mesh(dev):
    """``--from-env``'s mesh (``api_server.py:1122-1139``): the process
    group over torchrun's ``RANK``/``WORLD_SIZE`` where set, else over the
    handoff env (``TPU_WORKER_ID``, ``TPU_WORKER_HOSTNAMES``) at
    ``tcp://<hostnames[0]>:$TPUSLICE_COORDINATOR_PORT`` (default 8476, as
    the reference's ``meshenv.py:112``); a group the caller already
    started is used as it is. Every rank goes on ``model``."""
    from instaslice_tpu_torch.parallel.meshenv import (
        SliceTopology,
        initialize_distributed,
        slice_mesh,
    )

    topo = SliceTopology.from_env()
    init = None
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        host = topo.hostnames[0] if topo.hostnames else "127.0.0.1"
        port = os.environ.get("TPUSLICE_COORDINATOR_PORT", "8476")
        init = f"tcp://{host}:{port}"
    initialize_distributed(topo, init_method=init, device=dev)
    return slice_mesh(axes=("data", "seq", "model"), axis_sizes=(1, 1, -1),
                      device=dev, topo=topo)


def _driver_host() -> str:
    """Where rank 0 listens for followers: worker 0's hostname, as the
    rendezvous names it (torchrun's ``MASTER_ADDR`` without a handoff
    env)."""
    from instaslice_tpu_torch.parallel.meshenv import SliceTopology

    topo = SliceTopology.from_env()
    return (topo.hostnames[0] if topo.hostnames
            else os.environ.get("MASTER_ADDR", "127.0.0.1"))


def split_ranks(engine: ServingEngine, args):
    """The driver/follower split of a tensor-parallel server
    (``api_server.py:1275-1305``): on a mesh of more than one rank, rank
    0 gets its engine wrapped in a
    :class:`~instaslice_tpu_torch.serving.distributed.DistributedEngine`
    (which waits for every follower to connect), and every other rank
    replays the op stream on ``args.oplog_port`` until the driver shuts it
    down, then gets None. Without a mesh the engine comes back as it is."""
    if not getattr(engine, "_multiproc", False):
        return engine
    import torch.distributed as dist

    from instaslice_tpu_torch.serving.distributed import (
        DistributedEngine,
        run_follower,
    )

    rank, world = dist.get_rank(), dist.get_world_size()
    if rank != 0:
        host = _driver_host()
        log.info("rank %d following driver %s:%d", rank, host,
                 args.oplog_port)
        run_follower(engine, host, args.oplog_port)
        log.info("driver closed the op stream; exiting")
        return None
    log.info("rank 0 driving %d followers on port %d", world - 1,
             args.oplog_port)
    return DistributedEngine(engine, n_followers=world - 1,
                             port=args.oplog_port)


def build_engine(args) -> ServingEngine:
    """Model + params (seeded init on the device, optionally restored
    from a port checkpoint, optionally int8- or int4-quantized with an
    int8 KV cache; ``--quantize-bits`` implies ``--quantize``), plus the
    ``--draft-*`` draft model (bf16, seeded or restored from
    ``--draft-checkpoint``; it inherits ``--window``) -> engine, warmed
    before traffic. One ``--lora`` adapter merges into the bf16 weights
    BEFORE ``--quantize`` (int4 included; ``eng.merged_adapter`` names
    it); two or more serve batched as runtime adapters named by their
    directories' basenames, their deltas added to the dequantized
    product over an int4 base. With ``--from-env`` the engine serves this
    rank's shards of the mesh over every rank of the process group
    (:func:`_serving_mesh`); every rank builds the whole params from the
    same seed, quantizes them, keeps its shards and runs the warm-ups,
    whose forwards issue collectives, before :func:`split_ranks`. Split
    from :func:`main` so tests and ``chip_smoke.py`` drive the exact CLI
    wiring."""
    import dataclasses

    import torch

    from instaslice_tpu_torch import resolve_device
    from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM
    from instaslice_tpu_torch.models.lora import (
        LoraConfig,
        frozen,
        merge_lora,
    )
    from instaslice_tpu_torch.models.quant import quantize_params

    _refuse_unported(args)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = resolve_device(f"cuda:{os.environ['LOCAL_RANK']}")
    mesh = _serving_mesh(dev) if args.from_env else None
    cfg = ModelConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_heads=args.n_heads, n_kv_heads=args.n_kv_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, window=args.window,
        max_seq_len=args.max_len, dtype=torch.bfloat16, remat=False,
    )
    model = TpuLM(cfg)
    params = model.init(0, device=dev)
    if args.checkpoint:
        _restore_params(args.checkpoint, params)
    adapters, alphas, names = _load_adapters(args)
    merged_name = ""
    if len(adapters) == 1:
        # one adapter: merged once, no per-token cost
        blocks = adapters[0]["blocks"]
        lcfg = LoraConfig(
            rank=int(next(iter(blocks.values()))["a"].shape[-1]),
            alpha=alphas[0], targets=tuple(sorted(blocks)))
        with torch.no_grad():
            params = merge_lora(params, frozen(adapters[0], dev), cfg, lcfg)
        merged_name = names[0]
        adapters, alphas, names = [], [], []
    kv_quant = False
    # ANY explicit width implies --quantize (8 included)
    if args.quantize or args.quantize_bits is not None:
        params = quantize_params(params, bits=args.quantize_bits or 8)
        kv_quant = True
    draft_model = draft_params = None
    if args.draft_n_layers and not args.no_spec:
        dcfg = dataclasses.replace(
            cfg,
            n_layers=args.draft_n_layers,
            d_model=args.draft_d_model or cfg.d_model,
            n_heads=args.draft_n_heads or cfg.n_heads,
            d_ff=args.draft_d_ff or cfg.d_ff,
        )
        draft_model = TpuLM(dcfg)
        draft_params = draft_model.init(1, device=dev)
        if args.draft_checkpoint:
            _restore_params(args.draft_checkpoint, draft_params)
    eng = ServingEngine(
        model, params, max_batch=args.max_batch, max_len=args.max_len,
        prefill_len=args.prefill_len, kv_quant=kv_quant,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        min_p=args.min_p, repetition_penalty=args.repetition_penalty,
        kv_block_size=args.kv_block_size,
        radix_cache=not args.no_radix_cache,
        radix_decoded=not args.no_radix_decoded,
        batched_prefill=not args.no_batched_prefill,
        draft_model=draft_model, draft_params=draft_params,
        spec_k=args.spec_k,
        lora_adapters=adapters or None, lora_alphas=alphas or None,
        lora_names=names or None,
        adapter_fastpath=not args.no_adapter_fastpath,
        device=dev, mesh=mesh,
    )
    # the engine keeps its shards: drop the whole trees before the warm-up
    del params, draft_params
    #: a request naming the merged adapter gets the reference's 400 (it
    #: is always on: omit the field)
    eng.merged_adapter = merged_name
    # build the kernels and warm every prefill bucket (and, with a
    # draft, every spec round shape) at startup, not under the first
    # admission burst or mid-run round
    eng.warm_prefill_buckets()
    eng.warm_spec_programs()
    return eng


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    _refuse_unported(args)
    if args.profile:
        # arm BEFORE build_engine so warm-up builds land inside the
        # CompileWatch baseline, not as CompileObserved noise
        get_profiler().arm()
    engine = split_ranks(build_engine(args), args)
    if engine is None:
        return 0
    from instaslice_tpu_torch.faults import FaultPlan

    srv = ApiServer(engine, host=args.host, port=args.port,
                    request_timeout=args.request_timeout,
                    max_queue=args.max_queue,
                    drain_budget=args.drain_budget,
                    fault_plan=FaultPlan.from_env(),
                    tenants=args.tenants, mode=args.sched_mode,
                    preempt_margin=args.preempt_margin,
                    overlap=False if args.no_overlap else None).start()
    if args.metrics_port:
        from instaslice_tpu_torch.metrics.metrics import start_metrics_server

        start_metrics_server(
            srv.scheduler.metrics, args.metrics_port, host=args.host
        )
    log.info("serving on %s (device=%s, mesh=%s, quantized=%s)", srv.url,
             engine.device, engine.mesh and dict(
                 zip(engine.mesh.mesh_dim_names, engine.mesh.shape)),
             engine.kv_quant)
    # SIGTERM starts a drain instead of killing in-flight decodes:
    # readiness flips, in-flight requests finish inside the budget,
    # stragglers get a clean 503, then the process exits
    term = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *_: term.set())
    except ValueError:  # not the main thread (embedded use)
        pass
    try:
        term.wait()
        log.info("SIGTERM: draining (budget %.1fs)", args.drain_budget)
        srv.drain()
        srv.wait_drained(args.drain_budget + 5.0)
        srv.stop()
    except KeyboardInterrupt:
        srv.stop()
    finally:
        if hasattr(engine, "shutdown"):
            engine.shutdown()          # release the followers
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
