"""The driver/follower op stream (port of
``instaslice_tpu/serving/distributed.py``).

PyTorch is multi-controller: every rank of a tensor-parallel serving
mesh (:class:`~instaslice_tpu_torch.serving.engine.ServingEngine` with
``mesh=``) is its own process, and every process must issue the SAME
forwards in the SAME order, or the collectives inside them deadlock. An
HTTP server takes requests on one rank only, so serving a mesh needs one
mechanism the reference needs only across hosts: rank 0 (the
**driver**) decides the op sequence and broadcasts it; ranks 1..N-1
(**followers**) replay it verbatim on their own engines. Engines are
deterministic given the same op sequence (same seed, same host
bookkeeping, identical gathered logits), so every process issues the
same forwards and the collectives line up, even for a tp 2 server on one
host. Results are read on the driver only: every rank holds the whole
logits and samples the same tokens.

The op log is the entire protocol: newline-delimited JSON over one TCP
connection per follower, ops applied strictly in order. The radix
prefix cache needs no ops of its own: every tree mutation is
engine-internal and deterministic, and its LRU clock is logical.

Wire format (one JSON object per line)::

    {"op": "add_request", "prompt": [...], "stop": [[...]], "n": 1,
     "adapter": 0}
    {"op": "add_requests", "reqs": [{"prompt": [...], "n": 1,
     "stop": [[...]], "adapter": 0}, ...]}
    {"op": "step"} | {"op": "decode_block", "n": 8}
    {"op": "spec_step", "k": 4}
    {"op": "register_prefix", "tokens": [...]}
    {"op": "drop_prefix", "tokens": [...]}
    {"op": "finish_slot", "slot": 0, "n_keep": 5, "reason": "..."}
    {"op": "evict_slot", "slot": 0}
    {"op": "preempt_slot", "slot": 0}
    {"op": "resume_request", "rid": 7}
    {"op": "drop_parked", "rid": 7}
    {"op": "import_session", "blob": {...session wire format...}}
    {"op": "recover"}
    {"op": "shutdown"}

Usage: driver (rank 0)::

    eng = ServingEngine(model, params, mesh=mesh, ...)
    deng = DistributedEngine(eng, n_followers=world - 1, port=oplog_port)
    deng.generate(prompts, max_new_tokens=64)   # or ApiServer(deng)

followers (ranks 1..N-1)::

    eng = ServingEngine(model, params, mesh=mesh, ...)   # identical args
    run_follower(eng, driver_host, oplog_port)          # blocks

``ApiServer(deng)`` works unchanged: the scheduler mutates the engine
only through the ops this wrapper broadcasts. What the scheduler calls
besides them is rank-local: host-side reads and checks
(``can_admit``, ``_match_prefix``, the stats), ``cache_poisoned()``
and ``_drain_pending()`` (the driver's readback of a block its
followers replay synchronously). ``recover()`` rides the op stream
(the reference's op list has no such op, so after its scheduler
recovers the driver alone, the followers keep their slots and the
replicas diverge): it issues no collective, and every rank drops the
same slots, so the next admissions land in the same slots everywhere.
A fault that keeps the driver from an op it has already broadcast
leaves the followers in collectives it never joins: such a rank is
lost, as a failed chip's is. The warm-ups
(``warm_prefill_buckets``, ``warm_spec_programs``) issue forwards, so
every rank runs them before the driver/follower split
(``api_server.build_engine``). ``_bcast`` consults the network
nemesis (``faults/netchaos.py``) on each follower's edge, as the
reference's does: a partitioned follower is dropped like a dead one.
"""

from __future__ import annotations

import json
import logging
import socket
import time
from typing import List, Optional

from instaslice_tpu_torch.serving.engine import (
    AdmissionRequest,
    ServingEngine,
)

log = logging.getLogger("instaslice_tpu_torch.serving.distributed")

#: follower handshake marker (first line on connect)
HELLO_MAGIC = "tpuslice-oplog-v1"


def _recv_line(sock: socket.socket, limit: int = 4096) -> bytes:
    """Read up to the first newline (handshake use; tiny payload)."""
    buf = b""
    while b"\n" not in buf:
        chunk = sock.recv(1024)
        if not chunk or len(buf) > limit:
            raise OSError("connection closed during handshake")
        buf += chunk
    return buf.split(b"\n", 1)[0]


class DistributedEngine:
    """Worker-0 wrapper: broadcast each op to every follower, then
    apply it locally. Reads (``slots``, ``finished``, counters…)
    delegate to the local engine untouched."""

    def __init__(self, engine: ServingEngine, n_followers: int,
                 port: int, bind_host: str = "0.0.0.0",
                 accept_timeout: float = 120.0) -> None:
        self.engine = engine
        self._conns: List[tuple] = []       # (socket, peer-addr string)
        if n_followers:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((bind_host, port))
            srv.listen(n_followers + 4)
            deadline = time.monotonic() + accept_timeout
            while len(self._conns) < n_followers:
                srv.settimeout(max(deadline - time.monotonic(), 0.001))
                conn, addr = srv.accept()
                # one-line hello gates the op stream: a stray connector
                # (port scan, prober) must not consume a follower slot
                # or receive the broadcast (it carries prompt tokens)
                try:
                    conn.settimeout(10.0)
                    hello = json.loads(_recv_line(conn))
                    if hello.get("hello") != HELLO_MAGIC:
                        raise ValueError("bad hello")
                except (ValueError, OSError):
                    log.warning("rejecting non-follower connection "
                                "from %s", addr)
                    conn.close()
                    continue
                conn.settimeout(None)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._conns.append((conn, f"{addr[0]}:{addr[1]}"))
            srv.close()

    # ------------------------------------------------------------- plumbing

    def __setattr__(self, name, value):
        # generate() (run unbound over this wrapper) reassigns engine
        # attributes like ``finished`` — route them to the engine so the
        # wrapper never shadows live state
        if name in ("engine", "_conns"):
            object.__setattr__(self, name, value)
        else:
            setattr(self.engine, name, value)

    def _bcast(self, op: dict) -> None:
        """Send to every live follower. A dead follower is dropped with
        a loud log instead of raising into the scheduler thread: its
        rank's collectives then fail the driver's next forward, and the
        local server must keep serving/failing requests rather than
        silently dying. Each send consults the network nemesis on the
        ``opstream>follower:<addr>`` edge."""
        from instaslice_tpu_torch.faults.netchaos import get_nemesis

        line = (json.dumps(op) + "\n").encode()
        dead = []
        nemesis = get_nemesis()
        for pair in self._conns:
            conn, addr = pair
            try:
                if nemesis is not None:
                    # PartitionError is an OSError: a partitioned
                    # follower takes the same drop path as a dead one
                    nemesis.before_request("opstream", f"follower:{addr}")
                    nemesis.throttle_sleep(
                        "opstream", f"follower:{addr}", len(line))
                conn.sendall(line)
            except OSError as e:
                # addr captured at accept time: a reset socket raises
                # ENOTCONN from getpeername(), which would escape this
                # handler and kill the scheduler thread
                log.error("dropping dead follower %s: %s", addr, e)
                dead.append(pair)
        for pair in dead:
            self._conns.remove(pair)
            try:
                pair[0].close()
            except OSError:
                pass

    def __getattr__(self, name):
        # reads and non-broadcast helpers fall through to the engine
        return getattr(self.engine, name)

    # ------------------------------------------------------------- the ops

    def add_request(self, prompt: List[int], stop=None,
                    adapter: int = 0) -> int:
        return self.add_request_n(prompt, 1, stop=stop,
                                  adapter=adapter)[0]

    def add_request_n(self, prompt: List[int], n: int,
                      stop=None, adapter: int = 0) -> List[int]:
        # host-side validation BEFORE the broadcast: a rejected request
        # must not enter the op stream at all. (Followers additionally
        # swallow deterministic validation errors, so even an op that
        # slips through fails identically on every replica.)
        stop = ServingEngine._normalize_stop(stop)
        self.engine._check_prompt_fits(prompt)
        self.engine._check_capacity(n)
        # adapter rides the op stream: a follower replaying through the
        # base model while the driver used an adapter would silently
        # diverge the replicas
        self._bcast({"op": "add_request", "prompt": list(prompt),
                     "stop": stop, "n": n, "adapter": adapter})
        return self.engine.add_request_n(prompt, n, stop=stop,
                                         adapter=adapter)

    def add_requests(self, reqs):
        """Burst admission rides the op stream as ONE op: followers
        replay the identical batched prefill dispatches (same bucketed
        shapes), so the compiled-program sets stay aligned."""
        reqs = [r if isinstance(r, AdmissionRequest)
                else AdmissionRequest(**r) for r in reqs]
        norm = []
        for r in reqs:
            stop = ServingEngine._normalize_stop(r.stop)
            self.engine._check_prompt_fits(r.prompt)
            norm.append(AdmissionRequest(list(r.prompt), r.n, stop,
                                         r.adapter))
        self.engine._check_capacity(sum(r.n for r in norm))
        self._bcast({"op": "add_requests", "reqs": [
            {"prompt": r.prompt, "n": r.n, "stop": r.stop,
             "adapter": r.adapter} for r in norm
        ]})
        return self.engine.add_requests(norm)

    def step(self):
        self._bcast({"op": "step"})
        return self.engine.step()

    def decode_block(self, n_steps: int):
        self._bcast({"op": "decode_block", "n": n_steps})
        return self.engine.decode_block(n_steps)

    def decode_block_start(self, n_steps: int):
        """The overlap seam over the op stream: the BROADCAST happens
        at start (followers dispatch their block concurrently with the
        driver's — that is the point); finish is driver-local (the
        followers' replayed decode_block does its own readback)."""
        self._bcast({"op": "decode_block", "n": n_steps})
        return self.engine.decode_block_start(n_steps)

    def decode_block_finish(self):
        return self.engine.decode_block_finish()

    def spec_step(self, k=None):
        if k is None:
            k = self.engine.spec_plan_k()
        self._bcast({"op": "spec_step", "k": k})
        return self.engine.spec_step(k=k)

    def spec_step_start(self, k=None):
        """The spec overlap seam over the op stream, exactly like
        decode_block_start: the broadcast happens at START — with the
        driver's PLANNED k pinned into the op, so followers dispatch
        the identical draft/verify shapes even if their adaptive-EMA
        state ever drifted — and followers compute concurrently with
        the driver; finish is driver-local."""
        if k is None:
            k = self.engine.spec_plan_k()
        self._bcast({"op": "spec_step", "k": k})
        return self.engine.spec_step_start(k=k)

    def spec_step_finish(self):
        return self.engine.spec_step_finish()

    def register_prefix(self, prefix: List[int]) -> None:
        if tuple(prefix) not in self.engine.prefixes:
            self.engine._validate_prefix(prefix)   # before the broadcast
        self._bcast({"op": "register_prefix", "tokens": list(prefix)})
        self.engine.register_prefix(prefix)

    def drop_prefix(self, prefix: List[int]) -> bool:
        self._bcast({"op": "drop_prefix", "tokens": list(prefix)})
        return self.engine.drop_prefix(prefix)

    def finish_slot(self, slot: int, n_keep: Optional[int] = None,
                    reason: str = "max_new_tokens") -> None:
        self._bcast({"op": "finish_slot", "slot": slot,
                     "n_keep": n_keep, "reason": reason})
        self.engine.finish_slot(slot, n_keep=n_keep, reason=reason)

    def evict_slot(self, slot: int) -> None:
        self._bcast({"op": "evict_slot", "slot": slot})
        self.engine.evict_slot(slot)

    def preempt_slot(self, slot: int) -> int:
        # preemption/resume change slot occupancy AND dispatch stripe
        # reads/writes, so they are broadcast surface exactly like
        # finish_slot; parked state replays deterministically per host
        self._bcast({"op": "preempt_slot", "slot": slot})
        return self.engine.preempt_slot(slot)

    def resume_request(self, rid: int) -> int:
        if rid not in self.engine.parked:
            raise ValueError(f"request {rid} is not parked")
        self._bcast({"op": "resume_request", "rid": rid})
        return self.engine.resume_request(rid)

    def drop_parked(self, rid: int) -> bool:
        self._bcast({"op": "drop_parked", "rid": rid})
        return self.engine.drop_parked(rid)

    def import_session(self, blob: dict) -> int:
        """Inbound live migration rides the op stream: every replica
        materializes the identical parked state (and adopts the blob's
        RNG key), so the later resume_request replays aligned. The blob
        is validated BEFORE the broadcast — a rejected session must
        never enter the op stream. export_session needs no op: it is a
        pure read of parked state (and is refused on multi-process
        meshes — see the engine)."""
        self.engine._validate_session_blob(blob)
        self._bcast({"op": "import_session", "blob": blob})
        return self.engine.import_session(blob)

    def recover(self) -> List[int]:
        """Every replica drops its live slots and zeroes its caches, as
        the driver does (the scheduler's ``_recover_engine``)."""
        self._bcast({"op": "recover"})
        return self.engine.recover()

    def generate(self, prompts, max_new_tokens, block_size: int = 32,
                 stop=None):
        # ServingEngine.generate drives everything through the public
        # ops above, so running it unbound with this wrapper as `self`
        # broadcasts every device-touching step (duck typing is the
        # point: the wrapper IS engine-shaped)
        return ServingEngine.generate(
            self, prompts, max_new_tokens, block_size=block_size,
            stop=stop,
        )

    def shutdown(self) -> None:
        """Release the followers (they return from run_follower)."""
        self._bcast({"op": "shutdown"})
        for conn, _addr in self._conns:
            conn.close()
        self._conns = []


def run_follower(engine: ServingEngine, driver_host: str, port: int,
                 connect_timeout: float = 120.0) -> int:
    """Replay the driver's op stream on the local engine replica until
    shutdown/EOF; returns the number of ops applied.

    Every op triggers the same forwards the driver issues, which is
    what keeps the multi-process collectives aligned. Results are
    intentionally discarded — the driver owns delivery."""
    deadline = time.monotonic() + connect_timeout
    while True:
        # a fresh socket per attempt: on some Linux kernels a socket
        # whose connect was refused fails every later connect with
        # ECONNABORTED, however soon the driver listens (the reference
        # reuses one socket)
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.connect((driver_host, port))
            break
        except OSError:
            sock.close()
            if time.monotonic() > deadline:
                raise
            # driver not listening yet: deadline-bounded startup poll
            # (no stop event exists before the stream is established)
            time.sleep(0.2)  # slicelint: disable=sleep-in-loop
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.sendall((json.dumps({"hello": HELLO_MAGIC}) + "\n").encode())
    applied = 0
    buf = b""
    try:
        while True:
            nl = buf.find(b"\n")
            if nl < 0:
                chunk = sock.recv(65536)
                if not chunk:
                    return applied                    # driver went away
                buf += chunk
                continue
            line, buf = buf[:nl], buf[nl + 1:]
            op = json.loads(line)
            kind = op["op"]
            if kind == "shutdown":
                return applied
            if kind not in ("add_request", "add_requests", "step",
                            "decode_block",
                            "spec_step", "register_prefix",
                            "drop_prefix", "finish_slot", "evict_slot",
                            "preempt_slot", "resume_request",
                            "drop_parked", "import_session", "recover"):
                # a protocol mismatch is NOT deterministic-skip
                # territory: replicas are about to diverge — die loudly
                raise RuntimeError(f"unknown op {kind!r} in op stream")
            try:
                if kind == "add_request":
                    engine.add_request_n(op["prompt"], op.get("n", 1),
                                         stop=op["stop"],
                                         adapter=op.get("adapter", 0))
                elif kind == "add_requests":
                    engine.add_requests([
                        AdmissionRequest(r["prompt"], r.get("n", 1),
                                         r.get("stop"),
                                         r.get("adapter", 0))
                        for r in op["reqs"]
                    ])
                elif kind == "step":
                    engine.step()
                elif kind == "decode_block":
                    engine.decode_block(op["n"])
                elif kind == "spec_step":
                    # the driver's planned k rides the op. A missing k
                    # (a pre-r12 driver) makes the follower plan its
                    # own — best effort only: a mixed-version mesh is
                    # NOT a supported deployment (driver and followers
                    # ship in one pod template and restart together),
                    # and an old driver's un-floored k need not match
                    # the new shape set
                    engine.spec_step(k=op.get("k"))
                elif kind == "register_prefix":
                    engine.register_prefix(op["tokens"])
                elif kind == "drop_prefix":
                    engine.drop_prefix(op["tokens"])
                elif kind == "finish_slot":
                    engine.finish_slot(op["slot"], n_keep=op["n_keep"],
                                       reason=op["reason"])
                elif kind == "evict_slot":
                    engine.evict_slot(op["slot"])
                elif kind == "preempt_slot":
                    engine.preempt_slot(op["slot"])
                elif kind == "resume_request":
                    engine.resume_request(op["rid"])
                elif kind == "drop_parked":
                    engine.drop_parked(op["rid"])
                elif kind == "import_session":
                    engine.import_session(op["blob"])
                elif kind == "recover":
                    engine.recover()
            except (ValueError, KeyError, RuntimeError) as e:
                # deterministic host-side validation failure: the
                # driver hit (or pre-screened) the exact same error, so
                # replica state stays aligned by SKIPPING it here too.
                # RuntimeError SUBCLASSES (torch.OutOfMemoryError, a
                # collective's DistBackendError…) are real per-rank
                # failures: skipping would silently drop a forward the
                # driver executed and deadlock its collectives — die
                # loudly instead so the pod restarts.
                if isinstance(e, RuntimeError) and \
                        type(e) is not RuntimeError:
                    raise
                log.warning("skipping op %s: %s", kind, e)
            # results are the driver's business: drain the follower's
            # finished list so it can't grow without bound
            engine.finished.clear()
            applied += 1
    finally:
        sock.close()
