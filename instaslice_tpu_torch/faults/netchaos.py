"""Network nemesis: seeded, schedulable network-fault injection.

:mod:`instaslice_tpu_torch.faults` models *endpoint* misbehavior — a flaky
API server, a failing device ioctl, a poisoned engine dispatch. This
module models the **network between** endpoints: partitions (symmetric
and one-way), added latency/jitter, probabilistic drops, duplicated and
reordered watch deliveries, and slow-transfer throttling, all driven by
one seeded :class:`NemesisPlan` so a red chaos run replays exactly.

The plan speaks in directed **links** ``src>dst`` between named
endpoints (``controller``, ``agent-node-0``, ``router``,
``replica:http://…``, ``apiserver``, ``loadgen``, ``opstream``).
Injection happens at the transport seams:

- :class:`NemesisKubeClient` wraps any kube client (controller↔apiserver
  and agent↔apiserver): verbs consult the ``ident>apiserver`` edge,
  watch deliveries the reverse ``apiserver>ident`` edge — which is what
  makes **one-way** partitions real (a controller that can still write
  but sees no watch events, or the mirror image).
- The router consults its plan on the ``router>replica:<url>`` edge
  around every replica HTTP call and stream chunk
  (``serving/router.py``).
- The distributed op-stream consults ``opstream>follower:<addr>`` per
  broadcast (``serving/distributed.py``).

Every rule can carry ``start``/``duration`` offsets, so scenarios are
*scheduled*: partition at t=1s, heal at t=3s — the *timed heal* is what
lets every nemesis test end in a convergence check. :meth:`NemesisPlan.
heal` force-heals immediately.

A copy of ``instaslice_tpu/faults/netchaos.py`` (the port imports nothing
of the JAX package), over the port's kube client and lock checker.

Plans are built in tests or parsed from ``TPUSLICE_NEMESIS_PLAN``::

    TPUSLICE_NEMESIS_PLAN="seed=7;controller>apiserver:kind=partition,start=1,duration=2;router>replica:*:kind=latency,delay=0.05,jitter=0.02"

Grammar: ``seed=N`` then ``;``-separated ``src>dst:key=val,...`` rules
(the *last* ``:`` splits link from body, so ``replica:*`` works as a
dst). Keys: ``kind`` (``partition``/``partition-oneway``/``latency``/
``drop``/``dup``/``reorder``/``disconnect``/``expire``/``throttle``),
``p`` (probability for the stochastic kinds), ``delay``/``jitter``
(seconds), ``rate`` (bytes/s for ``throttle``), ``start``/``duration``
(seconds from :meth:`NemesisPlan.start`; no duration = until heal),
``max`` (fire cap). ``src``/``dst`` are fnmatch patterns.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from fnmatch import fnmatchcase
from typing import Dict, Iterator, List, Optional

from instaslice_tpu_torch.kube.client import (
    KubeClient,
    ResourceVersionExpired,
    WatchEvent,
)
from instaslice_tpu_torch.utils.lockcheck import named_lock

#: rule kinds a plan accepts (``partition`` is symmetric; everything
#: else applies to the rule's directed edge only)
NEMESIS_KINDS = (
    "partition", "partition-oneway", "latency", "drop", "dup",
    "reorder", "disconnect", "expire", "throttle",
)

#: watch-delivery kinds :meth:`NemesisPlan.watch_action` can return
_WATCH_KINDS = ("drop", "dup", "reorder", "disconnect", "expire")


class PartitionError(ConnectionError):
    """The network between two endpoints is partitioned (injected).

    Derives :class:`ConnectionError` so every transport-error handler —
    the kube retry layer, the router's breaker audit, the agent's
    degraded-mode detection — sees exactly what a real partition
    surfaces: a connection-level failure, not an API answer."""

    def __init__(self, src: str, dst: str) -> None:
        super().__init__(f"injected partition: {src} -/-> {dst}")
        self.src = src
        self.dst = dst


@dataclass
class NemesisRule:
    """One scheduled misbehavior on a directed link (see module
    docstring for the field semantics)."""

    src: str
    dst: str
    kind: str
    probability: float = 1.0
    delay_s: float = 0.05
    jitter_s: float = 0.0
    rate_bps: float = 0.0
    start_s: float = 0.0
    duration_s: float = -1.0     # -1 = until heal()
    max_fires: int = -1          # -1 = unlimited
    healed: bool = False
    fired: int = 0

    def matches(self, src: str, dst: str) -> bool:
        if fnmatchcase(src, self.src) and fnmatchcase(dst, self.dst):
            return True
        # a symmetric partition severs both directions of its link
        return self.kind == "partition" and (
            fnmatchcase(src, self.dst) and fnmatchcase(dst, self.src)
        )


class NemesisPlan:
    """Seeded, schedulable network-fault plan. Thread-safe: control-
    plane workers, the router's proxy threads, and the poll loop all
    consult it concurrently; every RNG draw happens under the plan
    lock so the same seed replays the same fault sequence."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self.rng = random.Random(seed)
        self.rules: List[NemesisRule] = []
        self._lock = named_lock("faults.nemesis")
        self._t0 = time.monotonic()

    # ------------------------------------------------------------ schedule

    def start(self) -> "NemesisPlan":
        """Re-anchor the schedule clock (``start``/``duration`` offsets
        count from here). Building a plan anchors it too — call this
        when the scenario begins later than plan construction."""
        with self._lock:
            self._t0 = time.monotonic()
        return self

    def rule(self, src: str, dst: str, kind: str, **kw) -> NemesisRule:
        if kind not in NEMESIS_KINDS:
            raise ValueError(
                f"unknown nemesis kind {kind!r} (want one of "
                f"{'/'.join(NEMESIS_KINDS)})"
            )
        r = NemesisRule(src=src, dst=dst, kind=kind, **kw)
        with self._lock:
            self.rules.append(r)
        return r

    # convenience constructors (what tests read best)

    def partition(self, src: str, dst: str, start: float = 0.0,
                  duration: float = -1.0) -> NemesisRule:
        """Symmetric partition: both directions of the link are cut."""
        return self.rule(src, dst, "partition", start_s=start,
                         duration_s=duration)

    def partition_oneway(self, src: str, dst: str, start: float = 0.0,
                         duration: float = -1.0) -> NemesisRule:
        """Cut ONLY ``src``→``dst``; the reverse direction still flows."""
        return self.rule(src, dst, "partition-oneway", start_s=start,
                         duration_s=duration)

    def latency(self, src: str, dst: str, delay: float,
                jitter: float = 0.0, start: float = 0.0,
                duration: float = -1.0) -> NemesisRule:
        return self.rule(src, dst, "latency", delay_s=delay,
                         jitter_s=jitter, start_s=start,
                         duration_s=duration)

    def drop(self, src: str, dst: str, p: float, start: float = 0.0,
             duration: float = -1.0, max_fires: int = -1) -> NemesisRule:
        return self.rule(src, dst, "drop", probability=p,
                         start_s=start, duration_s=duration,
                         max_fires=max_fires)

    def watch_chaos(self, src: str, dst: str, dup_p: float = 0.0,
                    reorder_p: float = 0.0) -> List[NemesisRule]:
        """Duplicated + reordered watch deliveries on ``src``→``dst``
        (``src`` is the server side for watches: ``apiserver``)."""
        out = []
        if dup_p > 0:
            out.append(self.rule(src, dst, "dup", probability=dup_p))
        if reorder_p > 0:
            out.append(self.rule(src, dst, "reorder",
                                 probability=reorder_p))
        return out

    def throttle(self, src: str, dst: str, rate_bps: float,
                 start: float = 0.0,
                 duration: float = -1.0) -> NemesisRule:
        return self.rule(src, dst, "throttle", rate_bps=rate_bps,
                         start_s=start, duration_s=duration)

    def heal(self, src: str = "*", dst: str = "*") -> int:
        """Force-heal every rule whose link matches; returns how many.
        (Timed rules heal themselves when ``duration`` elapses.)"""
        n = 0
        with self._lock:
            for r in self.rules:
                if (not r.healed and fnmatchcase(r.src, src)
                        and fnmatchcase(r.dst, dst)):
                    r.healed = True
                    n += 1
        return n

    # ------------------------------------------------------------ matching

    def _active(self, src: str, dst: str) -> List[NemesisRule]:
        """Rules live on the directed edge ``src``→``dst`` right now.
        Caller holds no lock; we take it (fire-cap bookkeeping happens
        later, under the lock, in the consult methods)."""
        now = time.monotonic()
        with self._lock:
            elapsed = now - self._t0
            out = []
            for r in self.rules:
                if r.healed or not r.matches(src, dst):
                    continue
                if elapsed < r.start_s:
                    continue
                if 0 <= r.duration_s < elapsed - r.start_s:
                    continue
                if 0 <= r.max_fires <= r.fired:
                    continue
                out.append(r)
            return out

    def _fires(self, r: NemesisRule) -> bool:
        """Probability draw + fire-cap bump (under the plan lock)."""
        with self._lock:
            if 0 <= r.max_fires <= r.fired:
                return False
            if r.probability < 1.0 and self.rng.random() >= r.probability:
                return False
            r.fired += 1
            return True

    def _jittered(self, r: NemesisRule) -> float:
        if r.jitter_s <= 0:
            return r.delay_s
        with self._lock:
            return r.delay_s + self.rng.uniform(0, r.jitter_s)

    def is_partitioned(self, src: str, dst: str) -> bool:
        return any(r.kind in ("partition", "partition-oneway")
                   for r in self._active(src, dst))

    # ------------------------------------------------------------ consults

    def before_request(self, src: str, dst: str) -> None:
        """One request attempt ``src``→``dst``: raises
        :class:`PartitionError` under a partition or a fired drop;
        sleeps under a latency rule."""
        for r in self._active(src, dst):
            if r.kind in ("partition", "partition-oneway"):
                with self._lock:
                    r.fired += 1
                raise PartitionError(src, dst)
            if r.kind == "drop" and self._fires(r):
                raise PartitionError(src, dst)
            if r.kind == "latency" and self._fires(r):
                # the injected stall IS the fault being modeled
                time.sleep(self._jittered(r))  # slicelint: disable=sleep-in-loop

    def watch_action(self, src: str, dst: str) -> Optional[str]:
        """One watch delivery ``src``→``dst`` (``src`` = the server).
        Returns ``"drop"``/``"dup"``/``"reorder"``/``"disconnect"``/
        ``"expire"`` or None; applies latency inline. A partition on
        the delivery edge reads as ``"disconnect"`` — the stream is
        cut and re-establishment then fails loudly at the verb edge."""
        for r in self._active(src, dst):
            if r.kind in ("partition", "partition-oneway"):
                with self._lock:
                    r.fired += 1
                return "disconnect"
            if r.kind == "latency" and self._fires(r):
                # the injected stall IS the fault being modeled
                time.sleep(self._jittered(r))  # slicelint: disable=sleep-in-loop
                continue
            if r.kind in _WATCH_KINDS and self._fires(r):
                return r.kind
        return None

    def throttle_sleep(self, src: str, dst: str, nbytes: int) -> None:
        """Slow-transfer model: sleep ``nbytes``/rate for the slowest
        active throttle on the edge."""
        rate = 0.0
        for r in self._active(src, dst):
            if r.kind == "throttle" and r.rate_bps > 0:
                rate = min(rate, r.rate_bps) if rate else r.rate_bps
                with self._lock:
                    r.fired += 1
        if rate > 0 and nbytes > 0:
            time.sleep(nbytes / rate)

    # --------------------------------------------------------------- stats

    def stats(self) -> List[dict]:
        """Per-rule fire counts — chaos tests log this on failure so a
        regression names the fault sequence that broke it."""
        with self._lock:
            return [
                {"link": f"{r.src}>{r.dst}", "kind": r.kind,
                 "fired": r.fired, "healed": r.healed}
                for r in self.rules
            ]

    # ----------------------------------------------------------------- env

    @classmethod
    def from_env(cls, text: Optional[str] = None) -> Optional["NemesisPlan"]:
        """Parse ``TPUSLICE_NEMESIS_PLAN`` (module-docstring grammar).
        Returns None for empty/missing text."""
        if text is None:
            text = os.environ.get("TPUSLICE_NEMESIS_PLAN", "")
        text = (text or "").strip()
        if not text:
            return None
        seed = 0
        rules: List[tuple] = []
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            if part.startswith("seed="):
                seed = int(part[len("seed="):])
                continue
            if ":" not in part or ">" not in part:
                raise ValueError(
                    f"TPUSLICE_NEMESIS_PLAN: malformed rule {part!r} "
                    f"(want src>dst:key=val,...)"
                )
            link, body = part.rsplit(":", 1)
            src, _, dst = link.partition(">")
            kw: dict = {}
            kind = ""
            for item in body.split(","):
                if not item.strip():
                    continue
                key, _, val = item.partition("=")
                key = key.strip()
                if key == "kind":
                    kind = val.strip()
                elif key == "p":
                    kw["probability"] = float(val)
                elif key == "delay":
                    kw["delay_s"] = float(val)
                elif key == "jitter":
                    kw["jitter_s"] = float(val)
                elif key == "rate":
                    kw["rate_bps"] = float(val)
                elif key == "start":
                    kw["start_s"] = float(val)
                elif key == "duration":
                    kw["duration_s"] = float(val)
                elif key == "max":
                    kw["max_fires"] = int(val)
                else:
                    raise ValueError(
                        f"TPUSLICE_NEMESIS_PLAN: unknown key {key!r} "
                        f"in {part!r}"
                    )
            if not kind:
                raise ValueError(
                    f"TPUSLICE_NEMESIS_PLAN: rule {part!r} needs kind="
                )
            rules.append((src.strip(), dst.strip(), kind, kw))
        plan = cls(seed)
        for src, dst, kind, kw in rules:
            plan.rule(src, dst, kind, **kw)
        return plan


#: the process-default nemesis plan — None (the overwhelmingly common
#: case) costs one global read per seam visit
_nemesis: Optional[NemesisPlan] = NemesisPlan.from_env()


def set_nemesis(plan: Optional[NemesisPlan]) -> None:
    """Install the process nemesis plan (tests / chaos drivers)."""
    global _nemesis
    _nemesis = plan


def get_nemesis() -> Optional[NemesisPlan]:
    return _nemesis


def reset_nemesis() -> None:
    """Re-read ``TPUSLICE_NEMESIS_PLAN`` (test isolation)."""
    global _nemesis
    _nemesis = NemesisPlan.from_env()


# ----------------------------------------------------------------- kube

class NemesisKubeClient(KubeClient):
    """Injects network behavior between one identified consumer and
    the API server. ``ident`` names the consumer (``controller``,
    ``agent-node-0``); verbs consult the ``ident>apiserver`` edge,
    watch deliveries the reverse ``apiserver>ident`` edge — one-way
    partitions behave asymmetrically exactly like iptables rules
    would. Composes with :class:`~instaslice_tpu_torch.faults.
    FaultyKubeClient` and both the fake and real clients."""

    SERVER = "apiserver"

    def __init__(self, inner: KubeClient, plan: NemesisPlan,
                 ident: str) -> None:
        self.inner = inner
        self.plan = plan
        self.ident = ident
        pref = getattr(inner, "preferred_watch_timeout", None)
        if pref is not None:
            self.preferred_watch_timeout = pref

    def _pre(self) -> None:
        self.plan.before_request(self.ident, self.SERVER)

    def create(self, kind: str, obj: dict) -> dict:
        self._pre()
        return self.inner.create(kind, obj)

    def get(self, kind: str, namespace: str, name: str) -> dict:
        self._pre()
        return self.inner.get(kind, namespace, name)

    def list(self, kind, namespace=None, label_selector=None):
        self._pre()
        return self.inner.list(kind, namespace=namespace,
                               label_selector=label_selector)

    def update(self, kind: str, obj: dict) -> dict:
        self._pre()
        return self.inner.update(kind, obj)

    def patch(self, kind, namespace, name, patch):
        self._pre()
        return self.inner.patch(kind, namespace, name, patch)

    def patch_status(self, kind, namespace, name, patch):
        self._pre()
        return self.inner.patch_status(kind, namespace, name, patch)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._pre()
        self.inner.delete(kind, namespace, name)

    def watch(self, kind, namespace=None, replay=True, timeout=None,
              resource_version=None) -> Iterator[WatchEvent]:
        self._pre()  # establishment rides the request edge
        stream = self.inner.watch(
            kind, namespace=namespace, replay=replay, timeout=timeout,
            resource_version=resource_version,
        )
        plan, server, ident = self.plan, self.SERVER, self.ident

        def _nemesis_stream() -> Iterator[WatchEvent]:
            held: Optional[WatchEvent] = None
            for ev in stream:
                act = plan.watch_action(server, ident)
                if act == "disconnect":
                    return          # stream cut mid-flight
                if act == "expire":
                    raise ResourceVersionExpired(
                        "injected: watch resourceVersion expired (410)"
                    )
                if act == "drop":
                    continue
                if act == "dup":
                    yield ev
                    yield ev
                    continue
                if act == "reorder" and held is None:
                    held = ev       # deliver AFTER the next event
                    continue
                yield ev
                if held is not None:
                    yield held
                    held = None
            if held is not None:
                yield held

        return _nemesis_stream()
