"""Deterministic, seedable fault injection for the port's serving plane.

A copy of the serving half of ``instaslice_tpu/faults/__init__.py``: the
:class:`FaultPlan` (a seeded RNG plus per-**site** specs: probability,
exact call schedules, fire caps), :class:`InjectedCrash` (which the
scheduler lets kill its thread), the engine hook
(:func:`engine_fault_hook`, consulted by
:class:`~instaslice_tpu_torch.serving.engine.ServingEngine` before every
device dispatch), the scheduler round hook, and the crash-point plan
(:class:`CrashPlan`, ``TPUSLICE_CRASH_AT``, :func:`maybe_crash`), whose
serving site is the session export (``serve.export``), and the agent's
are ``agent.realize`` and ``agent.teardown``. The kube and device
wrappers are copied too: :class:`FaultyKubeClient` (transient API
failures in every verb, disconnects mid-watch) and
:class:`FaultyBackend` (device errors, delays, chip failures in front of
a :class:`~instaslice_tpu_torch.device.backend.DeviceBackend`, whose
``reserve`` takes the port's ``profile`` and ``start``). The port
imports nothing of the JAX package. The network nemesis (partitions,
latency, watch dup/reorder, throttling) is the copy in
``faults/netchaos.py``, re-exported here as the reference re-exports
it.

Plans are built in tests or parsed from ``TPUSLICE_FAULT_PLAN``::

    TPUSLICE_FAULT_PLAN="seed=7;engine.prefill:at=2,kinds=poison"

Grammar: ``seed=N`` then ``;``-separated ``site:key=val,key=val`` specs
with keys ``p`` (probability), ``kinds`` (``|``-separated), ``at``
(``|``-separated exact call numbers, 1-based), ``max`` (fire cap),
``delay`` (seconds, for kind ``delay``).

:func:`poison_cache` is where the port differs: PyTorch donates no
buffer, so "poisoned" is the engine's own mark (set when a
cache-writing device call raises; cleared only by ``recover()``), and
the hook sets that mark.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from instaslice_tpu_torch.kube.client import ApiError, KubeClient, WatchEvent
from instaslice_tpu_torch.utils.lockcheck import named_lock

# Network nemesis layer (partitions, latency, watch dup/reorder,
# throttling) lives in ``faults/netchaos.py``; this module stays the one
# fault facade.
from instaslice_tpu_torch.faults.netchaos import (  # noqa: F401  (re-exports)
    NemesisKubeClient,
    NemesisPlan,
    NemesisRule,
    PartitionError,
    get_nemesis,
    reset_nemesis,
    set_nemesis,
)


class FaultError(Exception):
    """An injected failure (distinguishable from organic ones in logs)."""


class InjectedCrash(BaseException):
    """A simulated process death at a named crash point.

    Deliberately derives :class:`BaseException`: the reconcile
    framework, the repacker tick, and the serving scheduler all wrap
    their loops in ``except Exception`` keep-alive guards, and a crash
    must kill the component *through* those guards the way a SIGKILL
    would — anything that absorbs it is a bug the chaos tier exists to
    catch."""

    def __init__(self, site: str) -> None:
        super().__init__(f"injected crash at {site}")
        self.site = site


class CrashPlan:
    """Deterministic process-death schedule over named crash sites.

    ``sites`` maps site name → 1-based call number at which to fire
    (each site fires at most once — a crashed component does not keep
    crashing; its *restart* re-arms nothing). Thread-safe like
    :class:`FaultPlan`: crash sites sit on controller workers, agent
    reconcilers, and the serving scheduler concurrently."""

    def __init__(self, sites: Optional[Dict[str, int]] = None,
                 hard: bool = False) -> None:
        self.sites: Dict[str, int] = dict(sites or {})
        self.hard = hard
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}
        self._lock = named_lock("faults.crashplan")

    def arm(self, site: str, nth: int = 1) -> "CrashPlan":
        """Register/replace a crash site; returns self for chaining.
        ``nth`` counts from THIS arming: re-arming resets the site's
        call counter (otherwise a kill-loop re-arming a hot site after
        its calls already passed ``nth`` could silently never fire)."""
        with self._lock:
            self.sites[site] = max(1, int(nth))
            self.fired.pop(site, None)
            self.calls.pop(site, None)
        return self

    def check(self, site: str) -> None:
        """One call at ``site``: raises :class:`InjectedCrash` (or
        hard-exits) when the armed call number is reached."""
        with self._lock:
            self.calls[site] = n = self.calls.get(site, 0) + 1
            nth = self.sites.get(site)
            if nth is None or site in self.fired or n != nth:
                return
            self.fired[site] = n
        if self.hard or os.environ.get("TPUSLICE_CRASH_HARD") == "1":
            os._exit(17)
        raise InjectedCrash(site)

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {
                name: {"calls": self.calls.get(name, 0),
                       "fired": self.fired.get(name, 0)}
                for name in set(self.calls) | set(self.sites)
            }

    @classmethod
    def from_env(cls, text: Optional[str] = None) -> Optional["CrashPlan"]:
        """Parse ``TPUSLICE_CRASH_AT`` (``site[:nth]`` comma-separated).
        Returns None for empty/missing text."""
        if text is None:
            text = os.environ.get("TPUSLICE_CRASH_AT", "")
        text = (text or "").strip()
        if not text:
            return None
        plan = cls()
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            site, _, nth = part.partition(":")
            try:
                n = int(nth) if nth else 1
            except ValueError:
                # fail FAST and fail CLEAR: this parses at import time
                # in every component, and a chaos knob that silently
                # no-oped would invalidate the whole chaos run — but
                # the operator must see the misconfigured variable,
                # not an int() traceback deep in an import cascade
                raise ValueError(
                    f"TPUSLICE_CRASH_AT: malformed entry {part!r} "
                    f"(want site[:nth] with integer nth, e.g. "
                    f"'agent.realize:2')"
                ) from None
            plan.arm(site.strip(), n)
        return plan


#: the process-default crash plan consulted by :func:`maybe_crash` —
#: None (the overwhelmingly common case) costs one global read per
#: crash-point visit
_crash_plan: Optional[CrashPlan] = CrashPlan.from_env()


def set_crash_plan(plan: Optional[CrashPlan]) -> None:
    """Install the process crash plan (tests, simulated chaos runs)."""
    global _crash_plan
    _crash_plan = plan


def get_crash_plan() -> Optional[CrashPlan]:
    return _crash_plan


def reset_crash_plan() -> None:
    """Re-read ``TPUSLICE_CRASH_AT`` (test isolation)."""
    global _crash_plan
    _crash_plan = CrashPlan.from_env()


def maybe_crash(site: str) -> None:
    """THE crash-point hook: components call this at lifecycle edges
    (docs/RECOVERY.md catalogs the sites); a no-op unless a plan armed
    the site."""
    plan = _crash_plan
    if plan is not None:
        plan.check(site)


class InjectedApiError(ApiError):
    """An injected kube API failure; ``code`` carries the HTTP status."""


@dataclass
class SiteSpec:
    """How one site misbehaves. ``kinds`` is sampled uniformly when the
    site fires; ``at_calls`` (1-based call numbers) always fire
    regardless of probability — exact schedules for regression tests."""

    probability: float = 0.0
    kinds: Tuple[str, ...] = ("error",)
    at_calls: frozenset = field(default_factory=frozenset)
    max_fires: int = -1          # -1 = unlimited
    delay_s: float = 0.01


class FaultPlan:
    """Seeded fault schedule over named sites. Thread-safe: the serving
    data plane consults it from the scheduler thread while HTTP threads
    and the control plane consult it concurrently."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self.rng = random.Random(seed)
        self.sites: Dict[str, SiteSpec] = {}
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}
        self._lock = named_lock("faults.plan")

    def site(self, name: str, probability: float = 0.0,
             kinds: Tuple[str, ...] = ("error",), at_calls=(),
             max_fires: int = -1, delay_s: float = 0.01) -> "FaultPlan":
        """Register/replace a site spec; returns self for chaining."""
        self.sites[name] = SiteSpec(
            probability=probability, kinds=tuple(kinds),
            at_calls=frozenset(at_calls), max_fires=max_fires,
            delay_s=delay_s,
        )
        return self

    def fire(self, name: str) -> Optional[str]:
        """One call at ``name``: returns the fault kind to inject, or
        None. Counts every call (fired or not) so ``at_calls`` schedules
        are exact."""
        with self._lock:
            spec = self.sites.get(name)
            self.calls[name] = n = self.calls.get(name, 0) + 1
            if spec is None:
                return None
            if 0 <= spec.max_fires <= self.fired.get(name, 0):
                return None
            hit = n in spec.at_calls or (
                spec.probability > 0
                and self.rng.random() < spec.probability
            )
            if not hit:
                return None
            self.fired[name] = self.fired.get(name, 0) + 1
            return (spec.kinds[self.rng.randrange(len(spec.kinds))]
                    if len(spec.kinds) > 1 else spec.kinds[0])

    def randrange(self, n: int) -> int:
        """A draw from the plan's RNG under its lock — wrappers that
        need extra randomness (e.g. which chip to fail) must come
        through here, or concurrent fire() calls would interleave with
        the draw and break seeded replayability."""
        with self._lock:
            return self.rng.randrange(n)

    def stats(self) -> Dict[str, Dict[str, int]]:
        """Per-site {calls, fired} — chaos tests log this on failure so
        a regression names the fault sequence that broke it."""
        with self._lock:
            return {
                name: {"calls": self.calls.get(name, 0),
                       "fired": self.fired.get(name, 0)}
                for name in set(self.calls) | set(self.sites)
            }

    # ------------------------------------------------------------- env

    @classmethod
    def from_env(cls, text: Optional[str] = None) -> Optional["FaultPlan"]:
        """Parse the ``TPUSLICE_FAULT_PLAN`` grammar (module docstring).
        Returns None for empty/missing text so callers can write
        ``plan = FaultPlan.from_env()`` unconditionally."""
        if text is None:
            text = os.environ.get("TPUSLICE_FAULT_PLAN", "")
        text = (text or "").strip()
        if not text:
            return None
        seed = 0
        specs: List[Tuple[str, dict]] = []
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            if part.startswith("seed="):
                seed = int(part[len("seed="):])
                continue
            site, _, body = part.partition(":")
            kw: dict = {}
            for item in body.split(","):
                if not item.strip():
                    continue
                key, _, val = item.partition("=")
                key = key.strip()
                if key == "p":
                    kw["probability"] = float(val)
                elif key == "kinds":
                    kw["kinds"] = tuple(val.split("|"))
                elif key == "at":
                    kw["at_calls"] = frozenset(
                        int(x) for x in val.split("|") if x
                    )
                elif key == "max":
                    kw["max_fires"] = int(val)
                elif key == "delay":
                    kw["delay_s"] = float(val)
                else:
                    raise ValueError(
                        f"TPUSLICE_FAULT_PLAN: unknown key {key!r} "
                        f"in {part!r}"
                    )
            specs.append((site.strip(), kw))
        plan = cls(seed)
        for site, kw in specs:
            plan.site(site, **kw)
        return plan


# --------------------------------------------------------------- kube

class FaultyKubeClient(KubeClient):
    """Injects API flakiness between a consumer and any
    :class:`KubeClient`. Sites:

    - ``kube.request`` — every verb. Kinds: ``http-503``/``http-500``
      (InjectedApiError with that code), ``http-429`` (too many
      requests), ``conn-reset`` (ConnectionResetError — what a dropped
      TCP session surfaces after the real client's retries give up),
      ``delay`` (slow API server).
    - ``kube.watch`` — consulted per watch **event**. Kind
      ``disconnect`` truncates the stream mid-flight (the consumer must
      re-establish and resume); ``delay`` stalls delivery.

    The wrapper injects at the KubeClient interface, so it composes
    with both the in-process fake and :class:`RealKubeClient` (where it
    models failures that survive the client's own retry layer)."""

    def __init__(self, inner: KubeClient, plan: FaultPlan) -> None:
        self.inner = inner
        self.plan = plan
        # forward the watch-pacing hint so wrapped Managers behave
        pref = getattr(inner, "preferred_watch_timeout", None)
        if pref is not None:
            self.preferred_watch_timeout = pref

    def _maybe_fail(self) -> None:
        kind = self.plan.fire("kube.request")
        if kind is None:
            return
        if kind == "delay":
            time.sleep(self.plan.sites["kube.request"].delay_s)
            return
        if kind == "conn-reset":
            raise ConnectionResetError("injected: connection reset")
        code = {"http-429": 429, "http-500": 500}.get(kind, 503)
        err = InjectedApiError(f"injected: HTTP {code}")
        err.code = code
        raise err

    def create(self, kind: str, obj: dict) -> dict:
        self._maybe_fail()
        return self.inner.create(kind, obj)

    def get(self, kind: str, namespace: str, name: str) -> dict:
        self._maybe_fail()
        return self.inner.get(kind, namespace, name)

    def list(self, kind, namespace=None, label_selector=None):
        self._maybe_fail()
        return self.inner.list(kind, namespace=namespace,
                               label_selector=label_selector)

    def update(self, kind: str, obj: dict) -> dict:
        self._maybe_fail()
        return self.inner.update(kind, obj)

    def patch(self, kind, namespace, name, patch):
        self._maybe_fail()
        return self.inner.patch(kind, namespace, name, patch)

    def patch_status(self, kind, namespace, name, patch):
        self._maybe_fail()
        return self.inner.patch_status(kind, namespace, name, patch)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._maybe_fail()
        self.inner.delete(kind, namespace, name)

    def watch(self, kind, namespace=None, replay=True, timeout=None,
              resource_version=None) -> Iterator[WatchEvent]:
        stream = self.inner.watch(
            kind, namespace=namespace, replay=replay, timeout=timeout,
            resource_version=resource_version,
        )

        def _faulty() -> Iterator[WatchEvent]:
            for ev in stream:
                fault = self.plan.fire("kube.watch")
                if fault == "disconnect":
                    return  # stream cut mid-flight; consumer resumes
                if fault == "delay":
                    # the injected stall is the fault being modeled
                    time.sleep(  # slicelint: disable=sleep-in-loop
                        self.plan.sites["kube.watch"].delay_s)
                yield ev

        return _faulty()


# ------------------------------------------------------------- device

class FaultyBackend:
    """Injects device flakiness in front of a
    :class:`~instaslice_tpu_torch.device.backend.DeviceBackend`. Sites
    ``device.<op>`` for op in reserve/release/list/discover/health;
    kinds: ``error`` (DeviceError), ``delay`` (slow ioctl), and
    ``chip-fail`` (marks a random chip unhealthy through the inner
    backend's ``fail_chip`` — the health sweep then sees it, exactly
    like a GPU fallen off the bus). ``reserve`` passes the port's
    ``profile`` and ``start`` through."""

    def __init__(self, inner, plan: FaultPlan) -> None:
        self._inner = inner
        self._plan = plan

    def __getattr__(self, name):  # passthrough (test helpers included)
        return getattr(self._inner, name)

    def _maybe_fail(self, op: str) -> None:
        from instaslice_tpu_torch.device.backend import DeviceError

        kind = self._plan.fire(f"device.{op}")
        if kind is None:
            return
        if kind == "delay":
            time.sleep(self._plan.sites[f"device.{op}"].delay_s)
            return
        if kind == "chip-fail":
            fail = getattr(self._inner, "fail_chip", None)
            if fail is not None:
                inv = self._inner.discover()
                chips = sorted(inv.chip_paths)
                fail(chips[self._plan.randrange(len(chips))])
            return
        raise DeviceError(f"injected device.{op} failure")

    def discover(self):
        self._maybe_fail("discover")
        return self._inner.discover()

    def reserve(self, slice_uuid, chip_ids, profile="", start=-1):
        self._maybe_fail("reserve")
        return self._inner.reserve(slice_uuid, chip_ids, profile, start)

    def release(self, slice_uuid):
        self._maybe_fail("release")
        return self._inner.release(slice_uuid)

    def list_reservations(self):
        self._maybe_fail("list")
        return self._inner.list_reservations()

    def chip_health(self):
        self._maybe_fail("health")
        return self._inner.chip_health()


# ------------------------------------------------------------- engine

def poison_cache(engine) -> None:
    """Leave the engine's KV cache in the state a failed cache-writing
    device call leaves it: marked poisoned (``cache_poisoned()`` turns
    True; only ``recover()`` makes the engine decode again)."""
    engine.mark_cache_poisoned()


def engine_fault_hook(plan: FaultPlan, engine) -> Callable[[str], None]:
    """The callable for ``engine.fault_hook``: consulted with the op
    name (``"prefill"``/``"decode"``/``"spec"``) before each dispatch.
    Sites ``engine.<op>``; kinds: ``delay`` (slow dispatch), ``poison``
    (chip failure mid-dispatch: the cache is marked poisoned AND the
    call raises — the full recovery path), ``error`` (host-side raise,
    cache intact)."""

    def hook(op: str) -> None:
        site = f"engine.{op}"
        kind = plan.fire(site)
        if kind is None:
            return
        if kind == "delay":
            time.sleep(plan.sites[site].delay_s)
            return
        if kind == "poison":
            poison_cache(engine)
            raise FaultError(f"injected chip failure during {op} "
                             "(cache poisoned)")
        raise FaultError(f"injected {op} failure")

    return hook


def scheduler_fault_hook(plan: FaultPlan) -> Callable[[], None]:
    """Hook for the API scheduler's loop (site ``scheduler.round``):
    ``delay`` stalls a round, ``error`` raises into the loop's guard —
    proving one bad round never kills the serving thread."""

    def hook() -> None:
        kind = plan.fire("scheduler.round")
        if kind is None:
            return
        if kind == "delay":
            time.sleep(plan.sites["scheduler.round"].delay_s)
            return
        raise FaultError("injected scheduler-round failure")

    return hook
