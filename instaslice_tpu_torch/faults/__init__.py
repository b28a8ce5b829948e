"""Deterministic, seedable fault injection for the port's serving plane.

A copy of the serving half of ``instaslice_tpu/faults/__init__.py``: the
:class:`FaultPlan` (a seeded RNG plus per-**site** specs: probability,
exact call schedules, fire caps), :class:`InjectedCrash` (which the
scheduler lets kill its thread), the engine hook
(:func:`engine_fault_hook`, consulted by
:class:`~instaslice_tpu_torch.serving.engine.ServingEngine` before every
device dispatch), the scheduler round hook, and the crash-point plan
(:class:`CrashPlan`, ``TPUSLICE_CRASH_AT``, :func:`maybe_crash`), whose
serving site is the session export (``serve.export``). The port imports
nothing of the JAX package. The kube and device-backend wrappers and the
network nemesis stay with the reference, whose control plane the port
does not have.

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
from typing import Callable, Dict, List, Optional, Tuple

from instaslice_tpu_torch.utils.lockcheck import named_lock


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
