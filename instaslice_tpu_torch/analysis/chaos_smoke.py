"""Crash and partition gates of the port (``make gpu-chaos-crash-smoke``,
``make gpu-chaos-partition-smoke``, each < 60 s on the CPU): the port's
counterpart of the ``smoke`` classes of the reference's
``tests/test_crash_chaos.py`` and ``tests/test_partition_chaos.py``, as a
module that images and ``make`` run without ``tests/``.

``--crash`` kills, each under load:

1. a controller mid-fan-out (``controller.write_allocation:2``), then
   restarts it;
2. an agent mid-realize (``agent.realize:1``), then restarts it;
3. a serving replica mid-stream under the router (``ApiServer.kill``: no
   drain, no terminals), with a fresh replica added and the victim
   removed.

``--partition`` cuts, each healed:

1. the controller from the apiserver: it grants nothing while cut, and
   after the heal the pending pod is granted with no double allocation;
2. an agent from the apiserver: static mode (``DegradedModeEntered``
   once, the device reservation untouched), the heal's boot sweep, a pod
   granted after it;
3. a gray replica that answers every request but 25x slower: ejected on
   its latency EWMA, traffic routed around it, re-admitted after the
   heal, then the loadgen's nemesis arm.

The control-plane arms run the port's ``SimCluster`` on ``h100-80gb``
nodes (MIG on): ``1g.10gb`` stands for the reference's ``v5e-1x1`` and
``3g.40gb`` for ``v5e-2x1``/``v5e-2x2``. The serving arms run the port's
server, router and loadgen over the drives' tiny model
(``analysis/drive.py``) on ``--device`` (the card by default, raising
without one; ``cpu`` for the plain versions).

The invariants are functions here, each returning its findings (a list
of strings, empty when it holds): :func:`no_overlaps` (live boxes of a
group disjoint), :func:`no_orphans` (every device reservation is the
slice of an allocation some CR epoch claims), :func:`epochs_legal`
(``check_epochs``), :func:`nemesis_clean` (``check_nemesis``) and
:func:`chains_strict` (``check_chains(strict=True)``). An arm raises
``AssertionError`` when its scenario did not happen (a crash point that
never fired, a pod never granted, a replica never ejected) and returns
its findings otherwise; the gate exits non-zero on any finding.

The kill loop (:func:`kill_site`: every site of :data:`KILL_SITES`, the
repacker's on a fragmented MIG grid) and the watchdogs
(:func:`stuck_grant`, :func:`stuck_migration`, :func:`stall_rearm`) are
the ``make gpu-chaos`` tier's, run by its tests.

Every arm takes a :class:`Side`, the modules it drives: the port's by
default (:func:`port_side`, :func:`port_serving`). A caller can hand it
another implementation of the same API, which is how the tests hold the
port's arms against the reference's sim and server.

Usage::

    python -m instaslice_tpu_torch.analysis.chaos_smoke --crash --device cpu
    python -m instaslice_tpu_torch.analysis.chaos_smoke --partition --device cpu

One JSON line: the gate's seconds and, for each arm, its seconds, the
reasons the journal recorded over it (``CrashRecovered``,
``DegradedModeEntered``/``Exited``, ``ReplicaEjected``/``Readmitted``
...) and its findings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

#: the seed every arm draws from (``make gpu-chaos`` sweeps 1, 2, 3)
CHAOS_SEED = int(os.environ.get("CHAOS_SEED", "1234"))

#: every control-plane crash site the kill loop sweeps (site, nth), the
#: reference's list
CONTROL_SITES = [
    ("controller.write_allocation", 1),
    ("controller.write_allocation", 2),
    ("controller.ungate", 1),
    ("agent.realize", 1),
    ("agent.teardown", 1),
]
#: the kill loop: the control sites and the repacker's, which needs a
#: fragmented grid (:func:`repacker_kill`)
KILL_SITES = CONTROL_SITES + [("repacker.migrate", 1)]

#: the loadgen outcomes a replica kill may give besides ``ok``: each a
#: classified crash signature (``tests/test_crash_chaos.py:497-499``)
CLASSIFIED = ("ok", "stream-truncated", "timeout-503", "shed-429",
              "transport-error")

#: the reasons an arm exists to show; the JSON line counts them
CHAOS_REASONS = (
    "CrashRecovered", "OrphanReaped", "GrantDeadlineExceeded",
    "MigrationAborted", "ApiServerUnreachable", "DegradedModeEntered",
    "DegradedModeExited", "WriteFenced", "ReplicaEjected",
    "ReplicaReadmitted",
)

#: the replica-kill loadgen (the reference smoke's shape)
KILL_LOADGEN = dict(requests=24, concurrency=4, prompt_len=6,
                    max_tokens=24, vocab=64, stream=True, timeout=30)
#: the gray arm's loadgen runs (each 6 synchronous requests)
GRAY_LOADGEN = dict(requests=6, concurrency=2, prompt_len=4, max_tokens=4,
                    vocab=64, stream=False, timeout=60)
#: the gray arm's router knobs (the reference smoke's)
GRAY_ROUTER = dict(poll_interval=0.05, eject_min_samples=6,
                   eject_floor_s=0.02, hedge_after=0.0)
#: the latency injected on the router's hop to the gray replica
GRAY_DELAY_S = 0.5


def check(cond: bool, msg: str, **ctx) -> None:
    if not cond:
        raise AssertionError(
            f"{msg}" + (f" | {json.dumps(ctx, default=str)}" if ctx
                        else ""))


def wait_for(pred: Callable[[], bool], timeout: float = 10.0,
             interval: float = 0.02) -> bool:
    """Poll ``pred`` until it holds or ``timeout`` passes; its last value."""
    pacer = threading.Event()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        pacer.wait(interval)
    return bool(pred())


# ------------------------------------------------------------------ sides


class Side(SimpleNamespace):
    """What the control-plane arms drive: ``sim`` (a ``SimCluster``
    class), ``sim_kw`` (its keyword arguments beyond the arm's),
    ``small`` and ``big`` (the two profiles), ``faults`` (``CrashPlan``,
    ``set_crash_plan``, ``get_crash_plan``, ``NemesisPlan``,
    ``set_nemesis``), ``journal`` (``get_journal``, ``reset_journal``),
    ``box`` (``Box``, with ``from_key`` and ``overlaps``),
    ``slice_uuid_for`` and ``validate`` (``check_epochs``,
    ``check_nemesis``, ``check_chains``)."""

    def cluster(self, **kw):
        opts = dict(n_nodes=2, deletion_grace_seconds=0.2,
                    health_interval=0)
        opts.update(self.sim_kw)
        opts.update(kw)
        return self.sim(**opts)

    def events(self) -> List[dict]:
        return [e.to_dict() for e in self.journal.get_journal().events()]

    def reasons(self) -> List[str]:
        return [e.reason for e in self.journal.get_journal().events()]


def port_side(**sim_kw) -> Side:
    """The port's control plane on H100 80GB nodes of 2 GPUs, MIG on."""
    from instaslice_tpu_torch import faults
    from instaslice_tpu_torch.analysis import validate_events
    from instaslice_tpu_torch.api.types import slice_uuid_for
    from instaslice_tpu_torch.obs import journal
    from instaslice_tpu_torch.sim import SimCluster
    from instaslice_tpu_torch.topology import mig
    from instaslice_tpu_torch.topology.placement import Box

    kw = dict(generation=mig.H100_80GB, gpus_per_node=2, mig=True)
    kw.update(sim_kw)
    return Side(sim=SimCluster, sim_kw=kw, small="1g.10gb", big="3g.40gb",
                faults=faults, journal=journal, box=Box,
                slice_uuid_for=slice_uuid_for, validate=validate_events)


def port_serving(device: str = "cuda") -> SimpleNamespace:
    """What the serving arms drive: ``engine()`` (a fresh engine over
    the same seeded weights each call), ``ApiServer``, ``Router``,
    ``loadgen``, ``faults`` and ``journal``, the port's on ``device``."""
    from instaslice_tpu_torch import faults
    from instaslice_tpu_torch.analysis.drive import tiny_engine
    from instaslice_tpu_torch.obs import journal
    from instaslice_tpu_torch.serving import loadgen
    from instaslice_tpu_torch.serving.api_server import ApiServer
    from instaslice_tpu_torch.serving.router import Router

    return SimpleNamespace(
        engine=lambda: tiny_engine(device, max_len=96),
        ApiServer=ApiServer, Router=Router, loadgen=loadgen,
        faults=faults, journal=journal)


# ------------------------------------------------------------- invariants


def no_overlaps(c, box_cls) -> List[str]:
    """Zero double allocation: per group, the boxes of every two live
    allocations are disjoint (on a GPU grid a box is a GPU's memory
    slots, ``(slot, gpu, 0) + (n, 1, 1)``)."""
    found = []
    by_group: Dict[str, list] = {}
    for aid, a in sorted(c.allocations().items()):
        if a["status"] == "deleted":
            continue
        by_group.setdefault(a.get("torusGroup", ""), []).append(
            (aid, box_cls.from_key(a["box"])))
    for gid, boxes in sorted(by_group.items()):
        for i, (ax, x) in enumerate(boxes):
            for ay, y in boxes[i + 1:]:
                if x.overlaps(y):
                    found.append(f"double allocation in {gid}: {ax} "
                                 f"{x.key()} overlaps {ay} {y.key()}")
    return found


def no_orphans(c, slice_uuid_for) -> List[str]:
    """Zero orphaned device slices: every reservation on every node's
    device is the slice of an allocation its CR still claims."""
    found = []
    for node, backend in sorted(c.backends.items()):
        ts = c.kube.get("TpuSlice", c.namespace, node)
        claimed = {suid for aid in ts["spec"].get("allocations", {})
                   for suid in (slice_uuid_for(aid),
                                slice_uuid_for(aid, multihost=True))}
        for r in backend.list_reservations():
            if r.slice_uuid not in claimed:
                found.append(f"{node}: orphaned device slice "
                             f"{r.slice_uuid} (claimed: {sorted(claimed)})")
    return found


def no_double_grant(c) -> List[str]:
    """No device chip (a GPU, or a GPU's memory slot on a MIG grid)
    reserved twice on one node."""
    found = []
    for node, backend in sorted(c.backends.items()):
        held = []
        for r in backend.list_reservations():
            slots = getattr(r, "slots", None)  # a GPU's memory slots
            if slots is None:
                held += list(r.chip_ids)
            else:
                start, size = slots
                held += [(g, s) for g in r.chip_ids
                         for s in range(start, start + size)]
        if len(held) != len(set(held)):
            found.append(f"{node}: chip double-granted: {sorted(held)}")
    return found


def epochs_legal(side: Side, events: Optional[List[dict]] = None
                 ) -> List[str]:
    """Transition chains legal across restart epochs."""
    return list(side.validate.check_epochs(
        side.events() if events is None else events))


def nemesis_clean(side: Side, events: Optional[List[dict]] = None
                  ) -> List[str]:
    """The nemesis invariants: degraded entries paired, no pod
    double-placed, no slice leaked, every fenced write attributed."""
    return list(side.validate.check_nemesis(
        side.events() if events is None else events))


def chains_strict(side: Side, events: Optional[List[dict]] = None
                  ) -> List[str]:
    return list(side.validate.check_chains(
        side.events() if events is None else events, strict=True))


def eventually(fn: Callable[[], List[str]], timeout: float = 20.0
               ) -> List[str]:
    """``fn``'s findings once they are empty, or its last ones at
    ``timeout`` (device truth converges after the CR's: a teardown or a
    reap lands a moment after the record that asked for it)."""
    found = fn()
    pacer = threading.Event()
    deadline = time.monotonic() + timeout
    while found and time.monotonic() < deadline:
        pacer.wait(0.1)
        found = fn()
    return found


def settle(side: Side, c, pods, timeout: float = 45.0) -> None:
    """Every pod Running, then every live record ``ungated`` (Running
    precedes the created -> ungated status edge)."""
    for name in pods:
        check(c.wait_phase(name, "Running", timeout=timeout),
              f"pod {name} never ran", phase=c.pod_phase(name),
              reasons=sorted(set(side.reasons())))
    check(wait_for(lambda: all(
        a["status"] in ("ungated", "deleted")
        for a in c.allocations().values()), timeout),
        "allocations never converged",
        statuses={k: a["status"] for k, a in c.allocations().items()})


def _result(arm: str, side, t0: float, findings: dict, **extra) -> dict:
    """An arm's result: its seconds, the chaos reasons its journal
    (``side.journal``) recorded, its findings and ``extra``."""
    counts = side.journal.get_journal().counts()
    out = {"arm": arm, "seconds": round(time.monotonic() - t0, 3),
           "reasons": {r: counts[r] for r in CHAOS_REASONS
                       if counts.get(r)},
           "findings": findings}
    out.update(extra)
    return out


def findings_of(result: dict) -> List[str]:
    return [f"{result['arm']}: {name}: {f}"
            for name, fs in sorted(result["findings"].items()) for f in fs]


def _crashed_agent(c) -> Optional[str]:
    for node, agent in sorted(c.agents.items()):
        if agent.manager._stop.is_set():
            return node
    return None


def _fired(side: Side, site: str) -> bool:
    plan = side.faults.get_crash_plan()
    return bool(plan and plan.stats().get(site, {}).get("fired", 0))


# ------------------------------------------------------------- crash arms


def crash_controller(side: Side) -> dict:
    """A controller killed mid-fan-out at ``controller.write_allocation:2``
    and restarted: every pod granted, the invariants hold."""
    t0 = time.monotonic()
    side.journal.reset_journal()
    c = side.cluster().start()
    try:
        c.submit("p0", side.small)
        settle(side, c, ["p0"])
        side.faults.set_crash_plan(
            side.faults.CrashPlan().arm("controller.write_allocation", 2))
        for i in range(1, 4):
            c.submit(f"p{i}", side.big)
        check(wait_for(lambda: c.controller.manager._stop.is_set(), 15),
              "controller crash point never fired")
        side.faults.set_crash_plan(None)
        c.restart_controller()
        pods = [f"p{i}" for i in range(4)]
        settle(side, c, pods)
        return _result("crash_controller", side, t0, {
            "overlaps": no_overlaps(c, side.box),
            "orphans": eventually(lambda: no_orphans(c, side.slice_uuid_for)),
            "epochs": epochs_legal(side),
        }, phases={p: c.pod_phase(p) for p in pods})
    finally:
        side.faults.set_crash_plan(None)
        c.stop()


def crash_agent(side: Side) -> dict:
    """An agent killed mid-realize at ``agent.realize:1`` (the slice
    reserved on the device, the CR not told) and restarted."""
    t0 = time.monotonic()
    side.journal.reset_journal()
    c = side.cluster().start()
    try:
        side.faults.set_crash_plan(
            side.faults.CrashPlan().arm("agent.realize", 1))
        c.submit("a0", side.small)
        check(wait_for(lambda: _crashed_agent(c) is not None, 15),
              "agent crash point never fired")
        side.faults.set_crash_plan(None)
        c.restart_agent(_crashed_agent(c))
        settle(side, c, ["a0"])
        return _result("crash_agent", side, t0, {
            "overlaps": no_overlaps(c, side.box),
            "orphans": eventually(lambda: no_orphans(c, side.slice_uuid_for)),
            "epochs": epochs_legal(side),
        }, phases={"a0": c.pod_phase("a0")})
    finally:
        side.faults.set_crash_plan(None)
        c.stop()


def quiesced(server) -> List[str]:
    """A live server's ledger once idle: no live or parked slot, every
    used KV block the radix cache's."""
    st = server.scheduler.stats()
    found = []
    if st["live_slots"] or st.get("parked"):
        found.append(f"not quiesced: {st['live_slots']} live, "
                     f"{st.get('parked')} parked")
    kv, radix = st.get("kv", {}), st.get("radix", {})
    if "used" in kv and "blocks" in radix and kv["used"] != radix["blocks"]:
        found.append(f"leaked KV blocks: used {kv['used']}, radix "
                     f"{radix['blocks']}")
    return found


def kill_ledger(outcomes: dict, n: int) -> List[str]:
    """A replica kill's loadgen ledger: the outcomes sum to the ``n``
    requests, none hung, at least one ``ok``, and every other outcome is
    a classified crash signature (:data:`CLASSIFIED`)."""
    found = []
    if sum(outcomes.values()) != n:
        found.append(f"outcomes sum to {sum(outcomes.values())}, not {n}")
    if outcomes.get("hung", 0):
        found.append(f"{outcomes['hung']} hung")
    if outcomes.get("ok", 0) < 1:
        found.append("no request ok")
    if sum(outcomes.get(k, 0) for k in CLASSIFIED) != n:
        found.append(f"unclassified outcomes: {outcomes}")
    return found


def crash_replica(serving, seed: int = CHAOS_SEED) -> dict:
    """A serving replica killed mid-stream under the router (a power
    cut: no drain, no terminals) once it holds a live slot; a fresh
    replica added, the victim removed. The loadgen's ledger reconciles:
    outcomes sum to the requests, none hung, at least one ``ok``, every
    other outcome a classified crash signature; the survivor and the
    fresh replica end quiesced."""
    t0 = time.monotonic()
    serving.journal.reset_journal()
    servers = [serving.ApiServer(serving.engine(), block_size=4).start()
               for _ in range(2)]
    # eject_factor=0: no gray sweep. A replica whose polls stall (a cold
    # compile, a loaded host) would be ejected and its requests shed as
    # ``replica-ejected``: the gray arm's subject, not this one's
    router = serving.Router([s.url for s in servers], poll_interval=0.1,
                            stale_after=1.0, migrate_timeout=3.0,
                            eject_factor=0).start()
    report: dict = {}
    try:
        t = threading.Thread(target=lambda: report.update(
            serving.loadgen.run(router.url, seed=seed, **KILL_LOADGEN)))
        t.start()
        victim = servers[0]
        check(wait_for(lambda: victim.scheduler.stats()["live_slots"] > 0,
                       30), "no stream reached the victim")
        victim.kill()
        fresh = serving.ApiServer(serving.engine(), block_size=4).start()
        servers.append(fresh)
        router.add_replica(fresh.url)
        router.remove_replica(victim.url)
        t.join(timeout=120)
        check(bool(report) and not t.is_alive(), "loadgen never finished")
        out = report["outcomes"]
        live = [s for s in servers if s is not victim]
        return _result("crash_replica", serving, t0, {
            "ledger": kill_ledger(out, KILL_LOADGEN["requests"]),
            "replicas": [f for s in live for f in
                         eventually(lambda s=s: quiesced(s), 20)],
        }, outcomes={k: v for k, v in out.items() if v},
            victim_stopped=victim.scheduler.stop_flag.is_set())
    finally:
        router.stop()
        for s in servers:
            try:
                s.stop()
            except OSError:
                pass


# --------------------------------------------------------- partition arms


def partition_controller(side: Side, seed: int = CHAOS_SEED) -> dict:
    """The controller cut from the apiserver mid-run: it grants nothing
    while cut (its verbs refused, which the nemesis counts); on heal the
    pod waiting is granted, with no double allocation and clean nemesis
    and strict chains."""
    t0 = time.monotonic()
    side.journal.reset_journal()
    plan = side.faults.NemesisPlan(seed)
    c = side.cluster(nemesis=plan).start()
    try:
        c.submit("pre-partition", side.small)
        settle(side, c, ["pre-partition"], timeout=30)
        plan.partition("controller", "apiserver")
        c.submit("mid-partition", side.small)

        def refused() -> int:
            return sum(s["fired"] for s in plan.stats()
                       if s["link"] == "controller>apiserver")

        base = refused()
        check(wait_for(lambda: refused() >= base + 3, 15),
              "the cut controller never tried the apiserver",
              stats=plan.stats())
        cut_phase = c.pod_phase("mid-partition")
        check(cut_phase != "Running",
              "a controller cut from the apiserver granted a pod")
        plan.heal()
        # settled: its chain's ungated edge recorded before the checks
        settle(side, c, ["mid-partition"], timeout=30)
        return _result("partition_controller", side, t0, {
            "overlaps": no_overlaps(c, side.box),
            "orphans": eventually(lambda: no_orphans(c, side.slice_uuid_for)),
            "nemesis": nemesis_clean(side),
            "chains": chains_strict(side),
        }, phases={p: c.pod_phase(p)
                   for p in ("pre-partition", "mid-partition")},
            cut_phase=cut_phase)
    finally:
        c.stop()


def partition_agent(side: Side, seed: int = CHAOS_SEED) -> dict:
    """An agent cut from the apiserver: static mode, entered once, the
    realized slice kept on the device; on heal the boot sweep makes CR
    truth device truth and a new pod is granted."""
    t0 = time.monotonic()
    side.journal.reset_journal()
    plan = side.faults.NemesisPlan(seed)
    c = side.cluster(nemesis=plan, health_interval=0.3).start()
    try:
        c.submit("static-pod", side.small)
        settle(side, c, ["static-pod"], timeout=30)
        held = {node: [r.slice_uuid for r in b.list_reservations()]
                for node, b in c.backends.items()}
        victim = next(n for n, rs in sorted(held.items()) if rs)
        plan.partition(f"agent-{victim}", "apiserver")
        check(wait_for(lambda: "DegradedModeEntered" in side.reasons(), 15),
              "the cut agent never entered static mode",
              reasons=sorted(set(side.reasons())))
        kept = [r.slice_uuid for r in c.backends[victim].list_reservations()]
        static = []
        if kept != held[victim]:
            static.append(f"static mode changed the device: {held[victim]}"
                          f" -> {kept}")
        plan.heal()
        check(wait_for(lambda: "DegradedModeExited" in side.reasons(), 15),
              "the agent never left static mode after the heal",
              reasons=sorted(set(side.reasons())))
        c.submit("post-heal", side.small)
        settle(side, c, ["post-heal"], timeout=30)
        entered = side.reasons().count("DegradedModeEntered")
        if entered != 1:
            static.append(f"DegradedModeEntered {entered} times, not once")
        return _result("partition_agent", side, t0, {
            "static": static,
            "orphans": eventually(lambda: no_orphans(c, side.slice_uuid_for)),
            "nemesis": nemesis_clean(side),
        }, phases={p: c.pod_phase(p) for p in ("static-pod", "post-heal")},
            victim=victim)
    finally:
        c.stop()


def gray_replica(serving, validate, seed: int = CHAOS_SEED,
                 eject_factor: float = 3.0, eject_timeout: float = 20.0,
                 servers=None, events: Optional[Callable] = None) -> dict:
    """A replica A that answers every request but ``GRAY_DELAY_S`` slower
    on the router's hop: ejected on its latency EWMA alone, the traffic
    routed around it (all ``ok``, its engine idle, no session pinned to
    it), re-admitted after the heal; then the loadgen's nemesis arm with
    none hung, and ``check_nemesis`` clean. ``validate``: the
    ``check_nemesis`` module of the same implementation as ``serving``.

    The latency is on A's hop from the router's first poll. The sweep
    never ejects below two healthy replicas and compares each with the
    others' p95, so while A is slow no poll that host noise slows can
    eject the other, B; the reference smoke cuts A only after a loadgen
    run with both fast, where one slow poll of B (20 ms is the floor) can
    eject it first and leave A unejectable. Every wait logs both p95s at
    each of its polls (``polls``), and B ejected at any of them fails the
    arm: it is never retried.

    ``servers``: two running servers to use (and leave running; A is the
    first), else two are built from ``serving.engine()``. ``events``: the
    journal to check (a callable returning its events as dicts), else
    the process journal's ring."""
    t0 = time.monotonic()
    faults, journal = serving.faults, serving.journal
    own = servers is None
    if own:
        journal.reset_journal()
        servers = [serving.ApiServer(serving.engine(), block_size=4).start()
                   for _ in range(2)]
    a_url, b_url = (s.url.rstrip("/") for s in servers)
    plan = faults.NemesisPlan(seed)
    plan.latency("router", f"replica:{a_url}", delay=GRAY_DELAY_S)
    faults.set_nemesis(plan)
    router = serving.Router([a_url, b_url], eject_factor=eject_factor,
                            **GRAY_ROUTER).start()
    a, b = (next(r for r in router.replicas() if r.url == u)
            for u in (a_url, b_url))
    polls: list = []

    def wait(pred, what: str, timeout: float) -> float:
        t = time.monotonic()
        pacer = threading.Event()
        while True:
            polls.append((what, round(time.monotonic() - t0, 3),
                          round(a.lat_p95() * 1e3, 2),
                          round(b.lat_p95() * 1e3, 2), a.ejected))
            check(not b.ejected, f"the healthy replica was ejected "
                  f"waiting for {what}", polls=polls[-8:])
            if pred():
                return round(time.monotonic() - t, 3)
            check(time.monotonic() - t < timeout,
                  f"{what}: never within {timeout} s", polls=polls[-8:],
                  stats=plan.stats())
            pacer.wait(0.05)

    def served(i: int) -> int:
        return servers[i].scheduler.stats()["tokens_generated"]

    hung, around = [], []
    try:
        eject_s = wait(lambda: a.ejected, "the gray replica ejected",
                       eject_timeout)
        a0 = served(0)
        report = serving.loadgen.run(router.url, seed=1, **GRAY_LOADGEN)
        hung.append(report["outcomes"]["hung"])
        around_outcomes = report["outcomes"]
        if report["ok"] != GRAY_LOADGEN["requests"]:
            around.append(f"{report['ok']} of {GRAY_LOADGEN['requests']} ok"
                          f" while ejected: {report['outcomes']}")
        if served(0) != a0:
            around.append(f"the ejected replica generated {served(0) - a0}"
                          " tokens while ejected")
        with router._lock:
            pinned = [u for u, _ in router._sessions.values()]
        if a_url in pinned:
            around.append("a session pinned to the ejected replica")
        plan.heal()
        readmit_s = wait(lambda: not a.ejected,
                         "the healed replica re-admitted", 20)
        faults.set_nemesis(None)
        report = serving.loadgen.run(router.url, seed=2,
                                     nemesis_seed=seed, **GRAY_LOADGEN)
        hung.append(report["outcomes"]["hung"])
        wait(lambda: True, "the nemesis arm's end", 0)
        nemesis_arm = report["outcomes"]
        if report.get("nemesis", {}).get("seed") != seed:
            around.append(f"the nemesis arm did not run: "
                          f"{report.get('nemesis')}")
        if faults.get_nemesis() is not None:
            around.append("the loadgen's nemesis arm left its plan "
                          "installed")
        ejections = router.stats()["ejections"]
        if ejections.get(b_url):
            around.append(f"the healthy replica was ejected: {ejections}")
        evs = events() if events is not None else [
            e.to_dict() for e in journal.get_journal().events()]
        rs = [e["reason"] for e in evs]
        if "ReplicaEjected" not in rs or "ReplicaReadmitted" not in rs:
            around.append(f"journal lacks the ejection cycle: "
                          f"{sorted(set(rs))}")
        return _result("gray_replica", serving, t0, {
            "hung": [f"{h} hung in loadgen run {i}"
                     for i, h in enumerate(hung) if h],
            "around": around,
            "nemesis": list(validate.check_nemesis(evs)),
        }, eject_s=eject_s, readmit_s=readmit_s, ejections=ejections,
            around_outcomes=around_outcomes, nemesis_arm=nemesis_arm,
            polls=polls)
    finally:
        faults.set_nemesis(None)
        router.stop()
        if own:
            for s in servers:
                s.stop()


# -------------------------------------------------- kill loop, watchdogs


def carve_survivors(c, fillers) -> List[str]:
    """The GPU grid's fragmentation: keep one filler (the first seen)
    in each half of each GPU's memory slots and delete the rest, so no
    4-slot profile (``3g.40gb``: starts 0 and 4) fits while half the
    slots are free. Returns the survivors."""
    from instaslice_tpu_torch.topology import mig
    from instaslice_tpu_torch.topology.placement import Box

    keep: Dict[tuple, str] = {}
    doomed = []
    for _aid, a in sorted(c.allocations().items()):
        name = a["pods"][0]["podName"]
        if name not in fillers:
            continue
        gpu, start = mig.box_gpu_start(Box.from_key(a["box"]))
        half = (a.get("torusGroup", ""), gpu, start // 4)
        if half in keep:
            doomed.append(name)
        else:
            keep[half] = name
    for name in doomed:
        c.delete_pod(name)
    for name in doomed:
        check(c.wait_gone(name, timeout=30), f"filler {name} never went")
    return sorted(keep.values())


def repacker_kill(side: Side, seed: int = CHAOS_SEED) -> dict:
    """The repacker killed between drain and re-grant on a fragmented
    MIG grid (one GPU, a survivor in each half): the restarted
    controller adopts the chip-less ungated pod (``CrashRecovered``) and
    the blocked ``3g.40gb`` is granted."""
    t0 = time.monotonic()
    side.journal.reset_journal()
    c = side.cluster(n_nodes=1, gpus_per_node=1, policy="frag-aware",
                     repack=True, repack_interval=0.1, repack_cooldown=0.4,
                     stuck_grant_deadline=5.0).start()
    try:
        fillers = [f"fill-{i}" for i in range(7)]
        for n in fillers:
            c.submit(n, side.small)
        settle(side, c, fillers)
        survivors = carve_survivors(c, set(fillers))
        check(len(survivors) == 2, "carve kept one filler a half",
              survivors=survivors)
        side.faults.set_crash_plan(
            side.faults.CrashPlan().arm("repacker.migrate", 1))
        c.submit("big-0", side.big)
        check(wait_for(lambda: _fired(side, "repacker.migrate"), 20),
              "repacker.migrate never fired")
        side.faults.set_crash_plan(None)
        c.restart_controller()
        pods = ["big-0"] + survivors
        settle(side, c, pods, timeout=60)
        check("CrashRecovered" in side.reasons(), "no CrashRecovered")
        return _result("kill repacker.migrate:1", side, t0, {
            "overlaps": no_overlaps(c, side.box),
            "orphans": eventually(lambda: no_orphans(c, side.slice_uuid_for)),
            "epochs": epochs_legal(side),
        }, phases={p: c.pod_phase(p) for p in pods})
    finally:
        side.faults.set_crash_plan(None)
        c.stop()


def kill_site(side: Side, site: str, nth: int = 1,
              seed: int = CHAOS_SEED) -> dict:
    """One kill of the loop: a pod granted and then deleted (teardown),
    three more submitted, the component killed at ``site``'s ``nth``
    call and restarted; every pod granted, the deleted one gone, the
    invariants hold."""
    if site == "repacker.migrate":
        return repacker_kill(side, seed)
    t0 = time.monotonic()
    side.journal.reset_journal()
    c = side.cluster(stuck_grant_deadline=5.0).start()
    try:
        c.submit("pre", side.small)
        settle(side, c, ["pre"])
        side.faults.set_crash_plan(side.faults.CrashPlan().arm(site, nth))
        pods = []
        for i in range(3):
            name = f"{site.split('.')[-1].replace('_', '-')}-{i}"
            c.submit(name, side.big)
            pods.append(name)
        c.delete_pod("pre")  # drives the agent.teardown site
        check(wait_for(lambda: _fired(side, site), 20),
              f"{site}:{nth} never fired under load")
        side.faults.set_crash_plan(None)
        if site.startswith("controller."):
            check(wait_for(lambda: c.controller.manager._stop.is_set(), 10),
                  "the crashed controller's manager never stopped")
            c.restart_controller()
        else:
            check(wait_for(lambda: _crashed_agent(c) is not None, 10),
                  "the crashed agent's manager never stopped")
            for node in list(c.agents):
                if c.agents[node].manager._stop.is_set():
                    c.restart_agent(node)
        settle(side, c, pods)
        check(c.wait_gone("pre", timeout=20), "the deleted pod never went")
        return _result(f"kill {site}:{nth}", side, t0, {
            "overlaps": no_overlaps(c, side.box),
            "orphans": eventually(lambda: no_orphans(c, side.slice_uuid_for)),
            "epochs": epochs_legal(side),
        }, phases={p: c.pod_phase(p) for p in pods})
    finally:
        side.faults.set_crash_plan(None)
        c.stop()


def stuck_grant(side: Side) -> dict:
    """An agent dies mid-realize and stays dead: the stuck-grant
    watchdog rolls the epoch back (``GrantDeadlineExceeded``) and the pod
    is granted on the other node; the dead agent's return leaves no
    orphan."""
    t0 = time.monotonic()
    side.journal.reset_journal()
    c = side.cluster(stuck_grant_deadline=2.0).start()
    try:
        side.faults.set_crash_plan(
            side.faults.CrashPlan().arm("agent.realize", 1))
        c.submit("w0", side.small)
        check(wait_for(lambda: _crashed_agent(c) is not None, 15),
              "agent crash point never fired")
        crashed = _crashed_agent(c)
        side.faults.set_crash_plan(None)
        settle(side, c, ["w0"], timeout=40)
        check("GrantDeadlineExceeded" in side.reasons(),
              "the watchdog never fired")
        node = c.pod("w0").get("spec", {}).get("nodeName")
        check(node != crashed, "w0 granted on the dead agent's node",
              node=node)
        c.restart_agent(crashed)
        return _result("stuck_grant", side, t0, {
            "orphans": eventually(lambda: no_orphans(c, side.slice_uuid_for)),
            "overlaps": no_overlaps(c, side.box),
            "epochs": epochs_legal(side),
        }, node=node, dead=crashed)
    finally:
        side.faults.set_crash_plan(None)
        c.stop()


def stuck_migration(side: Side) -> dict:
    """A migration idle in ``realizing`` past the deadline is aborted
    (``MigrationAborted``) and rolled back; a second stall surrenders
    it to the controller (bounded abort)."""
    from instaslice_tpu_torch.controller.defrag import Migration

    t0 = time.monotonic()
    side.journal.reset_journal()
    c = side.cluster(repack=True, repack_interval=60.0,
                     repack_stuck_abort=0.05).start()
    try:
        c.submit("v0", side.small)
        settle(side, c, ["v0"])
        rep = c.repacker
        rep.stop()  # ticks driven by hand
        aid, alloc = next(iter(c.allocations().items()))
        mig = Migration(
            alloc_id=aid, group_id=alloc.get("torusGroup", ""),
            profile=side.small, old_box=alloc["box"], dest_box=None,
            target_box=alloc["box"], pending_profile=side.big, pods=[],
            trace_id="t-stuck", started=time.monotonic() - 10,
            phase="realizing", epoch=2,
            last_progress=time.monotonic() - 10)
        rep._active[aid] = mig
        rep.run_once()
        first = dict(rollback=mig.rollback, phase=mig.phase,
                     aborted=rep.migrations_aborted,
                     status=c.allocations()[aid]["status"])
        check(first["rollback"] and first["phase"] == "evicting"
              and first["aborted"] == 1, "first stall not aborted",
              **first)
        check("MigrationAborted" in side.reasons(), "no MigrationAborted")
        mig.last_progress = time.monotonic() - 10
        rep.run_once()
        check(aid not in rep._active and rep.migrations_failed >= 1,
              "second stall not surrendered",
              failed=rep.migrations_failed)
        return _result("stuck_migration", side, t0, {}, first=first,
                       failed=rep.migrations_failed)
    finally:
        c.stop()


def stall_rearm() -> bool:
    """The stall warning re-arms when a stuck migration progresses, so
    a later stall warns again."""
    from instaslice_tpu_torch.controller.defrag import Migration

    mig = Migration(alloc_id="a", group_id="g", profile="1g.10gb",
                    old_box="b", dest_box=None, target_box="b",
                    pending_profile="3g.40gb", pods=[], trace_id="t",
                    started=time.monotonic() - 100)
    mig.warned_stuck = True
    mig.progress()
    return (not mig.warned_stuck
            and time.monotonic() - mig.last_progress < 1.0)


# ------------------------------------------------------------------ gate


def crash_gate(side: Side, serving, seed: int) -> List[dict]:
    return [crash_controller(side), crash_agent(side),
            crash_replica(serving, seed)]


def partition_gate(side: Side, serving, seed: int) -> List[dict]:
    from instaslice_tpu_torch.analysis import validate_events

    return [partition_controller(side, seed), partition_agent(side, seed),
            gray_replica(serving, validate_events, seed)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chaos_smoke",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--crash", action="store_true",
                    help="the crash arms (controller, agent, replica)")
    ap.add_argument("--partition", action="store_true",
                    help="the partition arms (controller, agent, gray "
                         "replica)")
    ap.add_argument("--seed", type=int, default=CHAOS_SEED,
                    help="the arms' seed (default: CHAOS_SEED or 1234)")
    ap.add_argument("--device", default="cuda",
                    help="the serving arms' device: cuda (default; raises "
                         "without a card) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    from instaslice_tpu_torch import resolve_device

    resolve_device(args.device)  # no card: fail before anything runs
    gates = [g for g, on in (("crash", args.crash),
                             ("partition", args.partition)) if on] \
        or ["crash", "partition"]
    t0 = time.monotonic()
    side, serving = port_side(), port_serving(args.device)
    results = []
    for gate in gates:
        run = crash_gate if gate == "crash" else partition_gate
        results += run(side, serving, args.seed)
    found = [f for r in results for f in findings_of(r)]
    print(json.dumps({
        "chaos_smoke": "failed" if found else "ok", "gates": gates,
        "seed": args.seed, "device": args.device,
        "seconds": round(time.monotonic() - t0, 3),
        "arms": [{k: r[k] for k in ("arm", "seconds", "reasons")}
                 | {"findings": len(findings_of(r))} for r in results],
    }), flush=True)
    for f in found:
        print(f, file=sys.stderr)
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
