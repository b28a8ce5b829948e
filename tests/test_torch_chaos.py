"""Randomized operations against the port's simulated cluster on H100
80GB nodes, then invariant checks: the port's counterpart of
``tests/test_chaos.py::test_randomized_ops_converge``.

Seeded submissions (``1g.10gb`` for the reference's ``v5e-1x1``,
``3g.40gb`` for its ``v5e-2x1`` and ``v5e-2x2``, some restarted on
failure), deletions, injected reserve and release failures, and GPUs
failed and healed, on two nodes of 8 GPUs with MIG on. After every
operation no GPU memory slot is reserved twice; once everything is
healed every surviving pod settles Running or Pending (never wedged
half-granted); after deleting everything no allocation and no device
reservation is left. The run lasts ``CHAOS_DURATION`` seconds (3 by
default; ``make gpu-chaos`` sets 8) from ``CHAOS_SEED``, both printed,
the repro recipe of a red run. The same run goes over the in-process
transport and over HTTP (the sim's fake apiserver).

The control patches the agent's release out of teardown: the drain must
then leave reservations behind, and the convergence check misses.

The Cloud TPU arm of the reference (``test_randomized_ops_converge_
cloudtpu``) has no counterpart: the port has no Cloud TPU backend.
"""

import os
import random
import threading
import time

import pytest

from instaslice_tpu_torch.analysis import chaos_smoke as cs
from instaslice_tpu_torch.controller.gates import (
    RESTART_ON_FAILURE_ANNOTATION,
)
from instaslice_tpu_torch.device import fake as tfake
from instaslice_tpu_torch.kube import NotFound
from instaslice_tpu_torch.sim import SimCluster

#: the reference's profiles on the MIG grid
PROFILES = {"v5e-1x1": "1g.10gb", "v5e-2x1": "3g.40gb",
            "v5e-2x2": "3g.40gb"}
SEED = int(os.environ.get("CHAOS_SEED", "1234"))
DURATION_S = float(os.environ.get("CHAOS_DURATION", "3.0"))


@pytest.fixture(autouse=True)
def _print_chaos_params():
    print(f"chaos params: CHAOS_SEED={SEED} CHAOS_DURATION={DURATION_S}")
    yield


@pytest.fixture(autouse=True, scope="module")
def _lockcheck():
    from instaslice_tpu_torch.utils import lockcheck

    yield
    if lockcheck.armed():
        assert not lockcheck.report()["cycles"], lockcheck.report()


def delete(c, name: str) -> None:
    """Delete a pod the controller may already have deleted (a pod
    restarted on failure is deleted for its owner to recreate)."""
    try:
        c.delete_pod(name)
    except NotFound:
        pass


def hammer(c, rng, duration: float) -> list:
    """The seeded operations for ``duration`` seconds; the pods left."""
    live, n = [], 0
    pacer = threading.Event()
    deadline = time.monotonic() + duration
    profiles = list(PROFILES.values())
    while time.monotonic() < deadline:
        op = rng.random()
        if op < 0.45:
            name = f"c{n}"
            n += 1
            ann = ({RESTART_ON_FAILURE_ANNOTATION: "true"}
                   if rng.random() < 0.3 else None)
            c.submit(name, rng.choice(profiles), annotations=ann)
            live.append(name)
        elif op < 0.70 and live:
            delete(c, live.pop(rng.randrange(len(live))))
        elif op < 0.80:
            c.backends[rng.choice(sorted(c.backends))].inject_failures(
                rng.choice(["reserve", "release"]), 1)
        elif op < 0.90:
            c.backends[rng.choice(sorted(c.backends))].fail_chip(
                rng.randrange(c.gpus_per_node))
        else:
            for b in c.backends.values():
                for gpu in range(c.gpus_per_node):
                    b.heal_chip(gpu)
        assert cs.no_double_grant(c) == []
        pacer.wait(rng.uniform(0.0, 0.05))
    return live


def converge(c, live, settle_s: float = 20.0, drain_s: float = 30.0
             ) -> dict:
    """Heal, settle, then drain; what is left after each."""
    for b in c.backends.values():
        for gpu in range(c.gpus_per_node):
            b.heal_chip(gpu)
    pacer = threading.Event()
    deadline = time.monotonic() + settle_s
    prev, stable, phases = None, 0, {}
    while time.monotonic() < deadline:
        assert cs.no_double_grant(c) == []
        phases = {p: c.pod_phase(p) for p in live}
        stable = stable + 1 if phases == prev else 0
        prev = phases
        if stable >= 5 and "Pending" not in phases.values():
            break
        pacer.wait(0.2)
    wedged = {p: ph for p, ph in phases.items()
              if ph not in ("Running", "Pending", "Gone")}
    for name in live:
        delete(c, name)
    cs.wait_for(lambda: not c.allocations() and not any(
        b.list_reservations() for b in c.backends.values()), drain_s, 0.2)
    return {"wedged": wedged, "allocations": sorted(c.allocations()),
            "reservations": {n: [r.slice_uuid for r in b.list_reservations()]
                             for n, b in sorted(c.backends.items())
                             if b.list_reservations()},
            "pods": len(live)}


def run(transport: str, seed: int = SEED, duration: float = DURATION_S,
        **waits) -> dict:
    c = SimCluster(n_nodes=2, transport=transport,
                   deletion_grace_seconds=0.1, health_interval=0.1).start()
    try:
        return converge(c, hammer(c, random.Random(seed), duration),
                        **waits)
    finally:
        c.stop()


@pytest.mark.parametrize("transport", ["inproc", "http"])
def test_randomized_ops_converge(transport):
    got = run(transport)
    assert got["wedged"] == {}, f"pods wedged mid-grant: {got}"
    assert got["allocations"] == [] and got["reservations"] == {}, got


def test_control_teardown_without_release_leaks(monkeypatch):
    """The agent's teardown releases the device slice; patched to keep
    it, the drain leaves reservations and the check misses."""
    monkeypatch.setattr(tfake.FakeGpuBackend, "release",
                        lambda self, slice_uuid: None)
    # a correct drain takes ~1 s here: 10 s is ample room
    got = run("inproc", duration=1.0, settle_s=5.0, drain_s=10.0)
    assert got["reservations"], got
