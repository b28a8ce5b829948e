"""Fleet-telemetry CI smoke of the port (``make gpu-telemetry-smoke``,
< 60 s on the CPU): the port's copy of ``tools/telemetry_smoke.py``.

Stands up a 2-replica serving fleet of the port's ApiServer (on
``--device``: the card by default, ``cpu`` for the plain versions)
behind the port's router, points the port's
:class:`~instaslice_tpu_torch.obs.telemetry.FleetAggregator` at it
(pinned clock — burn windows advance deterministically), and proves the
three contracts of the reference's fleet telemetry:

1. **Exact three-way reconciliation** — the aggregator's federated
   rollups (requests, tokens, per-class SLO attainment) equal the
   loadgen CLIENT-side report equal the journal/metrics counters.
   Not approximately: the clean tenant's TTFT target (30 s) cannot
   miss and the burn tenant's (0.1 ms) cannot be met, so attainment
   is exactly 1.0 / 0.0 on BOTH sides of the wire and any drift is a
   counting bug, not jitter.
2. **Burn-rate lifecycle** — the injected-latency arm (a tenant whose
   TTFT SLO cannot be met) drives the multi-window burn monitor to
   ``SLOBurnRateHigh``; sliding the pinned clock past every window
   with no new misses drives it to ``SLOBurnRateCleared``. Both land
   in the journal.
3. **Cross-process trace stitching** — a routed serving request
   (router → replica) and a capacity-blocked pod grant on the port's
   SimCluster (an H100 80GB GPU filled by two ``3g.40gb`` slices, the
   ``1g.10gb`` pod carrying the serving trace id in its caused-by
   annotation) stitch into ONE timeline with >= 3 components.

The whole scenario runs twice: clean, and under one seeded fault plan
(delay-kind injections only — latency chaos must not change any
counter, so the reconciliation stays exact under faults). Zero hung
requests everywhere.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: one tenant per class so per-class (server) and per-tenant (client)
#: attainment are the same number — the exactness trick
TENANTS = "steady:1:standard:30,edge:1:latency:0.0001"


def check(cond: bool, msg: str, **ctx) -> None:
    if not cond:
        raise AssertionError(
            f"{msg}" + (f" | {json.dumps(ctx, default=str)}" if ctx
                        else "")
        )


def wait_ready(url: str, timeout: float = 15.0) -> None:
    import threading
    import urllib.error
    import urllib.request

    pacer = threading.Event()
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url + "/readyz", timeout=2) as r:
                if r.status == 200:
                    return
        except (urllib.error.URLError, OSError):
            pass
        pacer.wait(0.1)
    raise AssertionError(f"{url} never became ready")


def run_loadgen(url: str, tenants: str, requests: int) -> dict:
    from instaslice_tpu_torch.serving import loadgen

    report = loadgen.run(
        url, requests=requests, concurrency=2, prompt_len=4,
        max_tokens=6, vocab=64, stream=True, timeout=60,
        tenants=tenants,
    )
    check(report["outcomes"]["hung"] == 0, "hung requests",
          outcomes=report["outcomes"])
    # hedges/retries would double-count server-side; delay-only fault
    # plans must never trigger them, or exactness is meaningless
    check(report["outcomes"]["hedged-ok"] == 0, "unexpected hedge",
          outcomes=report["outcomes"])
    check(report["ok"] == requests, "not every request succeeded",
          report={k: report[k] for k in ("ok", "outcomes", "errors")})
    return report


def stitched_trace_arm(router_url: str, agg) -> str:
    """Route one traced request through the fleet, then grant a
    capacity-blocked pod carrying that trace id in its caused-by
    annotation. Returns the serving trace id; the caller asserts the
    stitched timeline."""
    from instaslice_tpu_torch.analysis.drive import PROFILE, sim_cluster
    from instaslice_tpu_torch.api.constants import CAUSED_BY_ANNOTATION
    from instaslice_tpu_torch.serving.loadgen import _one_request
    from instaslice_tpu_torch.utils.trace import new_trace_id

    tid = new_trace_id()
    _, _, toks, err, _ = _one_request(
        router_url, [1, 2, 3], 4, stream=False, timeout=60,
        trace_id=tid,
    )
    check(err is None, "traced request failed", error=err)
    check(toks > 0, "traced request returned no tokens")
    agg.poll()  # capture router.route + serve.* before ring churn

    with sim_cluster() as c:
        # an H100 80GB GPU is 8 memory slices: two 3g.40gb fillers
        # leave no room for a 1g.10gb
        c.submit("filler-a", "3g.40gb")
        c.submit("filler-b", "3g.40gb")
        check(c.wait_phase("filler-a", "Running", timeout=30)
              and c.wait_phase("filler-b", "Running", timeout=30),
              "filler pods never ran")
        c.submit("blocked", PROFILE,
                 annotations={CAUSED_BY_ANNOTATION: tid})
        # the pod must actually WAIT on capacity (the demand the
        # caused-by link records), then get unblocked by a teardown
        time.sleep(0.5)
        check(not c.wait_phase("blocked", "Running", timeout=0.1),
              "blocked pod ran with the node full — not blocked")
        c.delete_pod("filler-a")
        check(c.wait_gone("filler-a", timeout=30),
              "filler never tore down")
        check(c.wait_phase("blocked", "Running", timeout=30),
              "blocked pod never granted after capacity freed")
        c.delete_pod("blocked")
        c.delete_pod("filler-b")
        c.wait_gone("blocked", timeout=30)
        c.wait_gone("filler-b", timeout=30)
    agg.poll()  # capture controller/agent spans + lifecycle events
    return tid


def run_scenario(label: str, device: str, fault_plan=None) -> dict:
    from instaslice_tpu_torch.analysis.drive import tiny_engine
    from instaslice_tpu_torch.api.constants import (
        REASON_SLO_BURN_CLEARED,
        REASON_SLO_BURN_HIGH,
        REASON_SLO_MISSED,
    )
    from instaslice_tpu_torch.metrics.metrics import FleetMetrics
    from instaslice_tpu_torch.obs.journal import get_journal
    from instaslice_tpu_torch.obs.telemetry import (
        FleetAggregator,
        TelemetryServer,
        parse_exposition,
    )
    from instaslice_tpu_torch.serving.api_server import ApiServer
    from instaslice_tpu_torch.serving.router import Router

    t_start = time.time()

    def engine():
        return tiny_engine(device)

    journal = get_journal()
    base = journal.counts()

    def delta(reason: str) -> int:
        return journal.counts().get(reason, 0) - base.get(reason, 0)

    clk = [time.time()]
    with ApiServer(engine(), block_size=4, tenants=TENANTS,
                   fault_plan=fault_plan) as a, \
            ApiServer(engine(), block_size=4, tenants=TENANTS,
                      fault_plan=fault_plan) as b:
        # eject_factor=0: no gray-failure sweep. On a loaded host one
        # replica answers its polls slowly and the sweep would drain it
        # with migration, which counts its stream twice (ok and migrated)
        router = Router(replicas=(a.url, b.url), poll_interval=0.1,
                        eject_factor=0)
        router.start()
        agg = FleetAggregator(
            router_url=router.url, slo_target=0.99,
            metrics=FleetMetrics(), journal=journal,
            clock=lambda: clk[0],
        )
        tel = TelemetryServer(agg).start()
        try:
            wait_ready(router.url)
            wait_ready(a.url)
            wait_ready(b.url)

            # ---- phase 1: clean traffic, attainment exactly 1.0
            rep_clean = run_loadgen(router.url, "steady:1:standard:30",
                                    8)
            clk[0] += 5
            fleet = agg.poll()
            check(fleet["tokens"] == rep_clean["client_tokens"],
                  "clean: fleet tokens != client tokens",
                  fleet=fleet["tokens"],
                  client=rep_clean["client_tokens"])
            check(fleet["ok_requests"] == rep_clean["ok"],
                  "clean: fleet ok != client ok", fleet=fleet)
            att = fleet["attainment"]["standard"]
            client_att = rep_clean["tenants"]["steady"]["slo_attainment"]
            check(att["attainment"] == 1.0 == client_att,
                  "clean: attainment not exactly 1.0 on both sides",
                  server=att, client=client_att)
            check(not fleet["burn"].get("standard", {}).get("burning"),
                  "clean class burning", burn=fleet["burn"])

            # ---- phase 2: burn traffic in TWO bursts (the monitor
            # needs a miss DELTA between samples), attainment 0.0
            rep_b1 = run_loadgen(router.url, "edge:1:latency:0.0001", 4)
            clk[0] += 60
            fleet = agg.poll()
            check(fleet["tokens"] == rep_clean["client_tokens"]
                  + rep_b1["client_tokens"],
                  "burn1: fleet tokens != sum of client tokens")
            check(fleet["attainment"]["latency"]["attainment"] == 0.0
                  == rep_b1["tenants"]["edge"]["slo_attainment"],
                  "burn1: attainment not exactly 0.0 on both sides",
                  fleet=fleet["attainment"])

            rep_b2 = run_loadgen(router.url, "edge:1:latency:0.0001", 4)
            clk[0] += 60
            fleet = agg.poll()
            burned = rep_b1["ok"] + rep_b2["ok"]
            check(fleet["ok_requests"] == rep_clean["ok"] + burned,
                  "burn2: fleet ok != client ok", fleet=fleet)
            check(fleet["attainment"]["latency"]["missed"] == burned
                  == delta(REASON_SLO_MISSED),
                  "SLO-miss ledger disagrees (fleet vs client vs "
                  "journal)", fleet=fleet["attainment"],
                  journal=delta(REASON_SLO_MISSED))
            check(fleet["burn"]["latency"]["burning"],
                  "burn monitor did not fire", burn=fleet["burn"])
            check(delta(REASON_SLO_BURN_HIGH) == 1,
                  "SLOBurnRateHigh not journaled exactly once",
                  n=delta(REASON_SLO_BURN_HIGH))

            # ---- phase 3: heal — slide past every window, no new
            # misses -> cleared
            clk[0] += 7 * 3600
            fleet = agg.poll()
            check(not fleet["burn"]["latency"]["burning"],
                  "burn did not clear after heal", burn=fleet["burn"])
            check(delta(REASON_SLO_BURN_CLEARED) == 1,
                  "SLOBurnRateCleared not journaled exactly once",
                  n=delta(REASON_SLO_BURN_CLEARED))

            # ---- phase 4: demand->supply stitching + chip-hours
            tid = stitched_trace_arm(router.url, agg)
            timeline = agg.stitcher.timeline(tid)
            check(len(timeline["components"]) >= 3,
                  "stitched timeline spans < 3 components",
                  components=timeline["components"],
                  spans=timeline["spanCount"])
            check(timeline["linked"], "no caused-by linked grant trace",
                  timeline={k: timeline[k] for k in
                            ("components", "spanCount")})
            fleet = agg.poll()
            check(fleet["chip_hours"]["chip_seconds"] > 0,
                  "chip-hours accounting recorded nothing",
                  chip_hours=fleet["chip_hours"])
            check(fleet["chip_hours"]
                  ["chip_hours_per_million_requests"] > 0,
                  "chip-hours per Mreq rollup is zero")

            # ---- the HTTP plane serves what the aggregator knows
            import urllib.request

            with urllib.request.urlopen(tel.url + "/v1/fleet",
                                        timeout=5) as r:
                served = json.loads(r.read())
            check(served["tokens"] == fleet["tokens"],
                  "/v1/fleet drifted from the aggregator")
            with urllib.request.urlopen(
                tel.url + f"/v1/fleet/trace?trace_id={tid}", timeout=5
            ) as r:
                check(json.loads(r.read())["spanCount"]
                      == timeline["spanCount"],
                      "/v1/fleet/trace drifted from the stitcher")
            with urllib.request.urlopen(tel.url + "/metrics",
                                        timeout=5) as r:
                samples = parse_exposition(r.read().decode())
            check(any(n == "tpuslice_fleet_tokens_total"
                      for n, _ in samples),
                  "fleet exposition missing tpuslice_fleet_tokens_total")

            return {
                "arm": label,
                "ok_requests": fleet["ok_requests"],
                "tokens": fleet["tokens"],
                "attainment": fleet["attainment"],
                "chip_seconds": fleet["chip_hours"]["chip_seconds"],
                "stitched_components": timeline["components"],
                "scrape_errors": fleet["scrapes"]["error"],
                "wall_s": round(time.time() - t_start, 1),
            }
        finally:
            tel.stop()
            agg.stop()
            router.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="telemetry_smoke",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the replicas' device: cuda (default; raises "
                         "without a card) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    from instaslice_tpu_torch import resolve_device
    from instaslice_tpu_torch.faults import FaultPlan

    resolve_device(args.device)  # no card: fail before anything runs
    results = []
    results.append(run_scenario("clean", args.device))
    print(json.dumps(results[-1]), flush=True)

    seed = int(os.environ.get("TPUSLICE_TELEMETRY_SEED", "42"))
    plan = (
        FaultPlan(seed)
        .site("engine.decode", probability=0.25, kinds=("delay",),
              delay_s=0.02)
        .site("engine.prefill", probability=0.25, kinds=("delay",),
              delay_s=0.02)
        .site("scheduler.round", probability=0.05, kinds=("delay",),
              delay_s=0.02)
    )
    results.append(run_scenario(f"chaos-seed-{seed}", args.device,
                                fault_plan=plan))
    print(json.dumps(results[-1]), flush=True)

    print(json.dumps({"telemetry_smoke": "ok",
                      "arms": [r["arm"] for r in results]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
