"""Continuous-profiler CI smoke of the port (``make gpu-profile-smoke``,
< 60 s on the CPU): the port's copy of ``tools/profile_smoke.py``.

Stands up one serving replica of the port's ApiServer (on ``--device``:
the card by default, ``cpu`` for the plain versions) and proves the
contracts of the reference's continuous profiler:

1. **Bounded overhead** — the same loadgen workload runs unprofiled and
   profiled in one process (shared kernels and captured graphs). The
   armed arm must keep >= 95% of the unprofiled arm's client
   tokens/sec (retries absorb CPU-scheduler noise in CI).
2. **Ledger reconciliation** — over each armed arm, the scheduler's
   ``rounds_total`` delta equals the profiler's ``rounds_recorded``;
   the ``tpuslice_serve_profile_rounds_total`` counter equals the ring;
   after quiesce the ring stops growing (idle wait-loops leak zero
   records).
3. **Valid Chrome trace export** — ``chrome_trace`` over the recorded
   rounds/events round-trips through JSON and contains at least one
   full round lane (a ``round/*`` slice plus its segment slices, a
   ``dispatch`` among them) for Perfetto to render.
4. **Waterfall** — at least one request's waterfall stitches from the
   rings with a terminal outcome and at least one stage.
5. **No mid-traffic compiles** — with ``TPUSLICE_COMPILE_GRACE`` pinned
   low and a warm-up burst of the same traffic shape, no armed arm
   journals ``CompileObserved``, and ``engine.compiled_programs()`` (the
   kernel libraries and, on the card, the captured CUDA graphs by form)
   does not change over it: no graph is captured past warm-up.

:func:`unprofiled_arm`, :func:`profiled_arm` and :func:`exports` are the
gate's parts, for a caller that holds its own server (the chip smoke
runs them on its 7B int8 server, four arms a side in mirrored pairs).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

#: the lazy first-dispatch work rides the warm-up burst; the grace
#: window must close BEFORE the measured arms so a compile there would
#: be loudly journaled (``main`` sets it before any scheduler exists)
GRACE_S = 2.0

#: the profile-smoke gate: armed tok/s >= OVERHEAD_FLOOR x unprofiled
OVERHEAD_FLOOR = 0.95

LOADGEN = dict(requests=24, concurrency=6, prompt_len=12,
               max_tokens=16, vocab=64, stream=True, timeout=60)


def check(cond: bool, msg: str, **ctx) -> None:
    if not cond:
        raise AssertionError(
            f"{msg}" + (f" | {json.dumps(ctx, default=str)}" if ctx
                        else "")
        )


def quiesce(sched, timeout: float = 10.0) -> None:
    pacer = threading.Event()
    deadline = time.monotonic() + timeout
    eng = sched.engine
    while time.monotonic() < deadline and (
        eng.slots or sched.queue.qsize() or sched._ready
    ):
        pacer.wait(0.02)
    check(not eng.slots, "engine never quiesced",
          slots=len(eng.slots))


def run_arm(url: str, seed: int, loadgen_kw: dict = LOADGEN) -> dict:
    from instaslice_tpu_torch.serving import loadgen

    report = loadgen.run(url, seed=seed, **loadgen_kw)
    check(report["outcomes"]["hung"] == 0, "hung requests",
          outcomes=report["outcomes"])
    check(report["ok"] == loadgen_kw["requests"],
          "not every request succeeded",
          report={k: report[k] for k in ("ok", "outcomes", "errors")})
    return report


def _compiles() -> int:
    from instaslice_tpu_torch.api.constants import REASON_COMPILE_OBSERVED
    from instaslice_tpu_torch.obs.journal import get_journal

    return get_journal().counts().get(REASON_COMPILE_OBSERVED, 0)


def unprofiled_arm(srv, prof, seed: int,
                   loadgen_kw: dict = LOADGEN) -> dict:
    """One arm with the profiler disarmed: its client tok/s; it records
    no round."""
    prof.disarm()
    rec0 = prof.rounds_recorded
    rep = run_arm(srv.url, seed, loadgen_kw)
    quiesce(srv.scheduler)
    check(prof.rounds_recorded == rec0, "the disarmed arm recorded rounds",
          recorded=prof.rounds_recorded - rec0)
    return {"tok_s": rep["client_tokens_per_sec"], "report": rep}


def profiled_arm(srv, prof, seed: int,
                 loadgen_kw: dict = LOADGEN) -> dict:
    """One arm with the profiler armed (fresh ledger from here): its
    client tok/s, the ring against the scheduler's round counter, and no
    compile over it (journal and ``compiled_programs()``)."""
    sched = srv.scheduler
    eng = sched.engine
    rounds0 = sched.rounds_total
    rec0 = prof.rounds_recorded
    compiles0 = _compiles()
    programs0 = dict(eng.compiled_programs())
    prof.arm()
    try:
        rep = run_arm(srv.url, seed, loadgen_kw)
        quiesce(sched)
    finally:
        prof.disarm()
    recorded = prof.rounds_recorded - rec0
    rounds_delta = sched.rounds_total - rounds0
    check(recorded > 0, "armed arm recorded no rounds")
    check(recorded == rounds_delta,
          "profiler ring != scheduler round counter",
          recorded=recorded, rounds_total_delta=rounds_delta)
    compiles = _compiles() - compiles0
    check(compiles == 0, "CompileObserved during the measured window",
          compiles=compiles)
    programs = dict(eng.compiled_programs())
    check(programs == programs0,
          "compiled programs changed over the armed arm (a kernel built or "
          "a graph captured past warm-up)", before=programs0,
          after=programs)
    return {"tok_s": rep["client_tokens_per_sec"], "rounds": recorded,
            "report": rep}


def validate_chrome_trace(doc: dict) -> None:
    """Structural Chrome-trace-event validity + >= 1 full round lane:
    a ``round/*`` complete slice and segment slices under the same
    scheduler pid."""
    evs = doc.get("traceEvents")
    check(isinstance(evs, list) and evs, "traceEvents missing/empty")
    for ev in evs:
        check(ev.get("ph") in ("X", "i", "M"),
              "unknown trace-event phase", event=ev)
        check("pid" in ev and "ts" in ev, "trace event missing pid/ts",
              event=ev)
        if ev["ph"] == "X":
            check("dur" in ev and "tid" in ev and "name" in ev,
                  "complete event missing dur/tid/name", event=ev)
    rounds = [e for e in evs if e.get("ph") == "X"
              and str(e.get("name", "")).startswith("round/")]
    check(len(rounds) >= 1, "no round/* slice in the trace")
    round_pids = {e["pid"] for e in rounds}
    segs = [e for e in evs if e.get("cat") == "segment"
            and e.get("pid") in round_pids]
    check(len(segs) >= 1, "round lane has no segment slices")
    # dispatch must appear: a trace without the decode/spec dispatch
    # segment is a rounds-only skeleton, not a timeline
    check(any(e.get("name") == "dispatch" for e in segs),
          "no dispatch segment in any round",
          names=sorted({e.get("name") for e in segs}))


def exports(srv, prof) -> dict:
    """After the arms: the ``profile_rounds`` metric against the ring, no
    ring growth while idle, the Chrome trace, a waterfall, and the HTTP
    surface serving the same payloads."""
    import urllib.request

    from instaslice_tpu_torch.obs.profiler import (
        chrome_trace,
        debug_profile_payload,
        waterfall_payload,
    )

    sched = srv.scheduler
    counter = sched.metrics.profile_rounds
    metric_val = getattr(counter, "_value", None)
    if metric_val is not None:   # real prometheus counter
        check(int(metric_val.get()) == prof.rounds_recorded,
              "profile_rounds metric != ring recorded",
              metric=metric_val.get(), recorded=prof.rounds_recorded)
    # zero ring entries leaked after quiesce: idle wait-loops must not
    # record
    settle = prof.rounds_recorded
    threading.Event().wait(0.25)
    check(prof.rounds_recorded == settle, "ring grew while idle",
          before=settle, after=prof.rounds_recorded)

    # ---- chrome trace export round-trips and renders a lane
    payload = debug_profile_payload({"n": ["512"]}, profiler=prof)
    doc = chrome_trace(rounds=payload["recent"],
                       events=payload["recentEvents"])
    doc = json.loads(json.dumps(doc))   # must survive JSON
    validate_chrome_trace(doc)

    # ---- >= 1 waterfall from a recorded round's rid
    rids = []
    for rec in prof.rounds():
        rids.extend(rec.meta.get("rids") or [])
    check(rids, "no rids in any round record")
    w = waterfall_payload(str(rids[-1]), profiler=prof)
    check(w["outcome"] != "", "waterfall has no outcome", waterfall=w)
    check(len(w["stages"]) >= 1, "waterfall has no stages", waterfall=w)
    check(len(w["rounds"]) >= 1, "waterfall joined no round records",
          waterfall=w)

    # ---- the HTTP surface serves the same payloads
    with urllib.request.urlopen(
        srv.url + "/v1/debug/profile?n=4", timeout=60
    ) as r:
        served = json.loads(r.read())
    check(served["rounds"] == prof.rounds_recorded,
          "/v1/debug/profile drifted from the ring")
    with urllib.request.urlopen(
        srv.url + f"/v1/debug/profile?rid={rids[-1]}", timeout=60,
    ) as r:
        served_w = json.loads(r.read())
    check(served_w["traceId"] == w["traceId"],
          "HTTP waterfall != in-process waterfall")
    return {"rounds_recorded": prof.rounds_recorded,
            "trace_events": len(doc["traceEvents"]),
            "waterfall_outcome": w["outcome"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_smoke",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the replica's device: cuda (default; raises "
                         "without a card) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    # before any scheduler is constructed
    os.environ["TPUSLICE_COMPILE_GRACE"] = str(GRACE_S)

    from instaslice_tpu_torch.analysis.drive import tiny_engine
    from instaslice_tpu_torch.obs.profiler import Profiler, reset_profiler
    from instaslice_tpu_torch.serving.api_server import ApiServer

    t_start = time.time()
    eng = tiny_engine(args.device, d_model=64, d_ff=128, max_batch=8)
    # the warm window: prefill chunks (and spec forms, none here) run
    # before traffic; the decode forms ride the warm-up burst
    eng.warm_prefill_buckets()
    eng.warm_spec_programs()

    prof = Profiler(armed=False)
    reset_profiler(prof)
    try:
        with ApiServer(eng, block_size=8, request_timeout=60) as srv:
            sched = srv.scheduler
            check(sched.profiler is prof,
                  "scheduler did not pick up the process profiler")

            # ---- warm-up: same traffic shape as the measured arms,
            # then wait out the compile grace window
            run_arm(srv.url, seed=7)
            quiesce(sched)
            threading.Event().wait(GRACE_S + 0.3)

            ratio = 0.0
            for attempt in (1, 2, 3):
                off = unprofiled_arm(srv, prof, seed=8 + attempt)
                on = profiled_arm(srv, prof, seed=20 + attempt)
                ratio = on["tok_s"] / off["tok_s"] if off["tok_s"] else 0.0
                if ratio >= OVERHEAD_FLOOR:
                    break
                print(json.dumps({"retry": attempt, "ratio":
                                  round(ratio, 4)}), flush=True)
            check(ratio >= OVERHEAD_FLOOR,
                  f"armed arm kept < {OVERHEAD_FLOOR:.0%} of "
                  "unprofiled tok/s",
                  off_tps=off["tok_s"], on_tps=on["tok_s"],
                  ratio=round(ratio, 4))
            out = exports(srv, prof)
            print(json.dumps({
                "profile_smoke": "ok",
                "off_tokens_per_sec": off["tok_s"],
                "on_tokens_per_sec": on["tok_s"],
                "ratio": round(ratio, 4),
                "rounds_recorded": on["rounds"],
                "trace_events": out["trace_events"],
                "waterfall_outcome": out["waterfall_outcome"],
                "wall_s": round(time.time() - t_start, 1),
            }))
            return 0
    finally:
        reset_profiler()


if __name__ == "__main__":
    sys.exit(main())
