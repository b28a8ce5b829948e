"""``tpuslice-gpu`` operator CLI: inspect catalogs, simulate placement,
bench the serving engine, and read the observability planes (traces,
flight-recorder events, the per-pod decision timeline).

A copy of ``instaslice_tpu/cli/tpuslicectl.py`` (the port imports
nothing of the JAX package) with every command of the reference's
``tpuslice``: ``status``, ``describe``, ``events``, ``trace-summary``,
``profile``, ``waterfall`` and ``fleet`` run over the port's kube
client, journal, tracer and profiler. Where it differs:

- ``catalog`` and ``plan`` are the reference's on every TPU generation.
  On a GPU grid (``h100-80gb``, ``nvidia-gpu``) ``catalog`` lists what a
  GPU node's CR lists, the whole GPU (``gpu``) included, and ``plan``
  reads each request through ``controller/gpugrid`` against the grid's
  catalog, places on ``mig.gpu_group(--hosts, generation)`` (``--hosts``
  counts GPUs there, GPU i at y = i) and prints each placement's GPU
  index and memory slots where the reference prints local chip ids
  (:func:`plan_group`, :func:`plan_profile`, :func:`plan_hosts`).
- ``serve-bench`` builds the port's model and engine on ``--device``
  (the card by default, raising without one; bf16 there, fp32 on the
  CPU) from a seeded ``torch.Generator``; its JSON line has the
  reference's keys, ``backend`` the torch device type. A node of NVIDIA
  cards has no host-wide accelerator claim, so there is no ``tpulock``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import threading


def _serve_bench(args) -> int:
    import torch

    from instaslice_tpu_torch import resolve_device, serving
    from instaslice_tpu_torch.models.lm import ModelConfig, TpuLM

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    cfg = ModelConfig(
        vocab_size=args.vocab,
        d_model=args.d_model,
        n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads,
        n_layers=args.n_layers,
        d_ff=args.d_ff,
        window=args.window,
        dtype=torch.bfloat16 if on_card else torch.float32,
        remat=False,
    )
    model = TpuLM(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    kw = {}
    if args.quantize or args.spec:
        from instaslice_tpu_torch.models.quant import quantize_params

        qparams = quantize_params(params)
    if args.quantize:
        params, kw["kv_quant"] = qparams, True
    if args.spec:
        kw.update(draft_model=model, draft_params=qparams, spec_k=4)
    # looked up on the module at call time, so a harness can count the
    # engine's own steps (chip_smoke.ctl_bench)
    eng = serving.ServingEngine(
        model, params, max_batch=args.batch, max_len=args.max_len,
        prefill_len=args.prefill_len, device=dev, **kw,
    )
    out = {
        "metric": "serve_decode_tokens_per_sec",
        "unit": "tokens/s",
        "backend": dev.type,
        "batch": args.batch,
        "quantized": bool(args.quantize),
        "speculative": bool(args.spec),
        "model": {
            "dModel": args.d_model, "nLayers": args.n_layers,
            "nHeads": args.n_heads, "nKvHeads": args.n_kv_heads,
            "dFF": args.d_ff, "window": args.window,
        },
    }
    if args.spec:
        tput, per_round = eng.spec_throughput(rounds=args.steps)
        out["value"] = round(tput, 1)
        out["spec_tokens_per_round"] = round(per_round, 2)
    else:
        out["value"] = round(eng.throughput(n_steps=args.steps), 1)
    print(json.dumps(out))
    return 0


def _trace_summary(p, args) -> int:
    """``trace-summary``: one span pipeline, two sources — an offline
    ``TPUSLICE_TRACE_FILE`` JSONL dump, or a live server's in-memory
    ring over ``GET /v1/debug/trace``. Default output is per-span-name
    p50/p95/max rows; ``--slowest N`` adds the N slowest trace roots;
    ``--trace ID`` dumps one trace's spans in start order."""
    from instaslice_tpu_torch.utils.trace import summarize_durations

    if bool(args.file) == bool(args.url):
        p.error("trace-summary needs a JSONL file OR --url (not both)")

    if args.url:
        import urllib.parse
        import urllib.request

        base = args.url.rstrip("/") + "/v1/debug/trace"
        query = {}
        if args.trace:
            query["trace_id"] = args.trace
        if args.slowest:
            query["n"] = str(args.slowest)
        if query:
            base += "?" + urllib.parse.urlencode(query)
        try:
            with urllib.request.urlopen(base, timeout=10) as r:
                out = json.loads(r.read().decode())
        except Exception as e:  # noqa: BLE001 - CLI: message, not trace
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
            return 1
        if args.trace:
            for span in out.get("spans", []):
                print(json.dumps(span))
            return 0
        for name, row in out.get("summary", {}).items():
            print(json.dumps({"name": name, **row}))
        if args.slowest:
            for span in out.get("slowest", [])[: args.slowest]:
                print(json.dumps(span))
        return 0

    spans = []
    with open(args.file) as f:
        for line in f:
            line = line.strip()
            if line:
                spans.append(json.loads(line))
    if args.trace:
        mine = [s for s in spans if s.get("traceId") == args.trace]
        for span in sorted(mine, key=lambda s: s.get("start", 0.0)):
            print(json.dumps(span))
        return 0 if mine else 1
    by: dict = {}
    for rec in spans:
        by.setdefault(rec["name"], []).append(rec["durationMs"])
    for name, row in summarize_durations(by).items():
        print(json.dumps({"name": name, **row}))
    if args.slowest:
        roots = [s for s in spans if not s.get("parentId")]
        roots.sort(key=lambda s: -s["durationMs"])
        for span in roots[: args.slowest]:
            print(json.dumps(span))
    return 0


def _get_json(url: str, timeout: float = 10):
    """GET url → parsed JSON; (None, error-string) style return:
    ``(payload, "")`` on success, ``(None, message)`` on any failure."""
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read().decode()), ""
    except Exception as e:  # slicelint: disable=broad-except
        # CLI surface: the message IS the report (printed by callers)
        return None, f"{type(e).__name__}: {e}"


def _profile_cmd(args) -> int:
    """``profile``: the continuous profiler's export surface. Without
    ``--out``: per-segment p50/p95 summary rows (one JSON line each,
    the trace-summary idiom). With ``--out trace.json``: fetch the
    round records + timeline events (``GET /v1/debug/profile``) and
    the tracer's recent spans (``GET /v1/debug/trace``), interleave
    them into Chrome trace-event JSON (obs/profiler.py
    ``chrome_trace``), and write the file — open it in Perfetto or
    ``chrome://tracing``."""
    from instaslice_tpu_torch.obs.profiler import chrome_trace

    base = args.url.rstrip("/")
    profile, err = _get_json(f"{base}/v1/debug/profile?n={args.last}")
    if profile is None:
        print(json.dumps({"error": err}))
        return 1
    if not args.out:
        print(json.dumps({
            "armed": profile.get("armed"),
            "rounds": profile.get("rounds"),
            "events": profile.get("events"),
            "compileWallMs": profile.get("compileWallMs"),
        }))
        for name, row in sorted(
            (profile.get("segments") or {}).items()
        ):
            print(json.dumps({"segment": name, **row}))
        for c in profile.get("compiles") or []:
            print(json.dumps({"compile": c}))
        return 0
    # spans ride along on the same timeline; a trace-less component
    # (or a scrape error) degrades to rounds + events only
    trace, _terr = _get_json(f"{base}/v1/debug/trace?n={args.last}")
    spans = (trace or {}).get("recent") or []
    doc = chrome_trace(
        rounds=profile.get("recent") or [],
        events=profile.get("recentEvents") or [],
        spans=spans,
    )
    with open(args.out, "w") as f:
        json.dump(doc, f)
    print(json.dumps({
        "out": args.out,
        "traceEvents": len(doc["traceEvents"]),
        "rounds": len(profile.get("recent") or []),
        "events": len(profile.get("recentEvents") or []),
        "spans": len(spans),
    }))
    return 0


def render_waterfall(w: dict) -> str:
    """ASCII latency waterfall: one bar row per stage on a shared
    [0, totalMs] axis, then the journal markers."""
    width = 40
    total = max(float(w.get("totalMs") or 0.0), 0.001)
    lines = [
        f"request {w['rid']}  trace={w['traceId']}  "
        f"outcome={w['outcome'] or '?'}  total={w['totalMs']}ms  "
        f"preemptions={w['preemptions']}"
    ]
    for s in w.get("stages", []):
        start = float(s["startMs"])
        dur = float(s["durationMs"])
        left = min(width, int(round(start / total * width)))
        span = max(1, int(round(dur / total * width)))
        span = min(span, width - left) or 1
        bar = " " * left + "█" * span
        lines.append(
            f"  {s['stage']:<14} {bar:<{width}}  "
            f"{start:>9.2f}ms +{dur:.2f}ms"
        )
    for m in w.get("markers", []):
        lines.append(
            f"  ◆ {m['atMs']:>9.2f}ms  {m['reason']}: {m['message']}"
        )
    return "\n".join(lines)


def _waterfall_cmd(args) -> int:
    """``waterfall``: one request's queue→admission→prefill→rounds→
    (preempt/resume)→finish timeline, stitched server-side from round
    records + journal + trace (``GET /v1/debug/profile?rid=...``)."""
    base = args.url.rstrip("/")
    import urllib.parse

    w, err = _get_json(
        f"{base}/v1/debug/profile?"
        + urllib.parse.urlencode({"rid": args.rid})
    )
    if w is None:
        print(json.dumps({"error": err}))
        return 1
    if w.get("error"):
        print(json.dumps(w))
        return 1
    if args.as_json:
        print(json.dumps(w))
    else:
        print(render_waterfall(w))
    return 0


def _parse_jsonl_line(line: str):
    """One parsed JSONL record, or None for blank/malformed lines — a
    live, half-written tail must never crash a reader. The ONE
    malformed-line policy for every JSONL consumer in this CLI."""
    line = line.strip()
    if not line:
        return None
    try:
        rec = json.loads(line)
    except ValueError:
        return None
    return rec if isinstance(rec, dict) else None


def _read_jsonl(path: str) -> list:
    """Parsed records from a JSONL file ([] when absent)."""
    out = []
    if not path or not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            rec = _parse_jsonl_line(line)
            if rec is not None:
                out.append(rec)
    return out


def _event_matches(rec: dict, args) -> bool:
    if args.reason and rec.get("reason") != args.reason:
        return False
    if args.object and rec.get("objectRef") != args.object:
        return False
    if args.trace and rec.get("traceId") != args.trace:
        return False
    if args.component and rec.get("component") != args.component:
        return False
    return True


def _events_cmd(p, args) -> int:
    """``events``: the flight recorder, two sources — an offline
    ``TPUSLICE_EVENT_FILE`` JSONL dump, or a live component's
    ``GET /v1/debug/events`` (serving plane or operator probe plane).
    One JSON line per event; ``--follow`` tails the source."""
    if bool(args.file) == bool(args.url):
        p.error("events needs a JSONL file OR --url (not both)")
    pacer = threading.Event()  # interruptible nap (Ctrl-C ends follow)

    if args.url:
        import urllib.parse
        import urllib.request

        base = args.url.rstrip("/") + "/v1/debug/events"
        since = 0
        first = True
        while True:
            # -n bounds only the FIRST (historical) batch, like file
            # mode; follow-up polls fetch everything past since_seq so
            # a burst bigger than n is never silently dropped
            query = {"n": str((args.last or 10000) if first else 100000)}
            first = False
            if args.reason:
                query["reason"] = args.reason
            if args.object:
                query["object"] = args.object
            if args.trace:
                query["trace_id"] = args.trace
            if args.component:
                query["component"] = args.component
            if since:
                query["since_seq"] = str(since)
            url = base + "?" + urllib.parse.urlencode(query)
            try:
                with urllib.request.urlopen(url, timeout=10) as r:
                    out = json.loads(r.read().decode())
            except Exception as e:  # noqa: BLE001 - CLI: message, not trace
                print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
                return 1
            for rec in out.get("events", []):
                print(json.dumps(rec))
                since = max(since, int(rec.get("seq", 0)))
            if not args.follow:
                return 0
            pacer.wait(1.0)

    if not os.path.exists(args.file):
        # match URL mode's clean one-line failure, not a traceback
        print(json.dumps({"error": f"no such file: {args.file}"}))
        return 1
    with open(args.file) as f:
        # historical batch first (honoring -n like the other modes),
        # then — under --follow — tail from the current offset
        recs = [rec for rec in map(_parse_jsonl_line, f)
                if rec is not None and _event_matches(rec, args)]
        for rec in recs[-args.last:] if args.last else recs:
            print(json.dumps(rec), flush=True)
        if not args.follow:
            return 0
        while True:
            line = f.readline()
            if not line:
                pacer.wait(0.25)
                continue
            rec = _parse_jsonl_line(line)
            if rec is not None and _event_matches(rec, args):
                print(json.dumps(rec), flush=True)


def _fleet_cmd(args) -> int:
    """``fleet``: one-shot (or ``--follow``) view of a
    ``tpuslice-telemetry`` aggregator. Rollup mode prints the
    ``/v1/fleet`` snapshot as one JSON object per poll; ``--trace``
    mode prints the stitched cross-process timeline for one trace id
    (``/v1/fleet/trace``)."""
    import urllib.parse
    import urllib.request

    base = args.url.rstrip("/")
    if args.trace:
        path = "/v1/fleet/trace?" + urllib.parse.urlencode(
            {"trace_id": args.trace}
        )
    else:
        path = "/v1/fleet"
    pacer = threading.Event()  # interruptible nap (Ctrl-C ends follow)
    while True:
        try:
            with urllib.request.urlopen(base + path, timeout=10) as r:
                out = json.loads(r.read().decode())
        except Exception as e:  # noqa: BLE001 - CLI: message, not trace
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
            return 1
        print(json.dumps(out), flush=True)
        if not args.follow:
            return 0
        pacer.wait(max(0.1, args.interval))


def describe_pod(client, name: str, namespace: str = "default",
                 operator_namespace: str = "instaslice-tpu-system",
                 events_path: str = "", trace_path: str = "") -> dict:
    """Stitch one pod's control-plane history into a single timeline:
    the Kubernetes Events mirrored onto it, the allocation's persisted
    audit trail (CR ``transitions``), the journal JSONL (optional), and
    the grant trace's spans (optional). The data behind ``tpuslice
    describe pod`` — factored for tools/validate_events.py and tests."""
    from instaslice_tpu_torch.api.constants import (
        ERROR_ANNOTATION,
        KIND,
        TRANSITION_REASONS,
        UNHEALTHY_ANNOTATION,
    )
    from instaslice_tpu_torch.api.types import TpuSlice
    from instaslice_tpu_torch.kube.client import ApiError
    from instaslice_tpu_torch.utils.timeutil import parse_timestamp

    info: dict = {
        "pod": name, "namespace": namespace, "phase": "Gone",
        "gated": False, "gates": [], "error": "", "unhealthy": "",
        "allocation": None, "traceId": "", "timeline": [],
    }
    try:
        pod = client.get("Pod", namespace, name)
    except ApiError:
        pod = None
    if pod is not None:
        md = pod.get("metadata", {})
        ann = md.get("annotations") or {}
        gates = [g.get("name", "")
                 for g in pod.get("spec", {}).get("schedulingGates") or []]
        info.update(
            phase=pod.get("status", {}).get("phase", ""),
            gated=bool(gates), gates=gates,
            error=ann.get(ERROR_ANNOTATION, ""),
            unhealthy=ann.get(UNHEALTHY_ANNOTATION, ""),
        )

    timeline: list = []
    alloc_ref = ""
    trace_id = ""
    seen_transitions: set = set()
    try:
        crs = client.list(KIND, namespace=operator_namespace)
    except ApiError:
        crs = []
    for m in crs:
        ts_obj = TpuSlice.from_manifest(m)
        for a in ts_obj.spec.allocations.values():
            if not any(p.pod_name == name and p.namespace == namespace
                       for p in a.pods):
                continue
            if info["allocation"] is None:
                info["allocation"] = {
                    "id": a.alloc_id, "profile": a.profile,
                    "box": a.box, "status": a.status.value,
                    "nodes": sorted(a.parts), "realizedOn": [],
                }
            al = info["allocation"]
            al["realizedOn"] = sorted(
                set(al["realizedOn"]) | set(a.realized_on)
            )
            trace_id = trace_id or a.trace_id
            alloc_ref = f"alloc/{a.alloc_id}"
            # audit trail union across holder CRs: each holder of a
            # multi-host allocation runs the same transition sequence
            # but stamps its OWN timestamps, so the dedup key is the
            # trail position + content, never the clock
            for i, t in enumerate(a.transitions):
                key = (i, t.get("status"), t.get("message"))
                if key in seen_transitions:
                    continue
                seen_transitions.add(key)
                timeline.append({
                    "ts": float(t.get("ts", 0.0)), "source": "audit",
                    "reason": TRANSITION_REASONS.get(
                        t.get("status", ""), t.get("status", "")
                    ),
                    "message": t.get("message", ""),
                })
    info["traceId"] = trace_id

    try:
        kube_events = client.list("Event", namespace=namespace)
    except ApiError:
        kube_events = []
    for ev in kube_events:
        io = ev.get("involvedObject") or {}
        if io.get("kind", "Pod") != "Pod":
            continue  # a Deployment/Service sharing the name is not us
        if io.get("name") != name:
            continue
        if io.get("namespace", namespace) != namespace:
            continue
        timeline.append({
            "ts": parse_timestamp(
                ev.get("lastTimestamp") or ev.get("firstTimestamp")
            ),
            "source": "event",
            "reason": ev.get("reason", ""),
            "message": ev.get("message", ""),
        })

    want_refs = {f"Pod/{namespace}/{name}"}
    if alloc_ref:
        want_refs.add(alloc_ref)
    for rec in _read_jsonl(events_path):
        if rec.get("objectRef") in want_refs or (
            trace_id and rec.get("traceId") == trace_id
        ):
            comp = rec.get("component", "")
            msg = rec.get("message", "")
            timeline.append({
                "ts": float(rec.get("ts", 0.0)), "source": "journal",
                "reason": rec.get("reason", ""),
                "message": f"[{comp}] {msg}".strip() if comp else msg,
                "_key": (rec.get("reason", ""), msg),
            })

    if trace_id:
        for rec in _read_jsonl(trace_path):
            if rec.get("traceId") != trace_id:
                continue
            msg = f"{rec.get('durationMs', 0):.3f}ms"
            if rec.get("error"):
                msg += f" error={rec['error']}"
            timeline.append({
                "ts": float(rec.get("start", 0.0)), "source": "span",
                "reason": rec.get("name", ""), "message": msg,
                # spans are never decision mirrors: repeats (decode
                # rounds, retried reconciles) are distinct entries
                "_key": ("span", rec.get("name", ""),
                         round(float(rec.get("start", 0.0)), 6)),
            })

    timeline.sort(key=lambda t: (t["ts"], t["source"]))
    # cross-source dedup: one DECISION lands on up to three surfaces
    # (journal + mirrored kube Event; transition journal + audit trail)
    # — and a multi-host allocation re-records it once per holder with
    # per-holder clocks. So the key is the decision's CONTENT (reason +
    # message), never a timestamp; the first source in (ts, source)
    # order wins. Journal-only events (kube transport, erased retry
    # epochs) have no twin and survive untouched.
    seen_keys: set = set()
    deduped = []
    for t in timeline:
        key = t.pop("_key", None) or (t["reason"], t["message"])
        if key in seen_keys:
            continue
        seen_keys.add(key)
        deduped.append(t)
    info["timeline"] = deduped
    return info


def render_locks(payload: dict) -> str:
    """Human rendering of a ``/v1/debug/locks`` body
    (utils/lockcheck.py): live per-thread held locks first — the
    hung-process question — then accumulated order cycles, long holds,
    and the hottest locks by total hold time."""
    lines = [f"lockcheck armed: {'yes' if payload.get('armed') else 'no'}"]
    if not payload.get("armed"):
        lines.append(
            "  (set TPUSLICE_LOCKCHECK=1 on the component to record "
            "held locks, ordering edges and hold times)"
        )
    live = payload.get("live", [])
    lines.append(f"Held now ({len(live)} thread(s)):")
    for t in live:
        held = " -> ".join(
            f"{h['name']}({h['heldSeconds']:.3f}s"
            + (f",depth={h['depth']}" if h.get("depth", 1) > 1 else "")
            + ")"
            for h in t["held"]
        )
        lines.append(f"  {t['thread']}: {held}")
    cycles = payload.get("cycles", [])
    if cycles:
        lines.append(f"Lock-order cycles ({len(cycles)}) — ABBA "
                     "deadlocks waiting for the right interleaving:")
        for c in cycles:
            lines.append(f"  {' -> '.join(c['chain'])}  "
                         f"threads={','.join(c.get('threads', []))}")
    long_holds = payload.get("longHolds", [])
    if long_holds:
        lines.append(f"Long holds ({len(long_holds)}):")
        for h in long_holds[-20:]:
            lines.append(f"  {h['name']}  {h['seconds']}s  "
                         f"thread={h['thread']}")
    holds = payload.get("holds", {})
    if holds:
        top = sorted(holds.items(), key=lambda kv: -kv[1]["totalSeconds"])
        lines.append("Hottest locks (by total hold time):")
        for name, st in top[:10]:
            lines.append(
                f"  {name}  count={st['count']}  "
                f"total={st['totalSeconds']}s  max={st['maxSeconds']}s"
            )
    edges = payload.get("edges", [])
    lines.append(f"Ordering edges recorded: {len(edges)}")
    return "\n".join(lines)


def render_describe(info: dict) -> str:
    """Human rendering of :func:`describe_pod` — the "why is my pod
    still gated?" answer (README walkthrough)."""
    lines = [
        f"Pod {info['namespace']}/{info['pod']}  "
        f"phase={info['phase'] or '?'}  "
        f"gated={'yes (' + ','.join(info['gates']) + ')' if info['gated'] else 'no'}"
    ]
    if info["error"]:
        lines.append(f"  error annotation: {info['error']}")
    if info["unhealthy"]:
        lines.append(f"  degraded: {info['unhealthy']}")
    al = info["allocation"]
    if al is not None:
        lines.append(
            f"Allocation {al['id']}  profile={al['profile']}  "
            f"box={al['box']}  status={al['status']}  "
            f"realized={len(al['realizedOn'])}/{len(al['nodes'])} "
            f"nodes={','.join(al['nodes'])}"
        )
    elif info["gated"] and not info["error"]:
        lines.append(
            "No allocation yet — the pod is waiting for the controller "
            "(look for NoCapacity/Rejected entries below)"
        )
    if info["traceId"]:
        lines.append(f"Trace {info['traceId']}  "
                     "(tpuslice trace-summary --trace <id> drills in)")
    lines.append(f"Timeline ({len(info['timeline'])} entries):")
    for t in info["timeline"]:
        when = "?" * 13  # matches the HH:MM:SS.mmmZ column width
        if t["ts"]:
            when = (
                datetime.datetime.fromtimestamp(
                    t["ts"], datetime.timezone.utc
                ).strftime("%H:%M:%S.%f")[:-3] + "Z"
            )
        # migration epochs render distinctly: every repacker decision
        # (Repack* reasons) and every transition the repacker stamped
        # "(repack" into gets the ⟳ marker, so a drain→teardown→re-grant
        # chain is visually separable from the original grant's chain
        mark = " "
        if t["reason"].startswith("Repack") or "(repack" in t["message"]:
            mark = "⟳"
        lines.append(
            f"{mark} {when:>13}  {t['source']:<7}  {t['reason']:<20}  "
            f"{t['message']}"
        )
    return "\n".join(lines)


def _gpu_grid(generation: str) -> bool:
    from instaslice_tpu_torch.topology.mig import mig_catalog

    return mig_catalog(generation) is not None


def catalog_profiles(generation: str, max_chips=None) -> list:
    """The profiles ``catalog`` prints: the generation's catalog; on a GPU
    grid, what a GPU node's CR lists (``agent/discovery.py``): the grid's
    profiles and the whole GPU (``gpu``)."""
    from instaslice_tpu_torch.topology import profile_catalog
    from instaslice_tpu_torch.topology.mig import whole_gpu

    profs = profile_catalog(generation, max_chips)
    if _gpu_grid(generation):
        whole = whole_gpu(generation)
        if whole not in profs and (max_chips is None
                                   or whole.chip_count <= max_chips):
            profs.append(whole)
    return profs


def plan_group(generation: str, hosts: int):
    """The mesh ``plan`` places on: ``hosts`` hosts side by side along x
    (the reference's), or on a GPU grid ``mig.gpu_group`` of ``hosts``
    GPUs, GPU i at y = i."""
    from instaslice_tpu_torch.topology import NodeGrid, TorusGroup
    from instaslice_tpu_torch.topology.grid import get_generation
    from instaslice_tpu_torch.topology.mig import gpu_group

    if _gpu_grid(generation):
        return gpu_group(hosts, generation, group_id="plan")
    gen = get_generation(generation)
    hb = gen.host_bounds
    grids = {
        f"host-{i}": NodeGrid(gen, host_offset=(i * hb[0], 0, 0))
        for i in range(hosts)
    }
    return TorusGroup("plan", gen, (hb[0] * hosts, hb[1], hb[2]), grids)


def plan_profile(name: str, generation: str):
    """A ``plan`` request as the generation takes it: the reference's
    ``parse_profile_name``, or on a GPU grid the controller's reading
    (``gpugrid.parse_profile``, then the grid's own catalog; None when
    the catalog lacks it)."""
    from instaslice_tpu_torch.controller.gpugrid import (
        group_profile,
        parse_profile,
    )
    from instaslice_tpu_torch.topology import parse_profile_name

    if _gpu_grid(generation):
        return group_profile(parse_profile(name), generation)
    return parse_profile_name(name)


def plan_hosts(group, pl) -> dict:
    """Each part of a placement: the reference's local chip ids of its
    host, or on a GPU grid its GPU index and memory slots."""
    from instaslice_tpu_torch.topology.mig import box_gpu_start

    hb = group.generation.host_bounds
    if not _gpu_grid(group.generation.name):
        return {pt.node_name: pt.local_chip_ids(hb) for pt in pl.parts}
    out = {}
    for pt in pl.parts:
        gpu, start = box_gpu_start(pl.box)
        out[pt.node_name] = {
            "gpu": gpu, "slots": list(range(start, start + pl.box.shape[0]))}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tpuslice-gpu", description="instaslice_tpu_torch operator CLI"
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    cat = sub.add_parser("catalog", help="print the profile catalog")
    cat.add_argument("generation",
                     help="TPU generation, e.g. v5e, or GPU grid, e.g. "
                          "h100-80gb")
    cat.add_argument("--max-chips", type=int, default=None)

    place = sub.add_parser("plan", help="simulate placing profiles on a mesh")
    place.add_argument("generation")
    place.add_argument("profiles", nargs="+",
                       help="e.g. v5e-2x2 v5e-1x1, or 3g.40gb gpu")
    place.add_argument("--hosts", type=int, default=1,
                       help="hosts of the mesh (GPUs on a GPU grid)")
    place.add_argument("--policy", default="best-fit")

    tr = sub.add_parser(
        "trace-summary",
        help="summarize spans from a TPUSLICE_TRACE_FILE JSONL or a "
        "live server's GET /v1/debug/trace (per-span p50/p95/max, "
        "slowest traces, single-trace drill-down)",
    )
    tr.add_argument("file", nargs="?", default="",
                    help="trace JSONL path (or use --url)")
    tr.add_argument("--url", default="",
                    help="live tpuslice-serve base url (e.g. "
                         "http://127.0.0.1:8000): read the in-memory "
                         "ring over GET /v1/debug/trace instead of a "
                         "file")
    tr.add_argument("--trace", default="", metavar="TRACE_ID",
                    help="dump every span of ONE trace (start order) "
                         "— the id an X-Trace-Id response header or a "
                         "slowest-traces row points at")
    tr.add_argument("--slowest", type=int, default=0, metavar="N",
                    help="also print the N slowest trace roots "
                         "(name, traceId, durationMs)")

    ev = sub.add_parser(
        "events",
        help="flight-recorder events from a TPUSLICE_EVENT_FILE JSONL "
        "or a live component's GET /v1/debug/events (one JSON line per "
        "event; --follow tails)",
    )
    ev.add_argument("file", nargs="?", default="",
                    help="event JSONL path (or use --url)")
    ev.add_argument("--url", default="",
                    help="live base url — a tpuslice-serve server or a "
                         "controller/agent health-probe address")
    ev.add_argument("--reason", default="",
                    help="only this reason (docs/OBSERVABILITY.md "
                         "catalog)")
    ev.add_argument("--object", default="",
                    help="only this objectRef (e.g. Pod/default/demo)")
    ev.add_argument("--trace", default="", metavar="TRACE_ID",
                    help="only events linked to this trace")
    ev.add_argument("--component", default="",
                    help="only this emitting component")
    ev.add_argument("-n", type=int, default=0, dest="last", metavar="N",
                    help="only the last N matching events")
    ev.add_argument("--follow", action="store_true",
                    help="keep tailing the source (Ctrl-C to stop)")

    fl = sub.add_parser(
        "fleet",
        help="fleet telemetry snapshot from a tpuslice-telemetry "
        "aggregator's GET /v1/fleet (goodput, per-class SLO "
        "attainment, burn-rate state, chip-hours); --follow polls, "
        "--trace renders one stitched cross-process timeline",
    )
    fl.add_argument("--url", required=True,
                    help="aggregator base URL (tpuslice-telemetry)")
    fl.add_argument("--trace", default="",
                    help="print the stitched timeline for this trace "
                    "id instead of the rollup snapshot")
    fl.add_argument("--follow", action="store_true",
                    help="keep polling (Ctrl-C to stop)")
    fl.add_argument("--interval", type=float, default=2.0,
                    help="seconds between --follow polls")

    pr = sub.add_parser(
        "profile",
        help="continuous-profiler export from a live component's GET "
        "/v1/debug/profile: per-segment p50/p95 summary rows, or "
        "--out trace.json for a Perfetto-loadable Chrome trace-event "
        "timeline (rounds + engine events + tracer spans interleaved)",
    )
    pr.add_argument("--url", required=True,
                    help="live base url (tpuslice-serve replica, "
                         "router, probe port, or telemetry server)")
    pr.add_argument("--out", default="",
                    help="write Chrome trace-event JSON here (open in "
                         "Perfetto / chrome://tracing) instead of "
                         "printing the segment summary")
    pr.add_argument("-n", type=int, default=512, dest="last",
                    metavar="N",
                    help="how many recent rounds/events/spans to "
                         "export (default 512, bounded by the rings)")

    wf = sub.add_parser(
        "waterfall",
        help="one request's latency waterfall (queue → admission → "
        "prefill → decode/spec rounds → preempt/resume → finish), "
        "stitched from round records + journal + trace by rid or "
        "trace id (GET /v1/debug/profile?rid=...)",
    )
    wf.add_argument("rid",
                    help="engine request id (the integer in stream "
                         "payloads) or a trace id (X-Trace-Id header)")
    wf.add_argument("--url", required=True,
                    help="the serving replica's base url")
    wf.add_argument("--json", action="store_true", dest="as_json",
                    help="raw payload instead of the ASCII waterfall")

    de = sub.add_parser(
        "describe",
        help="one object's merged control-plane timeline: Kubernetes "
        "Events + CR audit trail + journal + trace spans — the 'why is "
        "my pod still gated?' answer",
    )
    de.add_argument("kind", choices=["pod", "locks"])
    de.add_argument("name", nargs="?", default="")
    de.add_argument("--url", default="",
                    help="component base URL for `describe locks` — "
                    "any /v1/debug surface (replica, router, or a "
                    "controller/agent probe port)")
    de.add_argument("--namespace", default="default")
    de.add_argument("--operator-namespace",
                    default="instaslice-tpu-system",
                    help="namespace holding the TpuSlice CRs")
    de.add_argument("--kubeconfig", default="")
    de.add_argument("--events-file", default="",
                    help="TPUSLICE_EVENT_FILE JSONL to merge in")
    de.add_argument("--trace-file", default="",
                    help="TPUSLICE_TRACE_FILE JSONL to merge in")
    de.add_argument("--json", action="store_true", dest="as_json")

    st = sub.add_parser(
        "status",
        help="cluster slice status: per-node chips, health, allocations "
        "(the `kubectl get` + `nvidia-smi` half of the reference's demo "
        "transcript, from the CRs)",
    )
    st.add_argument("--kubeconfig", default="")
    st.add_argument("--namespace", default="instaslice-tpu-system")
    st.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")

    sb = sub.add_parser(
        "serve-bench",
        help="decode tokens/sec of the serving engine on this host's "
        "card (BASELINE secondary metric: divide by chip count)",
    )
    sb.add_argument("--device", default="cuda",
                    help="torch device (default the card; 'cpu' runs the "
                         "plain versions in float32)")
    sb.add_argument("--d-model", type=int, default=512)
    sb.add_argument("--n-layers", type=int, default=4)
    sb.add_argument("--n-heads", type=int, default=8)
    sb.add_argument("--n-kv-heads", type=int, default=0,
                    help="grouped-query attention KV heads (0 = MHA)")
    sb.add_argument("--d-ff", type=int, default=2048)
    sb.add_argument("--vocab", type=int, default=32000)
    sb.add_argument("--batch", type=int, default=8)
    sb.add_argument("--max-len", type=int, default=256)
    sb.add_argument("--prefill-len", type=int, default=16)
    sb.add_argument("--steps", type=int, default=30)
    sb.add_argument("--window", type=int, default=0,
                    help="sliding-window attention (0 = full causal)")
    sb.add_argument("--quantize", action="store_true",
                    help="int8 weights + int8 KV cache")
    sb.add_argument("--spec", action="store_true",
                    help="speculative decoding (int8 self-draft, "
                         "lossless greedy): reports tokens/sec and "
                         "accepted tokens per verify round")

    args = p.parse_args(argv)

    if args.cmd == "serve-bench" and args.prefill_len > args.max_len:
        p.error(
            f"--prefill-len {args.prefill_len} must be <= --max-len "
            f"{args.max_len}"
        )
    if args.cmd == "serve-bench" and args.quantize and args.spec:
        p.error(
            "--quantize with --spec would make the draft IDENTICAL to "
            "the int8 target (guaranteed full acceptance, pure "
            "overhead); --spec already uses an int8 draft against the "
            "full-precision target — pick one"
        )

    if args.cmd == "serve-bench":
        return _serve_bench(args)

    if args.cmd == "status":
        from instaslice_tpu_torch.api.constants import KIND
        from instaslice_tpu_torch.api.types import TpuSlice
        from instaslice_tpu_torch.kube.real import build_client

        client = build_client(args.kubeconfig)
        nodes = []
        # multi-host allocations are fanned out to every participating
        # node's CR (controller/reconciler._write_allocation): merge by
        # allocation id so one slice is reported ONCE, with the union of
        # realized parts (the controller's own merged-view semantics)
        slices: dict = {}
        for m in sorted(
            client.list(KIND, namespace=args.namespace),
            key=lambda m: m["metadata"]["name"],
        ):
            ts = TpuSlice.from_manifest(m)
            nodes.append({
                "node": ts.name,
                "generation": ts.spec.generation,
                "chips": len(ts.spec.chips),
                "unhealthyChips": sorted(ts.status.unhealthy_chips),
                "prepared": len(ts.spec.prepared),
            })
            for aid, a in sorted(ts.spec.allocations.items()):
                s = slices.setdefault(aid, {
                    "id": aid,
                    "profile": a.profile,
                    "box": a.box,
                    "status": a.status.value,
                    "pods": sorted(p.pod_name for p in a.pods),
                    "nodes": sorted(a.parts),
                    "parts": len(a.parts),
                    "realizedOn": set(),
                })
                s["realizedOn"].update(a.realized_on)
        for s in slices.values():
            s["realizedOn"] = sorted(s["realizedOn"])
        out = {"nodes": nodes, "slices": sorted(
            slices.values(), key=lambda s: s["id"]
        )}
        if args.as_json:
            print(json.dumps(out))
            return 0
        if not nodes:
            print(f"no {KIND} objects in namespace {args.namespace}")
            return 0
        for n in nodes:
            bad = (f" unhealthy={n['unhealthyChips']}"
                   if n["unhealthyChips"] else "")
            print(f"{n['node']}: {n['generation']} chips={n['chips']}"
                  f" prepared={n['prepared']}{bad}")
        if out["slices"]:
            print("slices:")
        for s in out["slices"]:
            print(f"  {s['id'][:20]:<20} {s['profile']:<10} "
                  f"{s['box']:<14} {s['status']:<9} "
                  f"pods={','.join(s['pods'])} "
                  f"nodes={','.join(s['nodes'])} "
                  f"realized={len(s['realizedOn'])}/{s['parts']}")
        return 0

    if args.cmd == "trace-summary":
        return _trace_summary(p, args)

    if args.cmd == "events":
        try:
            return _events_cmd(p, args)
        except KeyboardInterrupt:
            return 0  # --follow's advertised stop path, not a crash

    if args.cmd == "fleet":
        try:
            return _fleet_cmd(args)
        except KeyboardInterrupt:
            return 0  # --follow's advertised stop path, not a crash

    if args.cmd == "profile":
        return _profile_cmd(args)

    if args.cmd == "waterfall":
        return _waterfall_cmd(args)

    if args.cmd == "describe" and args.kind == "locks":
        import urllib.request

        if not args.url:
            print(json.dumps(
                {"error": "describe locks needs --url <component>"}
            ))
            return 2
        try:
            with urllib.request.urlopen(
                args.url.rstrip("/") + "/v1/debug/locks", timeout=10
            ) as r:
                payload = json.loads(r.read().decode())
        except Exception as e:  # noqa: BLE001 - CLI: message, not trace
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
            return 1
        if args.as_json:
            print(json.dumps(payload))
        else:
            print(render_locks(payload))
        return 0

    if args.cmd == "describe":
        from instaslice_tpu_torch.kube.real import build_client

        if not args.name:
            print(json.dumps({"error": "describe pod needs a name"}))
            return 2
        client = build_client(args.kubeconfig)
        info = describe_pod(
            client, args.name, namespace=args.namespace,
            operator_namespace=args.operator_namespace,
            events_path=args.events_file, trace_path=args.trace_file,
        )
        if args.as_json:
            print(json.dumps(info))
        else:
            print(render_describe(info))
        return 0

    if args.cmd == "catalog":
        for prof in catalog_profiles(args.generation, args.max_chips):
            print(json.dumps({"name": prof.name, **prof.attributes()}))
        return 0

    if args.cmd == "plan":
        from instaslice_tpu_torch.topology import Occupancy, get_policy

        group = plan_group(args.generation, args.hosts)
        occ = Occupancy(group)
        pol = get_policy(args.policy)
        ok = True
        for i, name in enumerate(args.profiles):
            prof = plan_profile(name, args.generation)
            pl = None if prof is None else pol.choose(group, prof, occ)
            if pl is None:
                print(json.dumps({"request": name, "placed": False}))
                ok = False
                continue
            occ.occupy(pl.box, owner=str(i))
            print(
                json.dumps(
                    {
                        "request": name,
                        "placed": True,
                        "box": pl.box.key(),
                        "hosts": plan_hosts(group, pl),
                    }
                )
            )
        return 0 if ok else 1

    return 2


if __name__ == "__main__":
    sys.exit(main())
