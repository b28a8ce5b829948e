"""Validate a ``TPUSLICE_TRACE_FILE`` JSONL dump (and optionally
produce one first): the port's copy of ``tools/validate_trace.py``.

``python -m instaslice_tpu_torch.analysis.validate_trace TRACE.jsonl``
checks structural invariants every consumer of the trace format
(``tpuslice-gpu trace-summary``, the fleet stitcher) relies on:

- every line parses as a JSON object with ``name``, ``start``, and
  ``durationMs``;
- no negative durations;
- no orphan spans: a non-empty ``parentId`` must name a ``spanId``
  that exists in the same trace (span completion order means parents
  are written AFTER their children — the whole file is one unit);
- no duplicate ``spanId`` within a trace.

``--drive`` first GENERATES the file by running the observability
path end to end in-process — the port's SimCluster grants and tears
down one pod on a ``FakeGpuBackend`` H100 node (a ``1g.10gb`` MIG
slice), then a short loadgen burst runs against the port's live
ApiServer (on ``--device``: the card by default, ``cpu`` for the plain
versions), with ``TPUSLICE_TRACE_FILE`` pointed at the output — then
additionally asserts the propagation contract: one trace id links
``controller.allocate`` → ``device.reserve`` → ``controller.ungate``
(the grant), and every ``serve.request`` root has child spans in its
trace (the serving plane). This is the ``make gpu-trace-check`` gate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List


def validate(path: str) -> dict:
    """Structural validation. Returns a report dict; ``errors`` is the
    list that must stay empty for the file to pass."""
    errors: List[str] = []
    spans: List[dict] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {lineno}: unparseable JSONL: {e}")
                continue
            if not isinstance(rec, dict):
                errors.append(f"line {lineno}: not a JSON object")
                continue
            missing = [k for k in ("name", "start", "durationMs")
                       if k not in rec]
            if missing:
                errors.append(f"line {lineno}: missing {missing}")
                continue
            if rec["durationMs"] < 0:
                errors.append(
                    f"line {lineno}: negative duration "
                    f"{rec['durationMs']} on span {rec['name']!r}"
                )
            spans.append(rec)

    # per-trace span-id index for orphan + duplicate detection
    by_trace: Dict[str, Dict[str, dict]] = {}
    for rec in spans:
        tid = rec.get("traceId", "")
        sid = rec.get("spanId", "")
        if not sid:
            continue
        ids = by_trace.setdefault(tid, {})
        if sid in ids:
            errors.append(
                f"duplicate spanId {sid!r} in trace {tid!r} "
                f"({ids[sid]['name']!r} vs {rec['name']!r})"
            )
        ids[sid] = rec
    for rec in spans:
        pid = rec.get("parentId", "")
        if pid and pid not in by_trace.get(rec.get("traceId", ""), {}):
            errors.append(
                f"orphan span {rec['name']!r} "
                f"(spanId {rec.get('spanId')!r}): parentId {pid!r} "
                f"not in trace {rec.get('traceId')!r}"
            )

    names: Dict[str, int] = {}
    for rec in spans:
        names[rec["name"]] = names.get(rec["name"], 0) + 1
    return {
        "file": path,
        "spans": len(spans),
        "traces": len(by_trace),
        "names": names,
        "errors": errors,
        # the parsed spans, for check_propagation: re-reading the file
        # would crash on exactly the corrupt lines validate() already
        # reported, hiding the real finding behind a traceback
        "_spans": spans,
    }


def check_propagation(report: dict) -> None:
    """--drive extra: the trace file must PROVE end-to-end propagation,
    not just parse. Appends to ``report['errors']``."""
    spans = report["_spans"]
    by_trace: Dict[str, List[dict]] = {}
    for rec in spans:
        by_trace.setdefault(rec.get("traceId", ""), []).append(rec)

    # one grant trace spans controller → device → ungate
    grant_ok = any(
        {"controller.allocate", "device.reserve", "controller.ungate"}
        <= {s["name"] for s in trace}
        for trace in by_trace.values()
    )
    if not grant_ok:
        report["errors"].append(
            "no trace links controller.allocate + device.reserve + "
            "controller.ungate — grant-path propagation is broken"
        )
    # every serving request's trace has children beside the root
    roots = [s for s in spans if s["name"] == "serve.request"]
    if not roots:
        report["errors"].append("no serve.request spans in the file")
    for root in roots:
        kids = [s for s in by_trace.get(root.get("traceId", ""), [])
                if s.get("parentId")]
        if not kids:
            report["errors"].append(
                f"serve.request trace {root.get('traceId')!r} has no "
                "child spans — serving-plane propagation is broken"
            )


def drive(path: str, device: str = "cuda") -> None:
    """Produce ``path``: a pod grant/teardown in the sim plus a short
    loadgen burst against a live ApiServer on ``device``, all traced to
    the file."""
    from instaslice_tpu_torch import resolve_device

    resolve_device(device)  # no card: fail before anything runs
    if os.path.exists(path):
        os.unlink(path)
    os.environ["TPUSLICE_TRACE_FILE"] = path
    from instaslice_tpu_torch.utils.trace import reset_tracer

    reset_tracer()  # re-read the env: all spans now stream to `path`
    try:
        from instaslice_tpu_torch.analysis.drive import (
            PROFILE,
            sim_cluster,
            tiny_engine,
        )

        with sim_cluster() as c:
            c.submit("trace-check", PROFILE)
            assert c.wait_phase("trace-check", "Running", timeout=30), \
                "sim pod never reached Running"
            c.delete_pod("trace-check")
            assert c.wait_gone("trace-check", timeout=30), \
                "sim pod never tore down"

        from instaslice_tpu_torch.serving import loadgen
        from instaslice_tpu_torch.serving.api_server import ApiServer

        with ApiServer(tiny_engine(device), block_size=4) as srv:
            report = loadgen.run(srv.url, requests=6, concurrency=2,
                                 prompt_len=4, max_tokens=4, vocab=64,
                                 stream=False, timeout=60)
            assert report["outcomes"]["hung"] == 0, report
            assert report["ok"] > 0, report
    finally:
        del os.environ["TPUSLICE_TRACE_FILE"]
        reset_tracer()  # close the file handle (and detach the env)


def check_fleet(paths: List[str]) -> dict:
    """``--fleet``: merge every collected file into ONE
    :class:`~instaslice_tpu_torch.obs.telemetry.TraceStitcher` store and
    check for orphan parents ACROSS files. Per-file validation can
    pass while the fleet view is broken — a child span's parent may
    live in another process's file; only the merged view proves the
    collection set is complete."""
    from instaslice_tpu_torch.obs.telemetry import TraceStitcher

    stitcher = TraceStitcher()
    total = 0
    for path in paths:
        total += stitcher.ingest_file(path)
    orphans = stitcher.orphans()
    return {
        "files": len(paths),
        "spans_ingested": total,
        "traces": len(stitcher.trace_ids()),
        "orphans": len(orphans),
        "orphan_examples": [
            {"name": s.get("name"), "traceId": s.get("traceId"),
             "parentId": s.get("parentId")}
            for s in orphans[:10]
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="validate_trace")
    ap.add_argument("file", nargs="+",
                    help="trace JSONL path(s); several only with "
                         "--fleet")
    ap.add_argument("--drive", action="store_true",
                    help="first generate the file by running the sim "
                         "+ a short serving loadgen with "
                         "TPUSLICE_TRACE_FILE set, then also check "
                         "the propagation contract")
    ap.add_argument("--device", default="cuda",
                    help="--drive's serving model: cuda (default; raises "
                         "without a card) or cpu (the plain versions)")
    ap.add_argument("--fleet", action="store_true",
                    help="merge every given file into one stitched "
                         "store and fail on orphan parents ACROSS "
                         "files (the fleet-collection completeness "
                         "check)")
    args = ap.parse_args(argv)
    if len(args.file) > 1 and not args.fleet:
        ap.error("multiple files need --fleet")
    if args.drive:
        drive(args.file[0], args.device)
    report = validate(args.file[0])
    for extra in args.file[1:]:
        sub = validate(extra)
        report["spans"] += sub["spans"]
        report["traces"] += sub["traces"]
        report["errors"] += sub["errors"]
    if args.fleet:
        # per-file orphan findings are FALSE failures in fleet mode: a
        # child's parent legitimately lives in another process's file;
        # the merged store below is the authoritative orphan check
        report["errors"] = [
            e for e in report["errors"]
            if not e.startswith("orphan span ")
        ]
    if args.drive:
        check_propagation(report)
    out = {
        "file": report["file"] if len(args.file) == 1 else args.file,
        "spans": report["spans"],
        "traces": report["traces"],
        "span_names": len(report["names"]),
        "errors": report["errors"][:20],
    }
    if args.fleet:
        fleet = check_fleet(args.file)
        out["fleet"] = fleet
        if fleet["orphans"]:
            report["errors"].append(
                f"{fleet['orphans']} orphan parent(s) across the "
                f"merged fleet store"
            )
            out["errors"] = report["errors"][:20]
    out["ok"] = not report["errors"]
    print(json.dumps(out))
    return 0 if not report["errors"] else 1


if __name__ == "__main__":
    sys.exit(main())
