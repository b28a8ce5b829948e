"""Validate a ``TPUSLICE_EVENT_FILE`` JSONL dump (and optionally
produce one first): the port's copy of ``tools/validate_events.py``.

``python -m instaslice_tpu_torch.analysis.validate_events EVENTS.jsonl``
checks the structural invariants every consumer of the flight-recorder
format (``tpuslice-gpu events`` / ``describe pod``, the debug endpoints,
the fleet stitcher) relies on:

- every line parses as a JSON object with ``seq``, ``ts``,
  ``component``, and ``reason``;
- ``seq`` values are unique (the ring is the ordering authority; file
  line order may interleave across threads);
- every ``reason`` comes from the port's ``api/constants.py`` catalog
  (the reference's reasons, with the reference's values);
- allocation transition chains are complete and ordered: for each
  ``alloc/<id>``, the status sequence (split into epochs at each fresh
  ``creating`` — a controller retry tears down and re-places under a
  new trace) follows the legal transition graph, every transition
  event carries a non-empty ``traceId``, one trace id spans the whole
  epoch, and any granted epoch shows creating → created → ungated in
  order.

Transition events are emitted at the ``set_status`` decision point; a
CR write can still lose an optimistic-concurrency race, so chaos-grade
callers pass ``strict=False`` to :func:`check_chains`, which forgives a
"phantom" edge that is legal from an *earlier* status of the same epoch
(a stale read whose write never landed). The ``make events-check``
drive is quiet enough to validate strictly.

``--drive`` first GENERATES the file: the port's SimCluster (one
``FakeGpuBackend`` H100 node, MIG on) grants one clean ``1g.10gb`` pod
and one whose first reservation fails (injected device error →
``failed`` epoch → retry → grant), renders ``tpuslice-gpu describe pod``
for both against the live fake API (asserting the merged
event/audit/trace timeline), then runs a short loadgen burst plus a
drain/undrain cycle through the port's live ApiServer (on ``--device``).
This is the ``make gpu-events-check`` gate.

:func:`read_events` is the structural half alone, for a file whose
allocation chains continue in another process's file (the controller's
and the node agent's journals each hold part of a grant's chain): merge
such files' events by ``ts``, number them anew (``seq`` counts per
process, and :func:`check_chains` orders an allocation's events by it)
and run :func:`check_chains` over the merged list.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from instaslice_tpu_torch.api.constants import (
    EVENT_REASONS,
    REASON_ADMITTED,
    REASON_APISERVER_UNREACHABLE,
    REASON_CRASH_RECOVERED,
    REASON_DEGRADED_ENTERED,
    REASON_DEGRADED_EXITED,
    REASON_DRAIN_BEGIN,
    REASON_DRAIN_END,
    REASON_WRITE_FENCED,
    TRANSITION_REASONS,
)

#: reason → allocation status value (the inverse of TRANSITION_REASONS)
TRANSITION_STATUS = {r: s for s, r in TRANSITION_REASONS.items()}


def _legal_edges() -> Dict[str, set]:
    from instaslice_tpu_torch.api.types import _TRANSITIONS

    return {
        old.value: {new.value for new in news}
        for old, news in _TRANSITIONS.items()
    }


def check_chains(events: List[dict], strict: bool = True) -> List[str]:
    """Transition-chain invariants over parsed event dicts (the journal
    ring's ``to_dict`` shape == the JSONL shape). Reusable by the chaos
    tier against the in-memory ring."""
    errors: List[str] = []
    legal = _legal_edges()
    by_alloc: Dict[str, List[dict]] = {}
    for rec in events:
        ref = rec.get("objectRef", "")
        if rec.get("reason") in TRANSITION_STATUS and \
                ref.startswith("alloc/"):
            by_alloc.setdefault(ref, []).append(rec)

    for ref, recs in sorted(by_alloc.items()):
        recs.sort(key=lambda r: r.get("seq", 0))
        # epochs: each fresh `creating` after prior history is a
        # re-placement (retry) — chains restart there
        epochs: List[List[dict]] = []
        cur: List[dict] = []
        for rec in recs:
            if TRANSITION_STATUS[rec["reason"]] == "creating" and cur:
                epochs.append(cur)
                cur = []
            cur.append(rec)
        if cur:
            epochs.append(cur)
        for n, epoch in enumerate(epochs):
            statuses = [TRANSITION_STATUS[r["reason"]] for r in epoch]
            if statuses[0] != "creating":
                errors.append(
                    f"{ref} epoch {n}: chain starts at "
                    f"{statuses[0]!r}, not 'creating'"
                )
                continue
            seen = {statuses[0]}
            prev = statuses[0]
            for st in statuses[1:]:
                if st == prev:  # idempotent re-emit (conflict retry)
                    continue
                if st in legal[prev]:
                    seen.add(st)
                    prev = st
                    continue
                # stale-read phantom: legal from an EARLIER status of
                # this epoch — tolerated only in non-strict mode. The
                # phantom may be EITHER side of the illegal pair (a
                # failed that lost to a concurrent promote reads as
                # creating→failed→created→ungated), so re-anchor the
                # chain on the tolerated status rather than keeping
                # the possibly-phantom prev.
                if not strict and any(st in legal[s] for s in seen):
                    seen.add(st)
                    prev = st
                    continue
                errors.append(
                    f"{ref} epoch {n}: illegal transition "
                    f"{prev!r} -> {st!r} (chain {statuses})"
                )
                prev = st
                seen.add(st)
            tids = {r.get("traceId", "") for r in epoch}
            if "" in tids:
                errors.append(
                    f"{ref} epoch {n}: transition event without a "
                    "traceId — the grant trace link is broken"
                )
            elif len(tids) > 1:
                errors.append(
                    f"{ref} epoch {n}: {len(tids)} trace ids in one "
                    f"epoch ({sorted(tids)})"
                )
            if "ungated" in statuses:
                order = [statuses.index(s)
                         for s in ("creating", "created", "ungated")
                         if s in statuses]
                if len(order) < 3 or order != sorted(order):
                    errors.append(
                        f"{ref} epoch {n}: granted without a complete "
                        f"creating->created->ungated chain ({statuses})"
                    )
    return errors


def check_epochs(events: List[dict]) -> List[str]:
    """Crash-chaos chain invariants (``--epochs``, docs/RECOVERY.md):
    transition chains must stay legal *across restart epochs*.

    Chains are split on two boundaries: the ``attempt_epoch`` attr the
    transition choke point stamps (the precise placement-epoch fence)
    and ``CrashRecovered`` markers (component restarts and recovery
    re-grants emit them; they split an alloc's chain for events
    predating the attr). Within a group the walk is lenient the way
    ``check_chains(strict=False)`` is — crash journals are full of
    catch-up re-writes and stale-read phantoms — but two invariants
    are strict:

    - each restart epoch's transitions must be reachable (legal from
      the previous status or some earlier status of the same group);
    - no grant chain may be ABANDONED: every superseded attempt epoch
      must end ``deleted``, and the final attempt epoch must end
      ``ungated`` (granted) or ``deleted`` (cleanly torn down).
    """
    errors: List[str] = []
    legal = _legal_edges()
    global_marks = sorted(
        r.get("seq", 0) for r in events
        if r.get("reason") == REASON_CRASH_RECOVERED
        and str(r.get("objectRef", "")).startswith("component/")
    )
    alloc_marks: Dict[str, List[int]] = {}
    by_alloc: Dict[str, List[dict]] = {}
    for rec in events:
        ref = str(rec.get("objectRef", ""))
        if not ref.startswith("alloc/"):
            continue
        if rec.get("reason") == REASON_CRASH_RECOVERED:
            alloc_marks.setdefault(ref, []).append(rec.get("seq", 0))
        elif rec.get("reason") in TRANSITION_STATUS:
            by_alloc.setdefault(ref, []).append(rec)

    for ref, recs in sorted(by_alloc.items()):
        recs.sort(key=lambda r: r.get("seq", 0))
        marks = sorted(set(global_marks) | set(alloc_marks.get(ref, [])))

        def group_of(rec) -> int:
            attr = (rec.get("attrs") or {}).get("attempt_epoch")
            if attr is not None:
                return int(attr)
            # pre-attr events: the count of markers before this seq is
            # its restart-epoch ordinal (kept distinct from real
            # attempt epochs by the negative sign)
            seq = rec.get("seq", 0)
            return -sum(1 for m in marks if m < seq) - 1

        groups: Dict[int, List[dict]] = {}
        for rec in recs:
            groups.setdefault(group_of(rec), []).append(rec)
        # order groups chronologically by their first seq
        ordered = sorted(
            groups.items(), key=lambda kv: kv[1][0].get("seq", 0)
        )
        final_statuses: List[str] = []
        for gid, grecs in ordered:
            seen: set = set()
            prev: Optional[str] = None
            for rec in grecs:
                st = TRANSITION_STATUS[rec["reason"]]
                if prev is None or st == "creating":
                    # a fresh creating restarts the sub-chain (retry
                    # re-placement inside one attempt epoch)
                    seen = {st}
                    prev = st
                    continue
                if st == prev:
                    continue
                if st in legal[prev] or any(
                    st in legal[s] for s in seen
                ):
                    seen.add(st)
                    prev = st
                    continue
                errors.append(
                    f"{ref} attempt-epoch group {gid}: illegal "
                    f"transition {prev!r} -> {st!r}"
                )
                seen.add(st)
                prev = st
            final_statuses.append(prev or "")
        for st in final_statuses[:-1]:
            if st != "deleted":
                errors.append(
                    f"{ref}: superseded attempt epoch abandoned in "
                    f"{st!r} (must end 'deleted')"
                )
        if final_statuses and final_statuses[-1] not in (
            "ungated", "deleted"
        ):
            errors.append(
                f"{ref}: grant chain abandoned in "
                f"{final_statuses[-1]!r} without a terminal reason"
            )
    return errors


def check_nemesis(events: List[dict]) -> List[str]:
    """Partition-chaos invariants (``--nemesis``, docs/RECOVERY.md):
    replay the journal across partition epochs and prove split-brain
    safety end to end. Every nemesis scenario ends in a timed heal, so
    the journal under inspection must describe a CONVERGED run:

    - degraded-mode pairing: every ``DegradedModeEntered`` is preceded
      by an ``ApiServerUnreachable`` from the same component and
      followed by a heal-side ``DegradedModeExited`` (the agent's
      durable-truth reconcile on heal emits it);
    - fence attribution: every ``WriteFenced`` event names the
      component whose stale-epoch write was refused;
    - no grant double-placed: at any journal instant at most ONE
      allocation per pod (linked through the ``Admitted`` event's
      trace id) is in the granted state — a second simultaneous grant
      means a deposed leader's write slipped the epoch fence;
    - no slice leaks: every allocation chain ends granted (still
      serving) or ``deleted`` (torn down) — an alloc abandoned
      mid-flight past heal is a leaked chip reservation.
    """
    errors: List[str] = []

    # degraded-mode pairing (per component, in seq order)
    open_degraded: Dict[str, int] = {}
    unreachable: Dict[str, int] = {}
    for rec in events:
        comp = str(rec.get("component", ""))
        reason = rec.get("reason")
        if reason == REASON_APISERVER_UNREACHABLE:
            unreachable[comp] = unreachable.get(comp, 0) + 1
        elif reason == REASON_DEGRADED_ENTERED:
            if comp not in unreachable:
                errors.append(
                    f"{comp}: DegradedModeEntered without a preceding "
                    "ApiServerUnreachable — the trigger is unjournaled"
                )
            open_degraded[comp] = open_degraded.get(comp, 0) + 1
        elif reason == REASON_DEGRADED_EXITED:
            if not open_degraded.get(comp):
                errors.append(
                    f"{comp}: DegradedModeExited without a matching "
                    "DegradedModeEntered"
                )
            else:
                open_degraded[comp] -= 1
        elif reason == REASON_WRITE_FENCED and not comp:
            errors.append(
                f"seq {rec.get('seq')}: WriteFenced without a "
                "component — the deposed writer is unattributable"
            )
    for comp, n in sorted(open_degraded.items()):
        if n:
            errors.append(
                f"{comp}: {n} DegradedModeEntered never paired with a "
                "heal-side DegradedModeExited — the scenario must end "
                "healed and reconciled"
            )

    # double-place + leak sweep across partition epochs
    trace_pod: Dict[str, str] = {}
    for rec in events:
        if rec.get("reason") == REASON_ADMITTED and rec.get("traceId"):
            trace_pod[rec["traceId"]] = str(rec.get("objectRef", ""))
    granted: Dict[str, str] = {}    # owner pod -> alloc ref holding the grant
    status: Dict[str, str] = {}     # alloc ref -> last status
    for rec in events:
        st = TRANSITION_STATUS.get(rec.get("reason", ""))
        ref = str(rec.get("objectRef", ""))
        if st is None or not ref.startswith("alloc/"):
            continue
        tid = rec.get("traceId", "")
        # an alloc without an Admitted link degrades to per-trace
        # (then per-alloc) grouping — still catches same-grant splits
        pod = trace_pod.get(tid, tid or ref)
        status[ref] = st
        if st == "ungated":
            cur = granted.get(pod)
            if cur is not None and cur != ref:
                errors.append(
                    f"{pod}: double-placed — {cur} and {ref} granted "
                    "simultaneously (a stale-epoch write slipped the "
                    "lease fence)"
                )
            granted[pod] = ref
        elif st in ("deleted", "failed", "creating") \
                and granted.get(pod) == ref:
            # a grant holder leaving the granted state releases the
            # slot (creating = a fresh retry epoch for the same id)
            del granted[pod]
    for ref in sorted(status):
        if status[ref] not in ("deleted", "ungated"):
            errors.append(
                f"{ref}: slice leak — chain ends {status[ref]!r} "
                "after heal (neither granted nor torn down)"
            )
    return errors


def read_events(path: str) -> Tuple[List[dict], List[str]]:
    """The structural half of :func:`validate`: the file's events in
    ``seq`` order and the errors of its lines (unparseable, a field
    missing, a reason outside the catalog, a duplicate ``seq``)."""
    errors: List[str] = []
    events: List[dict] = []
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
            missing = [k for k in ("seq", "ts", "component", "reason")
                       if k not in rec]
            if missing:
                errors.append(f"line {lineno}: missing {missing}")
                continue
            if rec["reason"] not in EVENT_REASONS:
                errors.append(
                    f"line {lineno}: unknown reason {rec['reason']!r} "
                    "— reasons live in instaslice_tpu_torch/api/"
                    "constants.py"
                )
            events.append(rec)

    seqs = [r["seq"] for r in events]
    if len(seqs) != len(set(seqs)):
        dupes = sorted({s for s in seqs if seqs.count(s) > 1})
        errors.append(f"duplicate seq values: {dupes[:10]}")
    events.sort(key=lambda r: r["seq"])
    return events, errors


def validate(path: str, strict: bool = True,
             epochs: bool = False) -> dict:
    """Structural + chain validation of one JSONL file. ``errors`` must
    stay empty for the file to pass. ``epochs=True`` swaps the chain
    check for :func:`check_epochs` (crash-chaos journals: chains legal
    across restart epochs, no abandoned grants)."""
    events, errors = read_events(path)
    if epochs:
        errors.extend(check_epochs(events))
    else:
        errors.extend(check_chains(events, strict=strict))

    reasons: Dict[str, int] = {}
    for rec in events:
        reasons[rec["reason"]] = reasons.get(rec["reason"], 0) + 1
    return {
        "file": path,
        "events": len(events),
        "reasons": reasons,
        "errors": errors,
        "_events": events,
    }


def check_drive_expectations(report: dict, granted_text: str,
                             faulted_text: str) -> None:
    """--drive extra: the file must PROVE the flight-recorder contract,
    not just parse. Appends to ``report['errors']``."""
    events = report["_events"]
    reasons = report["reasons"]

    # a granted chain whose Admitted event shares the grant's trace id
    granted = False
    for rec in events:
        if rec.get("reason") == TRANSITION_REASONS["ungated"]:
            tid = rec.get("traceId", "")
            if tid and any(
                r.get("reason") == REASON_ADMITTED
                and r.get("traceId") == tid
                for r in events
            ):
                granted = True
                break
    if not granted:
        report["errors"].append(
            "no granted chain links an Admitted event to its "
            "SliceUngated transition by trace id"
        )
    if "failed" not in {
        TRANSITION_STATUS.get(r.get("reason", "")) for r in events
    }:
        report["errors"].append(
            "no failed epoch in the drive — the injected device fault "
            "never surfaced as a SliceFailed transition"
        )
    for want in (REASON_DRAIN_BEGIN, REASON_DRAIN_END):
        if not reasons.get(want):
            report["errors"].append(
                f"serving plane emitted no {want} event"
            )
    for label, text, needles in (
        ("granted", granted_text,
         ("SliceUngated", "controller.allocate", "Admitted")),
        ("faulted", faulted_text,
         ("SliceFailed", "SliceRealizeFailed")),
    ):
        if label == "faulted":
            ok = any(n in text for n in needles)
        else:
            ok = all(n in text for n in needles)
        if not ok:
            report["errors"].append(
                f"describe-pod rendering for the {label} pod is missing "
                f"expected entries {needles}; got:\n{text}"
            )


def drive(path: str, device: str = "cuda") -> tuple:
    """Produce ``path``: one clean grant, one faulted-then-retried
    grant, describe-pod renderings for both, then a serving burst on
    ``device`` with a drain/undrain cycle — all recorded to the file.
    Returns the two describe renderings."""
    from instaslice_tpu_torch import resolve_device

    resolve_device(device)  # no card: fail before anything runs
    if os.path.exists(path):
        os.unlink(path)
    trace_path = tempfile.mktemp(prefix="tpuslice-events-check-trace.",
                                 suffix=".jsonl")
    os.environ["TPUSLICE_EVENT_FILE"] = path
    os.environ["TPUSLICE_TRACE_FILE"] = trace_path
    from instaslice_tpu_torch.obs.journal import reset_journal
    from instaslice_tpu_torch.utils.trace import reset_tracer

    reset_journal()  # re-read the env: events now stream to `path`
    reset_tracer()
    granted_text = faulted_text = ""
    try:
        from instaslice_tpu_torch.analysis.drive import (
            PROFILE,
            sim_cluster,
            tiny_engine,
        )
        from instaslice_tpu_torch.cli.tpuslicectl import (
            describe_pod,
            render_describe,
        )

        with sim_cluster() as c:
            # the faulted pod: its first reservation raises, so the
            # allocation runs creating → failed → deleted, then the
            # controller re-places it and the retry epoch grants
            c.backends["node-0"].inject_failures("reserve", 1)
            c.submit("events-faulted", PROFILE)
            assert c.wait_phase("events-faulted", "Running", timeout=30), \
                "faulted sim pod never recovered to Running"
            c.submit("events-granted", PROFILE)
            assert c.wait_phase("events-granted", "Running", timeout=30), \
                "sim pod never reached Running"
            # the pod runs once its gate is gone, and the controller
            # persists the allocation's ungated status after that: the
            # rendering waits for the status (the reference's drive
            # renders at once and can miss SliceUngated under load)
            deadline = time.monotonic() + 30
            while True:
                granted = describe_pod(c.kube, "events-granted",
                                       events_path=path,
                                       trace_path=trace_path)
                if (granted["allocation"] or {}).get("status") == \
                        "ungated" or time.monotonic() > deadline:
                    break
                # bounded observer poll of the sim; nothing to interrupt
                time.sleep(0.02)  # slicelint: disable=sleep-in-loop
            granted_text = render_describe(granted)
            faulted_text = render_describe(describe_pod(
                c.kube, "events-faulted", events_path=path,
                trace_path=trace_path,
            ))
            c.delete_pod("events-granted")
            c.delete_pod("events-faulted")
            assert c.wait_gone("events-granted", timeout=30)
            assert c.wait_gone("events-faulted", timeout=30)

        from instaslice_tpu_torch.serving import loadgen
        from instaslice_tpu_torch.serving.api_server import ApiServer

        with ApiServer(tiny_engine(device), block_size=4) as srv:
            report = loadgen.run(srv.url, requests=6, concurrency=2,
                                 prompt_len=4, max_tokens=4, vocab=64,
                                 stream=False, timeout=60)
            assert report["outcomes"]["hung"] == 0, report
            assert report["ok"] > 0, report
            srv.drain(0.5)
            assert srv.wait_drained(10), "drain never quiesced"
            srv.undrain()
    finally:
        del os.environ["TPUSLICE_EVENT_FILE"]
        del os.environ["TPUSLICE_TRACE_FILE"]
        reset_journal()  # close the file handle (and detach the env)
        reset_tracer()
        if os.path.exists(trace_path):
            os.unlink(trace_path)
    return granted_text, faulted_text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="validate_events")
    ap.add_argument("file", help="event JSONL path")
    ap.add_argument("--drive", action="store_true",
                    help="first generate the file by running a sim "
                         "grant + an injected-fault retry + a serving "
                         "drain cycle with TPUSLICE_EVENT_FILE set, "
                         "then also check the flight-recorder contract")
    ap.add_argument("--device", default="cuda",
                    help="--drive's serving model: cuda (default; raises "
                         "without a card) or cpu (the plain versions)")
    ap.add_argument("--lenient", action="store_true",
                    help="tolerate stale-read phantom transitions "
                         "(chaos-grade files)")
    ap.add_argument("--epochs", action="store_true",
                    help="crash-chaos mode: split chains on "
                         "attempt-epoch stamps / CrashRecovered "
                         "markers, require each restart epoch legal "
                         "and no grant chain abandoned without a "
                         "terminal reason (docs/RECOVERY.md)")
    ap.add_argument("--nemesis", action="store_true",
                    help="partition-chaos mode (composes with the "
                         "chain check): degraded-mode entries pair "
                         "with heal-side exits, WriteFenced events "
                         "attribute the deposed writer, no grant is "
                         "double-placed across partition epochs, no "
                         "slice leaks past heal")
    args = ap.parse_args(argv)
    granted_text = faulted_text = ""
    if args.drive:
        granted_text, faulted_text = drive(args.file, args.device)
    report = validate(args.file, strict=not args.lenient,
                      epochs=args.epochs)
    if args.nemesis:
        report["errors"].extend(check_nemesis(report["_events"]))
    if args.drive:
        check_drive_expectations(report, granted_text, faulted_text)
    print(json.dumps({
        "file": report["file"],
        "events": report["events"],
        "reasons": report["reasons"],
        "errors": report["errors"][:20],
        "ok": not report["errors"],
    }))
    return 0 if not report["errors"] else 1


if __name__ == "__main__":
    sys.exit(main())
