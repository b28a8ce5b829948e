"""``tpuslice-gpu`` (``instaslice_tpu_torch/cli/tpuslicectl.py``) against
the reference's ``tpuslice`` (``instaslice_tpu/cli/tpuslicectl.py``).

- ``status`` and ``describe pod`` of both CLIs read ONE live cluster (the
  reference's ``SimCluster`` on v5e over HTTP, a granted pod and a
  two-host group) through one JSON kubeconfig: their outputs are equal.
  ``catalog`` and ``plan`` on v5e equal the reference's line for line.
- The GPU rules, each beside a control that puts the reference's rule
  back and misses: ``plan h100-80gb`` reads MIG names through
  ``controller/gpugrid`` (the reference's ``parse_profile_name`` raises),
  places on ``mig.gpu_group`` (the reference's hosts side by side along x
  put GPU 1 beside GPU 0's slots) and prints GPU indices and slots (the
  reference's local chip ids are memory slots there); ``catalog
  h100-80gb`` lists the whole GPU as a node's CR does (the reference's
  catalog leaves it out).
- ``serve-bench --device cpu`` prints the reference's keys with
  ``backend`` ``cpu``; ``--quantize --spec`` and a prefill longer than
  ``--max-len`` are refused as the reference refuses them.
"""

import json

import pytest

from instaslice_tpu.cli import tpuslicectl as rctl
from instaslice_tpu_torch.cli import tpuslicectl as tctl
from instaslice_tpu_torch.topology import parse_profile_name


def _run(capsys, main, argv):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _lines(out):
    return [json.loads(x) for x in out.strip().splitlines()]


# ------------------------------------------------------- one live cluster


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The reference's SimCluster over HTTP (three hosts on one torus), a
    v5e-4x4 group of two across two hosts and a v5e-2x2 pod granted, and
    a kubeconfig for it."""
    from instaslice_tpu.sim import SimCluster

    c = SimCluster(n_nodes=3, generation="v5e", deletion_grace_seconds=0.2,
                   transport="http").start()
    try:
        for w in (0, 1):
            c.submit(f"mh-w{w}", profile="v5e-4x4", group="mh",
                     group_size=2)
        assert c.wait_phase("mh-w1", "Running", timeout=30)
        c.submit("ctl-pod", profile="v5e-2x2")
        for name in ("ctl-pod", "mh-w0", "mh-w1"):
            assert c.wait_phase(name, "Running", timeout=30), name
        path = tmp_path_factory.mktemp("ctl") / "kubeconfig.json"
        path.write_text(json.dumps({
            "apiVersion": "v1", "kind": "Config", "current-context": "sim",
            "contexts": [{"name": "sim",
                          "context": {"cluster": "sim", "user": "u"}}],
            "clusters": [{"name": "sim",
                          "cluster": {"server": c.server.url}}],
            "users": [{"name": "u", "user": {"token": "t"}}]}))
        # every record ungated and realized on each part: nothing moves
        # between the two CLIs' reads
        for _ in range(500):
            allocs = c.allocations().values()
            if len(allocs) == 2 and all(
                    a["status"] == "ungated"
                    and len(a["realizedOn"]) == len(a["parts"])
                    for a in allocs):
                break
            __import__("time").sleep(0.02)
        yield c, str(path)
    finally:
        c.stop()


@pytest.mark.parametrize("argv", [
    ["status", "--json"],
    ["status"],
    ["status", "--namespace", "nothing-here"],
    ["describe", "pod", "ctl-pod", "--json"],
    ["describe", "pod", "mh-w1", "--json"],
    ["describe", "pod", "ctl-pod"],
    ["describe", "pod", "no-such-pod", "--json"],
])
def test_status_and_describe_equal_the_reference(cluster, capsys, argv):
    _, kubeconfig = cluster
    argv = argv[:1] + argv[1:] + ["--kubeconfig", kubeconfig]
    want = _run(capsys, rctl.main, argv)
    got = _run(capsys, tctl.main, argv)
    assert got == want
    assert got[0] == 0 and got[1]


def test_status_reads_the_grants(cluster, capsys):
    _, kubeconfig = cluster
    rc, out = _run(capsys, tctl.main,
                   ["status", "--kubeconfig", kubeconfig, "--json"])
    data = json.loads(out)
    assert rc == 0 and [n["node"] for n in data["nodes"]] == \
        ["node-0", "node-1", "node-2"]
    by = {s["profile"]: s for s in data["slices"]}
    assert by["v5e-2x2"]["pods"] == ["ctl-pod"]
    assert len(by["v5e-4x4"]["nodes"]) == 2
    assert by["v5e-4x4"]["pods"] == ["mh-w0", "mh-w1"]
    assert len(by["v5e-4x4"]["realizedOn"]) == 2


def test_describe_timeline_orders_the_decisions(cluster, capsys):
    _, kubeconfig = cluster
    rc, out = _run(capsys, tctl.main, ["describe", "pod", "ctl-pod",
                                       "--kubeconfig", kubeconfig, "--json"])
    reasons = [t["reason"] for t in json.loads(out)["timeline"]]
    idx = [reasons.index(r) for r in ("Admitted", "Placed", "Ungated")]
    assert rc == 0 and idx == sorted(idx)


# --------------------------------------------------- catalog and plan, v5e


@pytest.mark.parametrize("argv", [
    ["catalog", "v5e"],
    ["catalog", "v5e", "--max-chips", "4"],
    ["catalog", "v4"],
    ["plan", "v5e", "v5e-2x2", "v5e-1x1"],
    ["plan", "v5e", "v5e-4x4", "v5e-2x4", "v5e-2x2", "--hosts", "2"],
    ["plan", "v5e", "v5e-2x4", "v5e-2x4", "v5e-1x1", "--policy",
     "first-fit"],
    ["plan", "v4", "v4-2x2x2", "v4-2x2x1"],
])
def test_catalog_and_plan_on_v5e_equal_the_reference(capsys, argv):
    want = _run(capsys, rctl.main, argv)
    got = _run(capsys, tctl.main, argv)
    assert got == want and got[1].count("\n") >= 2


# ------------------------------------------------------------ GPU rules

PLAN = ["plan", "h100-80gb", "3g.40gb", "3g.40gb", "1g.10gb"]
PLAN2 = PLAN + ["--hosts", "2", "--policy", "first-fit"]


def test_plan_on_one_gpu(capsys):
    rc, out = _run(capsys, tctl.main, PLAN)
    rows = _lines(out)
    assert rc == 1
    assert [r["placed"] for r in rows] == [True, True, False]
    assert sorted(tuple(r["hosts"]["gpu0"]["slots"]) for r in rows[:2]) \
        == [(0, 1, 2, 3), (4, 5, 6, 7)]
    assert {r["hosts"]["gpu0"]["gpu"] for r in rows[:2]} == {0}


def test_plan_on_two_gpus(capsys):
    rc, out = _run(capsys, tctl.main, PLAN2)
    rows = _lines(out)
    assert rc == 0 and all(r["placed"] for r in rows)
    assert rows[2] == {"request": "1g.10gb", "placed": True,
                       "box": "0,1,0+1x1x1",
                       "hosts": {"gpu1": {"gpu": 1, "slots": [0]}}}


def test_control_plan_parses_by_the_reference_rule(capsys, monkeypatch):
    monkeypatch.setattr(tctl, "plan_profile",
                        lambda name, gen: parse_profile_name(name))
    with pytest.raises(ValueError, match="malformed profile name"):
        tctl.main(PLAN)


def test_control_plan_on_the_reference_grid(capsys, monkeypatch):
    """The reference's hosts side by side along x: GPU 1 sits at x 8..15,
    beside GPU 0's slots, and the 1g.10gb never reaches GPU 1."""
    from instaslice_tpu_torch.topology import NodeGrid, TorusGroup
    from instaslice_tpu_torch.topology.grid import get_generation

    def ref_group(generation, hosts):
        gen = get_generation(generation)
        hb = gen.host_bounds
        return TorusGroup("plan", gen, (hb[0] * hosts, hb[1], hb[2]), {
            f"host-{i}": NodeGrid(gen, host_offset=(i * hb[0], 0, 0))
            for i in range(hosts)})

    monkeypatch.setattr(tctl, "plan_group", ref_group)
    rc, out = _run(capsys, tctl.main, PLAN2)
    rows = _lines(out)
    assert not (rc == 0 and rows[2]["placed"]
                and rows[2]["hosts"] == {"gpu1": {"gpu": 1, "slots": [0]}})


def test_control_plan_prints_local_chip_ids(capsys, monkeypatch):
    """The reference's local chip ids: memory slots on a GPU grid, no GPU
    index."""
    monkeypatch.setattr(tctl, "plan_hosts", lambda group, pl: {
        pt.node_name: pt.local_chip_ids(group.generation.host_bounds)
        for pt in pl.parts})
    rc, out = _run(capsys, tctl.main, PLAN2)
    assert rc == 0
    assert _lines(out)[2]["hosts"] != {"gpu1": {"gpu": 1, "slots": [0]}}
    assert _lines(out)[2]["hosts"] == {"gpu1": [0]}


def _catalog(capsys, gen):
    rc, out = _run(capsys, tctl.main, ["catalog", gen])
    assert rc == 0
    return [r["name"] for r in _lines(out)]


def test_catalog_lists_what_a_node_cr_lists(capsys):
    from instaslice_tpu_torch.agent.discovery import build_tpuslice
    from instaslice_tpu_torch.device.fake import FakeGpuBackend

    b = FakeGpuBackend(gpu_count=2)
    cr = build_tpuslice("n", "ns", b.discover(), b)
    assert _catalog(capsys, "h100-80gb") == \
        [p["name"] for p in cr.spec.profiles]
    assert _catalog(capsys, "h100-80gb")[-2:] == ["7g.80gb", "gpu"]
    assert _catalog(capsys, "nvidia-gpu") == ["gpu"]


def test_control_catalog_by_the_reference_rule(capsys, monkeypatch):
    from instaslice_tpu_torch.topology import profile_catalog

    monkeypatch.setattr(tctl, "catalog_profiles", profile_catalog)
    assert "gpu" not in _catalog(capsys, "h100-80gb")


# ------------------------------------------------------------ serve-bench

TINY = ["--d-model", "32", "--n-layers", "2", "--n-heads", "2",
        "--d-ff", "64", "--vocab", "64", "--batch", "2", "--max-len", "64",
        "--prefill-len", "8", "--steps", "4"]


@pytest.fixture(scope="module")
def reference_lines():
    """The reference's serve-bench lines on the CPU (plain and spec)."""
    import contextlib
    import io

    out = {}
    for mode, extra in (("plain", []), ("spec", ["--spec"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert rctl.main(["serve-bench"] + TINY + extra) == 0
        out[mode] = json.loads(buf.getvalue().strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("extra,flags", [
    ([], {"quantized": False, "speculative": False}),
    (["--quantize"], {"quantized": True, "speculative": False}),
    (["--spec"], {"quantized": False, "speculative": True}),
])
def test_serve_bench_prints_the_reference_keys(capsys, reference_lines,
                                               extra, flags):
    rc, out = _run(capsys, tctl.main,
                   ["serve-bench"] + TINY + extra + ["--device", "cpu"])
    line = json.loads(out.strip().splitlines()[-1])
    want = reference_lines["spec" if "--spec" in extra else "plain"]
    assert rc == 0 and set(line) == set(want)
    assert line["backend"] == "cpu" and line["value"] > 0
    assert {k: line[k] for k in ("metric", "unit", "batch", "model")} == \
        {k: want[k] for k in ("metric", "unit", "batch", "model")}
    for k, v in flags.items():
        assert line[k] == v
    if "--spec" in extra:
        assert 1.0 < line["spec_tokens_per_round"] <= 5.0


@pytest.mark.parametrize("extra,msg", [
    (["--quantize", "--spec"], "pick one"),
    (["--prefill-len", "100"], "must be <= --max-len"),
])
def test_serve_bench_refusals_as_the_reference(capsys, extra, msg):
    for main in (rctl.main, tctl.main):
        with pytest.raises(SystemExit):
            main(["serve-bench"] + TINY + extra + ["--device", "cpu"]
                 if main is tctl.main else ["serve-bench"] + TINY + extra)
        assert msg in capsys.readouterr().err


def test_serve_bench_on_the_card_raises_without_one(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tctl.main(["serve-bench"] + TINY)


# ---------------------------------------- the observability commands


SPANS = [
    {"name": "engine.prefill", "traceId": "t1", "spanId": "a",
     "parentId": "", "start": 100.0, "durationMs": 12.5,
     "attrs": {"slot": 0}},
    {"name": "engine.decode", "traceId": "t1", "spanId": "b",
     "parentId": "a", "start": 100.02, "durationMs": 3.25, "attrs": {}},
    {"name": "engine.prefill", "traceId": "t2", "spanId": "c",
     "parentId": "", "start": 101.0, "durationMs": 7.0, "attrs": {}},
]
EVENTS = [
    {"seq": 1, "ts": 100.0, "component": "controller", "reason": "Admitted",
     "objectRef": "Pod/default/p", "traceId": "t1", "message": "a"},
    {"seq": 2, "ts": 100.1, "component": "agent", "reason": "SliceRealized",
     "objectRef": "alloc/x", "traceId": "t1", "message": "r"},
    {"seq": 3, "ts": 100.2, "component": "controller", "reason": "Ungated",
     "objectRef": "Pod/default/p", "traceId": "t1", "message": "u"},
]
PROFILE = {
    "armed": True, "rounds": 2, "events": 1, "compileWallMs": 1.5,
    "segments": {"decode": {"p50": 1.0, "p95": 2.0, "count": 2}},
    "compiles": [{"name": "decode_block", "ts": 100.0}],
    "recent": [{"idx": 0, "ts": 100.0, "phase": "decode", "wallMs": 2.0,
                "segs": [["forward", 0.1, 1.5]], "meta": {"batch": 8}}],
    "recentEvents": [{"kind": "compile", "name": "decode_block",
                      "ts": 100.5, "durMs": 4.0, "attrs": {"k": "1"}},
                     {"kind": "dispatch", "name": "decode_block",
                      "ts": 100.6, "attrs": {}}],
}
WATERFALL = {"rid": "7", "traceId": "t1", "outcome": "ok", "totalMs": 20.0,
             "preemptions": 0,
             "stages": [{"stage": "queue", "startMs": 0.0,
                         "durationMs": 2.0},
                        {"stage": "prefill", "startMs": 2.0,
                         "durationMs": 8.0}],
             "markers": [{"atMs": 3.0, "reason": "Admitted",
                          "message": "m"}]}
LOCKS = {"armed": True, "live": [{"thread": "w0", "held": [
    {"name": "engine", "heldSeconds": 0.5, "depth": 2}]}],
    "cycles": [{"chain": ["a", "b", "a"], "threads": ["w0"]}],
    "longHolds": [{"name": "engine", "seconds": 1.2, "thread": "w0"}],
    "holds": {"engine": {"count": 3, "totalSeconds": 1.5,
                         "maxSeconds": 1.2}}, "edges": [["a", "b"]]}


@pytest.fixture(scope="module")
def debug_server():
    """A stand-in component answering the /v1/debug/* and /v1/fleet
    routes with fixed payloads."""
    import threading
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            u = urllib.parse.urlparse(self.path)
            q = urllib.parse.parse_qs(u.query)
            if u.path == "/v1/debug/profile":
                body = WATERFALL if "rid" in q else PROFILE
            elif u.path == "/v1/debug/trace":
                body = {"summary": {"engine.prefill": {"p50": 9.0}},
                        "slowest": SPANS[:1], "recent": SPANS,
                        "spans": SPANS[:2]}
            elif u.path == "/v1/debug/events":
                body = {"events": EVENTS}
            elif u.path == "/v1/debug/locks":
                body = LOCKS
            elif u.path.startswith("/v1/fleet"):
                body = {"path": u.path, "trace": q.get("trace_id", [""])}
            else:
                self.send_response(404)
                self.end_headers()
                return
            data = json.dumps(body).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def jsonl(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs")
    spans, events = d / "trace.jsonl", d / "events.jsonl"
    spans.write_text("".join(json.dumps(s) + "\n" for s in SPANS))
    events.write_text("".join(json.dumps(e) + "\n" for e in EVENTS)
                      + "not json\n")
    return str(spans), str(events)


@pytest.mark.parametrize("argv", [
    ["trace-summary", "SPANS"],
    ["trace-summary", "SPANS", "--slowest", "2"],
    ["trace-summary", "SPANS", "--trace", "t1"],
    ["trace-summary", "--url", "URL"],
    ["trace-summary", "--url", "URL", "--trace", "t1"],
    ["events", "EVENTS"],
    ["events", "EVENTS", "--reason", "Ungated"],
    ["events", "EVENTS", "-n", "1", "--component", "controller"],
    ["events", "--url", "URL", "--object", "Pod/default/p"],
    ["profile", "--url", "URL"],
    ["waterfall", "7", "--url", "URL"],
    ["waterfall", "7", "--url", "URL", "--json"],
    ["describe", "locks", "--url", "URL"],
    ["fleet", "--url", "URL"],
    ["fleet", "--url", "URL", "--trace", "t1"],
    ["describe", "pod", "p", "--kubeconfig", "KUBE", "--events-file",
     "EVENTS", "--trace-file", "SPANS", "--json"],
])
def test_observability_commands_equal_the_reference(
        capsys, debug_server, jsonl, cluster, argv):
    spans, events = jsonl
    sub = {"SPANS": spans, "EVENTS": events, "URL": debug_server,
           "KUBE": cluster[1]}
    argv = [sub.get(a, a) for a in argv]
    want = _run(capsys, rctl.main, argv)
    got = _run(capsys, tctl.main, argv)
    assert got == want and got[0] == 0 and got[1]


def test_profile_out_writes_the_references_chrome_trace(
        capsys, debug_server, tmp_path):
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    want = _run(capsys, rctl.main, ["profile", "--url", debug_server,
                                    "--out", str(ref_out)])
    got = _run(capsys, tctl.main, ["profile", "--url", debug_server,
                                   "--out", str(port_out)])
    assert got[0] == want[0] == 0
    assert json.loads(port_out.read_text()) == json.loads(ref_out.read_text())
    assert json.loads(got[1])["traceEvents"] == \
        json.loads(want[1])["traceEvents"] > 0
