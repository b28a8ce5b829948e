"""The port's Kubernetes layer held against the reference's, in process.

The same seeded op sequences (create, get, list, update with fresh and
stale resourceVersions, merge-patch, status patch, delete, finalizers,
duplicate creates) run through ``instaslice_tpu.kube.FakeKube`` and
``instaslice_tpu_torch.kube.FakeKube``: every returned object, error
type and message, resourceVersion, and every watch event (a resume from
a version mid-sequence, the relist, the bookmark) must be equal, with
wall-clock timestamps normalised. The informer, the reconcile
``Manager`` (its workqueue: dedupe, requeue, error retry), the
``LeaderElector`` with its ``EpochFence`` and the ``ProbeServer`` are
held the same way. Each comparison has a control that must miss: the
same check run on a sequence that differs by one op.
"""

import random
import threading
import time
import urllib.error
import urllib.request

import pytest

from instaslice_tpu.kube import client as jclient
from instaslice_tpu.kube import fake as jfake
from instaslice_tpu.kube import informer as jinformer
from instaslice_tpu.obs import journal as jjournal
from instaslice_tpu.utils import election as jelection
from instaslice_tpu.utils import probes as jprobes
from instaslice_tpu.utils import reconcile as jreconcile
from instaslice_tpu.utils import timeutil as jtime
from instaslice_tpu_torch.kube import client as tclient
from instaslice_tpu_torch.kube import fake as tfake
from instaslice_tpu_torch.kube import informer as tinformer
from instaslice_tpu_torch.obs import journal as tjournal
from instaslice_tpu_torch.utils import election as telection
from instaslice_tpu_torch.utils import probes as tprobes
from instaslice_tpu_torch.utils import reconcile as treconcile
from instaslice_tpu_torch.utils import timeutil as ttime

PKGS = {
    "ref": dict(fake=jfake, client=jclient, informer=jinformer,
                election=jelection, probes=jprobes, reconcile=jreconcile,
                journal=jjournal),
    "port": dict(fake=tfake, client=tclient, informer=tinformer,
                 election=telection, probes=tprobes, reconcile=treconcile,
                 journal=tjournal),
}
NAMES = [f"p{i}" for i in range(6)]
NSS = ("default", "team-a")
_TIMES = ("creationTimestamp", "deletionTimestamp", "renewTime")


def norm(x):
    """``x`` with wall-clock timestamps replaced by ``"T"``."""
    if isinstance(x, dict):
        return {k: ("T" if k in _TIMES else norm(v)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


def pod(name, ns, **labels):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns,
                         **({"labels": labels} if labels else {})},
            "spec": {"n": 0}, "status": {}}


def ops(seed: int, n: int = 150):
    """A seeded op sequence over a few Pods in two namespaces."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        verb = rng.choice(["create", "create", "get", "list", "update",
                           "stale", "patch", "status", "delete",
                           "finalize", "unfinalize"])
        out.append((verb, rng.choice(NAMES), rng.choice(NSS),
                    rng.randrange(100)))
    return out


def apply(kube, op, held):
    """One op on ``kube``: ("ok", normalised result) or (error type,
    message). ``held`` keeps each object's last read, for updates."""
    verb, name, ns, v = op
    key = (ns, name)
    try:
        if verb == "create":
            out = kube.create("Pod", pod(name, ns, tier=str(v % 3)))
        elif verb == "get":
            out = held[key] = kube.get("Pod", ns, name)
        elif verb == "list":
            out = kube.list("Pod", namespace=None if v % 2 else ns,
                            label_selector={"tier": str(v % 3)}
                            if v % 3 == 0 else None)
        elif verb in ("update", "stale"):
            obj = held.get(key) if verb == "stale" else None
            if obj is None:
                obj = held[key] = kube.get("Pod", ns, name)
            obj = dict(obj, spec={"n": v})
            out = kube.update("Pod", obj)
        elif verb == "patch":
            out = kube.patch("Pod", ns, name,
                             {"metadata": {"labels": {"tier": str(v % 3)}},
                              "spec": {"x": v if v % 4 else None}})
        elif verb == "status":
            out = kube.patch_status("Pod", ns, name, {"phase": str(v)})
        elif verb == "delete":
            kube.delete("Pod", ns, name)
            out = None
        elif verb == "finalize":
            out = kube.patch("Pod", ns, name,
                             {"metadata": {"finalizers": ["x/f"]}})
        else:
            out = kube.patch("Pod", ns, name,
                             {"metadata": {"finalizers": None}})
        return ("ok", norm(out))
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return (type(e).__name__, str(e))


def run_sequence(pkg, seq, watch_from=None):
    """The outcomes of ``seq`` on a fresh fake of ``pkg``, and the watch
    events after resourceVersion ``watch_from`` (a resume), or of a
    relist (``None``)."""
    kube = PKGS[pkg]["fake"].FakeKube()
    held = {}
    outcomes = [apply(kube, op, held) for op in seq]
    if watch_from is None:
        stream = kube.watch("Pod", replay=True, timeout=0.05)
    else:
        stream = kube.watch("Pod", replay=False, timeout=0.05,
                            resource_version=str(watch_from))
    events = [(ev, norm(obj)) for ev, obj in stream]
    return outcomes, events


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fake_apiserver_equal_under_seeded_sequences(seed):
    seq = ops(seed)
    for watch_from in (None, 0, 40):
        assert run_sequence("port", seq, watch_from) == \
            run_sequence("ref", seq, watch_from)
    outcomes, _ = run_sequence("port", seq)
    kinds = {o[0] for o in outcomes}
    # the sequences reach every outcome that matters
    assert {"ok", "NotFound", "AlreadyExists", "Conflict"} <= kinds


def test_fake_apiserver_control_one_op_apart_differs():
    seq = ops(0)
    assert run_sequence("port", seq[1:]) != run_sequence("ref", seq)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_watch_resume_bookmark_and_filter(pkg):
    kube = PKGS[pkg]["fake"].FakeKube()
    kube.create("Pod", pod("a", "default"))
    rv = kube.create("Pod", pod("b", "team-a"))["metadata"]["resourceVersion"]
    kube.patch("Pod", "default", "a", {"spec": {"x": 1}})
    kube.delete("Pod", "team-a", "b")
    evs = list(kube.watch("Pod", namespace="default", replay=False,
                          timeout=0.05, resource_version=rv))
    assert [e for e, _ in evs] == ["MODIFIED", "BOOKMARK"]
    assert int(evs[-1][1]["metadata"]["resourceVersion"]) == 4


def _update_with_retry_outcome(pkg):
    c = PKGS[pkg]["client"]
    kube = PKGS[pkg]["fake"].FakeKube()
    kube.create("Pod", pod("a", "default"))
    calls = []

    def mut(obj):
        calls.append(obj["metadata"]["resourceVersion"])
        if len(calls) == 1:  # a concurrent writer lands first
            kube.patch("Pod", "default", "a", {"spec": {"other": 1}})
        obj["spec"]["mine"] = len(calls)
        return obj

    out = c.update_with_retry(kube, "Pod", "default", "a", mut)
    aborted = c.update_with_retry(kube, "Pod", "default", "a",
                                  lambda o: None)
    return calls, norm(out), aborted


def test_update_with_retry_equal():
    assert _update_with_retry_outcome("port") == \
        _update_with_retry_outcome("ref")
    calls, out, aborted = _update_with_retry_outcome("port")
    assert calls == ["1", "2"] and out["spec"] == {
        "n": 0, "other": 1, "mine": 2} and aborted is None


# ------------------------------------------------------------ informer

def _wait(cond, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.01)
    return False


def informer_run(pkg, seq):
    """An informer over a fresh fake, started before ``seq``: its
    handler's (event, name, rv) sequence and its final cache."""
    p = PKGS[pkg]
    kube = p["fake"].FakeKube()
    kube.create("Pod", pod("seed", "default"))
    inf = p["informer"].Informer(kube, "Pod", resync_period=3600.0,
                                 indexers={"tier": lambda o: [
                                     o["metadata"].get("labels", {})
                                     .get("tier", "")]})
    seen = []
    inf.add_handler(lambda ev, obj: seen.append(
        (ev, obj["metadata"]["name"], obj["metadata"]["resourceVersion"])))
    inf.start()
    try:
        assert inf.wait_synced(10)
        held = {}
        for op in seq:
            apply(kube, op, held)
        head = sorted((o["metadata"]["namespace"], o["metadata"]["name"],
                       o["metadata"]["resourceVersion"])
                      for o in kube.list("Pod"))
        assert _wait(lambda: sorted(
            (o["metadata"]["namespace"], o["metadata"]["name"],
             o["metadata"]["resourceVersion"]) for o in inf.list()) == head)
        time.sleep(0.05)
        return (seen, norm(sorted(inf.list(), key=lambda o: (
            o["metadata"]["namespace"], o["metadata"]["name"]))),
            {k: sorted(o["metadata"]["name"] for o in inf.by_index("tier", k))
             for k in inf.index_keys("tier")})
    finally:
        inf.stop()


@pytest.mark.parametrize("seed", [5, 6])
def test_informer_equal(seed):
    seq = ops(seed, 80)
    assert informer_run("port", seq) == informer_run("ref", seq)


def test_informer_control_one_op_apart_differs():
    seq = ops(5, 80)
    assert informer_run("port", seq[:-3]) != informer_run("ref", seq)


# ------------------------------------------------------------- manager

def manager_run(pkg, drop: str = ""):
    """A reconcile ``Manager`` over a fresh fake: keys from a watch map
    (``drop`` is left out of it, the control), one key that fails once
    and is retried, one that requeues itself three times. Returns the
    last state each key's reconcile read, and the fail/requeue counts."""
    p = PKGS[pkg]
    kube = p["fake"].FakeKube()
    last, counts = {}, {}
    lock = threading.Lock()

    def reconcile(key):
        with lock:
            counts[key] = counts.get(key, 0) + 1
            n = counts[key]
        if key == "boom" and n == 1:
            raise RuntimeError("transient")
        try:
            obj = kube.get("Pod", "default", key)
            last[key] = (obj["spec"], obj["metadata"]["resourceVersion"])
        except p["client"].NotFound:
            last[key] = None
        if key == "again" and n < 3:
            return 0.02
        return None

    mgr = p["reconcile"].Manager(
        name=f"m-{pkg}", client=kube, reconcile=reconcile,
        watches=[("Pod", "default", lambda ev, obj: [
            obj["metadata"]["name"]] if obj["metadata"]["name"] != drop
            else [])],
        error_backoff=0.02, workers=2)
    mgr.start()
    try:
        assert mgr.wait_synced(10)
        for name in ("a", "b", "boom", "again"):
            kube.create("Pod", pod(name, "default"))
        for v in range(5):
            kube.patch("Pod", "default", "a", {"spec": {"n": v}})
        kube.delete("Pod", "default", "b")
        assert _wait(lambda: counts.get("again", 0) >= 3
                     and counts.get("boom", 0) >= 2)
        assert mgr.wait_idle(10)
        return last, counts["boom"] >= 2, counts["again"]
    finally:
        mgr.stop()


def test_manager_equal():
    assert manager_run("port") == manager_run("ref")
    last, retried, again = manager_run("port")
    assert last["b"] is None and last["a"][0] == {"n": 4}
    assert retried and again == 3


def test_manager_control_dropped_key_differs():
    assert manager_run("port", drop="a") != manager_run("ref")


# ------------------------------------------------------------ election

def election_run(pkg, depose: bool = True):
    """Two electors over one fake: a acquires, b is refused, a lets its
    lease lapse and b takes it (with ``depose`` False, the control, a
    renews and b is refused again); the epoch fence over a, a write
    through it while a leads, and one after."""
    p = PKGS[pkg]
    kube = p["fake"].FakeKube()
    kube.create("Pod", pod("x", "default"))
    el = p["election"]
    a = el.LeaderElector(kube, "ns", "lease", "a", lease_seconds=0.2,
                         retry_seconds=0.02)
    b = el.LeaderElector(kube, "ns", "lease", "b", lease_seconds=0.2,
                         retry_seconds=0.02)
    fence = el.EpochFence(lambda: a)
    steps = [a.acquire(), b._try_acquire_or_renew(),
             a.epoch, b.epoch, fence(), fence.epoch]
    out = p["client"].update_with_retry(
        kube, "Pod", "default", "x",
        lambda o: dict(o, spec={"w": "a"}), fence=fence)
    steps.append(norm(out["metadata"].get("annotations")))
    time.sleep(0.3)
    if not depose:
        steps.append(a._try_acquire_or_renew())
    steps += [b._try_acquire_or_renew(), b.epoch,
              norm(kube.get("Lease", "ns", "lease"))]
    try:
        p["client"].update_with_retry(
            kube, "Pod", "default", "x",
            lambda o: dict(o, spec={"w": "stale"}), fence=fence)
        steps.append("landed")
    except p["client"].Fenced as e:
        steps.append(("Fenced", str(e)))
    steps.append(norm(kube.get("Pod", "default", "x")["spec"]))
    return steps


def test_leader_election_and_epoch_fence_equal():
    got, want = election_run("port"), election_run("ref")
    assert got == want
    assert got[:6] == [True, False, 0, -1, True, 0]
    assert got[-2][0] == "Fenced" and got[-1] == {"w": "a"}


def test_leader_election_control_renewed_lease_differs():
    assert election_run("port", depose=False) != election_run("ref")


@pytest.mark.parametrize("text", [
    "2026-10-18T02:50:39Z", "2026-10-18T02:50:39.123456Z",
    "2026-10-18T02:50:39+02:00", 1760755839.5, "1760755839.5", None, "",
    "garbage"])
def test_timestamps_parse_equal(text):
    assert ttime.parse_timestamp(text) == jtime.parse_timestamp(text)


# -------------------------------------------------------------- probes

def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


PROBE_PATHS = ("/healthz", "/readyz", "/v1/debug/events?n=5",
               "/v1/debug/events?n=x", "/v1/debug/trace?n=3",
               "/v1/debug/trace?n=0", "/v1/debug/trace?trace_id=nope",
               "/v1/debug/locks", "/v1/debug/profile", "/nope")


def probe_run(pkg, ready: bool = True):
    """Status codes and payload keys of every probe path, ready and
    then draining."""
    import json

    p = PKGS[pkg]
    srv = p["probes"].ProbeServer("127.0.0.1:0",
                                  ready_check=lambda: ready).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        out = []
        for path in PROBE_PATHS:
            code, body = _get(base + path)
            try:
                shape = sorted(json.loads(body))
            except ValueError:
                shape = body.decode()
            out.append((path, code, shape))
        srv.set_draining(True)
        out.append(("draining", _get(base + "/readyz")[0],
                    _get(base + "/healthz")[0]))
        return out
    finally:
        srv.stop()


def test_probe_server_equal():
    got = probe_run("port")
    assert got == probe_run("ref")
    codes = {path: code for path, code, *_ in got[:-1]}
    assert codes["/healthz"] == codes["/readyz"] == 200
    assert got[-1] == ("draining", 503, 200)


def test_probe_server_control_not_ready_differs():
    assert probe_run("port", ready=False) != probe_run("ref")
