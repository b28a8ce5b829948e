"""The port's Kubernetes wire held against the reference's, over HTTP.

Both ways across: the port's ``RealKubeClient`` against the reference's
``httptest`` server, and the reference's client against the port's,
through the same seeded op sequences (verbs, merge and status patches,
error mapping) and watch streams (replay, resume from a version,
bookmarks), each compared with the reference's client on the
reference's server. The resilience cases of
``tests/test_kube_resilience.py`` (5xx and connection-reset retries,
``Retry-After`` on 429, the attempt limit, no retry of semantic errors,
the circuit breaker's open, half-open and re-open, a dropped watch
resumed from its last version) run on both clients against the same
scripted servers and must put the same requests on the wire.

The port reads kubeconfigs without PyYAML (``kube/kubeconfig.py``):
its reader is held against ``yaml.safe_load`` on ``yaml.safe_dump``
output in several styles and on a kubectl-style file, malformed files
raise, and a client built from each file reaches a token-guarded server.
"""

import json
import time

import pytest
import yaml

from instaslice_tpu.kube import fake as jfake
from instaslice_tpu.kube import httptest as jhttp
from instaslice_tpu.kube import real as jreal
from instaslice_tpu_torch.kube import fake as tfake
from instaslice_tpu_torch.kube import httptest as thttp
from instaslice_tpu_torch.kube import real as treal
from instaslice_tpu_torch.kube.kubeconfig import (
    KubeconfigError,
    load_kubeconfig,
)
from test_kube_resilience import OK_BODY, _ScriptedServer, _WatchServer
from test_torch_kube import apply, norm, ops

SIDES = {"ref": (jfake, jhttp, jreal), "port": (tfake, thttp, treal)}


def wire_run(client_side, server_side, seq, watch_from=0):
    """``seq`` through ``client_side``'s RealKubeClient on
    ``server_side``'s fake served over HTTP; the outcomes, a Node status
    patch and a watch resumed from ``watch_from`` (its events up to the
    bookmark)."""
    fake, http, _ = SIDES[server_side]
    real = SIDES[client_side][2]
    store = fake.FakeKube()
    with http.FakeApiServer(store) as srv:
        c = real.RealKubeClient(srv.url)
        held = {}
        outcomes = [apply(c, op, held) for op in seq]
        c.create("Node", {"apiVersion": "v1", "kind": "Node",
                          "metadata": {"name": "n1"}, "status": {}})
        outcomes.append(norm(c.patch_status(
            "Node", "", "n1", {"capacity": {"x/y": "1"}})))
        outcomes.append(norm(c.patch_status(
            "Node", "", "n1", {"capacity": {"x/y": None}})))
        events = []
        for ev, obj in c.watch("Pod", replay=False, timeout=2.0,
                               resource_version=str(watch_from)):
            events.append((ev, norm(obj)))
            if ev == "BOOKMARK":
                break
        relist = []
        for ev, obj in c.watch("Pod", namespace="default", replay=True,
                               timeout=2.0):
            relist.append((ev, norm(obj)))
            if ev == "BOOKMARK":
                break
    return outcomes, events, relist


@pytest.mark.parametrize("client_side,server_side",
                         [("port", "ref"), ("ref", "port"),
                          ("port", "port")])
@pytest.mark.parametrize("seed", [0, 5])
def test_wire_equal_both_ways(client_side, server_side, seed):
    seq = ops(seed, 60)
    got = wire_run(client_side, server_side, seq, watch_from=20)
    assert got == wire_run("ref", "ref", seq, watch_from=20)
    outcomes, events, relist = got
    assert {"ok", "NotFound", "Conflict"} <= {o[0] for o in outcomes[:-2]}
    assert events and events[-1][0] == "BOOKMARK"
    assert relist and relist[-1][0] == "BOOKMARK"


def test_wire_control_one_op_apart_differs():
    seq = ops(0, 60)
    assert wire_run("port", "ref", seq[1:]) != wire_run("ref", "ref", seq)


# ---------------------------------------------------------- resilience

def fast_client(side, url, **overrides):
    c = SIDES[side][2].RealKubeClient(url)
    c.max_attempts = overrides.pop("max_attempts", 4)
    c.backoff_base = 0.01
    c.backoff_cap = 0.05
    for k, v in overrides.items():
        setattr(c, k, v)
    return c


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return (type(e).__name__,)


def retry_case(side, case):
    """One scripted failure sequence: the client's outcomes and the
    requests that reached the wire."""
    scripts = {
        "5xx": [(503, {}, {"message": "overloaded"}),
                (502, {}, {"message": "bad gateway"})],
        "reset": ["rst", "rst"],
        "429": [(429, {"Retry-After": "1"}, {"message": "slow down"})],
        "give_up": [(503, {}, {"message": "down"})] * 10,
        "semantic": [(404, {}, {"message": "nope", "reason": "NotFound"})],
        "breaker": [(503, {}, {"message": "down"})] * 20,
        "half_open": [(503, {}, {"message": "down"})] * 5,
        "reopen": [(503, {}, {"message": "down"})] * 6,
    }
    srv = _ScriptedServer(scripts[case])
    try:
        if case in ("breaker", "half_open", "reopen"):
            c = fast_client(side, srv.url, max_attempts=1,
                            breaker_threshold=5,
                            breaker_cooldown=30.0 if case == "breaker"
                            else 0.15)
            get = lambda: c.get("Pod", "default", "x")  # noqa: E731
            out = [_outcome(get) for _ in range(5)]
            if case != "breaker":
                out.append(_outcome(get))
                time.sleep(0.2)
            out += [_outcome(get), _outcome(get)]
            return out, len(srv.seen)
        c = fast_client(side, srv.url,
                        max_attempts=3 if case == "give_up" else 4)
        t0 = time.monotonic()
        out = _outcome(lambda: c.get("Pod", "default", "x"))
        waited = time.monotonic() - t0 >= 0.9
        return out, len(srv.seen), waited
    finally:
        srv.stop()


CASES = ["5xx", "reset", "429", "give_up", "semantic", "breaker",
         "half_open", "reopen"]


@pytest.mark.parametrize("case", CASES)
def test_resilience_equal(case):
    got = retry_case("port", case)
    assert got == retry_case("ref", case)
    want = {"5xx": (("ok", OK_BODY), 3, False),
            "reset": (("ok", OK_BODY), 3, False),
            "429": (("ok", OK_BODY), 2, True),
            "give_up": (("ApiError",), 3, False),
            "semantic": (("NotFound",), 1, False)}
    if case in want:
        assert got == want[case]
    elif case == "breaker":
        assert got == ([("ApiError",)] * 5 + [("CircuitOpen",)] * 2, 5)
    elif case == "half_open":
        assert got[0][5] == ("CircuitOpen",) and got[0][6][0] == "ok"
    else:
        assert got[0][6] == ("ApiError",) and got[0][7] == ("CircuitOpen",)


def test_resilience_control_more_attempts_differs():
    srv = _ScriptedServer([(503, {}, {"message": "down"})] * 10)
    try:
        c = fast_client("port", srv.url, max_attempts=4)
        out = (_outcome(lambda: c.get("Pod", "default", "x")),
               len(srv.seen), False)
    finally:
        srv.stop()
    assert out != retry_case("ref", "give_up")


def watch_drop(side, drops_before_progress=0):
    conns = [([("ADDED", 1), ("ADDED", 2)], True), ([("MODIFIED", 3)],
                                                     False)]
    srv = _WatchServer([([], True)] * drops_before_progress + conns)
    try:
        c = fast_client(side, srv.url, watch_reconnects=2)
        out = _outcome(lambda: [
            (e, o["metadata"]["resourceVersion"]) for e, o in c.watch(
                "Pod", namespace="default", replay=False,
                resource_version="0", timeout=1.0) if e != "BOOKMARK"])
        return out, srv.rvs_seen
    finally:
        srv.stop()


def test_dropped_watch_resumes_equal():
    got = watch_drop("port")
    assert got == watch_drop("ref")
    assert got == (("ok", [("ADDED", "1"), ("ADDED", "2"),
                           ("MODIFIED", "3")]), ["0", "2"])
    # the control: a zero-progress drop storm exhausts the budget
    assert watch_drop("port", 10)[0] == ("ApiError",) != got[0]


# ---------------------------------------------------------- kubeconfig

KUBECTL_STYLE = """\
# written by kubectl config view --raw
apiVersion: v1
clusters:
- cluster:
    certificate-authority-data: LS0tLS1CRUdJTiBDRVJUSUZJQ0FURS0tLS0t
    server: {server}
  name: kind-kind
contexts:
- context:
    cluster: kind-kind
    user: kind-kind
  name: kind-kind
- context:
    cluster: kind-kind
    namespace: "team-a"
    user: 'other'
  name: other
current-context: kind-kind
kind: Config
preferences: {{}}
users:
- name: kind-kind
  user:
    token: {token}   # a bearer token
- name: other
  user:
    exec:
      apiVersion: client.authentication.k8s.io/v1beta1
      args:
      - --region
      - "us-east-1"
      command: aws
      env: null
      interactiveMode: IfAvailable
      provideClusterInfo: false
"""


def kubeconfig_dict(server, token):
    return {
        "apiVersion": "v1", "kind": "Config", "preferences": {},
        "current-context": "smoke",
        "clusters": [{"name": "smoke", "cluster": {
            "server": server, "insecure-skip-tls-verify": True,
            "certificate-authority-data": "LS0t" * 30}}],
        "contexts": [{"name": "smoke", "context": {
            "cluster": "smoke", "user": "smoke", "namespace": "default"}}],
        "users": [{"name": "smoke", "user": {
            "token": token,
            "exec": {"command": "gke-gcloud-auth-plugin",
                     "args": ["--a", "b c", "", "123", "true", "null",
                              "x\ny", "it's \"q\"", "a " * 50, "k: v",
                              "#c", "[a]", "a #b", "0755", "1e3", "~"],
                     "env": [{"name": "A", "value": "1"}],
                     "provideClusterInfo": True}}}],
        "extensions": [], "n": 5, "f": 1.25, "z": None, "t": False,
    }


@pytest.mark.parametrize("style", [
    {}, {"default_flow_style": False}, {"width": 20}, {"indent": 4},
    {"allow_unicode": True, "width": 10}, {"explicit_start": True},
    {"sort_keys": False}])
def test_kubeconfig_reader_equals_safe_load(style):
    text = yaml.safe_dump(kubeconfig_dict("https://10.0.0.1:6443",
                                          "tok:en #1"), **style)
    assert load_kubeconfig(text) == yaml.safe_load(text)
    # the control: a changed token reads differently
    assert load_kubeconfig(text.replace("tok:en", "tok-en")) != \
        yaml.safe_load(text)


def test_kubeconfig_reader_kubectl_style_and_json():
    text = KUBECTL_STYLE.format(server="https://127.0.0.1:6443",
                                token="abc")
    assert load_kubeconfig(text) == yaml.safe_load(text)
    data = yaml.safe_load(text)
    assert load_kubeconfig(json.dumps(data, indent=2)) == data


@pytest.mark.parametrize("bad", [
    "a: &x 1\nb: *x\n",                          # anchor, alias
    "a: !!str 1\n",                              # tag
    "a: |\n  text\n",                            # block scalar
    "a: >\n  text\n",                            # folded block scalar
    "a:\n\t- b\n",                               # a tab
    "a: 'unterminated\n",                        # open quote
    "a: {b: 1}\n",                               # flow mapping
    "a: [1, 2]\n",                               # flow sequence
    "a: 1\n b: 2\n",                             # bad indentation
    "a: 1\na: 2\n",                              # duplicate key
    "a: 1\n---\nb: 2\n",                         # second document
    "- - a\n",                                   # nested inline lists
    "? a\n: b\n",                                # complex key
    "a: b: c\n",                                 # mapping in a scalar
    '{"a": 1,}',                                 # malformed JSON
])
def test_kubeconfig_reader_raises_on_what_it_does_not_read(bad):
    with pytest.raises(KubeconfigError):
        load_kubeconfig(bad)


@pytest.mark.parametrize("fmt", ["kubectl", "safe_dump", "json"])
def test_clients_from_kubeconfig_reach_a_token_guarded_server(fmt,
                                                              tmp_path):
    store = tfake.FakeKube()
    with thttp.FakeApiServer(store) as srv:
        srv.handler.token_validator = lambda t: t == "s3cret"
        if fmt == "kubectl":
            text = KUBECTL_STYLE.format(server=srv.url, token="s3cret")
        else:
            cfg = {"apiVersion": "v1", "kind": "Config",
                   "current-context": "c",
                   "clusters": [{"name": "c", "cluster": {
                       "server": srv.url}}],
                   "users": [{"name": "u", "user": {"token": "s3cret"}}],
                   "contexts": [{"name": "c", "context": {
                       "cluster": "c", "user": "u"}}]}
            text = (json.dumps(cfg) if fmt == "json"
                    else yaml.safe_dump(cfg))
        path = tmp_path / "kubeconfig"
        path.write_text(text)
        port = treal.RealKubeClient.from_kubeconfig(str(path))
        ref = jreal.RealKubeClient.from_kubeconfig(str(path))
        try:
            port.create("Pod", {"apiVersion": "v1", "kind": "Pod",
                                "metadata": {"name": "a",
                                             "namespace": "default"}})
            assert norm(port.get("Pod", "default", "a")) == \
                norm(ref.get("Pod", "default", "a"))
            assert port.base_url == ref.base_url == srv.url
            # the control: a wrong token is refused
            bad = treal.RealKubeClient(srv.url, token="wrong")
            bad.max_attempts = 1
            with pytest.raises(Exception):
                bad.get("Pod", "default", "a")
        finally:
            port.close()
            ref.close()
