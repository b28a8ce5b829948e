"""Real Kubernetes API client over the stdlib (no external deps).

The reference gets its API access from controller-runtime/client-go; this
environment ships no ``kubernetes`` package, so the client is implemented
directly against the REST API: bearer-token / client-cert auth, in-cluster
service-account config, kubeconfig parsing, JSON verbs with the error
mapping the reconcilers rely on (404 → NotFound, 409 reason AlreadyExists
vs Conflict), merge-patch, the status subresource, and **streaming watches
with resourceVersion resume + bookmarks** — the exact contract
:class:`instaslice_tpu_torch.kube.client.KubeClient` documents and the fake
implements, so every reconciler runs unchanged against a live cluster.

Tested against a real HTTP server in ``tests/test_realclient.py`` (the
fake API served over HTTP — the envtest analog: same wire format, no
cluster needed).

A copy of ``instaslice_tpu/kube/real.py`` (the port imports nothing of
the JAX package). Where the reference reads a kubeconfig with PyYAML,
the port reads JSON or the block YAML kubeconfigs are written in with
:func:`~instaslice_tpu_torch.kube.kubeconfig.load_kubeconfig`, which
raises on anything else; it is held against the reference's client
over HTTP in ``tests/test_torch_kubewire.py``.
"""

from __future__ import annotations

import atexit
import base64
import http.client
import json
import logging
import os
import random
import socket
import ssl
import subprocess
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from typing import Dict, Iterator, List, Optional, Tuple

from instaslice_tpu_torch.api.constants import (
    GROUP,
    KIND,
    PLURAL,
    VERSION,
    REASON_BACKOFF,
    REASON_BREAKER_OPEN,
    REASON_WATCH_RECONNECT,
)
from instaslice_tpu_torch.obs.journal import get_journal
from instaslice_tpu_torch.kube.client import (
    AlreadyExists,
    ApiError,
    BadRequest,
    Conflict,
    KubeClient,
    NotFound,
    ResourceVersionExpired,
    WatchEvent,
)
from instaslice_tpu_torch.kube.kubeconfig import load_kubeconfig
from instaslice_tpu_torch.utils.trace import get_tracer
from instaslice_tpu_torch.utils.lockcheck import named_lock

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

log = logging.getLogger("instaslice_tpu_torch.kube")

#: transport-level failures worth a retry: connection reset/refused,
#: DNS blips, read timeouts, truncated responses from a dying apiserver
_TRANSIENT_EXC = (
    urllib.error.URLError,
    ConnectionError,
    socket.timeout,
    TimeoutError,
    http.client.HTTPException,
)


class CircuitOpen(ApiError):
    """The client's circuit breaker is open: recent requests failed
    consecutively past the threshold, so callers fail fast instead of
    stacking timeouts against a dead API server. Clears after the
    cooldown (next request is the half-open probe)."""

    code = 503


class CircuitBreaker:
    """Consecutive-failure circuit breaker with a half-open probe —
    the fail-fast half of this module's resilience story, factored out
    so the fleet serving router (serving/router.py) breaks per REPLICA
    with the same semantics the kube transport uses per API server.

    ``threshold`` consecutive :meth:`fail` calls open the circuit for
    ``cooldown`` seconds; while open, :meth:`check` raises
    :class:`CircuitOpen`. Past the cooldown EXACTLY ONE caller becomes
    the half-open probe — concurrent callers keep fast-failing until
    the probe resolves via :meth:`ok`/:meth:`fail` (or its claim
    expires after another ``cooldown``, covering a probe thread that
    died without resolving). Without the single-probe claim, N worker
    threads all passing :meth:`check` at cooldown expiry would
    stampede a just-recovered server with N simultaneous "probes".
    The failure count sits one short of the threshold while half-open,
    so a failed probe re-opens immediately and a successful
    :meth:`ok` resets. Thread-safe."""

    def __init__(self, threshold: int = 5, cooldown: float = 10.0,
                 name: str = "") -> None:
        self.threshold = threshold
        self.cooldown = cooldown
        self.name = name
        self._lock = named_lock("kube.breaker")
        self._failures = 0
        self._open_until = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0

    def check(self) -> None:
        """Fail fast while open; past the cooldown, admit exactly one
        half-open probe and fast-fail everyone else until it
        resolves."""
        with self._lock:
            now = time.monotonic()
            remaining = self._open_until - now
            if remaining > 0:
                raise CircuitOpen(
                    f"circuit open for another {remaining:.1f}s "
                    f"({self.threshold} consecutive failures "
                    f"against {self.name})"
                )
            if self._open_until:
                # half-open: the circuit tripped and the cooldown has
                # elapsed — admit one probe, everyone else stays fast-
                # failed; a stale claim (probe never resolved) expires
                # after another cooldown
                if (self._probe_inflight
                        and now - self._probe_started <= self.cooldown):
                    raise CircuitOpen(
                        f"half-open: probe already in flight against "
                        f"{self.name}"
                    )
                self._probe_inflight = True
                self._probe_started = now

    def is_open(self) -> bool:
        with self._lock:
            return self._open_until - time.monotonic() > 0

    def fail(self) -> bool:
        """Record one failure; True exactly when THIS call opened the
        circuit (callers log/journal outside the lock)."""
        with self._lock:
            self._probe_inflight = False
            self._failures += 1
            if self._failures >= self.threshold:
                self._open_until = time.monotonic() + self.cooldown
                # leave the count one short of the threshold: a failed
                # half-open probe re-opens immediately, a success resets
                self._failures = self.threshold - 1
                return True
            return False

    def ok(self) -> None:
        with self._lock:
            self._probe_inflight = False
            self._failures = 0
            self._open_until = 0.0


def build_client(kubeconfig: str = "") -> "RealKubeClient":
    """Standard client resolution: explicit kubeconfig → in-cluster
    service account → default kubeconfig path."""
    if kubeconfig:
        return RealKubeClient.from_kubeconfig(kubeconfig)
    if os.environ.get("KUBERNETES_SERVICE_HOST"):
        return RealKubeClient.in_cluster()
    return RealKubeClient.from_kubeconfig()

#: kind → (api prefix, plural, namespaced)
_KIND_INFO: Dict[str, Tuple[str, str, bool]] = {
    "Pod": ("api/v1", "pods", True),
    "Node": ("api/v1", "nodes", False),
    "ConfigMap": ("api/v1", "configmaps", True),
    # flight-recorder mirroring (obs/journal.emit_pod_event): pod-scoped
    # decisions become `kubectl describe pod` events
    "Event": ("api/v1", "events", True),
    "Namespace": ("api/v1", "namespaces", False),
    "Lease": ("apis/coordination.k8s.io/v1", "leases", True),
    KIND: (f"apis/{GROUP}/{VERSION}", PLURAL, True),
    # deploy-plane kinds: the operator never touches these at runtime,
    # but `make test-deploy` applies the rendered kustomize tree through
    # this client against the fake API server (wire-level apply check)
    "Deployment": ("apis/apps/v1", "deployments", True),
    "DaemonSet": ("apis/apps/v1", "daemonsets", True),
    "Service": ("api/v1", "services", True),
    "ServiceAccount": ("api/v1", "serviceaccounts", True),
    "ClusterRole": (
        "apis/rbac.authorization.k8s.io/v1", "clusterroles", False),
    "ClusterRoleBinding": (
        "apis/rbac.authorization.k8s.io/v1", "clusterrolebindings", False),
    "Role": ("apis/rbac.authorization.k8s.io/v1", "roles", True),
    "RoleBinding": (
        "apis/rbac.authorization.k8s.io/v1", "rolebindings", True),
    "CustomResourceDefinition": (
        "apis/apiextensions.k8s.io/v1", "customresourcedefinitions", False),
    "ServiceMonitor": (
        "apis/monitoring.coreos.com/v1", "servicemonitors", True),
}


def _raise_for(status: int, body: bytes) -> None:
    try:
        payload = json.loads(body.decode() or "{}")
    except ValueError:
        payload = {}
    message = payload.get("message", body.decode(errors="replace")[:300])
    reason = payload.get("reason", "")
    if status == 404:
        raise NotFound(message)
    if status == 409:
        if reason == "AlreadyExists":
            raise AlreadyExists(message)
        raise Conflict(message)
    if status == 400 or status == 422:
        raise BadRequest(message)
    if status == 410:
        raise ResourceVersionExpired(message)
    err = ApiError(f"HTTP {status}: {message}")
    err.code = status
    raise err


class RealKubeClient(KubeClient):
    """Talks to a live API server. Construct via :meth:`in_cluster`,
    :meth:`from_kubeconfig`, or directly with a base URL (tests)."""

    #: real watches are cheap to hold open; the reconcile Manager reads
    #: this to avoid 4-reconnects-per-second against a live API server
    preferred_watch_timeout = 15.0

    # --- retry/backoff policy (instance-overridable; client-go's
    # rest.Config QPS/backoff analog). A verb retries TRANSIENT failures
    # (connection reset/refused/timeout, truncated response, HTTP 429,
    # HTTP 5xx) up to max_attempts with capped exponential backoff +
    # decorrelated jitter; 429/503 Retry-After headers are honored
    # (capped). Non-transient API errors (404/409/400/410) surface
    # immediately — retrying a semantic error cannot help.
    max_attempts = 4
    backoff_base = 0.1
    backoff_cap = 5.0
    retry_after_cap = 30.0
    #: consecutive transient failures (across requests) that open the
    #: circuit breaker; while open every call fails fast with
    #: :class:`CircuitOpen` until the cooldown elapses, then ONE
    #: half-open probe is let through (a probe failure re-opens).
    breaker_threshold = 5
    breaker_cooldown = 10.0
    #: transparent in-stream watch re-establishments before giving up
    watch_reconnects = 5

    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        ca_file: Optional[str] = None,
        client_cert: Optional[Tuple[str, str]] = None,
        insecure_skip_verify: bool = False,
        token_file: Optional[str] = None,
        exec_config: Optional[dict] = None,
    ) -> None:
        """``token`` is a static bearer token. ``token_file`` points at a
        rotating credential (projected SA tokens rotate hourly on GKE) and
        is re-read when stale or on 401. ``exec_config`` is a kubeconfig
        ``user.exec`` stanza (client.authentication.k8s.io ExecCredential
        — how GKE kubeconfigs authenticate via ``gke-gcloud-auth-plugin``);
        the plugin's token is cached until its ``expirationTimestamp``.
        Resolution order per request: exec plugin → token file → static
        token. The reference inherits all of this from client-go
        (/root/reference/go.mod:60)."""
        self.base_url = base_url.rstrip("/")
        self._token = token
        self._token_file = token_file
        self._exec_config = exec_config
        self._cached_token: Optional[str] = None
        self._cached_token_expiry = 0.0   # monotonic deadline
        #: temp files holding materialized kubeconfig cert/key data —
        #: private-key material; deleted on close() (atexit-registered by
        #: from_kubeconfig)
        self._temp_files: List[str] = []
        # circuit breaker: shared across this client's threads (the
        # policy numbers stay client attributes — tests and embedders
        # tune them post-construction — and sync onto the breaker at
        # each use)
        self._breaker = CircuitBreaker(
            self.breaker_threshold, self.breaker_cooldown,
            name=self.base_url,
        )
        if self.base_url.startswith("https"):
            ctx = ssl.create_default_context(cafile=ca_file)
            if insecure_skip_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            if client_cert:
                ctx.load_cert_chain(*client_cert)
            self._ctx: Optional[ssl.SSLContext] = ctx
        else:
            self._ctx = None

    # ------------------------------------------------------------- config

    @classmethod
    def in_cluster(cls) -> "RealKubeClient":
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if ":" in host and not host.startswith("["):
            host = f"[{host}]"
        # token_file, not a one-shot read: projected SA tokens rotate
        # (kubelet refreshes the file); a process outliving the rotation
        # with a startup-read token gets 401s exactly when it matters
        return cls(
            f"https://{host}:{port}",
            token_file=os.path.join(SA_DIR, "token"),
            ca_file=os.path.join(SA_DIR, "ca.crt"),
        )

    @classmethod
    def from_kubeconfig(
        cls, path: str = "", context: str = ""
    ) -> "RealKubeClient":
        path = path or os.environ.get(
            "KUBECONFIG", os.path.expanduser("~/.kube/config")
        )
        with open(path) as f:
            cfg = load_kubeconfig(f.read())
        ctx_name = context or cfg.get("current-context", "")
        ctx = next(
            c["context"] for c in cfg["contexts"] if c["name"] == ctx_name
        )
        cluster = next(
            c["cluster"] for c in cfg["clusters"]
            if c["name"] == ctx["cluster"]
        )
        user = next(
            u["user"] for u in cfg["users"] if u["name"] == ctx["user"]
        )

        temp_files: List[str] = []

        def materialize(data_key: str, file_key: str, blob: dict):
            if file_key in blob:
                return blob[file_key]
            if data_key in blob:
                f = tempfile.NamedTemporaryFile(delete=False, suffix=".pem")
                f.write(base64.b64decode(blob[data_key]))
                f.close()
                temp_files.append(f.name)
                return f.name
            return None

        ca = materialize(
            "certificate-authority-data", "certificate-authority", cluster
        )
        cert = materialize(
            "client-certificate-data", "client-certificate", user
        )
        key = materialize("client-key-data", "client-key", user)
        client = cls(
            cluster["server"],
            token=user.get("token"),
            ca_file=ca,
            client_cert=(cert, key) if cert and key else None,
            insecure_skip_verify=bool(
                cluster.get("insecure-skip-tls-verify")
            ),
            exec_config=user.get("exec"),
        )
        # the cert chain is loaded into the ssl context at construction;
        # the key material need not persist on disk past process exit
        client._temp_files = temp_files
        atexit.register(client.close)
        return client

    def close(self) -> None:
        """Delete materialized cert/key temp files (idempotent)."""
        while self._temp_files:
            path = self._temp_files.pop()
            try:
                os.unlink(path)
            except OSError:
                pass

    # -------------------------------------------------------------- auth

    #: projected SA tokens rotate on the order of an hour; re-reading the
    #: file once a minute is free and never serves a token more than 60 s
    #: stale
    _TOKEN_FILE_TTL = 60.0

    def _run_exec_plugin(self) -> Tuple[str, float]:
        """Run the kubeconfig exec credential plugin; returns (token,
        seconds-until-refresh). client-go's exec transport analog."""
        spec = self._exec_config or {}
        cmd = [spec["command"]] + list(spec.get("args") or [])
        env = dict(os.environ)
        for kv in spec.get("env") or []:
            env[str(kv.get("name"))] = str(kv.get("value", ""))
        env["KUBERNETES_EXEC_INFO"] = json.dumps({
            "apiVersion": spec.get(
                "apiVersion", "client.authentication.k8s.io/v1"
            ),
            "kind": "ExecCredential",
            "spec": {"interactive": False},
        })
        try:
            out = subprocess.run(
                cmd, env=env, capture_output=True, timeout=60
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            raise ApiError(f"exec credential plugin: {e}") from None
        if out.returncode != 0:
            raise ApiError(
                "exec credential plugin failed: "
                + out.stderr.decode(errors="replace")[:300]
            )
        try:
            status = json.loads(out.stdout.decode()).get("status") or {}
        except ValueError:
            raise ApiError(
                "exec credential plugin emitted invalid JSON"
            ) from None
        token = status.get("token")
        if not token:
            raise ApiError("exec credential plugin returned no token")
        ttl = 300.0  # no expiry advertised → re-run every 5 min
        exp = status.get("expirationTimestamp")
        if exp:
            from datetime import datetime, timezone

            try:
                ts = datetime.fromisoformat(exp.replace("Z", "+00:00"))
                # refresh 60 s before expiry; floor at 10 s so the last
                # minute of a token's life doesn't spawn the plugin
                # subprocess on every single request
                ttl = max(
                    10.0,
                    (ts - datetime.now(timezone.utc)).total_seconds() - 60.0,
                )
            except ValueError:
                pass
        return token, ttl

    def _bearer_token(self) -> Optional[str]:
        """Current bearer token: exec plugin → token file → static."""
        now = time.monotonic()
        if self._cached_token is not None and now < self._cached_token_expiry:
            return self._cached_token
        if self._exec_config:
            token, ttl = self._run_exec_plugin()
            self._cached_token = token
            self._cached_token_expiry = now + ttl
            return token
        if self._token_file:
            with open(self._token_file) as f:
                self._cached_token = f.read().strip()
            self._cached_token_expiry = now + self._TOKEN_FILE_TTL
            return self._cached_token
        return self._token

    def _refreshable(self) -> bool:
        return bool(self._exec_config or self._token_file)

    def _invalidate_token(self) -> None:
        self._cached_token = None
        self._cached_token_expiry = 0.0

    # -------------------------------------------------------------- http

    def _path(self, kind: str, namespace: Optional[str], name: str = "",
              subresource: str = "") -> str:
        try:
            prefix, plural, namespaced = _KIND_INFO[kind]
        except KeyError:
            raise BadRequest(f"unmapped kind {kind!r}") from None
        parts = [self.base_url, prefix]
        if namespaced and namespace:
            parts += ["namespaces", urllib.parse.quote(namespace)]
        parts.append(plural)
        if name:
            parts.append(urllib.parse.quote(name))
        if subresource:
            parts.append(subresource)
        return "/".join(parts)

    # ----------------------------------------------------------- breaker

    def _sync_breaker(self) -> "CircuitBreaker":
        """The policy numbers live on the client (instance-tunable);
        copy them onto the shared breaker before each use."""
        b = self._breaker
        b.threshold = self.breaker_threshold
        b.cooldown = self.breaker_cooldown
        return b

    def _breaker_check(self) -> None:
        """Fail fast while the breaker is open (threshold consecutive
        transient failures); past the cooldown the caller becomes the
        half-open probe."""
        self._sync_breaker().check()

    def _breaker_fail(self) -> None:
        opened = self._sync_breaker().fail()
        if opened:
            # report outside the breaker lock: the span ring and the
            # journal ring must not order-couple to it
            log.warning(
                "kube circuit breaker OPEN for %.1fs (%s)",
                self.breaker_cooldown, self.base_url,
            )
            get_tracer().record(
                "kube.breaker_open", 0.0,
                cooldown=self.breaker_cooldown, server=self.base_url,
            )
            get_journal().emit(
                "kube", reason=REASON_BREAKER_OPEN,
                object_ref=self.base_url,
                message=(f"circuit breaker open for "
                         f"{self.breaker_cooldown:.1f}s after "
                         f"{self.breaker_threshold} consecutive "
                         "transient failures"),
            )

    def _breaker_ok(self) -> None:
        self._breaker.ok()

    @staticmethod
    def _retry_after_seconds(headers) -> Optional[float]:
        """Parse a Retry-After header (delta-seconds form; the HTTP-date
        form is ignored — kube API servers send seconds)."""
        raw = headers.get("Retry-After") if headers is not None else None
        if not raw:
            return None
        try:
            return max(0.0, float(raw))
        except ValueError:
            return None

    def _backoff_sleep(self, prev: float,
                       retry_after: Optional[float]) -> float:
        """Sleep with capped decorrelated jitter, stretched to honor a
        server-provided Retry-After; returns the new backoff state."""
        delay = min(self.backoff_cap,
                    random.uniform(self.backoff_base, prev * 3))
        if retry_after is not None:
            delay = max(delay, min(retry_after, self.retry_after_cap))
        get_journal().emit(
            "kube", reason=REASON_BACKOFF, object_ref=self.base_url,
            message=(f"backing off {delay:.3f}s"
                     + (f" (Retry-After {retry_after:g}s)"
                        if retry_after is not None else "")),
        )
        # a span, not a log line: backoff stalls inside a reconcile show
        # up as children of that reconcile's kube.request span, so a
        # slow grant is attributable to API-server pushback
        with get_tracer().span(
            "kube.backoff", delay=round(delay, 3),
            retry_after=retry_after if retry_after is not None else "",
        ):
            time.sleep(delay)
        return delay

    def _request(
        self,
        method: str,
        url: str,
        body: Optional[dict] = None,
        content_type: str = "application/json",
        timeout: float = 30.0,
    ) -> dict:
        # one span per API round-trip (retries included — the span's
        # duration is what the CALLER waited); errors and the attempt
        # count land in it, so trace-summary shows API-server pain
        path = (url[len(self.base_url):]
                if url.startswith(self.base_url) else url)
        with get_tracer().span(
            "kube.request", method=method, path=path.partition("?")[0],
        ) as sp:
            return self._request_attempts(
                method, url, body, content_type, timeout, sp
            )

    def _request_attempts(
        self,
        method: str,
        url: str,
        body: Optional[dict],
        content_type: str,
        timeout: float,
        sp,
    ) -> dict:
        data = None if body is None else json.dumps(body).encode()
        auth_retried = False
        attempt = 0
        delay = self.backoff_base
        last_exc: Optional[BaseException] = None
        while attempt < self.max_attempts:
            self._breaker_check()
            req = urllib.request.Request(url, data=data, method=method)
            req.add_header("Accept", "application/json")
            if data is not None:
                req.add_header("Content-Type", content_type)
            token = self._bearer_token()
            if token:
                req.add_header("Authorization", f"Bearer {token}")
            try:
                with urllib.request.urlopen(
                    req, context=self._ctx, timeout=timeout
                ) as resp:
                    self._breaker_ok()
                    if attempt:
                        sp.attrs["retries"] = str(attempt)
                    return json.loads(resp.read().decode() or "{}")
            except urllib.error.HTTPError as e:
                # rotated-out credential: refresh and retry once (not a
                # transient failure — doesn't count against attempts or
                # the breaker)
                if e.code == 401 and not auth_retried and self._refreshable():
                    auth_retried = True
                    self._invalidate_token()
                    continue
                payload = e.read()
                if e.code == 429 or e.code >= 500:
                    self._breaker_fail()
                    attempt += 1
                    if attempt >= self.max_attempts:
                        _raise_for(e.code, payload)
                    delay = self._backoff_sleep(
                        delay, self._retry_after_seconds(e.headers)
                    )
                    continue
                # semantic errors (404/409/400/410) are HEALTHY server
                # round-trips: they prove connectivity, so they reset
                # the consecutive-failure count like a 2xx — otherwise
                # a 404-heavy poll loop would let isolated transients
                # accumulate across hours and trip the breaker
                self._breaker_ok()
                _raise_for(e.code, payload)
                raise  # unreachable; _raise_for always raises
            except _TRANSIENT_EXC as e:
                self._breaker_fail()
                last_exc = e
                attempt += 1
                if attempt >= self.max_attempts:
                    break
                delay = self._backoff_sleep(delay, None)
        err = ApiError(
            f"{method} {url} failed after {attempt} attempts: "
            f"{type(last_exc).__name__}: {last_exc}"
        )
        err.code = 503
        raise err from last_exc

    # ------------------------------------------------------------- verbs

    def create(self, kind: str, obj: dict) -> dict:
        ns = obj.get("metadata", {}).get("namespace", "")
        return self._request("POST", self._path(kind, ns), obj)

    def get(self, kind: str, namespace: str, name: str) -> dict:
        return self._request(
            "GET", self._path(kind, namespace, name)
        )

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[dict]:
        url = self._path(kind, namespace)
        if label_selector:
            sel = ",".join(f"{k}={v}" for k, v in label_selector.items())
            url += "?" + urllib.parse.urlencode({"labelSelector": sel})
        out = self._request("GET", url)
        items = out.get("items", [])
        # list items omit apiVersion/kind; restore for manifest roundtrips
        for it in items:
            it.setdefault("kind", kind)
        return items

    def update(self, kind: str, obj: dict) -> dict:
        md = obj.get("metadata", {})
        return self._request(
            "PUT",
            self._path(kind, md.get("namespace", ""), md.get("name", "")),
            obj,
        )

    def patch(self, kind: str, namespace: str, name: str, patch: dict) -> dict:
        return self._request(
            "PATCH",
            self._path(kind, namespace, name),
            patch,
            content_type="application/merge-patch+json",
        )

    def patch_status(
        self, kind: str, namespace: str, name: str, patch: dict
    ) -> dict:
        return self._request(
            "PATCH",
            self._path(kind, namespace, name, subresource="status"),
            {"status": patch},
            content_type="application/merge-patch+json",
        )

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._request("DELETE", self._path(kind, namespace, name))

    # ------------------------------------------------------------- watch

    def watch(
        self,
        kind: str,
        namespace: Optional[str] = None,
        replay: bool = True,
        timeout: Optional[float] = None,
        resource_version: Optional[str] = None,
    ) -> Iterator[WatchEvent]:
        """List+watch with rv resume, per the KubeClient contract. A 410
        Gone on the resumed watch raises :class:`ResourceVersionExpired`
        so the caller relists with a fresh resourceVersion instead of
        hot-looping on the stale one (a real API server keeps only a
        bounded event window; the fake's log-tail replay has no such
        horizon). The stream ends after ``timeout`` seconds of quiet
        (socket read timeout) — the Manager re-establishes with the
        bookmark it last saw.

        A watch DROPPED mid-stream (connection reset, truncated chunk,
        5xx/429 at establishment) re-establishes transparently from the
        last seen resourceVersion with jittered backoff — up to
        ``watch_reconnects`` consecutive failures — so a flaky network
        path costs a short stall, not a cold relist; seen events are
        never replayed because the server resumes strictly after rv."""
        timeout = timeout if timeout is not None else 30.0

        def _connect(rv: Optional[str]):
            params = {
                "watch": "1",
                "allowWatchBookmarks": "true",
                "timeoutSeconds": str(max(1, int(timeout * 4))),
            }
            if rv:
                params["resourceVersion"] = rv
            url = (self._path(kind, namespace) + "?"
                   + urllib.parse.urlencode(params))
            req = urllib.request.Request(url, method="GET")
            req.add_header("Accept", "application/json")
            tok = self._bearer_token()
            if tok:
                req.add_header("Authorization", f"Bearer {tok}")
            return urllib.request.urlopen(
                req, context=self._ctx, timeout=timeout
            )

        def _stream() -> Iterator[WatchEvent]:
            rv = resource_version
            replay_events: List[WatchEvent] = []
            if replay or rv is None:
                url = self._path(kind, namespace)
                out = self._request("GET", url)
                rv = out.get("metadata", {}).get("resourceVersion", "") or rv
                for it in out.get("items", []):
                    it.setdefault("kind", kind)
                    replay_events.append(("ADDED", it))
            for ev in replay_events:
                yield ev
            # synthetic bookmark after the list burst so the consumer's
            # resume point advances even on a quiet cluster
            yield (
                "BOOKMARK",
                {"metadata": {"resourceVersion": rv or "0"}},
            )
            # A dropped watch re-establishes HERE, resuming from the
            # last seen resourceVersion with jittered backoff — seen
            # events are never replayed (the server resumes after rv)
            # and the consumer never restarts its burst cold. Clean
            # stream ends (server timeout / quiet period) still return:
            # the caller owns the long-term re-establishment cadence.
            reconnects = 0
            while True:
                try:
                    resp = _connect(rv)
                except urllib.error.HTTPError as e:
                    if e.code == 401 and self._refreshable():
                        self._invalidate_token()  # next attempt refreshes
                    payload = e.read()
                    if e.code == 429 or e.code >= 500:
                        reconnects += 1
                        if reconnects > self.watch_reconnects:
                            _raise_for(e.code, payload)
                        self._backoff_sleep(
                            self.backoff_base,
                            self._retry_after_seconds(e.headers),
                        )
                        continue
                    _raise_for(e.code, payload)  # 410 → RVExpired
                    return
                except _TRANSIENT_EXC as e:
                    reconnects += 1
                    if reconnects > self.watch_reconnects:
                        err = ApiError(
                            f"watch {kind} failed after {reconnects} "
                            f"attempts: {type(e).__name__}: {e}"
                        )
                        err.code = 503
                        raise err from e
                    self._backoff_sleep(self.backoff_base, None)
                    continue
                try:
                    buf = b""
                    while True:
                        try:
                            chunk = resp.read1(65536)
                        except (socket.timeout, TimeoutError):
                            return  # quiet period over; caller resumes
                        if not chunk:
                            return  # clean end; caller resumes by rv
                        buf += chunk
                        while b"\n" in buf:
                            line, buf = buf.split(b"\n", 1)
                            if not line.strip():
                                continue
                            rec = json.loads(line)
                            etype = rec.get("type", "")
                            obj = rec.get("object", {})
                            if etype == "ERROR":
                                if obj.get("code") == 410:
                                    raise ResourceVersionExpired(
                                        f"watch {kind} rv={rv} expired "
                                        "mid-stream"
                                    )
                                continue
                            seen = obj.get("metadata", {}).get(
                                "resourceVersion"
                            )
                            if seen:
                                rv = seen
                            # delivery proves the server is healthy:
                            # a fresh drop gets the full budget again
                            reconnects = 0
                            yield (etype, obj)
                except ResourceVersionExpired:
                    raise
                except (ConnectionResetError, http.client.IncompleteRead,
                        ssl.SSLError, OSError) as e:
                    # mid-stream transport drop (RST, truncated chunk):
                    # resume from the last seen rv instead of failing
                    # the whole stream back to a cold relist
                    get_tracer().record(
                        "kube.watch_reconnect", 0.0, kind=kind,
                        cause=type(e).__name__, rv=rv or "",
                    )
                    get_journal().emit(
                        "kube", reason=REASON_WATCH_RECONNECT,
                        object_ref=f"watch/{kind}",
                        message=(f"watch dropped ({type(e).__name__}); "
                                 f"resuming from rv={rv or '?'}"),
                    )
                    reconnects += 1
                    if reconnects > self.watch_reconnects:
                        err = ApiError(
                            f"watch {kind} dropped {reconnects} times: "
                            f"{type(e).__name__}: {e}"
                        )
                        err.code = 503
                        raise err from e
                    log.info(
                        "watch %s dropped (%s); resuming from rv=%s",
                        kind, type(e).__name__, rv,
                    )
                    self._backoff_sleep(self.backoff_base, None)
                finally:
                    resp.close()

        return _stream()
