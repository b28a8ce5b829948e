"""Serve a :class:`KubeClient` (normally the fake) over real HTTP with the
Kubernetes wire format — the envtest analog.

The reference's integration tier boots a real apiserver binary via
envtest (``suite_test.go:52-90``); none is available here, so this module
puts the in-process fake behind an actual HTTP server speaking the API
conventions (REST paths, list envelopes, watch streams with bookmarks,
merge-patch, status subresource, error payloads). ``RealKubeClient``
pointed at it exercises the full wire path — auth headers, URL building,
JSON verbs, streaming watch parsing — without a cluster.

A copy of ``instaslice_tpu/kube/httptest.py`` (the port imports nothing
of the JAX package).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from instaslice_tpu_torch.kube.client import (
    AlreadyExists,
    ApiError,
    BadRequest,
    Conflict,
    KubeClient,
    NotFound,
)
from instaslice_tpu_torch.kube.real import _KIND_INFO
from instaslice_tpu_torch.utils.guards import unguarded

_PLURAL_TO_KIND = {
    (prefix, plural): kind
    for kind, (prefix, plural, _) in _KIND_INFO.items()
}


def _parse(path: str) -> Tuple[str, Optional[str], str, str]:
    """URL path → (kind, namespace, name, subresource)."""
    parts = [p for p in path.split("/") if p]
    if not parts:
        raise BadRequest(f"bad path {path!r}")
    if parts[0] == "api":
        prefix_len = 2           # api/v1
    elif parts[0] == "apis":
        prefix_len = 3           # apis/<group>/<version>
    else:
        raise BadRequest(f"bad path {path!r}")
    prefix = "/".join(parts[:prefix_len])
    rest = parts[prefix_len:]
    namespace: Optional[str] = None
    if len(rest) >= 2 and rest[0] == "namespaces":
        namespace = rest[1]
        rest = rest[2:]
    if not rest:
        raise BadRequest(f"bad path {path!r}")
    plural, rest = rest[0], rest[1:]
    kind = _PLURAL_TO_KIND.get((prefix, plural))
    if kind is None:
        raise NotFound(f"no resource {prefix}/{plural}")
    name = rest[0] if rest else ""
    sub = rest[1] if len(rest) > 1 else ""
    return kind, namespace, name, sub


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.0"  # close-delimited: simplest for streams
    # bound once on the handler subclass at server construction, before
    # serve_forever(); request threads only read (the fake client
    # underneath carries its own lock)
    kube: unguarded("class attr set before the server thread starts; "
                    "handler threads only read") = None
    #: when set, every request's Bearer token must satisfy it or 401 —
    #: lets tests exercise the client's token-refresh / exec-plugin path
    token_validator = None  # Optional[Callable[[Optional[str]], bool]]
    #: when set, watch resumes with resourceVersion < this respond 410 —
    #: models the real API server's bounded event window
    min_watch_rv: Optional[int] = None

    def log_message(self, *a):  # quiet
        pass

    def _authorized(self) -> bool:
        if type(self).token_validator is None:
            return True
        auth = self.headers.get("Authorization", "")
        tok = auth[len("Bearer "):] if auth.startswith("Bearer ") else None
        return bool(type(self).token_validator(tok))

    def _send_401(self) -> None:
        self._send_json(
            401,
            {"kind": "Status", "status": "Failure",
             "message": "Unauthorized", "reason": "Unauthorized",
             "code": 401},
        )

    # ------------------------------------------------------------ helpers

    def _send_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_error_obj(self, e: ApiError) -> None:
        reason = {
            404: "NotFound",
            400: "BadRequest",
        }.get(e.code, "Conflict" if e.code == 409 else "InternalError")
        if isinstance(e, AlreadyExists):
            reason = "AlreadyExists"
        elif isinstance(e, Conflict):
            reason = "Conflict"
        self._send_json(
            e.code,
            {
                "kind": "Status",
                "status": "Failure",
                "message": str(e),
                "reason": reason,
                "code": e.code,
            },
        )

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length", "0") or 0)
        raw = self.rfile.read(n) if n else b"{}"
        return json.loads(raw.decode() or "{}")

    def _query(self) -> dict:
        from urllib.parse import parse_qs, urlsplit

        q = parse_qs(urlsplit(self.path).query)
        return {k: v[0] for k, v in q.items()}

    @property
    def _clean_path(self) -> str:
        from urllib.parse import urlsplit

        return urlsplit(self.path).path

    # -------------------------------------------------------------- verbs

    def do_GET(self):
        if not self._authorized():
            self._send_401()
            return
        try:
            kind, ns, name, _ = _parse(self._clean_path)
            q = self._query()
            if name:
                self._send_json(200, self.kube.get(kind, ns or "", name))
                return
            if q.get("watch") in ("1", "true"):
                self._do_watch(kind, ns, q)
                return
            sel = None
            if "labelSelector" in q:
                sel = dict(
                    kv.split("=", 1) for kv in q["labelSelector"].split(",")
                )
            items = self.kube.list(kind, namespace=ns, label_selector=sel)
            rv = getattr(self.kube, "_rv", 0)
            self._send_json(
                200,
                {
                    "kind": f"{kind}List",
                    "items": items,
                    "metadata": {"resourceVersion": str(rv)},
                },
            )
        except ApiError as e:
            self._send_error_obj(e)

    def _do_watch(self, kind, ns, q):
        floor = type(self).min_watch_rv
        rv_q = q.get("resourceVersion")
        if floor is not None and rv_q is not None:
            try:
                if int(rv_q) < floor:
                    self._send_json(
                        410,
                        {"kind": "Status", "status": "Failure",
                         "message": "too old resource version",
                         "reason": "Expired", "code": 410},
                    )
                    return
            except ValueError:
                pass
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        deadline = time.monotonic() + float(q.get("timeoutSeconds", 30))
        rv = q.get("resourceVersion")
        try:
            while time.monotonic() < deadline:
                for event, obj in self.kube.watch(
                    kind, namespace=ns, replay=False,
                    timeout=0.2, resource_version=rv or "0",
                ):
                    md = obj.get("metadata", {})
                    if md.get("resourceVersion"):
                        rv = md["resourceVersion"]
                    self.wfile.write(
                        (json.dumps({"type": event, "object": obj}) + "\n")
                        .encode()
                    )
                    self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            return

    def do_POST(self):
        if not self._authorized():
            self._send_401()
            return
        try:
            kind, _, _, _ = _parse(self._clean_path)
            self._send_json(201, self.kube.create(kind, self._body()))
        except ApiError as e:
            self._send_error_obj(e)

    def do_PUT(self):
        if not self._authorized():
            self._send_401()
            return
        try:
            kind, _, _, _ = _parse(self._clean_path)
            self._send_json(200, self.kube.update(kind, self._body()))
        except ApiError as e:
            self._send_error_obj(e)

    def do_PATCH(self):
        if not self._authorized():
            self._send_401()
            return
        try:
            kind, ns, name, sub = _parse(self._clean_path)
            patch = self._body()
            if sub == "status":
                out = self.kube.patch_status(
                    kind, ns or "", name, patch.get("status", patch)
                )
            else:
                out = self.kube.patch(kind, ns or "", name, patch)
            self._send_json(200, out)
        except ApiError as e:
            self._send_error_obj(e)

    def do_DELETE(self):
        if not self._authorized():
            self._send_401()
            return
        try:
            kind, ns, name, _ = _parse(self._clean_path)
            self.kube.delete(kind, ns or "", name)
            self._send_json(200, {"kind": "Status", "status": "Success"})
        except ApiError as e:
            self._send_error_obj(e)


class FakeApiServer:
    """The fake kube API behind a real HTTP listener."""

    def __init__(self, kube: KubeClient, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        handler = type("BoundHandler", (_Handler,), {"kube": kube})
        self.handler = handler
        self._srv = ThreadingHTTPServer((host, port), handler)
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="fake-apiserver",
            daemon=True,
        )

    @property
    def url(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "FakeApiServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "FakeApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
