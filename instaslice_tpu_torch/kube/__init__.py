"""Kubernetes access layer.

The reference talks to the API server through controller-runtime's cached
client; the API server is the *only* communication bus in the whole system
(SURVEY.md §0: "no RPC exists anywhere"). This package keeps that shape:

- :mod:`client`  — the minimal client interface reconcilers are written
  against (get/list/create/update/patch/delete/watch + conflict-retry).
- :mod:`fake`    — a thread-safe in-process API server with
  resourceVersion optimistic concurrency, finalizer-aware deletion, and
  watch streams. The envtest analog (SURVEY.md §4 tier 2) — and more: it
  lets a simulated multi-node cluster (one controller + N agents, all in
  one process) exercise the controller↔agent state machine, which the
  reference never tests.
- :mod:`http`    — the real API-server client (stdlib HTTP, in-cluster
  service-account auth or kubeconfig token), same interface.

A copy of ``instaslice_tpu/kube/__init__.py`` (the port imports nothing
of the JAX package).
"""

from instaslice_tpu_torch.kube.client import (
    ApiError,
    Conflict,
    AlreadyExists,
    NotFound,
    ResourceVersionExpired,
    KubeClient,
    update_with_retry,
)
from instaslice_tpu_torch.kube.fake import FakeKube
from instaslice_tpu_torch.kube.informer import Informer
from instaslice_tpu_torch.kube.coalesce import CoalescedWriter
