"""Timestamp helpers shared by controller and leader election: the fake
kube writes epoch floats, a real API server writes RFC3339 strings; both
must parse to epoch seconds.

A copy of ``instaslice_tpu/utils/timeutil.py`` (the port imports nothing
of the JAX package).
"""

from __future__ import annotations

import datetime
import logging

log = logging.getLogger("instaslice_tpu_torch")


def parse_timestamp(val) -> float:
    """Epoch seconds from a numeric value (FakeKube) or an RFC3339 string
    ('2026-07-29T08:00:00Z' / '...Z' with fractional seconds)."""
    if val is None:
        return 0.0
    try:
        return float(val)
    except (TypeError, ValueError):
        pass
    try:
        # 'Z' suffix only parses from 3.11; normalize for 3.10
        return datetime.datetime.fromisoformat(
            str(val).replace("Z", "+00:00")
        ).timestamp()
    except ValueError:
        # epoch 0 = "long expired": callers proceed rather than restarting
        # their grace window on every reconcile
        log.warning("unparseable timestamp %r; treating as epoch", val)
        return 0.0


def rfc3339_now() -> str:
    """Current time in the RFC3339Micro form the Lease API expects."""
    return (
        datetime.datetime.now(datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%S.%f")
        + "Z"
    )
