"""Tiny env-knob parsers shared across components.

One implementation so a knob's parse rule and its default cannot drift
between the library constructor that honors it and the CLI/doc that
names it (the same reason ``serving/api_server.py`` grew its private
``_env_float`` — new call sites use THIS one).

A copy of ``instaslice_tpu/utils/envutil.py`` (the port imports nothing
of the JAX package).
"""

from __future__ import annotations

import os


def env_float(name: str, default: float) -> float:
    """``float(os.environ[name])`` with ``default`` for unset/empty.
    A malformed value raises — a chaos/watchdog knob that silently
    fell back would invalidate the run it was meant to shape."""
    raw = os.environ.get(name, "")
    return float(raw) if raw else default
