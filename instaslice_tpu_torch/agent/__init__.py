"""The node agent's device handoff (``handoff.py``), copied from
``instaslice_tpu/agent/``. Its discovery, reconciler and runner take a
kube client and come with the port of ``kube/``."""
