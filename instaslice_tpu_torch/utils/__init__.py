"""Shared runtime utilities of the port, copied from ``instaslice_tpu/utils``
(the jax-free modules the serving plane needs)."""
