"""Observability of the port's serving plane: the event journal and the
continuous profiler, copied from ``instaslice_tpu/obs``."""
