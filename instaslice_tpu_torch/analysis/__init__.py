"""The port's build and CI gates, copied from the reference's ``tools/``:
the static pair (``slicelint``, ``slicecheck``, standard library only, run
by the port's images before ``pip install``) and the observability gates
(``validate_trace``, ``validate_events``, ``telemetry_smoke``,
``profile_smoke``) over the port's sim, server, router, loadgen and
aggregator. Each runs as ``python -m instaslice_tpu_torch.analysis.<name>``."""
