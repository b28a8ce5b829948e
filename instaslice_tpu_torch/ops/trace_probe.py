"""Which device records a torch.profiler window drops, against the age of
the process.

    python3 instaslice_tpu_torch/ops/trace_probe.py [--seconds 330] [--gap 4]
    python3 instaslice_tpu_torch/ops/trace_probe.py --sizes 100000,400000 \
        [--graph] [--buffer-mb 1024]

``chip_smoke.py`` counts a serving path's kernel launches from a
torch.profiler (CUPTI) trace of the card, and kineto drops some of a
window's first device records as "Out-of-range" (``KINETO_LOG_LEVEL=1``
prints its per-window record counts to stderr). This script opens one
window every ``--gap`` seconds for ``--seconds`` seconds, in turn of four
kinds, each a lead-in of ``torch.cuda._sleep`` markers, 1000 small
kernels on the current stream and a ~3 ms end marker:

- ``short``: 256 markers of 100 clock cycles (launch-bound, ~5 us apart);
- ``long``: 64 markers of 500,000 cycles (~0.3 ms each);
- ``sleep``: as ``short``, after the host sleeps 0.25 s in the window;
- ``streams``: as ``short``, and 1000 more kernels on a second stream.

Each window prints one JSON line: the process's age, the kind, the lead
markers lost, the end markers seen, and the work kernels seen by stream
against those launched. Needs one NVIDIA card; prints its name and power
limit first, and last one JSON line of the largest loss by kind and the
windows whose work or end marker was short.

With ``--sizes`` it asks instead whether a window's size loses its end:
one window for each count of work kernels (eager, or with ``--graph``
replays of a captured graph of 1000), each between 256 short markers and
the end marker, and one JSON line a window (markers and work kernels
seen, seconds). ``--buffer-mb`` passes kineto's
``ACTIVITIES_MAX_GPU_BUFFER_SIZE_MB`` through the profiler's
``experimental_config`` (under 2048: kineto holds it in bytes in a 32-bit
int); ``KINETO_LOG_LEVEL=0`` shows the configuration kineto took and its
record counts.

With ``--edges`` each window instead holds what a served window holds:
two host threads, each replaying a captured graph on a stream of its own
for ``--work-s`` seconds, between 4096 short markers and the end marker
with a ``--settle`` second wait before the stop. Each window prints the
markers seen and how far the first marker's and the end marker's device
times lie inside the host's start and stop (``start_ms``, ``end_ms``:
the end marker's end to the stop; about ``--settle`` if the two clocks
agree).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

#: kind -> (lead markers, cycles each, host sleep before them, second
#: stream)
KINDS = {"short": (256, 100, 0.0, False),
         "long": (64, 500_000, 0.0, False),
         "sleep": (256, 100, 0.25, False),
         "streams": (256, 100, 0.0, True)}
WORK = 1000
END_CYCLES = 5_000_000
END_NS = 1_000_000


def window(torch, kind: str, t0: float, x, y, side) -> dict:
    """One profiler window of ``kind`` (see the module's docstring)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lead, cycles, sleep, two = KINDS[kind]
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    if sleep:
        time.sleep(sleep)
    for _ in range(lead):
        torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    if two:
        with torch.cuda.stream(side):
            for _ in range(WORK):
                y.add_(1.0)
    for _ in range(WORK):
        x.add_(1.0)
    torch.cuda.synchronize()
    torch.cuda._sleep(END_CYCLES)
    torch.cuda.synchronize()
    time.sleep(0.25)
    prof.__exit__(None, None, None)
    kept = end = 0
    work = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if "spin_kernel" not in e.name():
            key = str(e.device_resource_id())
            work[key] = work.get(key, 0) + 1
        elif e.duration_ns() > END_NS:
            end += 1
        else:
            kept += 1
    return {"age_s": round(time.perf_counter() - t0, 1), "kind": kind,
            "lead": lead, "lead_lost": lead - kept, "end": end,
            "work": work, "work_launched": WORK * (2 if two else 1)}


def profiler(torch, buffer_mb: int = 0):
    """A CUDA-activity profiler; ``buffer_mb`` > 0 raises kineto's cap on
    the CUPTI buffers of one window (a key of its own line in the
    configuration string the profiler hands kineto)."""
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    if buffer_mb:
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(
            custom_profiler_config=(
                f"\nACTIVITIES_MAX_GPU_BUFFER_SIZE_MB={buffer_mb}"))
    return profile(activities=[ProfilerActivity.CUDA], **kw)


def size_window(torch, n: int, graph, buffer_mb: int, x) -> dict:
    """One window of ``n`` work kernels (``graph``: replays of a graph of
    1000) between 256 short markers and the end marker."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    t = time.perf_counter()
    prof = profiler(torch, buffer_mb)
    prof.__enter__()
    for _ in range(256):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()
    if graph is None:
        for _ in range(n):
            x.add_(1.0)
    else:
        for _ in range(n // 1000):
            graph.replay()
    torch.cuda.synchronize()
    torch.cuda._sleep(END_CYCLES)
    torch.cuda.synchronize()
    time.sleep(0.25)
    prof.__exit__(None, None, None)
    lead = end = work = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if "spin_kernel" not in e.name():
            work += 1
        elif e.duration_ns() > END_NS:
            end += 1
        else:
            lead += 1
    return {"n": n, "graph": graph is not None, "buffer_mb": buffer_mb,
            "lead": lead, "end": end, "work": work,
            "seconds": round(time.perf_counter() - t, 2)}


def sizes(torch, args) -> int:
    """The ``--sizes`` mode (see the module's docstring)."""
    x = torch.zeros(16, device="cuda")
    graph = None
    if args.graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            x.add_(1.0)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(1000):
                x.add_(1.0)
    short = []
    for n in (int(v) for v in args.sizes.split(",")):
        row = size_window(torch, n, graph, args.buffer_mb, x)
        print(json.dumps(row), flush=True)
        if row["end"] != 1 or row["work"] != n:
            short.append(n)
    print(json.dumps({"sizes": args.sizes, "graph": args.graph,
                      "buffer_mb": args.buffer_mb, "short": short}),
          flush=True)
    return 0


def edge_window(torch, args, workers) -> dict:
    """One ``--edges`` window (see the module's docstring)."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    prof = profiler(torch)
    t_start = time.time_ns()
    prof.__enter__()
    for _ in range(4096):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()
    replays = [0] * len(workers)
    go = time.perf_counter() + args.work_s
    import threading

    def work(i):
        g, st = workers[i]
        with torch.cuda.stream(st):
            while time.perf_counter() < go:
                g.replay()
                replays[i] += 1
                st.synchronize()
                # a probe's pacing for its fixed run: nothing stops it early
                time.sleep(0.0005)  # slicelint: disable=sleep-in-loop

    ts = [threading.Thread(target=work, args=(i,)) for i in range(
        len(workers))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    torch.cuda.synchronize()
    torch.cuda._sleep(END_CYCLES // 5)
    torch.cuda.synchronize()
    time.sleep(args.settle)
    t_stop = time.time_ns()
    prof.__exit__(None, None, None)
    lead, ends, work_n, first = 0, [], 0, None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if "spin_kernel" not in e.name():
            work_n += 1
        elif e.duration_ns() > END_NS // 4:
            ends.append(e.start_ns() + e.duration_ns())
        else:
            lead += 1
            first = e.start_ns() if first is None else min(first,
                                                           e.start_ns())
    return {"lead": lead, "end": len(ends), "work": work_n,
            "work_launched": sum(replays) * GRAPH_N,
            "start_ms": None if first is None else (first - t_start) / 1e6,
            "end_ms": None if not ends else (t_stop - max(ends)) / 1e6}


GRAPH_N = 200


def edges(torch, args) -> int:
    """The ``--edges`` mode (see the module's docstring)."""
    workers = []
    for _ in range(2):
        st = torch.cuda.Stream()
        x = torch.zeros(1 << 16, device="cuda")
        with torch.cuda.stream(st):
            x.add_(1.0)
        st.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=st):
            for _ in range(GRAPH_N):
                x.add_(1.0)
        workers.append((g, st))
    t0 = time.perf_counter()
    rows = []
    while time.perf_counter() - t0 < args.seconds:
        row = edge_window(torch, args, workers)
        row["age_s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(row), flush=True)
        rows.append(row)
    ends = [r["end_ms"] for r in rows if r["end_ms"] is not None]
    starts = [r["start_ms"] for r in rows if r["start_ms"] is not None]
    print(json.dumps({
        "windows": len(rows), "settle_s": args.settle,
        "end_lost": sum(r["end"] != 1 for r in rows),
        "work_short": sum(r["work"] != r["work_launched"] for r in rows),
        "end_ms_min": min(ends, default=None),
        "end_ms_max": max(ends, default=None),
        "start_ms_min": min(starts, default=None),
        "start_ms_max": max(starts, default=None)}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=330.0)
    ap.add_argument("--gap", type=float, default=4.0)
    ap.add_argument("--sizes", default="")
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--buffer-mb", type=int, default=0)
    ap.add_argument("--edges", action="store_true")
    ap.add_argument("--work-s", type=float, default=2.0)
    ap.add_argument("--settle", type=float, default=0.25)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("trace_probe: needs one NVIDIA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    if args.sizes:
        return sizes(torch, args)
    if args.edges:
        return edges(torch, args)
    x = torch.zeros(16, device="cuda")
    y = torch.zeros(16, device="cuda")
    side = torch.cuda.Stream()
    worst = dict.fromkeys(KINDS, 0)
    short, n = [], 0
    while time.perf_counter() - t0 < args.seconds:
        kind = list(KINDS)[n % len(KINDS)]
        row = window(torch, kind, t0, x, y, side)
        print(json.dumps(row), flush=True)
        worst[kind] = max(worst[kind], row["lead_lost"])
        if row["end"] != 1 or sum(row["work"].values()) != row[
                "work_launched"]:
            short.append(row)
        n += 1
        # a probe's pacing for its fixed run: nothing stops it early
        time.sleep(args.gap)  # slicelint: disable=sleep-in-loop
    print(json.dumps({"windows": n, "lead_lost_max": worst,
                      "short_windows": short}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
