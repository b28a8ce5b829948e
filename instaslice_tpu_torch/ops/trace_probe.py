"""Which device records a torch.profiler window drops, against the age of
the process.

    python3 instaslice_tpu_torch/ops/trace_probe.py [--seconds 330] [--gap 4]

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=330.0)
    ap.add_argument("--gap", type=float, default=4.0)
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
        time.sleep(args.gap)
    print(json.dumps({"windows": n, "lead_lost_max": worst,
                      "short_windows": short}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
