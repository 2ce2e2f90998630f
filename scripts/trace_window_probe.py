"""How often a ``torch.profiler`` trace of a short call loses its device
events, with and without a host pause around the traced call.

Usage (from the repo root, on a machine with an NVIDIA GPU):
    python scripts/trace_window_probe.py [--n 300] [--pauses 0 0.05]

Traces each of three workloads ``--n`` times for each pause, as
``chip_smoke.trace_acc`` traces ``acc(x)``: two untraced calls, then a
profiler schedule of one warm-up and one active step, the active step's
call inside a ``record_function`` mark and followed by a device
synchronize, the pause (seconds) slept before and after it.  The
workloads are a CUDA graph of 4 tiny kernels, one of 400, and 4 tiny
kernels launched eagerly.  For each (workload, pause) it counts the traces
whose kernel events are not exactly the launched ones, and gives the least,
median and largest offset of the first kernel event from the mark (us, on
the trace's clock).

Writes ``chiprun_out/trace_window_probe.json`` and prints one line per
(workload, pause).  Needs no JAX and launches no hand-written kernel.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "chiprun_out")


def trace_kernels(fn, pause: float, path: str) -> tuple[int, float | None]:
    """The kernel events of one trace of ``fn()`` and the first one's
    offset from the call's mark (us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for step in range(2):
            if step == 1:
                time.sleep(pause)
            with record_function("probe.call"):
                fn()
                torch.cuda.synchronize()
            if step == 1:
                time.sleep(pause)
            prof.step()
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    kernels = [float(e["ts"]) for e in events if str(e.get("cat", "")).lower() == "kernel"]
    marks = [float(e["ts"]) for e in events if e.get("name") == "probe.call"]
    return len(kernels), (min(kernels) - marks[0]) if kernels and marks else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=300, help="traces per workload and pause")
    ap.add_argument("--pauses", type=float, nargs="+", default=[0.0, 0.05])
    args = ap.parse_args()

    import torch

    dev = torch.device("cuda")
    x = torch.zeros(1024, device=dev)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        for _ in range(12):
            x.add_(1)
    torch.cuda.synchronize()
    graphs = {}
    for n in (4, 400):
        graphs[n] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[n]):
            for _ in range(n):
                x.add_(1)
    torch.cuda.synchronize()
    workloads = (("graph of 4", graphs[4].replay, 4), ("graph of 400", graphs[400].replay, 400),
                 ("eager 4", lambda: [x.add_(1) for _ in range(4)], 4))
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "trace_window_probe.json.gz")
    res = []
    for name, fn, want in workloads:
        for pause in args.pauses:
            got = [trace_kernels(fn, pause, path) for _ in range(args.n)]
            offs = sorted(o for _, o in got if o is not None)
            r = {"workload": name, "pause_s": pause, "traces": args.n,
                 "lost": sum(n != want for n, _ in got),
                 "kernels_when_lost": sorted({n for n, _ in got if n != want}),
                 "first_kernel_minus_mark_us": [offs[0], offs[len(offs) // 2], offs[-1]]
                 if offs else None}
            res.append(r)
            print(json.dumps(r), flush=True)
    os.remove(path)
    with open(os.path.join(OUT, "trace_window_probe.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "runs": res}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
