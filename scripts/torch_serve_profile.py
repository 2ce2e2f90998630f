"""Where the host's time goes when the port serves the NID-MLP.

Usage (from the repo root; ``--device cpu`` runs the kernels' plain
versions, the default is the CUDA device):
    PYTHONPATH=src python scripts/torch_serve_profile.py [--device cpu] [--top 25]

Builds the NID-MLP standard variant of the golden file with
``target="serving"`` and serves the 4,096 flows of ``nid.make_dataset(4096,
seed=1)`` through ``acc.serve(batch_buckets=(1, 8, 32, 128), slo_s=0.05)``
in the bursts of ``chip_smoke.py``'s serve phase (sizes 1-128 from a seeded
generator, closed loop), three times: untimed (warm-up), timed on the host
clock, and under ``cProfile``.  Prints the timed run's flows/s and its
dispatched batches, then the profiled run's functions with the most own
time and the serving methods with their cumulative time, each with its
calls and microseconds per call, and the share of the profiled run spent
in the kernel wrappers' launches.  The profiler's own overhead inflates
every Python call; compare shares within one run, not against the timed
rate.  Needs no JAX.
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (burst_sizes, serve_stream, record_dispatches)

SERVING_METHODS = ("poll", "harvest", "_harvest_once", "_dispatch", "_complete", "_record",
                   "dispatch", "resolve", "submit_batch", "submit", "pop", "observe_latency",
                   "ready", "_stream", "_chain")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import numpy as np
    import torch

    from repro_torch.build import build
    from repro_torch.configs import nid_mlp
    from repro_torch.data import nid

    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    gd = nid_mlp.load_golden()["standard"]
    acc = build(nid_mlp.build_graph(gd["seed"]), target="serving", tune="off",
                folding=nid_mlp.foldings(), device=dev, **gd["build"])
    xs = nid.make_dataset(gd["batch"], seed=gd["data_seed"])[0]
    want = acc(torch.from_numpy(xs).to(dev)).cpu().numpy()
    sizes = chip_smoke.burst_sizes(len(xs), chip_smoke.SERVE_SEED)

    def run():
        batcher = acc.serve(batch_buckets=chip_smoke.SERVE_BUCKETS,
                            slo_s=chip_smoke.SERVE_SLO_S)
        log = chip_smoke.record_dispatches(batcher.pool)
        t0 = time.perf_counter()
        rids = chip_smoke.serve_stream(batcher, xs, sizes)
        batcher.drain(timeout=300)
        wall = time.perf_counter() - t0
        y = np.stack([batcher.results[r].out for r in rids])
        chip_smoke.check(np.array_equal(y, want), "served outputs differ from acc(x)")
        return wall, log

    run()
    wall, log = run()
    print(f"serve: {len(xs)} flows in {len(sizes)} bursts, {len(log)} batches: "
          f"{len(xs) / wall:.1f} flows/s ({wall * 1e3:.3f} ms) on {dev}", flush=True)
    prof = cProfile.Profile()
    prof.enable()
    pwall, _ = run()
    prof.disable()
    stats = pstats.Stats(prof)
    total = sum(v[2] for v in stats.stats.values())  # own time of every function
    print(f"profiled run: {pwall * 1e3:.3f} ms wall, {total * 1e3:.3f} ms of own time "
          "(the profiler's overhead included)", flush=True)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:args.top]
    for (path, line, name), (_, ncalls, tt, ct, _) in rows:
        print(f"own: {tt * 1e3:9.3f} ms {tt / total * 100:5.1f}% {ncalls:7d} calls "
              f"{tt / ncalls * 1e6:8.2f} us/call  {os.path.relpath(path, HERE)}:{line} {name}",
              flush=True)
    for (path, line, name), (_, ncalls, tt, ct, _) in sorted(
            stats.stats.items(), key=lambda kv: -kv[1][3]):
        if name in SERVING_METHODS and "repro_torch" in path:
            print(f"cumulative: {ct * 1e3:9.3f} ms {ct / total * 100:5.1f}% {ncalls:7d} calls "
                  f"{ct / ncalls * 1e6:8.2f} us/call  {os.path.relpath(path, HERE)}:{line} "
                  f"{name}", flush=True)
    launch = sum(v[3] for (path, _, name), v in stats.stats.items()
                 if name == "run" and path.endswith("_cuda.py"))
    print(f"kernel launches (_cuda.Library.run, cumulative): {launch * 1e3:.3f} ms, "
          f"{launch / total * 100:.1f}% of the profiled own time", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
