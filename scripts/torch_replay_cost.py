"""What one replayed ``acc(x)`` costs the host, piece by piece, on the card.

Usage (from the repo root, on a machine with an NVIDIA GPU):
    PYTHONPATH=src python scripts/torch_replay_cost.py

Builds the NID-MLP standard variant (4096 flows) and the FULL CNV standard
variant (256 images) of the golden files on the card, each at one
microbatch (the tile ``tune_engine`` chose for both on the H100), and
times the first ``acc(x)``, which runs the stream eagerly and captures it.
Then, with the card kept busy by a spin kernel so that only the host's
enqueue is timed (microseconds a call, the median of five runs of 200
calls): the captured graph's ``replay()``
alone, the whole ``acc(x)``, the eager stream (``engine._stream``), and
the pieces of ``acc(x)`` around the replay (``engine.params``,
``engine.plan``, the graph key ``_GraphCache.key``, the replay stream's
check, the input copy and the output clone).  Last, one call of each arm from an idle card: the card's
time between events recorded around it and the host's time to its last
result (median of 20).  Needs no JAX.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

SPIN_CYCLES = 200_000_000  # the card's busy time while the host enqueues


def host_us(fn, calls: int = 200, runs: int = 5) -> float:
    """Median host microseconds a call of ``fn``, enqueued behind a spin."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out)


def one_call(fn, reps: int = 20) -> tuple[float, float]:
    """(card ms between events around one call, host ms to its last result)."""
    import torch

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    card, host = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        card.append(e0.elapsed_time(e1))
    return statistics.median(card), statistics.median(host)


def report(label: str, acc, x) -> None:
    import torch

    from repro_torch.core import engine as engine_mod

    eng = acc.engine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc(x)  # the eager run and the capture
    torch.cuda.synchronize()
    print(f"{label}: first acc(x) (the eager run and the capture) "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    graphs = eng._graphs._graphs
    g = next(g for k, g in graphs.items() if k[1] == tuple(x.shape))
    def eager():
        return eng._stream(eng.params, x, 1)

    pieces = {"replay()": g.replay, "acc(x)": lambda: acc(x), "eager stream": eager,
              "engine.params": lambda: eng.params,
              "engine.plan": lambda: eng.plan(x.shape[0]),
              "graph key": lambda: eng._graphs.key(eng.params, x, 1),
              "stream check": lambda: engine_mod._current_stream_id(x.device),
              "input copy_": lambda: g.x.copy_(x), "output clone": g.out.clone}
    print(f"{label}: host us a call, the card busy: " + ", ".join(
        f"{name} {host_us(fn):.2f}" for name, fn in pieces.items()), flush=True)
    for name in ("replay()", "acc(x)", "eager stream"):
        card, host = one_call(pieces[name])
        print(f"{label}: one {name} from an idle card: {card:.4f} ms between its events, "
              f"{host:.4f} ms host to the last result", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.build import build
    from repro_torch.configs import cnv_bnn, nid_mlp
    from repro_torch.data import nid

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{torch.__version__} CUDA {torch.version.cuda}; {smi.strip()}", flush=True)
    gd = nid_mlp.load_golden()["standard"]
    acc = build(nid_mlp.build_graph(gd["seed"]), target="engine", folding=nid_mlp.foldings(),
                device="cuda", **gd["build"])
    acc.engine._tile = 4096
    report("nid standard 4096, one microbatch", acc,
           torch.from_numpy(nid.make_dataset(4096, seed=gd["data_seed"])[0]).cuda())
    gd = cnv_bnn.load_golden()["standard"]
    kw = gd["build"]
    acc = build(cnv_bnn.build_graph(cnv_bnn.spec_for(kw), seed=gd["seed"]), target="engine",
                device="cuda", **kw)
    acc.engine._tile = 256
    report("cnv standard 256, one microbatch", acc,
           torch.from_numpy(cnv_bnn.images(256, kw["act_bits"], gd["data_seed"])).cuda())
    return 0


if __name__ == "__main__":
    sys.exit(main())
