#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure exits non-zero:

1. env     torch and CUDA versions, the card's name and power limit.
2. build   the MVU kernel from ``src/repro_torch/kernels/csrc/`` (nvcc).
3. kernel  ``mvu_int`` against ``mvu_int_plain`` on the card at every
           (N, K) of the NID path, M in {1, 3, 128, 4096}, all three
           epilogues, 2-bit and full-int8 weights: exact equality.  Device
           times (CUDA events, median) of the kernel, its plain version and
           a float32 ``torch.matmul`` + epilogue yardstick (``library_ms``;
           exact here since |acc| < 2^24), beside the least time the card
           needs (bytes at 3.35 TB/s or operations at the 1,979 TOP/s int8
           tensor-core peak, whichever is larger).
4. slice   the NID-MLP (Table 6) built on the card at 2-bit weights and
           activations; ``acc(x)`` on ``nid.make_dataset(4096, seed=1)``
           must equal ``acc.interpret(x)`` and the JAX package's golden
           digest, and must launch the kernel exactly 4 x n_micro times;
           flows/s at batch 4096 and 65536 (host clock, synchronised).
5. the kernels JSON line, the card's ``nvidia-smi`` line, and last the
   result line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package (``src/repro``).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
KERNEL_MS = (1, 3, 128, 4096)
SLEEP_CYCLES = 50_000_000  # keeps the card busy while a timed loop is enqueued


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def device_ms(fn, reps: int, trials: int = 5) -> float:
    """Median device milliseconds per call of ``fn`` (CUDA events).

    The card sleeps while the host enqueues ``reps`` calls, so the events
    time back-to-back device work, not the host's launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(trials):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(m: int, n: int, k: int, epilogue_bytes: int) -> tuple[float, str]:
    """Least ms the card needs for one launch: read A (int32) and W (int8)
    and the epilogue operand once, write the (M, N) 4-byte output once."""
    by = m * k * 4 + n * k + epilogue_bytes + m * n * 4
    ops = 2 * m * n * k
    t_bytes, t_ops = by / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    from repro_torch.build import build
    from repro_torch.configs import nid_mlp
    from repro_torch.data import nid
    from repro_torch.kernels import mvu_int as K

    path_nk = sorted({(n, k) for k, n, _, _ in nid_mlp.LAYERS}, reverse=True)

    # ------------------------------------------------------------ 1. env
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # the yardstick matmul in full float32

    # ---------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    lib = K.build_library()
    print(f"build: {os.path.relpath(lib, HERE)} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # --------------------------------------------------------- 3. kernel
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    max_err = 0.0
    n_checked = 0
    timing = {}  # (m, n, k) -> (kernel, plain, library, bound) ms on the layer's own epilogue
    for n, k in path_nk:
        thr = torch.sort(torch.randint(-300, 300, (n, 3), generator=g, dtype=torch.int32),
                         dim=1).values.to(dev)
        scale = (torch.rand(n, generator=g) + 0.01).to(dev)
        for m in KERNEL_MS:
            a = torch.randint(0, 4, (m, k), generator=g, dtype=torch.int32).to(dev)
            for lo, hi in ((-1, 2), (-128, 128)):
                w = torch.randint(lo, hi, (n, k), generator=g, dtype=torch.int8).to(dev)
                for t, s in ((None, None), (thr, None), (None, scale)):
                    got = K.mvu_int(a, w, t, s)
                    want = K.mvu_int_plain(a, w, t, s)
                    torch.cuda.synchronize()
                    check(got.dtype == want.dtype and torch.equal(got, want),
                          f"mvu_int != mvu_int_plain at M={m} N={n} K={k} "
                          f"w in [{lo},{hi}) thresholds={t is not None} scale={s is not None}")
                    max_err = max(max_err, (got.double() - want.double()).abs().max().item()
                                  if got.numel() else 0.0)
                    n_checked += 1
            # time the layer as the path runs it: 2-bit weights, its own epilogue
            w = torch.randint(-1, 2, (n, k), generator=g, dtype=torch.int8).to(dev)
            t, s = (thr, None) if n > 1 else (None, scale)
            af, wf = a.float(), w.float()
            tf = None if t is None else t.float()

            def library(af=af, wf=wf, tf=tf, s=s):
                c = torch.matmul(af, wf.T)
                return ((c[:, :, None] >= tf[None]).sum(-1, dtype=torch.int32)
                        if tf is not None else c * s)

            check(torch.equal(library(), K.mvu_int(a, w, t, s)),
                  f"the float32 yardstick disagrees with the kernel at M={m} N={n} K={k}")
            kms = device_ms(lambda: K.mvu_int(a, w, t, s), reps=100)
            pms = device_ms(lambda: K.mvu_int_plain(a, w, t, s), reps=10)
            lms = device_ms(library, reps=100)
            bms, bby = bound(m, n, k, t.numel() * 4 if t is not None else s.numel() * 4)
            timing[(m, n, k)] = (kms, pms, lms, bms)
            print(f"kernel: M={m} N={n} K={k} {'thresholds' if t is not None else 'scale'}: "
                  f"ms={kms:.5f} plain_ms={pms:.5f} library_ms={lms:.5f} "
                  f"bound_ms={bms:.6f} ({bby})", flush=True)
    print(f"kernel: {n_checked} checks equal to the plain version, max_abs_err={max_err}",
          flush=True)

    # ---------------------------------------------------------- 4. slice
    golden = nid_mlp.load_golden()
    t0 = time.perf_counter()
    acc = build(nid_mlp.build_graph(golden["seed"]), target="engine", mode="standard",
                weight_bits=golden["weight_bits"], act_bits=golden["act_bits"],
                folding=nid_mlp.foldings(), device="cuda")
    print(f"slice: built {acc.report.step_names} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    batch = golden["batch"]
    x = torch.from_numpy(nid.make_dataset(batch, seed=golden["data_seed"])[0]).to(dev)
    plan = acc.plan(batch)
    K.LAUNCHES = 0
    y = acc(x)
    torch.cuda.synchronize()
    launches = K.LAUNCHES
    check(launches == 4 * plan.n_micro,
          f"acc(x) launched the kernel {launches} times, want 4 x {plan.n_micro}")
    check(y.is_cuda and y.dtype == torch.float32 and tuple(y.shape) == (batch, 1)
          and bool(torch.isfinite(y).all()), f"bad output {y.dtype} {tuple(y.shape)}")
    check(torch.equal(y, acc.interpret(x)), "acc(x) differs from acc.interpret(x)")
    meta = {k: golden[k] for k in ("seed", "data_seed", "batch", "weight_bits", "act_bits")}
    check(nid_mlp.golden_digest(y.cpu().numpy(), nid_mlp.graph_layers(acc.graph), **meta)
          == golden,
          "the card's NID output differs from the JAX package's golden digest")
    print(f"slice: acc(x) at batch {batch} equals acc.interpret(x) and the golden digest; "
          f"{launches} launches = 4 x n_micro={plan.n_micro}", flush=True)
    for b in (4096, 65536):
        xb = torch.from_numpy(nid.make_dataset(b, seed=golden["data_seed"])[0]).to(dev)
        for _ in range(2):
            acc(xb)
        torch.cuda.synchronize()
        secs = []
        for _ in range(7):
            t0 = time.perf_counter()
            acc(xb)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        med = statistics.median(secs)
        print(f"slice: batch {b}: {b / med:.1f} flows/s (median of 7 acc(x), "
              f"{med * 1e3:.3f} ms)", flush=True)

    # -------------------------------------------------------- 5. results
    mb = plan.microbatch
    # one acc(x) launches each layer once per microbatch, at M = microbatch
    per_acc = [plan.n_micro * sum(timing[(mb, n, k)][i] for k, n, _, _ in nid_mlp.LAYERS)
               for i in range(4)]
    print(json.dumps({"kernels": [{
        "name": "mvu_int", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mvu_int.cu",
        "replaces": "src/repro/kernels/mvu_int.py:59",
        "launches": launches, "max_abs_err": max_err,
        "ms": per_acc[0], "plain_ms": per_acc[1], "library_ms": per_acc[2],
        "bound_ms": per_acc[3], "bound_by": "bytes" if all(
            bound(mb, n, k, 0)[1] == "bytes" for n, k in path_nk) else "operations",
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
