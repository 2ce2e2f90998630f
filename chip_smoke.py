#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure exits non-zero:

1. env     torch and CUDA versions, the card's name and power limit.
2. build   the five MVU kernels from ``src/repro_torch/kernels/csrc/``:
           one nvcc per source, all started together.
3. kernel  ``mvu_int`` against ``mvu_int_plain`` on the card at every
           (N, K) of the NID path, M in {1, 3, 128, 4096}, all three
           epilogues, 2-bit and full-int8 weights: exact equality.  Device
           times (CUDA events, median) of the kernel, its plain version and
           a float32 ``torch.matmul`` + epilogue yardstick (``library_ms``;
           exact here since |acc| < 2^24), beside the least time the card
           needs (bytes at 3.35 TB/s or operations at the 1,979 TOP/s int8
           tensor-core peak, whichever is larger).
   kernel  the same for ``mvu_xnor``, ``mvu_binary``, ``mvu_binary_packed``
           and ``mvu_int2_packed`` at M in {1, 128, 4096}, activations up
           to 299 (the packed kernels narrow them to int8 with a wrap); the
           yardstick multiplies the unpacked +/-1 or integer operands.
4. slice   the NID-MLP (Table 6) built on the card in each variant of the
           golden file (2-bit standard, xnor, binary, packed binary,
           packed 2-bit standard); ``acc(x)`` on ``nid.make_dataset(4096,
           seed=1)`` must equal ``acc.interpret(x)`` and the JAX package's
           golden digest, and, with every launch counter set to 0 just
           before it, must launch the variant's kernel exactly
           4 x n_micro times and no other kernel; flows/s at batch 4096
           (and 65536 for the standard variant), host clock, synchronised.
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
NEW_KERNEL_MS = (1, 128, 4096)
SLEEP_CYCLES = 50_000_000  # keeps the card busy while a timed loop is enqueued
CSRC = "src/repro_torch/kernels/csrc/"
# kernel -> (its source, the JAX function it replaces: file:line)
KERNELS = {
    "mvu_int": (CSRC + "mvu_int.cu", "src/repro/kernels/mvu_int.py:59"),
    "mvu_xnor": (CSRC + "mvu_xnor.cu", "src/repro/kernels/mvu_xnor.py:74"),
    "mvu_binary": (CSRC + "mvu_binary.cu", "src/repro/kernels/mvu_binary.py:60"),
    "mvu_binary_packed": (CSRC + "mvu_packed.cu", "src/repro/kernels/mvu_packed.py:124"),
    "mvu_int2_packed": (CSRC + "mvu_packed.cu", "src/repro/kernels/mvu_packed.py:250"),
}


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


def bound_of(nbytes: int, ops: int) -> tuple[float, str]:
    """Least ms the card needs: ``nbytes`` at the HBM rate or ``ops`` at the
    int8 tensor-core peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(m: int, n: int, k: int, epilogue_bytes: int) -> tuple[float, str]:
    """Least ms for one ``mvu_int`` launch: read A (int32) and W (int8)
    and the epilogue operand once, write the (M, N) 4-byte output once."""
    return bound_of(m * k * 4 + n * k + epilogue_bytes + m * n * 4, 2 * m * n * k)


def new_kernel_case(name, m, n, k, g, dev):
    """Operands of one launch of the xnor, binary or packed kernels:
    ``(wrapper, plain, args, a_f, w_f, nbytes)`` -- the wrapper and plain
    version take ``*args`` plus the epilogue; ``a_f @ w_f.T`` (float32, the
    +/-1 or integer values the kernel multiplies) is the yardstick's
    product; ``nbytes`` counts the activation and weight bytes the launch
    must read."""
    import torch

    from repro_torch.kernels import mvu_binary as B, mvu_packed as P, mvu_xnor as X
    from repro_torch.kernels import packing
    from repro_torch.kernels._common import narrow_int8

    a = torch.randint(-8, 300, (m, k), generator=g, dtype=torch.int32)
    bits = torch.randint(0, 2, (n, k), generator=g, dtype=torch.int8)
    bipolar = 2 * bits.float() - 1
    if name == "mvu_xnor":
        ap, wp = packing.pack_bits(a), packing.pack_bits(bits)
        fn, plain, args = X.mvu_xnor, X.mvu_xnor_plain, (ap, wp, k)
        a_f, w_f, nbytes = 2 * (a & 1).float() - 1, bipolar, 4 * (ap.numel() + wp.numel())
    elif name == "mvu_binary":
        fn, plain, args = B.mvu_binary, B.mvu_binary_plain, (a, bits)
        a_f, w_f, nbytes = a.float(), bipolar, 4 * a.numel() + bits.numel()
    elif name == "mvu_binary_packed":
        wp = packing.pack_bits(bits)
        fn, plain, args = P.mvu_binary_packed, P.mvu_binary_packed_plain, (a, wp, k)
        a_f, w_f, nbytes = narrow_int8(a).float(), bipolar, 4 * (a.numel() + wp.numel())
    else:
        w2 = torch.randint(-2, 2, (n, k), generator=g, dtype=torch.int8)
        wp = packing.pack_int2(w2)
        fn, plain, args = P.mvu_int2_packed, P.mvu_int2_packed_plain, (a, wp, k)
        a_f, w_f, nbytes = narrow_int8(a).float(), w2.float(), 4 * a.numel() + wp.numel()
    args = tuple(x.to(dev) if isinstance(x, torch.Tensor) else x for x in args)
    return fn, plain, args, a_f.to(dev), w_f.to(dev), nbytes


def main() -> int:
    import torch

    from repro_torch.build import build
    from repro_torch.configs import nid_mlp
    from repro_torch.data import nid
    from repro_torch.kernels import _cuda, ops
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
    libs = _cuda.build_all(ops.LIBRARIES)
    print(f"build: {', '.join(os.path.relpath(p, HERE) for p in libs)} in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)", flush=True)

    # --------------------------------------------------------- 3. kernel
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    max_err = dict.fromkeys(KERNELS, 0.0)
    n_checked = 0
    # (kernel, m, n, k) -> (kernel, plain, library, bound) ms on the layer's own
    # epilogue, and what bounds it ("bytes" or "operations")
    timing = {}

    def err(got, want):
        return (got.double() - want.double()).abs().max().item() if got.numel() else 0.0

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
                    max_err["mvu_int"] = max(max_err["mvu_int"], err(got, want))
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
            timing[("mvu_int", m, n, k)] = (kms, pms, lms, bms, bby)
            print(f"kernel: mvu_int M={m} N={n} K={k} "
                  f"{'thresholds' if t is not None else 'scale'}: "
                  f"ms={kms:.5f} plain_ms={pms:.5f} library_ms={lms:.5f} "
                  f"bound_ms={bms:.6f} ({bby})", flush=True)
    print(f"kernel: mvu_int: {n_checked} checks equal to the plain version, "
          f"max_abs_err={max_err['mvu_int']}", flush=True)

    for name in ("mvu_xnor", "mvu_binary", "mvu_binary_packed", "mvu_int2_packed"):
        n_checked = 0
        for n, k in path_nk:
            thr = torch.sort(torch.randint(-300 * k, 300 * k, (n, 3), generator=g,
                                           dtype=torch.int32), dim=1).values.to(dev)
            scale = (torch.rand(n, generator=g) + 0.01).to(dev)
            for m in NEW_KERNEL_MS:
                fn, plain, args, af, wf, nbytes = new_kernel_case(name, m, n, k, g, dev)
                for t, s in ((None, None), (thr, None), (None, scale)):
                    got = fn(*args, t, s)
                    want = plain(*args, t, s)
                    torch.cuda.synchronize()
                    check(got.dtype == want.dtype and torch.equal(got, want),
                          f"{name} != its plain version at M={m} N={n} K={k} "
                          f"thresholds={t is not None} scale={s is not None}")
                    max_err[name] = max(max_err[name], err(got, want))
                    n_checked += 1
                t, s = (thr, None) if n > 1 else (None, scale)
                tf = None if t is None else t.float()

                def library(af=af, wf=wf, tf=tf, s=s):
                    c = torch.matmul(af, wf.T)
                    return ((c[:, :, None] >= tf[None]).sum(-1, dtype=torch.int32)
                            if tf is not None else c * s)

                check(torch.equal(library(), fn(*args, t, s)),
                      f"the float32 yardstick disagrees with {name} at M={m} N={n} K={k}")
                kms = device_ms(lambda: fn(*args, t, s), reps=100)
                pms = device_ms(lambda: plain(*args, t, s), reps=10)
                lms = device_ms(library, reps=100)
                bms, bby = bound_of(nbytes + (t.numel() if t is not None else n) * 4
                                    + m * n * 4, 2 * m * n * k)
                timing[(name, m, n, k)] = (kms, pms, lms, bms, bby)
                print(f"kernel: {name} M={m} N={n} K={k} "
                      f"{'thresholds' if t is not None else 'scale'}: "
                      f"ms={kms:.5f} plain_ms={pms:.5f} library_ms={lms:.5f} "
                      f"bound_ms={bms:.6f} ({bby})", flush=True)
        print(f"kernel: {name}: {n_checked} checks equal to the plain version, "
              f"max_abs_err={max_err[name]}", flush=True)

    # ---------------------------------------------------------- 4. slice
    golden = nid_mlp.load_golden()
    launches = {}
    plan = None
    for variant in ("standard", *sorted(v for v in golden if v != "standard")):
        gd = golden[variant]
        kw = gd["build"]
        kernel = ops.kernel_name(kw["mode"], packed=kw.get("pack") == "always")
        t0 = time.perf_counter()
        acc = build(nid_mlp.build_graph(gd["seed"]), target="engine", tune="off",
                    folding=nid_mlp.foldings(), device="cuda", **kw)
        print(f"slice: {variant} {kw}: built {acc.report.step_names} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        batch = gd["batch"]
        x = torch.from_numpy(nid.make_dataset(batch, seed=gd["data_seed"])[0]).to(dev)
        plan = acc.plan(batch)
        ops.reset_launch_counts()
        y = acc(x)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(counts == {k: 4 * plan.n_micro if k == kernel else 0 for k in counts},
              f"{variant}: acc(x) launched {counts}, want {kernel} 4 x {plan.n_micro} "
              f"times and nothing else")
        launches[kernel] = counts[kernel]
        check(y.is_cuda and y.dtype == torch.float32 and tuple(y.shape) == (batch, 1)
              and bool(torch.isfinite(y).all()), f"{variant}: bad output {y.dtype} "
              f"{tuple(y.shape)}")
        check(torch.equal(y, acc.interpret(x)), f"{variant}: acc(x) differs from "
              "acc.interpret(x)")
        meta = {k: gd[k] for k in nid_mlp.GOLDEN_META}
        check(nid_mlp.golden_digest(y.cpu().numpy(), nid_mlp.graph_layers(acc.graph), **meta)
              == gd, f"{variant}: the card's NID output differs from the JAX package's "
              "golden digest")
        print(f"slice: {variant}: acc(x) at batch {batch} equals acc.interpret(x) and the "
              f"golden digest; {counts[kernel]} {kernel} launches = 4 x n_micro="
              f"{plan.n_micro}, no other kernel", flush=True)
        for b in (4096, 65536) if variant == "standard" else (4096,):
            xb = torch.from_numpy(nid.make_dataset(b, seed=gd["data_seed"])[0]).to(dev)
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
            print(f"slice: {variant}: batch {b}: {b / med:.1f} flows/s (median of 7 "
                  f"acc(x), {med * 1e3:.3f} ms)", flush=True)

    # -------------------------------------------------------- 5. results
    mb = plan.microbatch
    lines = []
    for name, (source, replaces) in KERNELS.items():
        # one acc(x) launches each layer once per microbatch, at M = microbatch
        rows = [timing[(name, mb, n, k)] for k, n, _, _ in nid_mlp.LAYERS]
        per_acc = [plan.n_micro * sum(r[i] for r in rows) for i in range(4)]
        lines.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": per_acc[0], "plain_ms": per_acc[1], "library_ms": per_acc[2],
            "bound_ms": per_acc[3],
            "bound_by": "bytes" if all(r[4] == "bytes" for r in rows) else "operations"})
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
