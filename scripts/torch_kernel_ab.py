"""Device times of ``conv_mvu`` and the kernels on the dense core
(``mvu_binary``, ``mvu_int``, ``mvu_binary_packed``, ``mvu_int2_packed``,
``mvu_xnor`` and, where the tree has it, its bit entry ``mvu_xnor_bits``),
their ptxas reports, the host's cost of one xnor stage, and the end-to-end
rates, of one source tree, for A/B runs of two trees on one card.

Usage (from the repo root, on a machine with an NVIDIA GPU and nvcc):
    python scripts/torch_kernel_ab.py <src dir> <label> --out FILE

Imports ``repro_torch`` from ``<src dir>`` (for example ``src``, or the
``src`` of an unpacked earlier commit) and, for its timing helpers and
shape lists, ``chip_smoke.py`` from the repo root.  It builds the kernels
there and measures:

* ``conv_mvu`` at the FULL CNV's six conv shapes in the three modes, at 1
  and 32 images, with the threshold epilogue, and the dense kernels at the
  CNV's dense shapes at M = 1 and the NID-MLP's layers at M = 1, 128 and
  4096 (thresholds; the 1- and 10-wide heads take the scale): device ms a
  launch, ``chip_smoke.device_ms`` (CUDA events, median of 7 trials of
  100 back-to-back launches), beside a float32 ``torch.matmul`` +
  epilogue yardstick; and, for the layers the main paths launch most
  (conv1 at one image, the CNV's fc0 at M = 1 and the NID's fc0 at
  M = 128), the host's µs a call: 2,000 calls back to back, host clock,
  to the card's last result -- the wrapper's checks, plan and ctypes
  launch, or the device time where that is longer;
* the host's µs a call of one engine xnor stage (``dataflow.node_runner``
  of NID fc0, M = 128, and of the CNV's fc0, M = 1, on int32 levels): the
  parent's ``pack_bits`` plus packed launch, or the bit entry's launch;
* flows/s of each NID-MLP variant of the golden file at batch 4096 and
  images/s of each FULL CNV variant at batch ``chip_smoke.CNV_BATCH``:
  ``chip_smoke.acc_seconds`` (host clock to the card's last result,
  median of 21).

Appends one JSON line a measurement (``label``, what was measured, ``ms``,
``us`` or the rate) to ``--out`` and prints them.  Run the trees in turns within one call (A, B, B, A) and
compare only within one call: two calls may land on two cards.  Needs no
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src")
    ap.add_argument("label")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke  # puts the repo's own src on the path: the tree goes first

    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    from repro_torch.configs import cnv_bnn, nid_mlp
    from repro_torch.core import dataflow
    from repro_torch.core.ir import Node
    from repro_torch.core.mvu import MVUConfig, MVUParams
    from repro_torch.data import nid
    from repro_torch.kernels import _cuda, mvu_binary as B, mvu_int as K, mvu_packed as P
    from repro_torch.kernels import mvu_xnor as X, packing, ops, swu_mvu as C

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device")
    _cuda.build_all(ops.LIBRARIES)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    rows = []

    def ms(fn):
        return smoke.device_ms(fn, reps=100, trials=7)

    def host_us(fn, calls: int = 2000) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    for mode in ("standard", "binary", "xnor"):
        for b in (1, 32):
            for h, c, n in smoke.conv_shapes(cnv_bnn.FULL):
                k = 9 * c
                if mode == "xnor":
                    x = torch.randint(0, 2, (b, h, h, c), generator=g, dtype=torch.int32)
                    w = packing.pack_bits(torch.randint(0, 2, (n, k), generator=g,
                                                        dtype=torch.int8))
                else:
                    x = torch.randint(0, 4, (b, h, h, c), generator=g, dtype=torch.int32)
                    w = torch.randint(-1 if mode == "standard" else 0, 2, (n, k),
                                      generator=g, dtype=torch.int8)
                t = torch.sort(torch.randint(-8 * k, 8 * k, (n, 3), generator=g,
                                             dtype=torch.int32), 1).values
                x, w, t = x.to(dev), w.to(dev), t.to(dev)
                fn = lambda: C.conv_mvu(x, w, t, kernel=3, mode=mode)  # noqa: E731
                rows.append(dict(kernel="conv_mvu", mode=mode, b=b, h=h, c=c, n=n, ms=ms(fn)))
                if (mode, b, h) == ("binary", 1, 30):
                    rows.append(dict(host="conv_mvu", mode=mode, b=b, h=h, c=c, n=n,
                                     us=host_us(fn)))
    dense = [(1, n, k) for n, k in smoke.dense_shapes(cnv_bnn.FULL)]
    dense += [(m, n, k) for m in (1, 128, 4096) for k, n, _, _ in nid_mlp.LAYERS]
    kernels = ["mvu_binary", "mvu_int", "mvu_binary_packed", "mvu_int2_packed", "mvu_xnor"]
    if hasattr(X, "mvu_xnor_bits"):
        kernels.append("mvu_xnor_bits")
    for kernel in kernels:
        for m, n, k in dense:
            a = torch.randint(0, 4, (m, k), generator=g, dtype=torch.int32)
            af = a.float()
            if kernel in ("mvu_int", "mvu_int2_packed"):
                w = torch.randint(-1, 2, (n, k), generator=g, dtype=torch.int8)
                wf = w.float()
                if kernel == "mvu_int":
                    fn = K.mvu_int
                else:
                    w = packing.pack_int2(w)
                    fn = lambda a, w, t, s, k=k: P.mvu_int2_packed(a, w, k, t, s)  # noqa: E731
            else:
                w = torch.randint(0, 2, (n, k), generator=g, dtype=torch.int8)
                wf = 2 * w.float() - 1
                if kernel == "mvu_binary":
                    fn = B.mvu_binary
                elif kernel == "mvu_binary_packed":
                    w = packing.pack_bits(w)
                    fn = lambda a, w, t, s, k=k: P.mvu_binary_packed(a, w, k, t, s)  # noqa: E731
                else:  # xnor: the activations' LSBs, packed here or in the kernel
                    w = packing.pack_bits(w)
                    af = 2 * (a & 1).float() - 1
                    if kernel == "mvu_xnor":
                        a = packing.pack_bits(a)
                        fn = lambda a, w, t, s, k=k: X.mvu_xnor(a, w, k, t, s)  # noqa: E731
                    else:
                        fn = X.mvu_xnor_bits
            t = torch.sort(torch.randint(-300, 300, (n, 3), generator=g, dtype=torch.int32),
                           1).values
            if kernel.startswith("mvu_xnor"):
                t = t * k // 300  # an xnor dot lies in [-K, K]
            s = torch.rand(n, generator=g) + 0.01
            a, w, t, s, af, wf = (v.to(dev) for v in (a, w, t, s, af, wf))
            t, s = (None, s) if n in (1, 10) else (t, None)
            tf = None if t is None else t.float()

            def library(af=af, wf=wf, tf=tf, s=s):
                c = torch.matmul(af, wf.T)
                return ((c[:, :, None] >= tf[None]).sum(-1, dtype=torch.int32)
                        if tf is not None else c * s)

            run = lambda: fn(a, w, t, s)  # noqa: E731
            rows.append(dict(kernel=kernel, m=m, n=n, k=k, ms=ms(run), library_ms=ms(library)))
            if (m, n, k) in ((1, 512, 256), (128, 64, 600)):
                rows.append(dict(host=kernel, m=m, n=n, k=k, us=host_us(run)))
    # one engine xnor stage as node_runner runs it, on int32 levels
    for m, n, k in ((128, 64, 600), (1, 512, 256)):
        cfg = MVUConfig(k, n, mode="xnor", weight_bits=1, act_bits=1)
        wp = packing.pack_bits(torch.randint(0, 2, (n, k), generator=g))
        t = torch.sort(torch.randint(-k, k, (n, 1), generator=g, dtype=torch.int32), 1).values
        params, stage = dataflow.node_runner(
            Node("mvu", "fc", attrs={"config": cfg},
                 params={"mvu": MVUParams(wp.to(dev), t.to(dev), None)}))
        x = torch.randint(0, 2, (m, k), generator=g, dtype=torch.int32).to(dev)
        rows.append(dict(host="xnor_stage", m=m, n=n, k=k,
                         us=host_us(lambda: stage(params, x))))
    for source in ("mvu_binary.cu", "mvu_int.cu", "mvu_packed.cu", "mvu_xnor.cu"):
        for line in smoke.ptxas_lines(_cuda.ptxas_report(source)):
            rows.append(dict(ptxas=source, line=line))

    for variant, gd in sorted(nid_mlp.load_golden().items()):
        acc = smoke.nid_accelerator(gd)
        x = torch.from_numpy(nid.make_dataset(4096, seed=gd["data_seed"])[0]).to(dev)
        rows.append(dict(e2e="nid", variant=variant, batch=4096,
                         flows_per_s=4096 / smoke.acc_seconds(acc, x, trials=21)))
    for variant, gd in sorted(cnv_bnn.load_golden().items()):
        acc = smoke.cnv_accelerator(gd)
        x = torch.from_numpy(cnv_bnn.images(smoke.CNV_BATCH, gd["build"]["act_bits"],
                                            gd["data_seed"])).to(dev)
        rows.append(dict(e2e="cnv", variant=variant, batch=smoke.CNV_BATCH,
                         images_per_s=smoke.CNV_BATCH / smoke.acc_seconds(acc, x,
                                                                          trials=21)))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        for r in rows:
            f.write(json.dumps(dict(label=args.label, **r)) + "\n")
    print(args.label, torch.cuda.get_device_name(0), flush=True)
    for r in rows:
        print(" ", json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
