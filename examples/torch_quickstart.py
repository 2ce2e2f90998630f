"""Quickstart on the PyTorch/CUDA port: the paper's MVU in five minutes.

1. Build a quantized MVU layer (three SIMD datapaths).
2. Run the hand-written kernel against the plain reference
   (``backend="torch"``), bit exact.
3. Fold a BatchNorm+quantizer into integer thresholds (streamlining).
4. Use the FINN-style folding pass + resource model.
5. Compile a whole MLP chain with the ``repro_torch.build`` step pipeline.

On the card (``--device cuda``, the default) the layers and the engine
launch the hand-written CUDA kernels; with ``--device cpu`` the kernel
wrappers run their plain PyTorch versions.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.folding import Folding, choose_folding
from repro_torch.core.mvu import MVUConfig, MVULayer
from repro_torch.core.thresholds import bn_quant_thresholds, integerize_thresholds
from repro_torch.kernels import ops, packing


def main(device: str = "cuda", out_dir: str = "experiments/build_torch"):
    dev = torch.device(device)
    m, n, k = 64, 64, 256

    print("== 1. three SIMD datapaths (paper Fig. 4) ==")
    for mode in ("xnor", "binary", "standard"):
        cfg = MVUConfig(in_features=k, out_features=n, mode=mode,
                        folding=Folding(32, 32))
        layer = MVULayer(cfg)
        g = torch.Generator().manual_seed(0)
        params = layer.init_params(g, device=dev)
        if mode == "xnor":
            x = packing.pack_bits(torch.randint(0, 2, (m, k), generator=g,
                                                dtype=torch.int32))
        else:
            x = torch.randint(-8, 8, (m, k), generator=g, dtype=torch.int8)
        y = layer(params, x.to(dev))
        res = layer.resources()
        print(f"  {mode:9s} out={tuple(y.shape)} {y.dtype} on {y.device} | "
              f"cycles/pixel={res.cycles} wmem_depth={res.weight_mem_depth} "
              f"inbuf_depth={res.input_buffer_depth}")

    print("== 2. hand kernel == plain reference (backend=\"torch\"), bit exact ==")
    g = torch.Generator().manual_seed(1)
    a = torch.randint(-8, 8, (37, 300), generator=g, dtype=torch.int8).to(dev)
    w = torch.randint(-8, 8, (53, 300), generator=g, dtype=torch.int8).to(dev)
    ops.reset_launch_counts()
    via_kernel = ops.mvu(a, w, "standard", block_n=32, block_k=64)
    launched = ops.launch_counts()["mvu_int"]
    via_ref = ops.mvu(a, w, "standard", backend="torch")
    assert via_kernel.dtype == via_ref.dtype and torch.equal(via_kernel, via_ref)
    path = (f"the CUDA kernel mvu_int ({launched} launch)" if a.is_cuda
            else "the wrapper's plain version (CPU tensors, no launch)")
    assert launched == (1 if a.is_cuda else 0)
    print(f"  exact match on {tuple(via_kernel.shape)}; ran {path}")

    print("== 3. BN+quant -> integer thresholds (streamlining) ==")
    gamma, beta = torch.ones(4), torch.zeros(4)
    mean, var = torch.zeros(4), torch.ones(4) - 1e-5
    t, flip = bn_quant_thresholds(gamma, beta, mean, var, bits=2)
    print(f"  thresholds (2-bit):\n{integerize_thresholds(t)}")

    print("== 4. folding pass (FINN 'Folding and Resource Estimation') ==")
    fold = choose_folding(64, 600, target_cycles=16)
    print(f"  N=64 K=600 target 16 cycles -> PE={fold.pe} SIMD={fold.simd} "
          f"cycles={fold.cycles(64, 600)}")

    print("== 5. the build pipeline (FINN build_dataflow analog) ==")
    from repro_torch.build import build, default_steps
    from repro_torch.core.ir import Graph, Node

    rng = np.random.default_rng(0)
    gr = Graph([Node("input", "in", {"shape": (64,), "bits": 2})])
    for i, (kk, nn) in enumerate(((64, 32), (32, 8))):
        gr.append(Node("linear", f"fc{i}", {},
                       {"w": torch.from_numpy(rng.normal(0, 0.5, (nn, kk)).astype(np.float32))}))
        if i == 0:
            gr.append(Node("quant_act", "act0", {"bits": 2, "act_scale": 1.0}))
    acc = build(gr, target="engine", mode="standard", weight_bits=4, act_bits=2,
                device=dev, name="quickstart_mlp", output_dir=out_dir)
    xb = torch.from_numpy(rng.integers(0, 4, (16, 64)).astype(np.int32)).to(dev)
    assert torch.equal(acc(xb), acc.interpret(xb))
    print(f"  default steps ('engine'): {' -> '.join(default_steps('engine'))}")
    print(f"  verified transforms     : "
          f"{[s.name for s in acc.report.steps if s.verified]}")
    print(f"  schedule                : {acc.report.schedule}")
    print(f"  build report            : {acc.report.path}")
    print("  engine == interpreter on a probe batch (verified per step)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default="experiments/build_torch",
                    help="where the BuildReport JSON goes")
    args = ap.parse_args()
    main(device=args.device, out_dir=args.out_dir)
