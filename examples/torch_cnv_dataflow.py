"""CNV (the FINN BNN convnet) streaming through the port's fused engine.

One ``repro_torch.build`` call builds the CNV topology (conv/conv/pool/.../
dense) and lets the step pipeline lower conv layers to SWU+MVU pairs,
rate-balance the folding, collapse the pairs into line-buffer conv kernels
and stream the whole network in microbatches -- every transform verified
bit-exact against the eager interpreter, with the ``(B, OH*OW, Kd^2*C)``
im2col matrix never materializing.  On the card (``--device cuda``, the
default) the convs launch the hand-written ``conv_mvu`` kernel and the
dense layers ``mvu_xnor``; with ``--device cpu`` their plain versions run.
The BuildReport (per-step timing, per-stage folding + resource estimates)
lands in ``--out-dir``.

Run:  PYTHONPATH=src python examples/torch_cnv_dataflow.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.build import build
from repro_torch.configs import cnv_bnn
from repro_torch.kernels import ops


def main(device: str = "cuda", out_dir: str = "experiments/build_torch"):
    dev = torch.device(device)
    spec = cnv_bnn.QUICK  # 1/8-channel CNV on 16x16 inputs; FULL = the real one
    acc = build(
        cnv_bnn.build_graph(spec, seed=0),
        target="engine", mode="xnor",
        weight_bits=spec.weight_bits, act_bits=spec.act_bits,
        folding="balance", tune="cache",
        name="cnv_quick", output_dir=out_dir, device=dev,
    )
    engine = acc.engine
    print(f"[cnv] build steps: {' -> '.join(acc.report.step_names)}")
    print(f"[cnv] verified steps: "
          f"{[s.name for s in acc.report.steps if s.verified]}")
    print(f"[cnv] lowered ops: {[n.op for n in engine.graph]}")
    print(f"[cnv] schedule: {engine.schedule.summary()}")
    print(f"[cnv] per-stage folding: "
          f"{[(n.name, n.pe, n.simd, n.cycles) for n in acc.report.nodes]}")
    print(f"[cnv] build report -> {acc.report.path}")

    rng = np.random.default_rng(1)
    x = torch.from_numpy(
        rng.integers(0, 2**spec.act_bits, (32, spec.image, spec.image, 3))
        .astype(np.int32)).to(dev)
    plan = engine.plan(x.shape[0])
    print(f"[cnv] stream plan: {plan.n_micro} microbatches of "
          f"{plan.microbatch} image(s), II = {plan.interval_cycles} cycles")

    ops.reset_launch_counts()
    logits = engine(x)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    want = acc.interpret(x)
    assert torch.equal(logits, want), "engine diverged from interpreter"
    n_conv = sum(n.op == "conv_mvu" for n in engine.graph)
    n_dense = sum(n.op == "mvu" for n in engine.graph)
    if x.is_cuda:  # the hand kernels ran, one launch a layer a microbatch
        assert counts == {"conv_mvu": n_conv * plan.n_micro,
                          "mvu_xnor": n_dense * plan.n_micro}, counts
    print(f"[cnv] logits {tuple(logits.shape)}, bit-exact with the reference "
          f"interpreter; kernel launches {counts or 'none (plain versions on the CPU)'}")
    print(f"[cnv] predictions: {logits.argmax(-1)[:10].tolist()} ...")
    print("OK: CNV streamed through the fused conv path")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default="experiments/build_torch",
                    help="where the BuildReport JSON goes")
    args = ap.parse_args()
    main(device=args.device, out_dir=args.out_dir)
