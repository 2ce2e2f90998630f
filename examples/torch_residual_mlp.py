"""Residual (skip-connection) MLP on the port: the DAG IR end-to-end.

A NID-style variant with a residual connection around the middle layer:

      in(600) -> fc0 -> bn0 -> act0 --+--> fc1 -> bn1 -> act1 --+
                                      |                         v
                                      +-----------------------> add("res")
                                                                 |
                                                                 v
                                                             fc2 -> out(1)

  1. author the fan-out/fan-in graph (``repro_torch.configs.residual_mlp``),
  2. validate it (``ir.validate_graph``: arity, broadcast, single sink),
  3. build it for all three targets -- interpret, engine, pipeline --
     through the ``repro_torch.build`` step pipeline with every
     verification hook on, each transform held bit-exact against the DAG
     interpreter,
  4. print the lowered topology: edge list, branch labels, and the
     join's branch-latency skew + FIFO depth from the dataflow schedule,
  5. write the BuildReport JSON (carrying ``edges`` and per-node
     ``inputs``/``branch``) into ``--out-dir``.

On the card (``--device cuda``, the default) the engine launches the
hand-written ``mvu_int`` kernel; with ``--device cpu`` its plain version.

Run:  PYTHONPATH=src python examples/torch_residual_mlp.py [--fast] [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.build import build
from repro_torch.configs import residual_mlp
from repro_torch.core import ir
from repro_torch.kernels import ops


def main(fast: bool = False, device: str = "cuda",
         out_dir: str = "experiments/build_torch"):
    dev = torch.device(device)
    batch = 64 if fast else 256
    graph = residual_mlp.build_graph()
    print("== residual NID-MLP variant: 600-64-(64+skip)-1 @ 2-bit ==")
    ir.validate_graph(graph)
    labels = ir.branch_labels(graph)
    for node, ins, out_shape in ir.io_shapes(graph):
        srcs = ", ".join(node.inputs) if node.inputs else "-"
        print(f"  {node.name:5s} ({node.op:9s}) <- {srcs:12s} "
              f"-> {out_shape}  [branch {labels[node.name]}]")

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 2**residual_mlp.INPUT_BITS,
                                      (batch, residual_mlp.LAYERS[0][0]))
                         .astype(np.int32)).to(dev)

    print("== repro_torch.build: same graph, three targets, all verified ==")
    accs = {}
    for target in ("interpret", "engine", "pipeline"):
        # the engine build writes the BuildReport
        accs[target] = build(graph, target=target, mode="standard",
                             weight_bits=residual_mlp.WEIGHT_BITS,
                             act_bits=residual_mlp.INPUT_BITS,
                             folding=residual_mlp.foldings(), name="residual_mlp",
                             output_dir=out_dir if target == "engine" else None,
                             device=dev)
        rep = accs[target].report
        print(f"  target {target:9s}: steps {' -> '.join(rep.step_names)} "
              f"| verified {sum(1 for s in rep.steps if s.verified)}")

    ref = accs["interpret"](x)
    same = torch.equal(accs["pipeline"](x), ref)
    print(f"  pipeline  vs interpret: bit-exact={same}")
    assert same, "pipeline diverged from the DAG reference interpreter"
    acc = accs["engine"]
    ops.reset_launch_counts()
    got = acc(x)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    same = torch.equal(got, ref)
    print(f"  engine    vs interpret: bit-exact={same}; kernel launches "
          f"{counts or 'none (plain versions on the CPU)'}")
    assert same, "engine diverged from the DAG reference interpreter"
    if x.is_cuda:  # three MVU stages, one launch each a microbatch
        assert counts == {"mvu_int": 3 * acc.plan(batch).n_micro}, counts

    rep = acc.report
    print("== lowered DAG topology (from the BuildReport) ==")
    print(f"  edges          : {['->'.join(e) for e in rep.edges]}")
    print(f"  node branches  : "
          f"{ {n.name: n.branch for n in rep.nodes} }")
    sched = acc.engine.schedule
    print(f"  interval       : {sched.steady_state_interval} cycles "
          f"(bottleneck {sched.bottleneck.name})")
    print(f"  critical path  : {sched.latency_cycles} cycles "
          f"(longest path, not the stage sum)")
    for j in sched.joins:
        skew = max(j.branch_latency) - min(j.branch_latency)
        print(f"  join {j.name!r}     : branches {j.branches}, "
              f"latencies {j.branch_latency} (skew {skew}) "
              f"-> FIFO depth {j.fifo_depth}")
    assert sched.joins and sched.joins[0].fifo_depth >= 2
    print(f"  build report   : {rep.path}")
    print("OK: skip-connection graph builds and streams bit-exactly "
          "on every target")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="smaller probe batch (CI smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default="experiments/build_torch",
                    help="where the BuildReport JSON goes")
    args = ap.parse_args()
    main(fast=args.fast, device=args.device, out_dir=args.out_dir)
