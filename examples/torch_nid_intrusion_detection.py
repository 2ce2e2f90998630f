"""The paper's full example (Section 6.5) on the port: network intrusion
detection.

End-to-end FINN flow on the Table 6 MLP (600-64-64-64-1, 2-bit):

  1. train the float MLP with a quantization-aware straight-through
     estimator on a synthetic UNSW-NB15 stand-in (offline; same feature and
     label geometry),
  2. compile it through the ``repro_torch.build`` step pipeline (lowering,
     streamlining, the paper's Table 6 PE/SIMD folding, per-step
     verification against the reference interpreter),
  3. run integer inference through the hand-written ``mvu_int`` kernel on
     the card, bit-exact with the interpreter, and check it matches the
     float teacher,
  4. print the dataflow schedule: per-layer cycles reproduce Table 7,
  5. serve the fused engine through the ``EngineServer`` shim and the
     continuous batcher, and write the BuildReport JSON into ``--out-dir``.

With ``--device cpu`` the kernel wrappers run their plain versions.

Run:  PYTHONPATH=src python examples/torch_nid_intrusion_detection.py [--fast] [--device cpu]
"""

import argparse
import warnings

import numpy as np
import torch

from repro_torch.build import build
from repro_torch.configs import nid_mlp
from repro_torch.kernels import ops
from repro_torch.launch import nid_qat
from repro_torch.launch.serve import EngineServer


def main(fast: bool = False, device: str = "cuda",
         out_dir: str = "experiments/build_torch"):
    dev = torch.device(device)
    print("== NID MLP (paper Table 6): 600-64-64-64-1 @ 2-bit ==")
    for r in nid_qat.layer_rows():
        print(f"  layer {r['layer']}: K={r['K']:4d} N={r['N']:3d} PE={r['PE']:3d} "
              f"SIMD={r['SIMD']:3d} | cycles {r['exec_cycles_model']} "
              f"(paper RTL: {r['exec_cycles_paper_rtl']}) "
              f"| wmem_depth={r['wmem_depth']} inbuf={r['inbuf_depth']}")

    print("== train (QAT) -> build(streamline steps) -> integer inference ==")
    out = nid_qat.accuracy_check(steps=120 if fast else 300, device=dev)
    print(f"  float teacher accuracy : {out['float_acc']:.3f}")
    print(f"  integer MVU accuracy   : {out['mvu_int_acc']:.3f} "
          f"(engine == interpreter, bit for bit, on {dev})")
    print(f"  pipeline interval      : {out['pipeline_interval_cycles']} cycles "
          f"(bottleneck {out['bottleneck']})")
    print(f"  pipeline latency       : {out['pipeline_latency_cycles']} cycles")
    assert out["mvu_int_acc"] > 0.95, "integer pipeline must match the teacher"
    print("OK: end-to-end FINN flow reproduced on the NID use case")

    print("== repro_torch.build: one call replaces the manual lowering chain ==")
    # target="serving" = the engine pipeline + measured cycle-time
    # calibration; every step is verified bit-exact against the reference
    # interpreter
    acc = build(nid_mlp.build_graph(0), target="serving", mode="standard",
                weight_bits=8, act_bits=nid_mlp.INPUT_BITS,
                folding=nid_mlp.foldings(), name="nid_mlp", output_dir=out_dir,
                device=dev)
    engine = acc.engine
    plan = engine.plan(256)
    rng = np.random.default_rng(0)
    x_np = rng.integers(0, 4, (256, 600)).astype(np.int32)
    x = torch.from_numpy(x_np).to(dev)
    ops.reset_launch_counts()
    y = engine(x)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    same = torch.equal(y, acc.interpret(x))
    if x.is_cuda:  # four layers, one mvu_int launch each a microbatch
        assert counts == {"mvu_int": 4 * plan.n_micro}, counts
    print(f"  build steps            : {' -> '.join(acc.report.step_names)}")
    print(f"  verified steps         : "
          f"{sum(1 for s in acc.report.steps if s.verified)} "
          f"(bit-exact vs the reference interpreter, per transform)")
    print(f"  epilogues fused        : {sum(1 for n in engine.graph if n.attrs.get('fused'))} "
          f"bn+quant pairs -> MVU thresholds")
    print(f"  stream plan (B=256)    : {plan.n_micro} microbatches x {plan.microbatch} "
          f"(II {plan.interval_cycles} cycles)")
    print(f"  kernel launches        : {counts or 'none (plain versions on the CPU)'}")
    print(f"  build report           : {acc.report.path}")
    print(f"  bit-exact vs interpret : {same}")
    assert same

    want = engine(x[:11]).cpu().numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # legacy shim
        server = EngineServer(engine, batch_buckets=(1, 8, 32))
    rids = [server.submit(x_np[i]) for i in range(11)]
    done = {r.rid: r for r in server.flush()}
    ok = all(np.array_equal(done[r].out, want[i]) for i, r in enumerate(rids))
    print(f"  served 11 requests in {server.stats['flushes']} bucketed flushes "
          f"(padding {server.stats['padded_samples']}): correct={ok}")
    assert ok
    print("OK: fused engine serves the NID workload bit-exactly")

    print("== continuous-batching serving subsystem (Accelerator.serve) ==")
    batcher = acc.serve(batch_buckets=(1, 8, 32), slo_s=0.05)
    rids = [batcher.submit(x_np[i]) for i in range(11)]
    batcher.drain()
    ok = all(np.array_equal(batcher.pop_result(r).out, want[i])
             for i, r in enumerate(rids))
    snap = batcher.metrics.snapshot()
    budget = batcher.budgets[batcher.bucket_for(1)]
    cal = acc.calibration
    print(f"  admission queue         : bounded at {batcher.queue.capacity} "
          f"samples, validated against input spec {batcher.spec.shape}")
    ii = engine.schedule.steady_state_interval
    print(f"  flush budget (bucket 1) : {budget * 1e3:.3f} ms "
          f"(II {ii} cycles x measured {cal['s_per_cycle'] * 1e6:.1f} us/cycle "
          f"x 2.0 safety)")
    print(f"  replicas                : {len(batcher.pool)} device(s), "
          f"least-loaded async dispatch")
    print(f"  metrics snapshot        : p99 {snap['p99_ms']:.2f} ms, "
          f"{snap['flushes']} flushes, padding {snap['padding_overhead']:.0%}, "
          f"correct={ok}")
    assert ok
    print("OK: continuous batcher serves the NID workload bit-exactly")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="fewer QAT steps (CI smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out-dir", default="experiments/build_torch",
                    help="where the BuildReport JSON goes")
    args = ap.parse_args()
    main(fast=args.fast, device=args.device, out_dir=args.out_dir)
