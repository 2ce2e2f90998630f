"""FINN streaming dataflow on the card: the pipeline-parallel executor.

FINN instantiates one MVU per layer and streams activations through AXI
links (paper Fig. 6).  This example runs the same discipline with
``repro_torch.distributed.pipeline``: four pipeline stages, each on a CUDA
stream of its own of one card (``--device cuda``, the default), with
microbatches handed from stage to stage by CUDA events, and the FINN
folding pass rate-balancing the stages.  With ``--device cpu`` the same
GPipe ticks run in order on the CPU.  The output, and the gradients
through the schedule, are checked against the sequential reference.

Run:  PYTHONPATH=src python examples/torch_dataflow_pipeline.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.folding import balance_pipeline
from repro_torch.distributed.pipeline import (
    pipeline_apply,
    sequential_reference,
    stage_params_split,
)


def layer_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def main(device: str = "cuda", out_dir: str | None = None, stages: int = 4) -> dict:
    del out_dir  # nothing is built: no BuildReport to write
    dev = torch.device(device)
    L, d = 8, 64
    n_micro, mb = 8, 4

    rng = np.random.default_rng(0)
    params = {
        "w": torch.tensor(rng.normal(0, 1, (L, d, d)) / np.sqrt(d), dtype=torch.float32,
                          device=dev, requires_grad=True),
        "b": torch.zeros((L, d), device=dev, requires_grad=True),
    }
    x = torch.tensor(rng.normal(0, 1, (n_micro, mb, d)), dtype=torch.float32, device=dev)

    # FINN folding: rate-balance the (identical) layers -> equal stage cycles
    folds = balance_pipeline([(d, d, 1)] * L, max_pe=64, max_simd=64)
    cycles = [f.cycles(d, d) for f in folds]
    print(f"[dataflow] {L} layers on {stages} stages ({dev.type} "
          f"{'streams' if dev.type == 'cuda' else 'ticks'}); per-layer cycles "
          f"{cycles[0]} (balanced: {len(set(cycles)) == 1})")
    print(f"[dataflow] steady-state interval = {max(cycles)} cycles, "
          f"fill/drain bubbles = {stages - 1} microbatch ticks")

    devices = [dev] * stages
    out = pipeline_apply(layer_fn, stage_params_split(params, stages), x, devices)
    want = sequential_reference(layer_fn, params, x)
    err = (out - want).abs().max().item()
    print(f"[dataflow] pipeline output == sequential reference (max err {err:.2e})")
    assert err < 1e-5, err

    # gradients flow through the pipeline schedule
    g = torch.autograd.grad((out ** 2).sum(), (params["w"], params["b"]))
    g_ref = torch.autograd.grad((want ** 2).sum(), (params["w"], params["b"]))
    grad_err = max((a - b).abs().max().item() for a, b in zip(g, g_ref))
    print(f"[dataflow] gradients through the schedule == sequential "
          f"(max err {grad_err:.2e})")
    assert grad_err < 1e-4, grad_err
    print(f"OK: FINN dataflow schedule reproduced with {dev.type} "
          f"{'stream events' if dev.type == 'cuda' else 'ticks'}")
    return {"stages": stages, "forward_err": err, "grad_err": grad_err}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
