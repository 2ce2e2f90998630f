"""Device time of one ``adamw.update`` over full-width Yi-9B at the train
phase's depth, of one source tree, for A/B runs of two trees on one card.

Usage (from the repo root, on a machine with an NVIDIA GPU):
    python scripts/adamw_update_ab.py <src dir> <label> --out FILE

Imports ``repro_torch`` from ``<src dir>`` (for example ``src``, or the
``src`` of an unpacked earlier tree) and the train phase's settings from
``chip_smoke.py``.  Draws the parameters as the train phase does
(``configs/yi_9b.py`` at ``chip_smoke.TRAIN_LAYERS[0]`` layers, W8A8 QAT,
bf16, ``Model.init`` from ``chip_smoke.LM_SEED`` on the card), gradients
of the same shapes from another seed, and a state one update in; then
times ``adamw.update`` with the train phase's ``AdamWConfig``: CUDA
events around each call, 1 warm-up and 7 timed calls, each on the
state the last one returned.  The least time the card could take is the
bytes the update must move at the HBM rate: the parameters and the
gradients read (the gradients twice: the global norm, then the step),
the float32 moments read and written, the parameters written.

Appends one JSON line (``label``, each call's ``ms``, the median, the
bound, the card) to ``--out`` and prints it.  Run the trees in turns
within one call (A, B, B, A) and compare only within one call.  Needs no
JAX and launches no hand-written kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the tree walkers of this script's own: an earlier tree may lack repro_torch.tree
def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _leaves(tree) -> list:
    return [x for v in tree.values() for x in _leaves(v)] if isinstance(tree, dict) else [tree]


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

    from repro_torch.configs import get_config, lm_golden as G
    from repro_torch.models.model import build
    from repro_torch.optim import adamw

    if not torch.cuda.is_available():
        raise SystemExit("adamw_update_ab: needs a CUDA device")
    dev = torch.device("cuda")
    cfg = get_config(smoke.LM_ARCH).replace(num_layers=smoke.TRAIN_LAYERS[0],
                                            linear_backend=smoke.TRAIN_BACKEND)
    params = build(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(smoke.LM_SEED))
    g = torch.Generator(device=dev).manual_seed(smoke.LM_SEED + 1)
    grads = _map(lambda p: (torch.randn(p.shape, generator=g, device=dev) * 1e-3).to(p.dtype),
                 params)
    opt_cfg = G.train_opt_config()
    with torch.no_grad():
        params, opt, _ = adamw.update(opt_cfg, params, grads, adamw.init(params))
        ms = []
        for i in range(8):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            params, opt, _ = adamw.update(opt_cfg, params, grads, opt)
            end.record()
            torch.cuda.synchronize()
            if i:
                ms.append(start.elapsed_time(end))
    leaves = _leaves(params)
    n = sum(p.numel() for p in leaves)
    nbytes = sum(p.numel() * (3 * p.element_size() + 2 * 8 + p.element_size()) for p in leaves)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    rec = {"label": args.label, "src": args.src, "what": "adamw.update", "layers": cfg.num_layers,
           "parameters": n, "ms": ms, "median_ms": statistics.median(ms),
           "bound_ms": nbytes / smoke.HBM_BYTES_PER_S * 1e3, "bound_bytes": nbytes,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi}
    line = json.dumps(rec)
    with open(args.out, "a") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
