"""The NID-MLP golden digest: the JAX package's output on one fixed input.

Usage (from the repo root, JAX on the CPU):
    PYTHONPATH=src python scripts/nid_golden.py          # check the file
    PYTHONPATH=src python scripts/nid_golden.py --write  # (re)write it

Builds ``repro.configs.nid_mlp.build_graph(SEED)`` with the JAX package at
Table 6 folding, runs ``nid.make_dataset(BATCH, seed=DATA_SEED)`` through
the fused engine, and digests the float32 output plus every MVU layer's
integer weights and thresholds (``repro_torch.configs.nid_mlp.
golden_digest``).  The result is ``src/repro_torch/configs/
nid_mlp_golden.json``, which ``tests/test_torch_golden.py`` and
``chip_smoke.py`` hold the port to.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SEED = 0
DATA_SEED = 1
BATCH = 4096


def jax_digest(weight_bits: int = 2, act_bits: int = 2) -> dict:
    from repro.build import build
    from repro.configs import nid_mlp
    from repro.data import nid
    from repro_torch.configs.nid_mlp import golden_digest

    acc = build(nid_mlp.build_graph(SEED), target="engine", mode="standard",
                weight_bits=weight_bits, act_bits=act_bits,
                folding=nid_mlp.foldings())
    x, _ = nid.make_dataset(BATCH, seed=DATA_SEED)
    out = np.asarray(acc(x))
    layers = {}
    for n in acc.graph:
        if n.op == "mvu":
            p = n.params["mvu"]
            layers[n.name] = {k: None if v is None else np.asarray(v) for k, v in (
                ("weights", p.weights), ("thresholds", p.thresholds),
                ("out_scale", p.out_scale))}
    return golden_digest(out, layers, seed=SEED, data_seed=DATA_SEED, batch=BATCH,
                         weight_bits=weight_bits, act_bits=act_bits)


def main(argv=None) -> int:
    from repro_torch.configs.nid_mlp import GOLDEN, load_golden

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true", help="rewrite the golden file")
    args = ap.parse_args(argv)
    digest = jax_digest()
    if args.write:
        with open(GOLDEN, "w") as f:
            json.dump(digest, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {GOLDEN}")
        return 0
    same = load_golden() == digest
    print("golden digest matches" if same else "golden digest DIFFERS")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
