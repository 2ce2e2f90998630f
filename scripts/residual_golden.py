"""The residual-MLP golden digest: the JAX package's output on one fixed input.

Usage (from the repo root, JAX on the CPU):
    PYTHONPATH=src python scripts/residual_golden.py          # check the file
    PYTHONPATH=src python scripts/residual_golden.py --write  # (re)write it

Builds ``repro.configs.residual_mlp.build_graph(SEED)`` with the JAX
package (``target="engine"``, ``tune="off"``, the 2-bit standard datapath
at Table 6 folding), runs ``nid.make_dataset(BATCH, seed=DATA_SEED)``
through the fused engine, and digests the float32 output plus every MVU
layer's weight storage, thresholds and scale
(``repro_torch.configs.golden.golden_digest``).  The result is
``src/repro_torch/configs/residual_mlp_golden.json``, one digest with its
build kwargs inside; ``tests/test_torch_dag.py`` and ``chip_smoke.py``
hold the port to it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SEED = 0
DATA_SEED = 1
BATCH = 4096
BUILD = {"mode": "standard", "weight_bits": 2, "act_bits": 2}


def jax_digest() -> dict:
    from repro.build import build
    from repro.configs import residual_mlp
    from repro.data import nid
    from repro_torch.configs.golden import golden_digest

    acc = build(residual_mlp.build_graph(SEED), target="engine", tune="off",
                folding=residual_mlp.foldings(), **BUILD)
    x, _ = nid.make_dataset(BATCH, seed=DATA_SEED)
    out = np.asarray(acc(x))
    if not np.array_equal(out, np.asarray(acc.interpret(x))):
        raise AssertionError("the JAX engine differs from its interpreter")
    layers = {}
    for n in acc.graph:
        if n.op == "mvu":
            p = n.params["mvu"]
            layers[n.name] = {k: None if v is None else np.asarray(v) for k, v in (
                ("weights", p.weights), ("thresholds", p.thresholds),
                ("out_scale", p.out_scale))}
    return golden_digest(out, layers, seed=SEED, data_seed=DATA_SEED, batch=BATCH,
                         build=dict(BUILD))


def main(argv=None) -> int:
    from repro_torch.configs.residual_mlp import GOLDEN, load_golden

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
