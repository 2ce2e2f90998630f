"""The NID-MLP golden digests: the JAX package's output on one fixed input.

Usage (from the repo root, JAX on the CPU):
    PYTHONPATH=src python scripts/nid_golden.py          # check the file
    PYTHONPATH=src python scripts/nid_golden.py --write  # (re)write it

For each build variant in ``VARIANTS`` -- the paper's 2-bit standard
datapath and the Fig. 4 binarized and packed datapaths, with the settings
of the JAX package's ``benchmarks/packed_gain.py`` -- builds
``repro.configs.nid_mlp.build_graph(SEED)`` with the JAX package at
Table 6 folding, runs ``nid.make_dataset(BATCH, seed=DATA_SEED)`` through
the fused engine, and digests the float32 output plus every MVU layer's
weight storage, thresholds and scale (``repro_torch.configs.golden.
golden_digest``).  The result is ``src/repro_torch/configs/
nid_mlp_golden.json``, ``{variant: digest}`` with each variant's build
kwargs inside its digest; ``tests/test_torch_golden.py`` and
``chip_smoke.py`` read the variants from there.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SEED = 0
DATA_SEED = 1
BATCH = 4096
VARIANTS = {
    "standard": {"mode": "standard", "weight_bits": 2, "act_bits": 2},
    "xnor": {"mode": "xnor", "weight_bits": 1, "act_bits": 1},
    "binary": {"mode": "binary", "act_bits": 4},
    "binary_packed": {"mode": "binary", "act_bits": 4, "pack": "always"},
    "standard_packed": {"mode": "standard", "weight_bits": 2, "act_bits": 2,
                        "pack": "always"},
}


def jax_digest(build_kwargs: dict) -> dict:
    from repro.build import build
    from repro.configs import nid_mlp
    from repro.data import nid
    from repro_torch.configs.golden import golden_digest

    acc = build(nid_mlp.build_graph(SEED), target="engine", tune="off",
                folding=nid_mlp.foldings(), **build_kwargs)
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
                         build=dict(build_kwargs))


def main(argv=None) -> int:
    from repro_torch.configs.nid_mlp import GOLDEN, load_golden

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true", help="rewrite the golden file")
    args = ap.parse_args(argv)
    digests = {name: jax_digest(kw) for name, kw in VARIANTS.items()}
    if args.write:
        with open(GOLDEN, "w") as f:
            json.dump(digests, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {GOLDEN}")
        return 0
    same = load_golden() == digests
    print("golden digests match" if same else "golden digests DIFFER")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
