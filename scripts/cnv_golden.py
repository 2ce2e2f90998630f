"""The CNV golden digests: the JAX package's FULL CNV output on one fixed batch.

Usage (from the repo root, JAX on the CPU; ~1 min a variant):
    PYTHONPATH=src python scripts/cnv_golden.py          # check the file
    PYTHONPATH=src python scripts/cnv_golden.py --write  # (re)write it

For each build variant in ``VARIANTS`` -- the FINN CNV's own W1A1 on the
xnor datapath, +/-1 weights with 2-bit activations on the binary one, and
2-bit weights and activations on the standard one -- builds
``repro.configs.cnv_bnn.build_graph(FULL at the variant's bits, seed=SEED)``
with the JAX package (``target="engine"``, ``tune="off"``, balanced
folding), runs ``BATCH`` numpy-seeded images
(``np.random.default_rng(DATA_SEED).integers(0, 2**act_bits, (BATCH, 32,
32, 3))``: CIFAR-10 is not in the repository) through the fused engine,
and digests the float32 logits plus every MVU and conv layer's weight
storage, thresholds and scale (``repro_torch.configs.golden``).  The result
is ``src/repro_torch/configs/cnv_bnn_golden.json``, ``{variant: digest}``
with each variant's build kwargs inside its digest; ``tests/
test_torch_cnv.py`` and ``chip_smoke.py`` read the variants from there.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SEED = 0
DATA_SEED = 1
BATCH = 64
VARIANTS = {
    "xnor": {"mode": "xnor", "weight_bits": 1, "act_bits": 1},
    "binary": {"mode": "binary", "act_bits": 2},
    "standard": {"mode": "standard", "weight_bits": 2, "act_bits": 2},
}


def jax_digest(build_kwargs: dict, batch: int = BATCH) -> dict:
    import dataclasses

    import jax.numpy as jnp

    from repro.build import build
    from repro.configs import cnv_bnn
    from repro_torch.configs.cnv_bnn import images
    from repro_torch.configs.golden import golden_digest

    spec = dataclasses.replace(cnv_bnn.FULL, act_bits=build_kwargs["act_bits"],
                               weight_bits=build_kwargs.get("weight_bits", 1))
    acc = build(cnv_bnn.build_graph(spec, seed=SEED), target="engine", tune="off",
                **build_kwargs)
    x = jnp.asarray(images(batch, spec.act_bits, DATA_SEED))
    out = np.asarray(acc(x))
    if not np.array_equal(out, np.asarray(acc.interpret(x))):
        raise AssertionError(f"{build_kwargs}: the JAX engine differs from its interpreter")
    layers = {}
    for n in acc.graph:
        if n.op in ("mvu", "conv_mvu"):
            p = n.params["mvu"]
            layers[n.name] = {k: None if v is None else np.asarray(v) for k, v in (
                ("weights", p.weights), ("thresholds", p.thresholds),
                ("out_scale", p.out_scale))}
    return golden_digest(out, layers, seed=SEED, data_seed=DATA_SEED, batch=batch,
                         build=dict(build_kwargs))


def main(argv=None) -> int:
    from repro_torch.configs.cnv_bnn import GOLDEN, load_golden

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true", help="rewrite the golden file")
    args = ap.parse_args(argv)
    digests = {}
    for name, kw in VARIANTS.items():
        digests[name] = jax_digest(kw)
        print(f"{name}: {digests[name]['output_sha256']}", flush=True)
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
