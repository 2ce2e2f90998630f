"""The NID QAT golden digests: the JAX package's streamlined NID graph on one
fixed input.

Usage (from the repo root, JAX on the CPU):
    PYTHONPATH=src python scripts/nid_qat_golden.py          # check the file
    PYTHONPATH=src python scripts/nid_qat_golden.py --write  # (re)write it

For each variant of ``repro_torch.launch.nid_qat.GOLDEN_VARIANTS`` -- float
weights drawn with numpy (``seeded_weights``), with the identity batchnorm
of the paper's QAT flow or seeded batchnorm constants with gammas of both
signs (``seeded_bn``) -- builds the same raw chain with the JAX package
through the Section 6.5 flow's steps (lower, streamline, finalize, fold;
``target="interpret"``) at Table 6 folding, runs
``nid.make_dataset(BATCH, seed=DATA_SEED)`` through the interpreter, and
digests the float32 output plus every MVU layer's weights, thresholds and
scale (``repro_torch.configs.golden.golden_digest``).  The result is
``src/repro_torch/configs/nid_qat_golden.json``; ``tests/test_torch_qat.py``
and ``chip_smoke.py`` read the variants from there and hold the port's
engine to them.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SEED = 0  # seeded_weights
DATA_SEED = 1
BATCH = 4096
JAX_STEPS = ("validate", "lower", "streamline", "finalize", "fold", "dataflow")


def jax_graph(graph):
    """The JAX package's copy of a raw port chain: same ops, names, attrs,
    and the float32 params as ``jnp`` arrays."""
    import jax.numpy as jnp
    from repro.core.ir import Node

    return [Node(n.op, n.name, dict(n.attrs),
                 {k: jnp.asarray(v.numpy()) for k, v in n.params.items()})
            for n in graph]


def jax_build(graph):
    """The reference ``accuracy_check``'s streamlined build of a raw port
    chain, with the JAX package (interpreter target)."""
    from repro.build import build
    from repro.configs import nid_mlp
    from repro_torch.launch import nid_qat

    kw = {k: v for k, v in nid_qat.build_kwargs().items() if k not in ("target", "steps")}
    return build(jax_graph(graph), target="interpret", folding=nid_mlp.foldings(),
                 steps=JAX_STEPS, **kw)


def jax_digest(variant: str) -> dict:
    from repro.data import nid
    from repro_torch.configs.golden import golden_digest
    from repro_torch.launch import nid_qat

    acc = jax_build(nid_qat.variant_graph(variant))
    x, _ = nid.make_dataset(BATCH, seed=DATA_SEED)
    out = np.asarray(acc.interpret(x))
    layers = {}
    for n in acc.graph:
        if n.op == "mvu":
            p = n.params["mvu"]
            layers[n.name] = {k: None if v is None else np.asarray(v) for k, v in (
                ("weights", p.weights), ("thresholds", p.thresholds),
                ("out_scale", p.out_scale))}
    return golden_digest(out, layers, seed=SEED, data_seed=DATA_SEED, batch=BATCH,
                         build={"variant": variant})


def main(argv=None) -> int:
    from repro_torch.launch.nid_qat import GOLDEN, GOLDEN_VARIANTS, load_golden

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true", help="rewrite the golden file")
    args = ap.parse_args(argv)
    digests = {v: jax_digest(v) for v in GOLDEN_VARIANTS}
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
