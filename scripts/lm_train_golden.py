"""The reduced Yi-9B train golden: the JAX package's AdamW training steps.

Usage (from the repo root, JAX on the CPU):
    PYTHONPATH=src python scripts/lm_train_golden.py           # check the file
    PYTHONPATH=src python scripts/lm_train_golden.py --write   # (re)write it
    PYTHONPATH=src python scripts/lm_train_golden.py --errors  # the port's errors

Runs the JAX package's ``jax.jit(make_train_step(build(cfg), opt))`` for
``TRAIN_STEPS`` steps from the float32 tree of
``repro_torch.convert.lm_numpy_params(cfg, SEED)`` and ``adamw.init``, on
the batches of ``repro_torch.configs.lm_golden.train_batches`` (the
port's ``SyntheticLM``, whose batches equal the JAX package's), for the
reduced Yi-9B (remat off) under ``dense`` and ``mvu_w8a8``.  The result,
each step's loss, ``grad_norm`` and ``lr`` and the digest of the final
params, ``mu`` and ``nu`` (``lm_golden.train_digest``), is
``src/repro_torch/configs/yi_9b_train_golden.json``;
``tests/test_torch_train.py`` and ``chip_smoke.py`` hold the port to it.
``--errors`` runs the port on the CPU beside the JAX package and prints
how far apart they lie: each metric's largest relative error over the
steps and, for each tree, the largest error of any leaf value over that
leaf's largest magnitude (the scale ``TRAIN_ATOL`` is set on).
"""

from __future__ import annotations

import argparse
import json
import sys


def jax_run(backend: str) -> tuple[dict, dict]:
    """(the golden digest, the final trees as float32 numpy by path)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_reduced
    from repro.launch.train import make_train_step
    from repro.models.model import build
    from repro.optim import adamw
    from repro_torch.configs import lm_golden as G
    from repro_torch.convert import lm_numpy_params
    from repro_torch.tree import flat_leaves

    cfg = get_reduced(G.ARCH).replace(dtype="float32", remat=False, linear_backend=backend)
    params = jax.tree.map(jnp.asarray, lm_numpy_params(cfg, G.SEED))
    opt = adamw.init(params)
    step = jax.jit(make_train_step(build(cfg), adamw.AdamWConfig(**G.TRAIN_OPT)))
    history = {k: [] for k in G.TRAIN_METRICS}
    for batch in G.train_batches():
        params, opt, metrics = step(params, opt, {"tokens": jnp.asarray(batch["tokens"])})
        for k in G.TRAIN_METRICS:
            history[k].append(float(metrics[k]))
    trees = {name: {p: np.asarray(a, np.float32) for p, a in flat_leaves(tree).items()}
             for name, tree in (("params", params), ("mu", opt["mu"]), ("nu", opt["nu"]))}
    return G.train_digest(history, trees["params"], trees["mu"], trees["nu"]), trees


def golden() -> dict:
    from repro_torch.configs import lm_golden as G

    return {"arch": G.ARCH, "seed": G.SEED, "dtype": "float32", "remat": False,
            "steps": G.TRAIN_STEPS, "opt": G.TRAIN_OPT, "data": list(G.TRAIN_DATA),
            "data_seed": G.TRAIN_DATA_SEED,
            "variants": {b: jax_run(b)[0] for b in G.TRAIN_VARIANTS}}


def errors() -> None:
    """Print the port's CPU run against the JAX package's, per variant."""
    import numpy as np
    import torch

    from repro_torch.configs import lm_golden as G
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import build
    from repro_torch.optim import adamw
    from repro_torch.tree import flat_leaves

    for backend in G.TRAIN_VARIANTS:
        want, trees = jax_run(backend)
        cfg = G.golden_config(backend)
        params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED))
        opt = adamw.init(params)
        step = make_train_step(build(cfg, device="cpu"), G.train_opt_config())
        got = {k: [] for k in G.TRAIN_METRICS}
        for batch in G.train_batches():
            params, opt, metrics = step(params, opt, batch)
            for k in G.TRAIN_METRICS:
                got[k].append(metrics[k].item())
        rel = {k: max(abs(g - w) / abs(w) for g, w in zip(got[k], want[k]))
               for k in G.TRAIN_METRICS}
        port = {"params": params, "mu": opt["mu"], "nu": opt["nu"]}
        worst = {}
        for name, tree in port.items():
            leaves = {p: t.to(torch.float32).numpy() for p, t in flat_leaves(tree).items()}
            worst[name] = max((float(np.abs(leaves[p] - r).max() / np.abs(r).max()), p)
                              for p, r in trees[name].items())
        print(f"{backend}: largest relative error over {G.TRAIN_STEPS} steps {rel}; largest "
              f"|port - JAX| of a leaf over its largest |JAX| {worst} (TRAIN_ATOL "
              f"{G.TRAIN_ATOL})")


def main(argv=None) -> int:
    from repro_torch.configs.lm_golden import TRAIN_GOLDEN, load_train_golden

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true", help="rewrite the golden file")
    ap.add_argument("--errors", action="store_true",
                    help="print the port's errors against the JAX package on the CPU")
    args = ap.parse_args(argv)
    if args.errors:
        errors()
        return 0
    digest = golden()
    if args.write:
        with open(TRAIN_GOLDEN, "w") as f:
            json.dump(digest, f, sort_keys=True)
            f.write("\n")
        print(f"wrote {TRAIN_GOLDEN}")
        return 0
    same = load_train_golden() == json.loads(json.dumps(digest))
    print("train golden matches" if same else "train golden DIFFERS")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
