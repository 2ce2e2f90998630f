"""The reduced Yi-9B QAT golden: the JAX package's loss and gradients.

Usage (from the repo root, JAX on the CPU):
    PYTHONPATH=src python scripts/lm_qat_golden.py          # check the file
    PYTHONPATH=src python scripts/lm_qat_golden.py --write  # (re)write it

Runs ``jax.value_and_grad(repro.models.model.build(cfg).loss,
has_aux=True)`` on the float32 tree of
``repro_torch.convert.lm_numpy_params(cfg, SEED)`` for the reduced Yi-9B
(remat on) under ``dense``, ``mvu_w8a8`` and ``mvu_binary`` (every
projection through the fake-quant arm of ``linear``), on a seeded token
batch (``repro_torch.configs.lm_golden``: ``qat_config``,
``qat_tokens``).  The result, the loss and each gradient leaf's size,
sum, L2 norm, largest magnitude and, a layer at a time, first values
and product with a fixed seeded vector, is
``src/repro_torch/configs/yi_9b_qat_golden.json``;
``tests/test_torch_lm_qat.py`` and ``chip_smoke.py`` hold the port to it.
"""

from __future__ import annotations

import argparse
import json
import sys


def jax_run(backend: str) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_reduced
    from repro.models.model import build
    from repro_torch.configs import lm_golden as G
    from repro_torch.convert import lm_numpy_params
    from repro_torch.tree import flat_leaves

    cfg = get_reduced(G.ARCH).replace(dtype="float32", remat=True, linear_backend=backend)
    params = jax.tree.map(jnp.asarray, lm_numpy_params(cfg, G.SEED))
    (loss, _), grads = jax.value_and_grad(build(cfg).loss, has_aux=True)(
        params, {"tokens": jnp.asarray(G.qat_tokens())})
    return G.grad_digest(float(loss), {p: np.asarray(g)
                                       for p, g in flat_leaves(grads).items()})


def golden() -> dict:
    from repro_torch.configs import lm_golden as G

    return {"arch": G.ARCH, "seed": G.SEED, "token_seed": G.TOKEN_SEED, "batch": G.BATCH,
            "seq": G.QAT_SEQ, "dtype": "float32", "remat": True,
            "variants": {b: jax_run(b) for b in G.QAT_VARIANTS}}


def main(argv=None) -> int:
    from repro_torch.configs.lm_golden import QAT_GOLDEN, load_qat_golden

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true", help="rewrite the golden file")
    args = ap.parse_args(argv)
    digest = golden()
    if args.write:
        with open(QAT_GOLDEN, "w") as f:
            json.dump(digest, f, sort_keys=True)
            f.write("\n")
        print(f"wrote {QAT_GOLDEN}")
        return 0
    same = load_qat_golden() == json.loads(json.dumps(digest))
    print("QAT golden matches" if same else "QAT golden DIFFERS")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
