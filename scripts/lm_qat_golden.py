"""A reduced LM's QAT golden: the JAX package's loss and gradients.

Usage (from the repo root, JAX on the CPU):
    PYTHONPATH=src python scripts/lm_qat_golden.py          # check the file
    PYTHONPATH=src python scripts/lm_qat_golden.py --write  # (re)write it
    PYTHONPATH=src python scripts/lm_qat_golden.py --arch qwen2-vl-7b --write
    PYTHONPATH=src python scripts/lm_qat_golden.py --arch whisper-tiny --write

Runs ``jax.value_and_grad(repro.models.model.build(cfg).loss,
has_aux=True)`` on the float32 tree of
``repro_torch.convert.lm_numpy_params(cfg, SEED)`` for the reduced
``--arch`` (one of ``lm_golden.QAT_GOLDENS``; default ``yi-9b``), remat
on, under ``dense``, ``mvu_w8a8`` and ``mvu_binary`` (every projection
through the fake-quant arm of ``linear``), on a seeded batch
(``repro_torch.configs.lm_golden``: ``qat_config``, ``qat_batch``; for
``qwen2-vl-7b`` the tokens follow a seeded 40-patch vision prefix, so its
M-RoPE turns the t, h and w sections by different ids; for
``whisper-tiny`` the encoder reads seeded frame embeddings).  The result, the
loss and each gradient leaf's size, sum, L2 norm, largest magnitude and, a
layer at a time, first values and product with a fixed seeded vector, is
``lm_golden.qat_golden_path(arch)`` under ``src/repro_torch/configs/``
(``yi_9b_qat_golden.json``, ``qwen2_vl_7b_qat_golden.json``,
``whisper_tiny_qat_golden.json``); ``tests/test_torch_lm_qat.py``,
``tests/test_torch_lm_vlm.py``, ``tests/test_torch_lm_encdec.py`` and
``chip_smoke.py`` hold the port to it.
"""

from __future__ import annotations

import argparse
import json
import sys


def jax_run(backend: str, arch: str) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_reduced
    from repro.models.model import build
    from repro_torch.configs import lm_golden as G
    from repro_torch.convert import lm_numpy_params
    from repro_torch.tree import flat_leaves

    cfg = get_reduced(arch).replace(dtype="float32", remat=True, linear_backend=backend)
    params = jax.tree.map(jnp.asarray, lm_numpy_params(cfg, G.SEED))
    batch = {k: jnp.asarray(v) for k, v in G.qat_batch(cfg).items()}
    (loss, _), grads = jax.value_and_grad(build(cfg).loss, has_aux=True)(params, batch)
    return G.grad_digest(float(loss), {p: np.asarray(g)
                                       for p, g in flat_leaves(grads).items()})


def golden(arch: str) -> dict:
    from repro_torch.configs import lm_golden as G

    out = {"arch": arch, "seed": G.SEED, "token_seed": G.TOKEN_SEED, "batch": G.BATCH,
           "seq": G.QAT_SEQ, "dtype": "float32", "remat": True,
           "variants": {b: jax_run(b, arch) for b in G.QAT_VARIANTS}}
    if G.qat_config(arch=arch).family == "vlm":
        out |= {"prefix": G.VLM_PREFIX, "prefix_seed": G.PREFIX_SEED,
                "prefix_scale": G.PREFIX_SCALE}
    if G.qat_config(arch=arch).encdec:
        out |= {"enc_frames": G.ENC_FRAMES, "enc_seed": G.ENC_SEED, "enc_scale": G.ENC_SCALE}
    return out


def main(argv=None) -> int:
    from repro_torch.configs.lm_golden import ARCH, QAT_GOLDENS, load_qat_golden, qat_golden_path

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=ARCH, choices=QAT_GOLDENS,
                    help="the reduced arch whose QAT golden to check or write")
    ap.add_argument("--write", action="store_true", help="rewrite the golden file")
    args = ap.parse_args(argv)
    digest = golden(args.arch)
    path = qat_golden_path(args.arch)
    if args.write:
        with open(path, "w") as f:
            json.dump(digest, f, sort_keys=True)
            f.write("\n")
        print(f"wrote {path}")
        return 0
    same = load_qat_golden(args.arch) == json.loads(json.dumps(digest))
    print("QAT golden matches" if same else "QAT golden DIFFERS")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
