"""A reduced LM's golden run: the JAX package's logits and greedy tokens.

Usage (from the repo root, JAX on the CPU):
    PYTHONPATH=src python scripts/lm_golden.py            # check the file
    PYTHONPATH=src python scripts/lm_golden.py --write    # (re)write it
    PYTHONPATH=src python scripts/lm_golden.py --arch granite-moe-3b-a800m --write
    PYTHONPATH=src python scripts/lm_golden.py --arch mamba2-780m --write
    PYTHONPATH=src python scripts/lm_golden.py --arch jamba-1.5-large-398b --write
    PYTHONPATH=src python scripts/lm_golden.py --arch qwen2-vl-7b --write
    PYTHONPATH=src python scripts/lm_golden.py --arch whisper-tiny --write
    PYTHONPATH=src python scripts/lm_golden.py --bf16-gap # bfloat16 gaps
    PYTHONPATH=src python scripts/lm_golden.py --bf16-gap --arch mamba2-780m
    PYTHONPATH=src python scripts/lm_golden.py --bf16-gap --arch jamba-1.5-large-398b

Runs ``repro.models.model.build(get_reduced(arch))`` (``--arch``, one of
``lm_golden.LM_GOLDENS``; default ``yi-9b``) in float32 on the tree of
``repro_torch.convert.lm_numpy_params(cfg, SEED)`` -- dense, and after
``quantize_model_params(params, "mvu_w8a8")`` -- through ``prefill`` of a
seeded prompt batch and three greedy ``decode_step``s
(``repro_torch.configs.lm_golden``).  For a MoE arch, and the hybrid
Jamba, it also counts, for each call, the token-to-expert assignments the
routing dropped for capacity (a ``jax.debug.callback`` on each
``dispatch_combine``).  The result is ``lm_golden.golden_path(arch)`` under
``src/repro_torch/configs/``; ``tests/test_torch_lm.py``,
``tests/test_torch_lm_moe.py``, ``tests/test_torch_lm_ssm.py``,
``tests/test_torch_lm_hybrid.py``, ``tests/test_torch_lm_vlm.py`` and
``tests/test_torch_lm_encdec.py`` and ``chip_smoke.py`` hold the port to
it.  The VLM's prompt is text only, as its serving is in both packages
(its M-RoPE ids all equal); the encoder-decoder's prefill also takes
seeded frame embeddings (``lm_golden.golden_batch``).

``--bf16-gap`` prints, for the reduced ``--arch`` in bfloat16 (the leaves
``convert.FLOAT32_LEAVES`` kept float32, as the reference's init keeps
them) at three seeds,
the prefill logits' max |difference| over the largest logit and 1 -
correlation between the JAX package compiled (its ``lax.scan`` layer
loop), the JAX package op by op (``jax.disable_jit()``) and the port on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def jax_run(backend: str, arch: str) -> dict:
    import jax
    import jax.numpy as jnp

    import repro.models.moe as moe
    from repro.configs import get_reduced
    from repro.models.layers import quantize_model_params
    from repro.models.model import build
    from repro_torch.configs import lm_golden as G
    from repro_torch.convert import lm_numpy_params

    cfg = get_reduced(arch).replace(dtype="float32", remat=False, linear_backend=backend)
    params = jax.tree.map(jnp.asarray, lm_numpy_params(cfg, G.SEED))
    if backend != "dense":
        params = quantize_model_params(params, backend)
    model = build(cfg)

    # each dispatch_combine's dropped assignments, wherever it is traced
    drops = []
    inner = moe.dispatch_combine

    def counted(idx, weights, e, capacity):
        dispatch, combine = inner(idx, weights, e, capacity)
        jax.debug.callback(lambda i, d: drops.append(int(i.size - np.count_nonzero(d))),
                           idx, dispatch)
        return dispatch, combine

    dropped = []

    def call(fn, *args):
        mark = len(drops)
        out = jax.block_until_ready(fn(*args))
        jax.effects_barrier()
        dropped.append(sum(drops[mark:]))
        return out

    moe.dispatch_combine = counted
    try:
        state = model.init_decode_state(G.BATCH, G.MAX_LEN)
        logits, state = call(model.prefill, params,
                             {k: jnp.asarray(v) for k, v in G.golden_batch(cfg).items()}, state)
        outs, toks = [], []
        for step in range(G.DECODE_STEPS + 1):
            outs.append(np.asarray(logits, np.float32))
            nxt = jnp.argmax(logits, -1)
            toks.append(np.asarray(nxt))
            if step < G.DECODE_STEPS:
                logits, state = call(model.decode_step, params, state, nxt)
    finally:
        moe.dispatch_combine = inner
    run = {"logits": np.stack(outs).tolist(), "tokens": np.stack(toks, axis=1).tolist()}
    if cfg.is_moe:
        run["dropped"] = dropped
    return run


def golden(arch: str) -> dict:
    from repro_torch.configs import lm_golden as G

    out = {"arch": arch, "seed": G.SEED, "token_seed": G.TOKEN_SEED, "batch": G.BATCH,
           "prompt_len": G.PROMPT_LEN, "max_len": G.MAX_LEN,
           "decode_steps": G.DECODE_STEPS, "dtype": "float32",
           "variants": {b: jax_run(b, arch) for b in G.VARIANTS}}
    if G.golden_config(arch=arch).encdec:
        out |= {"enc_frames": G.ENC_FRAMES, "enc_seed": G.ENC_SEED, "enc_scale": G.ENC_SCALE}
    return out


def bf16_gap(arch: str) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_reduced
    from repro.models.layers import quantize_model_params
    from repro.models.model import build
    from repro_torch.configs import get_reduced as port_reduced
    from repro_torch.convert import cast_numpy_params, lm_numpy_params, lm_params_from_numpy
    from repro_torch.models import layers as port_layers
    from repro_torch.models.model import build as port_build

    def gap(ref, out):
        return (f"{float(np.abs(out - ref).max() / np.abs(ref).max()):.5f} / "
                f"{1 - np.corrcoef(ref.ravel(), out.ravel())[0, 1]:.2e}")

    for backend in ("dense", "mvu_w8a8", "mvu_binary"):
        for seed in range(3):
            kw = dict(dtype="bfloat16", remat=False, linear_backend=backend)
            cfg = get_reduced(arch).replace(**kw)
            tree = cast_numpy_params(lm_numpy_params(cfg, seed), jnp.bfloat16)
            jp, tp = jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree)
            if backend != "dense":
                jp = quantize_model_params(jp, backend)
                tp = port_layers.quantize_model_params(tp, backend)
            toks = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (2, 12))
            model = build(cfg)
            logits = []
            for ctx in (jax.disable_jit(), jax.default_device(jax.devices("cpu")[0])):
                with ctx:
                    out, _ = model.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                                           model.init_decode_state(2, 32))
                logits.append(np.asarray(out.astype(jnp.float32)))
            op_by_op, compiled = logits
            pm = port_build(port_reduced(arch).replace(**kw), device="cpu")
            port, _ = pm.prefill(tp, {"tokens": toks.astype(np.int32)},
                                 pm.init_decode_state(2, 32))
            port = port.to(torch.float32).numpy()
            print(f"bf16 {arch} {backend} seed {seed}: max|d|/max|ref| / 1-corr: JAX compiled vs op "
                  f"by op {gap(compiled, op_by_op)}; port vs compiled {gap(compiled, port)}; "
                  f"port vs op by op {gap(op_by_op, port)}")


def main(argv=None) -> int:
    from repro_torch.configs.lm_golden import ARCH, LM_GOLDENS, golden_path, load_golden

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=ARCH, choices=LM_GOLDENS,
                    help="the reduced arch whose golden run to check or write (or whose "
                         "bfloat16 gaps to print)")
    ap.add_argument("--write", action="store_true", help="rewrite the golden file")
    ap.add_argument("--bf16-gap", action="store_true",
                    help="print the bfloat16 gaps between compiled JAX, op-by-op JAX and the "
                         "port instead")
    args = ap.parse_args(argv)
    if args.bf16_gap:
        bf16_gap(args.arch)
        return 0
    digest = golden(args.arch)
    if args.write:
        with open(golden_path(args.arch), "w") as f:
            json.dump(digest, f, sort_keys=True)
            f.write("\n")
        print(f"wrote {golden_path(args.arch)}")
        return 0
    same = load_golden(args.arch) == json.loads(json.dumps(digest))
    print("golden run matches" if same else "golden run DIFFERS")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
