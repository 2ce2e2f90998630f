"""The reduced Yi-9B's golden run: the JAX package's logits and greedy
tokens for one fixed prompt batch, and the tolerances the port is held to.

``scripts/lm_golden.py`` writes ``GOLDEN`` (``yi_9b_lm_golden.json``) with
the JAX package on the CPU: ``get_reduced("yi-9b")`` in float32 from
``convert.lm_numpy_params(cfg, SEED)``, a (BATCH, PROMPT_LEN) prompt from
``np.random.default_rng(TOKEN_SEED)``, then ``prefill`` and
``DECODE_STEPS`` greedy ``decode_step``s, for each variant in
``VARIANTS``: the dense projections and ``quantize_model_params(params,
"mvu_w8a8")``.  The tests (on the CPU) and ``chip_smoke.py`` (on the card)
run the port the same way (:func:`greedy_run`) and hold it to the file
with :func:`mismatch`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.configs import get_reduced

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "yi_9b_lm_golden.json")
ARCH = "yi-9b"
SEED = 0  # lm_numpy_params
TOKEN_SEED = 1
BATCH = 2
PROMPT_LEN = 12
MAX_LEN = 32
DECODE_STEPS = 3
VARIANTS = ("dense", "mvu_w8a8")
# float32 logits: max |port - reference| <= LOGIT_ATOL * max |reference|
LOGIT_ATOL = 1e-3


def golden_config(backend: str = "dense"):
    """The golden run's config: the reduced Yi-9B in float32 under ``backend``."""
    return get_reduced(ARCH).replace(dtype="float32", remat=False, linear_backend=backend)


def prompt_tokens() -> np.ndarray:
    return np.random.default_rng(TOKEN_SEED).integers(
        0, golden_config().vocab_size, (BATCH, PROMPT_LEN)).astype(np.int32)


def load_golden() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


def greedy_run(model, params) -> dict:
    """The golden run on the port: ``prefill`` of :func:`prompt_tokens`, then
    ``DECODE_STEPS`` greedy ``decode_step``s; float32 numpy logits of each
    call (``logits[0]`` the prefill's) and the greedy tokens, (BATCH,
    1 + DECODE_STEPS)."""
    state = model.init_decode_state(BATCH, MAX_LEN)
    logits, state = model.prefill(params, {"tokens": prompt_tokens()}, state)
    outs, toks = [], []
    for step in range(DECODE_STEPS + 1):
        outs.append(logits.to(torch.float32).cpu().numpy())
        nxt = torch.argmax(logits, -1)
        toks.append(nxt.cpu().numpy())
        if step < DECODE_STEPS:
            logits, state = model.decode_step(params, state, nxt)
    return {"logits": np.stack(outs), "tokens": np.stack(toks, axis=1)}


def mismatch(want: dict, got: dict) -> str | None:
    """None if ``got`` meets the float32 parity contract against ``want``
    (both ``greedy_run``-shaped): every call's logits within ``LOGIT_ATOL``
    times the reference's largest magnitude, and the greedy tokens equal;
    else what differs."""
    ref, out = np.asarray(want["logits"], np.float32), np.asarray(got["logits"], np.float32)
    if ref.shape != out.shape:
        return f"logits shape {out.shape}, want {ref.shape}"
    err = float(np.abs(out - ref).max())
    bound = LOGIT_ATOL * float(np.abs(ref).max())
    if not err <= bound:
        return f"max |logit error| {err:.3e} > {bound:.3e}"
    if not np.array_equal(np.asarray(want["tokens"]), np.asarray(got["tokens"])):
        return f"greedy tokens {np.asarray(got['tokens']).tolist()}, want {want['tokens']}"
    return None
