"""The reduced Yi-9B's golden runs: the JAX package's logits and greedy
tokens for one fixed prompt batch, its QAT loss and gradients for one
fixed training batch, and the tolerances the port is held to.

``scripts/lm_golden.py`` writes ``GOLDEN`` (``yi_9b_lm_golden.json``) with
the JAX package on the CPU: ``get_reduced("yi-9b")`` in float32 from
``convert.lm_numpy_params(cfg, SEED)``, a (BATCH, PROMPT_LEN) prompt from
``np.random.default_rng(TOKEN_SEED)``, then ``prefill`` and
``DECODE_STEPS`` greedy ``decode_step``s, for each variant in
``VARIANTS``: the dense projections and ``quantize_model_params(params,
"mvu_w8a8")``.  The tests (on the CPU) and ``chip_smoke.py`` (on the card)
run the port the same way (:func:`greedy_run`) and hold it to the file
with :func:`mismatch`.

``scripts/lm_qat_golden.py`` writes ``QAT_GOLDEN``
(``yi_9b_qat_golden.json``) the same way: the same float32 tree, remat on,
``jax.value_and_grad(model.loss, has_aux=True)`` on a (BATCH, QAT_SEQ + 1)
token batch from ``np.random.default_rng(TOKEN_SEED)``, for each backend
in ``QAT_VARIANTS`` (the fake-quant arm under ``mvu_*``): the loss and each
gradient leaf's :func:`grad_digest`, a layer at a time for a stacked leaf.
The port's side is :func:`qat_run`, held to the file with
:func:`qat_mismatch`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.models.transformer import flat_leaves

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
QAT_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "yi_9b_qat_golden.json")
QAT_VARIANTS = ("dense", "mvu_w8a8", "mvu_binary")
QAT_SEQ = 16  # tokens predicted a row
QAT_HEAD = 16  # each gradient row's first values kept
PROBE_SEED = 2  # the fixed vector each gradient row is projected on
# float32 QAT: |loss - reference| <= LOSS_RTOL * |reference|; each gradient
# leaf's values within GRAD_ATOL * its largest reference magnitude
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-4


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


def qat_config(backend: str = "dense"):
    """The QAT golden's config: the reduced Yi-9B in float32, remat on, under
    ``backend``."""
    return get_reduced(ARCH).replace(dtype="float32", remat=True, linear_backend=backend)


def qat_tokens() -> np.ndarray:
    return np.random.default_rng(TOKEN_SEED).integers(
        0, qat_config().vocab_size, (BATCH, QAT_SEQ + 1)).astype(np.int32)


def probe(n: int) -> np.ndarray:
    """A fixed unit vector of length ``n`` (float64, seeded by ``PROBE_SEED``)."""
    v = np.random.default_rng(PROBE_SEED).standard_normal(n)
    return v / np.linalg.norm(v)


def grad_digest(loss: float, grads: dict) -> dict:
    """The loss and, for each gradient leaf (float32 numpy by path), its
    size, sum, L2 norm and largest magnitude, and for each of its rows the
    first ``QAT_HEAD`` values and the dot product with :func:`probe`: a
    leaf stacked on the layer axis (under "layers/") has a row a layer,
    any other leaf one row."""
    out = {}
    for path, g in grads.items():
        g = np.asarray(g, np.float32)
        rows = g.reshape(g.shape[0] if path.startswith("layers/") else 1, -1)
        g = g.ravel()
        out[path] = {"size": int(g.size), "sum": float(g.sum(dtype=np.float64)),
                     "norm": float(np.sqrt(np.square(g, dtype=np.float64).sum())),
                     "max_abs": float(np.abs(g).max()),
                     "head": rows[:, :QAT_HEAD].tolist(),
                     "dot": (rows.astype(np.float64) @ probe(rows.shape[1])).tolist()}
    return {"loss": float(loss), "grads": out}


def qat_run(model, params) -> dict:
    """The QAT golden on the port: ``model.loss`` of :func:`qat_tokens` and
    ``torch.autograd.grad`` of every leaf of ``params`` (float; each set to
    require grad), digested."""
    leaves = flat_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, _ = model.loss(params, {"tokens": qat_tokens()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return grad_digest(loss.item(), {p: g.to(torch.float32).cpu().numpy()
                                     for p, g in zip(leaves, grads)})


def load_qat_golden() -> dict:
    with open(QAT_GOLDEN) as f:
        return json.load(f)


def qat_mismatch(want: dict, got: dict) -> str | None:
    """None if ``got`` meets the float32 QAT contract against ``want`` (both
    :func:`grad_digest`-shaped): the loss within ``LOSS_RTOL``; in each
    leaf every row's head values and the largest magnitude within eps =
    ``GRAD_ATOL`` times the reference's largest, the sum within size x eps,
    the norm within sqrt(size) x eps and each row's probe product within
    sqrt(row size) x eps (what every value within eps implies); else what
    differs."""
    if not abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"]):
        return f"loss {got['loss']!r}, want {want['loss']!r}"
    if got["grads"].keys() != want["grads"].keys():
        return f"gradient leaves {sorted(got['grads'])}, want {sorted(want['grads'])}"
    for path, w in want["grads"].items():
        g = got["grads"][path]
        eps = GRAD_ATOL * w["max_abs"]
        if g["size"] != w["size"] or len(g["dot"]) != len(w["dot"]):
            return f"{path}: size {g['size']} in {len(g['dot'])} rows, want {w['size']} in " \
                   f"{len(w['dot'])}"
        errs = {"head": float(np.abs(np.subtract(g["head"], w["head"])).max()),
                "max_abs": abs(g["max_abs"] - w["max_abs"]),
                "sum": abs(g["sum"] - w["sum"]) / w["size"],
                "norm": abs(g["norm"] - w["norm"]) / np.sqrt(w["size"]),
                "dot": float(np.abs(np.subtract(g["dot"], w["dot"])).max())
                / np.sqrt(w["size"] / len(w["dot"]))}
        bad = {k: e for k, e in errs.items() if not e <= eps}
        if bad:
            return f"{path}: {bad} (scaled errors) > {eps:.3e}"
    return None
