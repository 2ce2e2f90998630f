"""The reduced LMs' golden runs: the JAX package's logits and greedy
tokens for one fixed prompt batch, the reduced Yi-9B's QAT loss and
gradients for one fixed training batch and its training steps, and the
tolerances the port is held to.

``scripts/lm_golden.py [--arch ARCH]`` writes :func:`golden_path` of an
arch of ``LM_GOLDENS`` (``yi_9b_lm_golden.json`` for ``ARCH``, the default)
with the JAX package on the CPU: ``get_reduced(arch)`` in float32 from
``convert.lm_numpy_params(cfg, SEED)``, a (BATCH, PROMPT_LEN) prompt from
``np.random.default_rng(TOKEN_SEED)``, then ``prefill`` and
``DECODE_STEPS`` greedy ``decode_step``s, for each variant in
``VARIANTS``: the dense projections and ``quantize_model_params(params,
"mvu_w8a8")``.  A MoE arch's file, and the hybrid's (whose MoE layers
route as the MoE family's do), also records, for each call, how many
token-to-expert assignments the routing dropped for capacity
(``dropped``).  The encoder-decoder's prefill also reads
:func:`enc_embeds`, (BATCH, ENC_FRAMES, d) frame embeddings, normal x
``ENC_SCALE`` from ``ENC_SEED`` (:func:`golden_batch`).  The tests (on
the CPU) and ``chip_smoke.py`` (on the card) run the port the same way
(:func:`greedy_run`) and hold it to the file with :func:`mismatch`.

``scripts/lm_qat_golden.py [--arch ARCH]`` writes :func:`qat_golden_path`
of an arch of ``QAT_GOLDENS`` (``yi_9b_qat_golden.json`` for ``ARCH``, the
default) the same way: the same float32 tree, remat on,
``jax.value_and_grad(model.loss, has_aux=True)`` on :func:`qat_batch` (a
(BATCH, QAT_SEQ + 1) token batch from ``np.random.default_rng(TOKEN_SEED)``
and, for the VLM, a (BATCH, VLM_PREFIX, d) vision prefix, normal x
``PREFIX_SCALE`` from ``PREFIX_SEED``: at 40 patches on the 16-wide grid
the t, h and w ids all differ; for the encoder-decoder, the
:func:`enc_embeds` the encoder reads), for each backend in
``QAT_VARIANTS`` (the fake-quant arm under ``mvu_*``): the loss and each
gradient leaf's :func:`grad_digest`, a layer at a time for a stacked leaf.
The port's side is :func:`qat_run`, held to the file with
:func:`qat_mismatch`.

``scripts/lm_train_golden.py`` writes ``TRAIN_GOLDEN``
(``yi_9b_train_golden.json``): the golden run's float32 tree and config
(:func:`golden_config`: remat off, as the reference's ``_tiny_model``), trained
``TRAIN_STEPS`` steps by the JAX package's jitted ``make_train_step`` with
``AdamWConfig(**TRAIN_OPT)`` on batches of ``SyntheticLM(*TRAIN_DATA)``,
for each backend in ``TRAIN_VARIANTS``: each step's loss, ``grad_norm``
and ``lr``, and the :func:`leaf_digest` of the final params and both
moments.  The port's side is :func:`train_run`, held to the file with
:func:`train_mismatch`.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.train import make_train_step
from repro_torch.optim import adamw
from repro_torch.tree import flat_leaves

ARCH = "yi-9b"
# the archs with a golden run of prefill and decode: the dense Yi-9B, the
# MoE family's two, the SSM family's one and the hybrid's one
MOE_ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
SSM_ARCH = "mamba2-780m"
HYBRID_ARCH = "jamba-1.5-large-398b"
VLM_ARCH = "qwen2-vl-7b"
ENCDEC_ARCH = "whisper-tiny"
LM_GOLDENS = ("yi-9b", *MOE_ARCHS, SSM_ARCH, HYBRID_ARCH, VLM_ARCH, ENCDEC_ARCH)
SEED = 0  # lm_numpy_params
TOKEN_SEED = 1
BATCH = 2
PROMPT_LEN = 12
MAX_LEN = 32
DECODE_STEPS = 3
VARIANTS = ("dense", "mvu_w8a8")
# float32 logits: max |port - reference| <= LOGIT_ATOL * max |reference|
LOGIT_ATOL = 1e-3
# the archs with a QAT golden: the dense Yi-9B, the VLM with a vision prefix
# and the encoder-decoder with its frame embeddings
QAT_GOLDENS = ("yi-9b", VLM_ARCH, ENCDEC_ARCH)
VLM_PREFIX = 40  # patches: h ids 0..2, w ids 0..15, the text from 16
PREFIX_SEED = 3
PREFIX_SCALE = 0.1
# the encoder-decoder's frame embeddings: BATCH x ENC_FRAMES = 40 encoder
# rows a projection, not a multiple of a 32-row tile; the scale of the
# reference's test (tests/test_models.py)
ENC_FRAMES = 20
ENC_SEED = 4
ENC_SCALE = 0.1
QAT_VARIANTS = ("dense", "mvu_w8a8", "mvu_binary")
QAT_SEQ = 16  # tokens predicted a row
QAT_HEAD = 16  # each gradient row's first values kept
PROBE_SEED = 2  # the fixed vector each gradient row is projected on
# float32 QAT: |loss - reference| <= LOSS_RTOL * |reference|; each gradient
# leaf's values within GRAD_ATOL * its largest reference magnitude
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-4
TRAIN_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "yi_9b_train_golden.json")
TRAIN_VARIANTS = ("dense", "mvu_w8a8")
TRAIN_STEPS = 4
TRAIN_OPT = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 8}
TRAIN_DATA = (256, 32, 4)  # SyntheticLM(vocab, seq, batch): the reduced model's vocab
TRAIN_DATA_SEED = 0
TRAIN_METRICS = ("loss", "grad_norm", "lr")
# float32 training, each step against the reference's jitted make_train_step:
# the loss as the reference's crash-resume test holds it, grad_norm and lr
TRAIN_LOSS_RTOL, TRAIN_LOSS_ATOL = 1e-4, 1e-5
TRAIN_GNORM_RTOL = 1e-4
TRAIN_LR_RTOL = 1e-6
# the final params and moments: each leaf's values within TRAIN_ATOL times
# its largest reference magnitude (the port on the CPU reaches 2.2e-5 for
# params, 3.6e-6 for the moments; scripts/lm_train_golden.py --errors)
TRAIN_ATOL = 1e-4


def _path(arch: str, kind: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        f"{arch.replace('-', '_').replace('.', '_')}_{kind}_golden.json")


def golden_path(arch: str = ARCH) -> str:
    """The golden run's file of ``arch`` (one of ``LM_GOLDENS``)."""
    if arch not in LM_GOLDENS:
        raise KeyError(f"no LM golden run for {arch!r}; there is one for {LM_GOLDENS}")
    return _path(arch, "lm")


def qat_golden_path(arch: str = ARCH) -> str:
    """The QAT golden's file of ``arch`` (one of ``QAT_GOLDENS``)."""
    if arch not in QAT_GOLDENS:
        raise KeyError(f"no QAT golden for {arch!r}; there is one for {QAT_GOLDENS}")
    return _path(arch, "qat")


GOLDEN = golden_path()


def golden_config(backend: str = "dense", arch: str = ARCH):
    """The golden run's config, and the train golden's: the reduced ``arch``
    in float32 under ``backend``, remat off."""
    return get_reduced(arch).replace(dtype="float32", remat=False, linear_backend=backend)


def prompt_tokens(vocab_size: int | None = None) -> np.ndarray:
    """The golden prompt batch over ``vocab_size`` tokens (default: the
    reduced Yi-9B's)."""
    return np.random.default_rng(TOKEN_SEED).integers(
        0, vocab_size or golden_config().vocab_size, (BATCH, PROMPT_LEN)).astype(np.int32)


def enc_embeds(cfg) -> np.ndarray:
    """The golden runs' frame embeddings for an encoder-decoder ``cfg``:
    (BATCH, ENC_FRAMES, d) float32, normal x ``ENC_SCALE`` from
    ``ENC_SEED``."""
    rng = np.random.default_rng(ENC_SEED)
    return (rng.standard_normal((BATCH, ENC_FRAMES, cfg.d_model)) * ENC_SCALE).astype(
        np.float32)


def golden_batch(cfg) -> dict:
    """The golden prefill's batch for ``cfg``: :func:`prompt_tokens` over its
    vocabulary, and an encoder-decoder's :func:`enc_embeds`."""
    batch = {"tokens": prompt_tokens(cfg.vocab_size)}
    if cfg.encdec:
        batch["enc_embeds"] = enc_embeds(cfg)
    return batch


def load_golden(arch: str = ARCH) -> dict:
    with open(golden_path(arch)) as f:
        return json.load(f)


@contextlib.contextmanager
def counting_drops():
    """While open, each ``moe.dispatch_combine`` call of the port's MoE FFN
    appends to the yielded list the number of its token-to-expert
    assignments that no capacity slot took (a 0-d tensor on the routing's
    device: no host sync)."""
    from repro_torch.models import moe

    inner = moe.dispatch_combine
    drops = []

    def counted(idx, weights, e, capacity):
        dispatch, combine = inner(idx, weights, e, capacity)
        drops.append(idx.numel() - torch.count_nonzero(dispatch))
        return dispatch, combine

    moe.dispatch_combine = counted
    try:
        yield drops
    finally:
        moe.dispatch_combine = inner


def greedy_run(model, params) -> dict:
    """The golden run on the port: ``prefill`` of :func:`golden_batch`, then
    ``DECODE_STEPS`` greedy ``decode_step``s; float32 numpy logits of each
    call (``logits[0]`` the prefill's) and the greedy tokens, (BATCH,
    1 + DECODE_STEPS); for a MoE model also each call's dropped
    assignments (:func:`counting_drops`)."""
    dropped = []
    with counting_drops() as drops:
        def call(fn, *args):
            mark = len(drops)
            out = fn(*args)
            dropped.append(int(sum(drops[mark:])))
            return out

        state = model.init_decode_state(BATCH, MAX_LEN)
        logits, state = call(model.prefill, params, golden_batch(model.cfg), state)
        outs, toks = [], []
        for step in range(DECODE_STEPS + 1):
            outs.append(logits.to(torch.float32).cpu().numpy())
            nxt = torch.argmax(logits, -1)
            toks.append(nxt.cpu().numpy())
            if step < DECODE_STEPS:
                logits, state = call(model.decode_step, params, state, nxt)
    run = {"logits": np.stack(outs), "tokens": np.stack(toks, axis=1)}
    if model.cfg.is_moe:
        run["dropped"] = dropped
    return run


def mismatch(want: dict, got: dict) -> str | None:
    """None if ``got`` meets the float32 parity contract against ``want``
    (both ``greedy_run``-shaped): every call's logits within ``LOGIT_ATOL``
    times the reference's largest magnitude, the greedy tokens equal and,
    where ``want`` counts them, each call's dropped assignments equal;
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
    if "dropped" in want and list(got.get("dropped", ())) != list(want["dropped"]):
        return f"dropped assignments by call {got.get('dropped')}, want {want['dropped']}"
    return None


def qat_config(backend: str = "dense", arch: str = ARCH):
    """The QAT golden's config: the reduced ``arch`` (default Yi-9B) in
    float32, remat on, under ``backend``."""
    return get_reduced(arch).replace(dtype="float32", remat=True, linear_backend=backend)


def qat_batch(cfg) -> dict:
    """The QAT golden's batch for ``cfg`` (a :func:`qat_config`): (BATCH,
    QAT_SEQ + 1) tokens over its vocabulary from ``TOKEN_SEED``; for a
    VLM ``"prefix_embeds"`` (BATCH, VLM_PREFIX, d) float32, normal x
    ``PREFIX_SCALE`` from ``PREFIX_SEED``; for an encoder-decoder
    ``"enc_embeds"`` (:func:`enc_embeds`)."""
    batch = {"tokens": np.random.default_rng(TOKEN_SEED).integers(
        0, cfg.vocab_size, (BATCH, QAT_SEQ + 1)).astype(np.int32)}
    if cfg.family == "vlm":
        rng = np.random.default_rng(PREFIX_SEED)
        batch["prefix_embeds"] = (rng.standard_normal((BATCH, VLM_PREFIX, cfg.d_model))
                                  * PREFIX_SCALE).astype(np.float32)
    if cfg.encdec:
        batch["enc_embeds"] = enc_embeds(cfg)
    return batch


# the paths of the leaves stacked on a layer axis: a decoder's layers, an
# encoder-decoder's two stacks
STACKED = ("layers/", "encdec/enc/", "encdec/dec/")


def probe(n: int) -> np.ndarray:
    """A fixed unit vector of length ``n`` (float64, seeded by ``PROBE_SEED``)."""
    v = np.random.default_rng(PROBE_SEED).standard_normal(n)
    return v / np.linalg.norm(v)


def leaf_digest(leaves: dict) -> dict:
    """For each leaf (float32 numpy by path) its size, sum, L2 norm and
    largest magnitude, and for each of its rows the first ``QAT_HEAD``
    values and the dot product with :func:`probe`: a leaf stacked on the
    layer axis (under ``STACKED``) has a row a layer, any other leaf one
    row."""
    out = {}
    for path, g in leaves.items():
        g = np.asarray(g, np.float32)
        rows = g.reshape(g.shape[0] if path.startswith(STACKED) else 1, -1)
        g = g.ravel()
        out[path] = {"size": int(g.size), "sum": float(g.sum(dtype=np.float64)),
                     "norm": float(np.sqrt(np.square(g, dtype=np.float64).sum())),
                     "max_abs": float(np.abs(g).max()),
                     "head": rows[:, :QAT_HEAD].tolist(),
                     "dot": (rows.astype(np.float64) @ probe(rows.shape[1])).tolist()}
    return out


def grad_digest(loss: float, grads: dict) -> dict:
    """The loss and the :func:`leaf_digest` of the gradients."""
    return {"loss": float(loss), "grads": leaf_digest(grads)}


def qat_run(model, params) -> dict:
    """The QAT golden on the port: ``model.loss`` of :func:`qat_batch` and
    ``torch.autograd.grad`` of every leaf of ``params`` (float; each set to
    require grad), digested."""
    leaves = flat_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, _ = model.loss(params, qat_batch(model.cfg))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return grad_digest(loss.item(), {p: g.to(torch.float32).cpu().numpy()
                                     for p, g in zip(leaves, grads)})


def load_qat_golden(arch: str = ARCH) -> dict:
    with open(qat_golden_path(arch)) as f:
        return json.load(f)


def leaves_mismatch(want: dict, got: dict, atol: float) -> str | None:
    """None if every leaf of ``got`` meets ``want`` (both
    :func:`leaf_digest`-shaped) at eps = ``atol`` times the reference
    leaf's largest magnitude: each row's head values and the largest
    magnitude within eps, the sum within size x eps, the norm within
    sqrt(size) x eps and each row's probe product within sqrt(row size) x
    eps (what every value within eps implies); else what differs."""
    if got.keys() != want.keys():
        return f"leaves {sorted(got)}, want {sorted(want)}"
    for path, w in want.items():
        g = got[path]
        eps = atol * w["max_abs"]
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


def qat_mismatch(want: dict, got: dict) -> str | None:
    """None if ``got`` meets the float32 QAT contract against ``want`` (both
    :func:`grad_digest`-shaped): the loss within ``LOSS_RTOL`` and every
    gradient leaf within :func:`leaves_mismatch` at ``GRAD_ATOL``; else
    what differs."""
    if not abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"]):
        return f"loss {got['loss']!r}, want {want['loss']!r}"
    bad = leaves_mismatch(want["grads"], got["grads"], GRAD_ATOL)
    return None if bad is None else f"gradient {bad}"


# ------------------------------------------------------------------ training
def train_opt_config() -> adamw.AdamWConfig:
    """The train golden's optimizer: the reference's crash-resume test's,
    so that the clip and both legs of the schedule run."""
    return adamw.AdamWConfig(**TRAIN_OPT)


def train_batches() -> list[dict]:
    """The train golden's ``TRAIN_STEPS`` batches, drawn in order from
    ``SyntheticLM(*TRAIN_DATA, seed=TRAIN_DATA_SEED)``."""
    data = SyntheticLM(*TRAIN_DATA, seed=TRAIN_DATA_SEED)
    try:
        return [next(data) for _ in range(TRAIN_STEPS)]
    finally:
        data.close()


def train_digest(history: dict, params: dict, mu: dict, nu: dict) -> dict:
    """The train golden's record: each step's ``loss``, ``grad_norm`` and
    ``lr`` (``history``, lists of floats) and the :func:`leaf_digest` of the
    final params and both moments (float32 numpy trees by path)."""
    return {**{k: [float(v) for v in history[k]] for k in TRAIN_METRICS},
            "params": leaf_digest(params), "mu": leaf_digest(mu), "nu": leaf_digest(nu)}


def train_run(model, params, batches=None) -> dict:
    """The train golden on the port: ``adamw.init(params)``, then
    ``make_train_step`` over :func:`train_batches`, digested."""
    step = make_train_step(model, train_opt_config())
    opt = adamw.init(params)
    history = {k: [] for k in TRAIN_METRICS}
    for batch in train_batches() if batches is None else batches:
        params, opt, metrics = step(params, opt, batch)
        for k in TRAIN_METRICS:
            history[k].append(metrics[k].item())
    host = lambda tree: {p: t.to(torch.float32).cpu().numpy()
                         for p, t in flat_leaves(tree).items()}
    return train_digest(history, host(params), host(opt["mu"]), host(opt["nu"]))


def load_train_golden() -> dict:
    with open(TRAIN_GOLDEN) as f:
        return json.load(f)


def train_mismatch(want: dict, got: dict) -> str | None:
    """None if ``got`` meets the float32 training contract against
    ``want`` (both :func:`train_digest`-shaped): each step's loss within
    ``TRAIN_LOSS_RTOL`` x |loss| + ``TRAIN_LOSS_ATOL``, ``grad_norm``
    within ``TRAIN_GNORM_RTOL`` and ``lr`` within ``TRAIN_LR_RTOL`` of the
    reference, and the final params and moments within
    :func:`leaves_mismatch` at ``TRAIN_ATOL``; else what differs."""
    rtol = {"loss": TRAIN_LOSS_RTOL, "grad_norm": TRAIN_GNORM_RTOL, "lr": TRAIN_LR_RTOL}
    atol = {"loss": TRAIN_LOSS_ATOL, "grad_norm": 0.0, "lr": 0.0}
    for k in TRAIN_METRICS:
        if len(got[k]) != len(want[k]):
            return f"{k}: {len(got[k])} steps, want {len(want[k])}"
        for i, (g, w) in enumerate(zip(got[k], want[k])):
            if not abs(g - w) <= rtol[k] * abs(w) + atol[k]:
                return f"step {i + 1} {k} {g!r}, want {w!r}"
    for tree in ("params", "mu", "nu"):
        bad = leaves_mismatch(want[tree], got[tree], TRAIN_ATOL)
        if bad is not None:
            return f"{tree} {bad}"
    return None
