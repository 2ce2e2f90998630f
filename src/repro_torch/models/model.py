"""Model facade: build(config) -> init / loss / prefill / decode_step; the
port of the JAX package's ``repro/models/model.py`` for every family: the
dense, MoE, SSM, hybrid (Jamba) and VLM (Qwen2-VL backbone) decoders and
the encoder-decoder (Whisper backbone).

    batch (train): {"tokens": (B, S+1) int}
      vlm:    + {"prefix_embeds": (B, P, d)}, optional
      audio:  + {"enc_embeds": (B, T, d)}
    batch (serving prefill): {"tokens": (B, S) int}
      audio:  + {"enc_embeds": (B, T, d)}
    decode state: {"caches": ..., "pos": (B, 1) int32, ["enc_out"]}

``build(cfg, device=None)`` places the model on ``device``: None means the
card, and raises when CUDA is absent (pass ``device="cpu"`` to run the
kernels' plain versions).  ``loss`` is the QAT forward: under an ``mvu_*``
backend on float params every projection runs ``linear``'s fake-quant arm,
and ``torch.autograd`` gives the STE gradients (a MoE model's experts and
router stay float under every backend, as in the reference, and its loss
adds ``cfg.aux_loss_weight`` times the summed load-balancing loss; an SSM
model's projections are not in ``PROJ_NAMES`` and stay float too, so they
take the fake-quant arm at serving as well; a hybrid model holds both,
and only its attention and dense-FFN projections are integer-deployed);
``launch/train.py``'s ``make_train_step`` adds the AdamW step
(``optim/adamw.py``), and the train loop waits for ROADMAP queue A item
7, step 3c.

A VLM (``cfg.mrope``) is the dense stack with M-RoPE: its positions are
(3, B, S) t/h/w ids (``models/vlm.py::mrope_positions``).  Its ``loss``
takes an optional vision prefix, as the reference's does: the patch
embeddings cast to the model's dtype go in front of the token embeddings,
the text's ids start after the patch grid's largest id, and the prefix
rows are dropped before the final norm.  ``prefill`` and ``decode_step``
read only tokens, as the reference's do, so the served VLM is text only
(its t/h/w ids equal: 1-D RoPE); a ``prefix_embeds`` in a prefill batch
is ignored (ROADMAP queue C).

An encoder-decoder (``cfg.encdec``) holds ``params["encdec"]`` in place of
``params["layers"]`` (``transformer.encdec_init``).  Its ``loss`` and
``prefill`` run the encoder on ``batch["enc_embeds"]`` (the conv stem's
output, a stub in both packages: ``models/audio.py``), cast to the
model's dtype, over positions 0..T-1, then the decoder on the tokens over
positions 0..S-1; the loss's ``aux`` is a float32 zero.  Its decode state
holds the encoder's output as ``enc_out`` (a (B, 1, d) zero placeholder
until ``prefill`` replaces it) beside the decoder's KV caches, and every
``decode_step`` attends to it, projecting it again in each layer.  It is
served through ``prefill`` (with ``enc_embeds``) and ``decode_step``, as
the reference's dry run drives it: ``launch/serve.py::serve_loop`` passes
tokens alone, so on this model it raises ``KeyError: 'enc_embeds'``, as
the reference's does (ROADMAP queue C).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (
    embed,
    embed_init,
    layernorm,
    layernorm_init,
    linear,
    linear_init,
    rmsnorm,
    rmsnorm_init,
    unembed,
)
from repro_torch.models.vlm import mrope_positions


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_decode_state: Callable[..., Any]


def _positions(cfg, batch: int, seq: int, device, prefix: int = 0) -> torch.Tensor:
    """The positions of ``prefix + seq`` tokens: (3, B, P+S) M-RoPE ids for a
    model with ``cfg.mrope``, else (B, P+S) positions 0..P+S-1."""
    if cfg.mrope:
        return mrope_positions(batch, prefix, seq, device=device)
    return torch.arange(prefix + seq, dtype=torch.int32, device=device)[None].expand(
        batch, prefix + seq)


def _ce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy, the logits cast to float32 first."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0].mean()


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available and no device was given: pass "
                               "device='cpu' to run the model on the CPU (the kernels' "
                               "plain versions)")
        device = "cuda"
    return torch.device(device)


def build(cfg: ModelConfig, device=None) -> Model:
    tf.require_ported(cfg)
    device = _device(device)
    dt = getattr(torch, cfg.dtype)

    # ----------------------------------------------------------------- init
    def init(generator: torch.Generator, *, quantize: str | None = None):
        """Random params on the model's device, drawn on ``generator``'s.

        ``quantize`` (an ``mvu_*`` backend) gives the serving params
        ``quantize_model_params(init(generator), quantize)`` from the same
        draws, each layer (a hybrid's group) quantized as soon as it is
        drawn, so the float model never lies whole on the device."""
        params = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dt, device)}
        if cfg.encdec:
            params["encdec"] = tf.encdec_init(generator, cfg, dt, device, quantize=quantize)
        else:
            params["layers"] = tf.stack_init(generator, cfg, dt, device, quantize=quantize)
        params["ln_f"] = (layernorm_init(cfg.d_model, dt, device) if cfg.norm == "layernorm"
                          else rmsnorm_init(cfg.d_model, dt, device))
        if not cfg.tie_embeddings:
            params["unembed"] = linear_init(generator, cfg.d_model, cfg.vocab_size, dt, device)
        return params

    def _norm_f(params, x):
        fn = layernorm if cfg.norm == "layernorm" else rmsnorm
        return fn(params["ln_f"], x, cfg.norm_eps)

    def _encode(params, batch, b: int):
        """The encoder's output for ``batch["enc_embeds"]`` (B, T, d), cast
        to the model's dtype, over positions 0..T-1."""
        enc_in = torch.as_tensor(batch["enc_embeds"], device=device).to(dt)
        return tf.encoder_forward(params["encdec"], cfg, enc_in,
                                  _positions(cfg, b, enc_in.shape[1], device))

    def _logits(params, x):
        if cfg.tie_embeddings:
            return unembed(params["embed"], x)
        return linear(params["unembed"], x)

    # ----------------------------------------------------------------- loss
    def loss(params, batch):
        """(total, {"ce", "aux"}) of next-token prediction on ``batch["tokens"]``
        (B, S+1): ``total = ce + cfg.aux_loss_weight * aux``, ``aux`` the MoE
        layers' summed load-balancing loss (0 for the dense, SSM, VLM and
        encoder-decoder families).  A VLM batch may hold ``"prefix_embeds"``
        (B, P, d): cast to the model's dtype and put in front of the token
        embeddings, with M-RoPE ids over the patch grid
        (``mrope_positions(b, s, prefix=P)``); its P output rows are dropped
        before the norm and the logits.  An encoder-decoder batch holds
        ``"enc_embeds"`` (B, T, d), which the encoder reads (cast to the
        model's dtype) before the decoder reads the tokens."""
        tokens = torch.as_tensor(batch["tokens"], device=device)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        b, s = inputs.shape
        x = embed(params["embed"], inputs)
        p_len = 0
        if cfg.encdec:
            enc_out = _encode(params, batch, b)
            x = tf.decoder_forward(params["encdec"], cfg, x, _positions(cfg, b, s, device),
                                   enc_out)
            aux = torch.zeros((), dtype=torch.float32, device=device)
        else:
            if cfg.family == "vlm" and "prefix_embeds" in batch:
                prefix = torch.as_tensor(batch["prefix_embeds"], device=device).to(dt)
                p_len = prefix.shape[1]
                x = torch.cat([prefix, x], dim=1)
            pos = _positions(cfg, b, s, device, prefix=p_len)
            x, aux = tf.stack_forward(params["layers"], cfg, x, pos)
            x = x[:, p_len:]
        ce = _ce_loss(_logits(params, _norm_f(params, x)), targets)
        return ce + cfg.aux_loss_weight * aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------- serving
    def init_decode_state(batch: int, max_len: int):
        """``pos`` (B, 1) zeros and the stacked caches; an encoder-decoder's
        are the decoder's L KV caches, beside a (B, 1, d) zero ``enc_out``
        placeholder that ``prefill`` replaces."""
        state = {"pos": torch.zeros((batch, 1), dtype=torch.int32, device=device)}
        if cfg.encdec:
            state["caches"] = tf.stack_layers(
                (tf.init_kv_cache(cfg, batch, max_len, dt, device)
                 for _ in range(cfg.num_layers)), cfg.num_layers)
            state["enc_out"] = torch.zeros((batch, 1, cfg.d_model), dtype=dt, device=device)
        else:
            state["caches"] = tf.init_stack_caches(cfg, batch, max_len, dt, device)
        return state

    def prefill(params, batch, state):
        """Process the full prompt; returns (last-token logits, state).  A
        decoder reads only ``batch["tokens"]``, as in the reference: a VLM's
        ``prefix_embeds`` is ignored and its prompt takes text ids 0..S-1
        on all three M-RoPE axes (ROADMAP queue C).  An encoder-decoder
        runs the encoder on ``batch["enc_embeds"]`` (a batch without it
        raises ``KeyError``), then the decoder's teacher-forced pass over
        the tokens, and keeps the encoder's output as ``state["enc_out"]``."""
        tokens = torch.as_tensor(batch["tokens"], device=device)
        b, s = tokens.shape
        x = embed(params["embed"], tokens)
        pos = _positions(cfg, b, s, device)
        if cfg.encdec:
            enc_out = _encode(params, batch, b)
            x, caches = tf.decoder_prefill(params["encdec"], cfg, x, pos, state["caches"],
                                           enc_out)
            state = {**state, "enc_out": enc_out}
        else:
            x, caches = tf.stack_prefill(params["layers"], cfg, x, pos, state["caches"])
        state = {**state, "caches": caches,
                 "pos": torch.full((b, 1), s, dtype=torch.int32, device=device)}
        logits = _logits(params, _norm_f(params, x[:, -1:]))
        return logits[:, 0], state

    def decode_step(params, state, tokens):
        """tokens (B,) -> (logits (B, V), new state); one step, KV cache (an
        encoder-decoder's decoder attending to ``state["enc_out"]``)."""
        x = embed(params["embed"], tokens[:, None])
        pos = state["pos"]
        if cfg.encdec:
            x, caches = tf.decoder_decode(params["encdec"], cfg, x, pos, state["caches"],
                                          state["enc_out"])
        else:
            x, caches = tf.stack_decode(params["layers"], cfg, x, pos, state["caches"])
        logits = _logits(params, _norm_f(params, x))
        return logits[:, 0], {**state, "caches": caches, "pos": pos + 1}

    return Model(cfg, device, init, loss, prefill, decode_step, init_decode_state)
