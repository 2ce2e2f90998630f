"""Carry a graph across from a plain, framework-free description.

``graph_from_numpy(nodes, device)`` takes each node as a dict

    {"op": str, "name": str, "attrs": dict, "inputs": tuple | None,
     "params": {name: np.ndarray}}

and returns the port's :class:`~repro_torch.core.ir.Graph` with every array
as a tensor on ``device``: a raw ``conv`` node's (Kd, Kd, Cin, Cout) float
weights and its kernel/stride/pad, a ``maxpool``'s size, as they come.  For
a lowered node (``mvu``, ``conv_mvu``), ``params["mvu"]`` is a dict
of ``weights`` / ``thresholds`` / ``out_scale`` arrays (None where absent)
and ``attrs["config"]`` a dict of :class:`MVUConfig` fields, ``folding`` as
``{"pe", "simd"}`` and a tuned schedule (``blocks``) as a dict of
:class:`KernelBlocks` fields (``block_m`` the burst; ``block_n`` /
``block_k`` / ``block_kw`` / ``rows_per_tile`` pick the CUDA kernel's
compiled tile, rounded up onto its set, as they pick the Pallas blocks).  The JAX package's backend names map to the
port's: ``pallas`` -> ``cuda``, ``xla`` -> ``torch``.  Packed uint32 words
arrive as the port's int32 bit patterns (see :func:`_tensor`).  Whoever
holds the JAX graph makes the description (``np.asarray`` on each param);
the port never imports JAX.

An LM's parameter tree crosses the same way: ``lm_params_from_numpy(tree,
device)`` takes the JAX package's tree as nested dicts of numpy arrays
(``np.asarray`` on each leaf) and returns the port's, leaf for leaf (a
leaf given in float32 stays float32 in a bfloat16 tree);
``lm_numpy_params(cfg, seed)`` draws a dense, MoE, SSM, hybrid or VLM
decoder's tree, or an encoder-decoder's, in that layout with numpy alone,
so both packages can start from the same weights, and
``cast_numpy_params(tree, dtype)`` casts it to a model's dtype but for
the leaves the reference keeps float32 (``FLOAT32_LEAVES``).  An
AdamW state (``adamw.init`` / ``update``'s ``{"mu", "nu", "step"}``)
crosses by ``opt_state_from_numpy(state, device)``, and any port tree
goes back by ``numpy_tree(tree)``, so both packages can also carry on
from the same optimizer state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ssm_dims
from repro_torch.core.folding import Folding
from repro_torch.core.ir import Graph, Node
from repro_torch.core.mvu import KernelBlocks, MVUConfig, MVUParams
from repro_torch.kernels.ops import BACKEND_NAMES
from repro_torch.models.layers import is_gated
from repro_torch.models.transformer import require_ported
from repro_torch.tree import tree_map


def _tensor(a, device):
    """One array as a tensor on ``device``.  uint32 arrays (the JAX
    package's packed words) become the port's int32 bit patterns by a
    ``view`` -- the same 32 bits, not a value cast; uint8 lanes stay uint8."""
    if a is None:
        return None
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def _config(d: dict) -> MVUConfig:
    d = dict(d)
    if d.get("folding") is not None:
        d["folding"] = Folding(**d["folding"])
    if d.get("blocks") is not None:
        d["blocks"] = KernelBlocks(**d["blocks"])  # an unknown field raises
    d["backend"] = BACKEND_NAMES[d.get("backend", "cuda")]
    return MVUConfig(**d)


def graph_from_numpy(nodes, device="cpu") -> Graph:
    """The port's Graph for a list of plain node dicts (see module doc)."""
    g = Graph()
    for nd in nodes:
        attrs = dict(nd.get("attrs") or {})
        if "config" in attrs:
            attrs["config"] = _config(attrs["config"])
        params = {}
        for k, v in (nd.get("params") or {}).items():
            if k == "mvu":
                params[k] = MVUParams(**{f: _tensor(v.get(f), device)
                                         for f in ("weights", "thresholds", "out_scale")})
            else:
                params[k] = _tensor(v, device)
        inputs = nd.get("inputs")
        g.append(Node(nd["op"], nd["name"], attrs, params,
                      inputs=None if inputs is None else tuple(inputs)))
    return g


def lm_params_from_numpy(tree, device="cpu"):
    """The port's LM parameter tree for the JAX package's, given as nested
    dicts of numpy arrays: each leaf a tensor on ``device`` of the same
    values and dtype, except that ``int4`` (the reference's 4-bit and 1-bit
    MVU values) becomes int8, the dtype the port carries them in, and
    numpy's ``bfloat16`` becomes torch's."""
    def leaf(a):
        a = np.array(a)
        if a.dtype.name == "int4":
            a = a.astype(np.int8)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
        return torch.from_numpy(a).to(device)

    return tree_map(leaf, tree)


def opt_state_from_numpy(state, device="cpu") -> dict:
    """The port's AdamW state for the JAX package's, given as nested dicts
    of numpy arrays: the float32 moments leaf for leaf (as
    :func:`lm_params_from_numpy` carries params) and the step as a 0-d
    int32 tensor, all on ``device``."""
    return {"mu": lm_params_from_numpy(state["mu"], device),
            "nu": lm_params_from_numpy(state["nu"], device),
            "step": torch.from_numpy(np.array(state["step"], np.int32)).to(device)}


def numpy_tree(tree):
    """A port tree (params or an AdamW state) as nested dicts of numpy
    arrays, copied to the host: a bfloat16 leaf as float32, which holds it
    exactly (the other side casts it back)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, tree)


# the leaves the reference keeps float32 in a model of any dtype: a MoE
# layer's router, an SSM layer's A_log, D and dt_bias (in a uniform stack
# or a hybrid's sub-stacks)
FLOAT32_LEAVES = ("router", "A_log", "D", "dt_bias")


def keeps_float32(path: str) -> bool:
    """Whether the leaf at ``path`` ("layers/moe/router/w") stays float32
    whatever the model's dtype."""
    return any(k in FLOAT32_LEAVES for k in path.split("/"))


def cast_numpy_params(tree: dict, dtype) -> dict:
    """A float32 numpy tree (:func:`lm_numpy_params`'s) in a model's
    ``dtype`` (a numpy dtype, e.g. ``ml_dtypes.bfloat16``), each leaf of
    :func:`keeps_float32` left float32, as the reference's init leaves it."""
    def walk(node, prefix):
        return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict)
                else v if keeps_float32(prefix + k) else np.asarray(v).astype(dtype)
                for k, v in node.items()}

    return walk(tree, "")


def lm_numpy_params(cfg, seed: int = 0) -> dict:
    """A dense, MoE, SSM, hybrid or VLM decoder's parameters, or an
    encoder-decoder's, in the JAX package's layout (the tree its
    ``build(cfg).init`` returns, layers stacked on a leading axis; a VLM's
    is the dense tree) as float32 numpy arrays from
    ``np.random.default_rng(seed)``: each projection ``normal /
    sqrt(fan_in)``, the embedding ``normal * 0.02``, the norms at their
    init (scale 1, bias 0).  A MoE block holds ``moe/{router/w (L, d, E),
    w_up (L, E, d, f), w_gate (L, E, d, f), w_down (L, E, f, d)}`` in place
    of ``ffn``.  An SSM block holds ``ln1`` and ``ssm``
    (:func:`_ssm_numpy_params`) and no ``ln2``.  A hybrid stack holds G =
    ``num_layers // attn_period`` groups of ``per = attn_period``:
    ``ln_mix`` / ``ln_ffn`` (G, per, d), ``attn`` (G, ...), ``ssm`` (G,
    per - 1, ...), ``ffn`` (G, per - per // 2, ...) and ``moe`` (G, per //
    2, ...).  An encoder-decoder holds ``encdec`` in place of ``layers``:
    ``enc`` (``enc_layers`` stacked layers of ``ln1``, ``attn``, ``ln2``,
    ``ffn``), ``dec`` (``num_layers`` of ``ln1``, ``attn``, ``lnx``,
    ``xattn`` -- the cross attention, an ``attn`` node --, ``ln2``,
    ``ffn``) and ``ln_enc`` (d,).  The config's dtype is the caller's cast
    (:func:`cast_numpy_params`)."""
    require_ported(cfg)
    rng = np.random.default_rng(seed)
    d = cfg.d_model

    def dense(*shape):  # (..., fan_in, fan_out)
        return rng.standard_normal(shape, dtype=np.float32) / np.float32(np.sqrt(shape[-2]))

    def norm(*shape):
        p = {"scale": np.ones(shape, np.float32)}
        if cfg.norm == "layernorm":
            p["bias"] = np.zeros(shape, np.float32)
        return p

    table = rng.standard_normal((cfg.vocab_size, d), dtype=np.float32) * np.float32(0.02)
    params = {"embed": {"table": table}}
    if cfg.encdec:
        params["encdec"] = _encdec_numpy_params(cfg, dense, norm)
    else:
        params["layers"] = _layers_numpy_params(cfg, rng, dense, norm)
    params["ln_f"] = norm(d)
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": dense(d, cfg.vocab_size)}
    return params


def _layers_numpy_params(cfg, rng, dense, norm) -> dict:
    """The stacked layers of :func:`lm_numpy_params`, drawn on ``rng``."""
    n_layers, d = cfg.num_layers, cfg.d_model
    if cfg.is_hybrid:
        n, per = n_layers // cfg.attn_period, cfg.attn_period
        n_moe = per // 2
        return {"ln_mix": norm(n, per, d), "ln_ffn": norm(n, per, d),
                "attn": _attn_numpy_params(cfg, dense, norm, (n,)),
                "ssm": _ssm_numpy_params(cfg, rng, dense, (n, per - 1)),
                "ffn": _ffn_numpy_params(cfg, dense, (n, per - n_moe)),
                "moe": _moe_numpy_params(cfg, dense, (n, n_moe))}
    if cfg.family == "ssm":
        return {"ln1": norm(n_layers, d), "ssm": _ssm_numpy_params(cfg, rng, dense, (n_layers,))}
    layers = {"ln1": norm(n_layers, d), "ln2": norm(n_layers, d),
              "attn": _attn_numpy_params(cfg, dense, norm, (n_layers,))}
    if cfg.is_moe:
        layers["moe"] = _moe_numpy_params(cfg, dense, (n_layers,))
    else:
        layers["ffn"] = _ffn_numpy_params(cfg, dense, (n_layers,))
    return layers


def _encdec_numpy_params(cfg, dense, norm) -> dict:
    """The encoder's and the decoder's stacked layers and ``ln_enc`` of
    :func:`lm_numpy_params`."""
    n_enc, n_dec, d = cfg.enc_layers, cfg.num_layers, cfg.d_model
    enc = {"ln1": norm(n_enc, d), "attn": _attn_numpy_params(cfg, dense, norm, (n_enc,)),
           "ln2": norm(n_enc, d), "ffn": _ffn_numpy_params(cfg, dense, (n_enc,))}
    dec = {"ln1": norm(n_dec, d), "attn": _attn_numpy_params(cfg, dense, norm, (n_dec,)),
           "lnx": norm(n_dec, d), "xattn": _attn_numpy_params(cfg, dense, norm, (n_dec,)),
           "ln2": norm(n_dec, d), "ffn": _ffn_numpy_params(cfg, dense, (n_dec,))}
    return {"enc": enc, "dec": dec, "ln_enc": norm(d)}


def _attn_numpy_params(cfg, dense, norm, lead: tuple) -> dict:
    """An attention stack: ``{wq, wk, wv, wo}/w (*lead, in, out)``, and
    ``qnorm`` / ``knorm`` under ``cfg.qk_norm``."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = {"wq": {"w": dense(*lead, d, cfg.num_heads * hd)},
            "wk": {"w": dense(*lead, d, cfg.num_kv_heads * hd)},
            "wv": {"w": dense(*lead, d, cfg.num_kv_heads * hd)},
            "wo": {"w": dense(*lead, cfg.num_heads * hd, d)}}
    if cfg.qk_norm:
        attn["qnorm"], attn["knorm"] = norm(*lead, hd), norm(*lead, hd)
    return attn


def _ffn_numpy_params(cfg, dense, lead: tuple) -> dict:
    """A dense FFN stack: ``{w_up, w_down, w_gate}/w (*lead, in, out)``
    (``w_gate`` if the activation is gated)."""
    d, ff = cfg.d_model, cfg.d_ff
    ffn = {"w_up": {"w": dense(*lead, d, ff)}, "w_down": {"w": dense(*lead, ff, d)}}
    if is_gated(cfg.activation):
        ffn["w_gate"] = {"w": dense(*lead, d, ff)}
    return ffn


def _moe_numpy_params(cfg, dense, lead: tuple) -> dict:
    """A MoE FFN stack: ``router/w (*lead, d, E)``, ``w_up`` / ``w_gate``
    (*lead, E, d, f) and ``w_down`` (*lead, E, f, d), raw arrays as the
    reference's ``moe_init`` makes them."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    moe = {"router": {"w": dense(*lead, d, e)}, "w_up": dense(*lead, e, d, f),
           "w_down": dense(*lead, e, f, d)}
    if is_gated(cfg.activation):
        moe["w_gate"] = dense(*lead, e, d, f)
    return moe


def _ssm_numpy_params(cfg, rng, dense, lead: tuple) -> dict:
    """An SSM stack's ``ssm`` node in the reference's layout, every leaf
    with the leading axes ``lead``: ``{w_z, w_x, w_B, w_C, w_dt,
    out_proj}/w (*lead, in, out)``, ``conv_{x,B,C}/{w (*lead, K, C) normal
    * 0.2, b (*lead, C) zero}`` with each sub-layer's ``conv_C`` equal to
    its ``conv_B`` (the reference draws both from one key), ``A_log`` =
    log(1..H), ``D`` = 1 and ``dt_bias`` = log(expm1(0.01)), each (*lead,
    H), and ``norm/scale`` (*lead, d_inner) ones."""
    d = cfg.d_model
    d_inner, nheads, _ = ssm_dims(cfg)
    gn = cfg.ssm_groups * cfg.ssm_state

    def conv(c):
        w = rng.standard_normal((*lead, cfg.ssm_conv, c), dtype=np.float32) * np.float32(0.2)
        return {"w": w, "b": np.zeros((*lead, c), np.float32)}

    per_head = lambda v: np.broadcast_to(np.asarray(v, np.float32), (*lead, nheads)).copy()
    conv_bc = conv(gn)
    return {"w_z": {"w": dense(*lead, d, d_inner)},
            "w_x": {"w": dense(*lead, d, d_inner)},
            "w_B": {"w": dense(*lead, d, gn)},
            "w_C": {"w": dense(*lead, d, gn)},
            "w_dt": {"w": dense(*lead, d, nheads)},
            "conv_x": conv(d_inner),
            "conv_B": conv_bc,
            "conv_C": {k: v.copy() for k, v in conv_bc.items()},
            "A_log": per_head(np.log(np.arange(1, nheads + 1, dtype=np.float32))),
            "D": per_head(np.ones(nheads, np.float32)),
            "dt_bias": per_head(np.log(np.expm1(np.full(nheads, 0.01, np.float32)))),
            "norm": {"scale": np.ones((*lead, d_inner), np.float32)},
            "out_proj": {"w": dense(*lead, d_inner, d)}}
