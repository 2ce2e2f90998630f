"""Graph transformation passes: FINN's lowering + streamlining.

    lower_to_mvu:   conv -> [swu, mvu];  linear -> mvu
    streamline:     [mvu, batchnorm, quant_act] -> mvu(+thresholds)
    fuse_epilogues: same fold for finalized graphs (the runtime engine path)
    fuse_swu:       [swu, mvu] -> conv_mvu (line-buffer fused conv kernel)
    apply_folding:  attach rate-balanced Folding to every mvu node
    apply_schedules: pin autotuned schedules (``core/autotune.py``)
    pack_weights:   bit-packed weight storage (forced, or where a node asks)

All passes are DAG-aware: patterns match along explicit dataflow edges
(producer -> sole-consumer paths), not list adjacency.  Every pass returns
a graph whose nodes carry explicit ``inputs`` edges.

Weight quantization and threshold folding are float32 math followed by
rounding; run them on CPU tensors (``repro_torch.build`` does) so the
integer weights and thresholds equal the JAX reference's wherever the
engine later runs.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import ir, swu as swu_mod
from repro_torch.core.folding import balance_pipeline
from repro_torch.core.ir import Graph, Node, validate_graph
from repro_torch.core.mvu import MVUConfig, MVULayer, MVUParams, coded_weights
from repro_torch.core.thresholds import (
    bn_quant_thresholds,
    integerize_thresholds,
    streamline_signs,
)
from repro_torch.kernels import packing
from repro_torch.kernels.mvu_packed import pack_mvu_weights


def _reroute(graph: Graph, renames: dict[str, str]) -> Graph:
    """Repoint every input edge through ``renames`` (old producer name ->
    the name of the node that now yields its stream)."""
    if not renames:
        return graph
    out = Graph()
    for n in graph:
        ins = tuple(renames.get(s, s) for s in n.inputs)
        out.append(n if ins == n.inputs else dataclasses.replace(n, inputs=ins))
    return out


def _sole_consumer(cons: dict[str, list[Node]], name: str, op: str) -> Node | None:
    """The single consumer of ``name`` when it exists and has op ``op``."""
    cs = cons.get(name, ())
    if len(cs) == 1 and cs[0].op == op:
        return cs[0]
    return None


def lower_to_mvu(graph: Graph, *, mode: str = "standard",
                 weight_bits: int = 4, act_bits: int = 4,
                 backend: str = "cuda") -> Graph:
    """conv -> swu+mvu; linear -> mvu. Float weights stay attached (raw)."""
    validate_graph(graph)
    out = Graph()
    renames: dict[str, str] = {}
    for node in ir.as_graph(graph):
        if node.op == "conv":
            out.append(Node("swu", node.name + ".swu", dict(node.attrs),
                            inputs=node.inputs))
            wm = swu_mod.pack_conv_weights(node.params["w"])  # (N, K)
            cfg = MVUConfig(
                in_features=wm.shape[1], out_features=wm.shape[0],
                mode=mode, weight_bits=weight_bits, act_bits=act_bits,
                backend=backend,
            )
            out.append(Node("mvu", node.name + ".mvu", {"config": cfg},
                            {"w_float": wm}, inputs=(node.name + ".swu",)))
            renames[node.name] = node.name + ".mvu"
        elif node.op == "linear":
            w = node.params["w"]
            cfg = MVUConfig(
                in_features=w.shape[1], out_features=w.shape[0],
                mode=mode, weight_bits=weight_bits, act_bits=act_bits,
                backend=backend,
            )
            out.append(Node("mvu", node.name + ".mvu", {"config": cfg},
                            {"w_float": w}, inputs=node.inputs))
            renames[node.name] = node.name + ".mvu"
        else:
            out.append(node)
    return _reroute(out, renames)


def streamline(graph: Graph) -> Graph:
    """Fold [mvu, batchnorm, quant_act] into mvu-with-thresholds (MVTU).

    Matched along edges: the batchnorm must be the MVU's sole consumer and
    the quant_act the batchnorm's sole consumer.  The quant_act's own
    fan-out is fine -- its consumers are rerouted to the fused node.
    """
    g = ir.as_graph(graph)
    cons = ir.consumer_map(g)
    drop: set[str] = set()
    fused: dict[str, Node] = {}
    renames: dict[str, str] = {}
    for node in g:
        if node.op != "mvu" or "w_float" not in node.params:
            continue
        bn = _sole_consumer(cons, node.name, "batchnorm")
        qa = bn and _sole_consumer(cons, bn.name, "quant_act")
        if qa is None:
            continue
        cfg: MVUConfig = node.attrs["config"]
        bits = qa.attrs["bits"]
        # weight scale factors into BN: acc_int * (w_scale) feeds BN.
        _, qt = MVULayer.from_float(cfg, node.params["w_float"])
        acc_scale = qt.scale.reshape(-1)  # (N,)
        t, flip = bn_quant_thresholds(
            bn.params["gamma"], bn.params["beta"],
            bn.params["mean"], bn.params["var"],
            bits=bits, acc_scale=1.0,
            act_scale=qa.attrs.get("act_scale", 1.0),
        )
        # thresholds computed against real acc = acc_int * acc_scale:
        t = t / acc_scale[:, None]
        # flip rows (negative gamma): negate quantized weight rows.
        wq = streamline_signs(qt.values.to(torch.int32), flip).to(qt.values.dtype)
        params = MVUParams(weights=coded_weights(cfg.mode, wq),
                           thresholds=integerize_thresholds(t), out_scale=None)
        cfg2 = MVUConfig(**{**cfg.__dict__, "act_bits": bits})
        fused[node.name] = Node("mvu", node.name, {"config": cfg2},
                                {"mvu": params}, inputs=node.inputs)
        drop.update((bn.name, qa.name))
        renames[qa.name] = node.name
    out = Graph(fused.get(n.name, n) for n in g if n.name not in drop)
    return _reroute(out, renames)


def finalize(graph: Graph) -> Graph:
    """Quantize any mvu nodes still carrying float weights (no BN to fold)."""
    out = Graph()
    for node in ir.as_graph(graph):
        if node.op == "mvu" and "mvu" not in node.params:
            cfg: MVUConfig = node.attrs["config"]
            params, _ = MVULayer.from_float(cfg, node.params["w_float"])
            out.append(Node("mvu", node.name, dict(node.attrs), {"mvu": params},
                            inputs=node.inputs))
        else:
            out.append(node)
    return out


def _flip_weight_rows(weights: torch.Tensor, flip: torch.Tensor,
                      cfg: MVUConfig) -> torch.Tensor:
    """Negate the (bipolar) value of flipped weight rows, per weight coding.

    standard: integer rows negate directly (widened so -(-2^(b-1)) is safe);
    binary:   {0,1}-coded +/-1 rows flip bits (1 - w);
    xnor:     packed rows unpack over the true K bits, flip, repack (pad
              bits stay zero, preserving the popcount correction).
    """
    if cfg.mode == "xnor":
        bits = packing.unpack_bits(weights, cfg.in_features)
        return packing.pack_bits(torch.where(flip[:, None], 1 - bits, bits))
    if cfg.mode == "binary":
        return torch.where(flip[:, None], 1 - weights, weights).to(weights.dtype)
    return streamline_signs(weights.to(torch.int32), flip).to(weights.dtype)


def fuse_epilogues(graph: Graph) -> Graph:
    """Fold batchnorm/quant_act successors of *finalized* MVU nodes into the
    kernel's multi-threshold epilogue.

    :func:`streamline` does this rewrite at lowering time on float weights;
    this pass is its runtime-engine analog for graphs that kept standalone
    ``batchnorm``/``quant_act`` nodes (the unfused interpreter path).  The
    dequant scale already attached to the MVU (``out_scale``) folds into the
    thresholds, so the fused node emits integer activation levels straight
    from the accumulator.  Handled patterns, on sole-consumer paths off the
    MVU (the quant_act's own consumers reroute to the fused node):
        mvu -> batchnorm -> quant_act   =>  mvu(+thresholds)
        mvu -> quant_act                =>  mvu(+thresholds)  (identity BN)
    """
    g = ir.as_graph(graph)
    cons = ir.consumer_map(g)
    drop: set[str] = set()
    fused_nodes: dict[str, Node] = {}
    renames: dict[str, str] = {}
    for node in g:
        fusable = (
            node.op in ("mvu", "conv_mvu")
            and "mvu" in node.params
            and node.params["mvu"].thresholds is None
        )
        if not fusable:
            continue
        bn = _sole_consumer(cons, node.name, "batchnorm")
        qa = (_sole_consumer(cons, bn.name, "quant_act") if bn is not None
              else _sole_consumer(cons, node.name, "quant_act"))
        if qa is None:
            continue

        cfg: MVUConfig = node.attrs["config"]
        params: MVUParams = node.params["mvu"]
        n = cfg.out_features
        bits = qa.attrs["bits"]
        if bn is not None:
            gamma, beta = bn.params["gamma"], bn.params["beta"]
            mean, var = bn.params["mean"], bn.params["var"]
        else:
            # identity BN: var = 1 - eps so sqrt(var + eps) == 1 exactly and
            # the thresholds reduce to the bare quantizer boundaries.
            gamma = torch.ones((n,), dtype=torch.float32)
            beta = torch.zeros((n,), dtype=torch.float32)
            mean = torch.zeros((n,), dtype=torch.float32)
            var = torch.ones((n,), dtype=torch.float32) - 1e-5
        t, flip = bn_quant_thresholds(
            gamma, beta, mean, var,
            bits=bits, acc_scale=1.0,
            act_scale=qa.attrs.get("act_scale", 1.0),
        )
        # thresholds hold on the real accumulator; the kernel compares the
        # integer accumulator, so divide per-row by the dequant scale.
        scale = params.out_scale
        if scale is not None:
            t = t / scale.reshape(-1)[:, None]
        fused_params = MVUParams(
            weights=_flip_weight_rows(params.weights, flip, cfg),
            thresholds=integerize_thresholds(t), out_scale=None,
        )
        cfg2 = MVUConfig(**{**cfg.__dict__, "act_bits": bits})
        attrs = dict(node.attrs)
        attrs["config"] = cfg2
        attrs["fused"] = tuple(x.name for x in (bn, qa) if x is not None)
        fused_nodes[node.name] = Node(node.op, node.name, attrs,
                                      {"mvu": fused_params}, inputs=node.inputs)
        drop.update(x.name for x in (bn, qa) if x is not None)
        renames[qa.name] = node.name
    out = Graph(fused_nodes.get(n.name, n) for n in g if n.name not in drop)
    return _reroute(out, renames)


def fuse_swu(graph: Graph) -> Graph:
    """Collapse ``swu -> mvu`` edges into one ``conv_mvu`` node.

    The standalone SWU materialises the full (B, OH*OW, Kd^2*C) window
    matrix before the MVU consumes it; the fused node streams sliding
    windows through the line-buffer kernel (``kernels/swu_mvu.py``) instead
    -- the runtime analog of FINN's SWU->MVU stream, where that matrix
    never exists in memory.  Requires finalized MVU nodes (``params["mvu"]``)
    and an SWU with a single consumer; run after :func:`finalize` /
    :func:`fuse_epilogues`.
    """
    g = ir.as_graph(graph)
    cons = ir.consumer_map(g)
    drop: set[str] = set()
    fused: dict[str, Node] = {}
    renames: dict[str, str] = {}
    for node in g:
        if node.op != "swu":
            continue
        mvu = _sole_consumer(cons, node.name, "mvu")
        if mvu is None or "mvu" not in mvu.params:
            continue
        attrs = dict(mvu.attrs)
        for key in ("kernel", "stride", "pad"):
            attrs[key] = node.attrs[key]
        name = mvu.name.replace(".mvu", ".conv_mvu")
        fused[mvu.name] = Node("conv_mvu", name, attrs, mvu.params, inputs=node.inputs)
        drop.add(node.name)
        renames[mvu.name] = name
    out = Graph(fused.get(n.name, n) for n in g if n.name not in drop)
    return _reroute(out, renames)


def apply_folding(graph: Graph, *, target_cycles: int | None = None,
                  max_pe: int = 128, max_simd: int = 128) -> Graph:
    """FINN folding pass: rate-balance all MVU stages.

    MVU stages are visited in topological (dataflow) order; configs rewrite
    in place through the shared attrs dicts, so the caller's graph is
    updated.
    """
    shapes = []
    mvu_nodes = []
    for node, _, out_shape in ir.io_shapes(graph):
        if node.op in ("mvu", "conv_mvu"):
            cfg: MVUConfig = node.attrs["config"]
            shapes.append((cfg.out_features, cfg.in_features,
                           ir.n_pixels(out_shape)))
            mvu_nodes.append(node)
    folds = balance_pipeline(shapes, slowest_cycles=target_cycles,
                             max_pe=max_pe, max_simd=max_simd)
    for node, f in zip(mvu_nodes, folds):
        cfg = node.attrs["config"]
        node.attrs["config"] = MVUConfig(**{**cfg.__dict__, "folding": f})
    return graph


def apply_schedules(graph: Graph, *, cache=None, mode: str = "cache",
                    device=None) -> Graph:
    """Empirical-schedule pass: the autotuned counterpart of
    :func:`apply_folding`.  Rewrites every finalized mvu / conv_mvu node's
    config with the schedule recorded in the autotune cache
    (``autotune.tune_graph``): ``mode="cache"`` only looks up, ``"auto"``
    measures misses and fills the cache.  Returns a new graph."""
    from repro_torch.core import autotune

    return autotune.tune_graph(graph, cache=cache, mode=mode, device=device)


def packable(cfg: MVUConfig) -> bool:
    """Whether the packed datapath exists for this config's weight coding:
    all 1-bit codings pack into 32-bit bitplanes; standard weights pack into
    2-bit lanes only when they fit signed 2 bits.  (The JAX package keeps
    this in its autotuner, ``core/autotune.py:271``; the port's autotuner
    imports it from here.)"""
    return cfg.mode in ("xnor", "binary") or cfg.weight_bits <= 2


def pack_weights(graph: Graph, *, force: bool = False) -> Graph:
    """Packing rewrite: store MVU weights in their bit-packed form.

    Rewrites every finalized dense ``mvu`` node whose config selects the
    packed datapath (``cfg.packed``, pinned by a tuned schedule entry
    carrying ``"packed": true``), or every :func:`packable` one when ``force`` is
    set (the build's ``pack="always"``).  Storage converts per coding:
    binary {0,1} int8 rows -> int32 bitplanes (8x smaller), standard signed
    2-bit rows -> uint8 lanes (4x), xnor rows are already words (storage
    no-op; the flag routes ``backend="torch"`` onto the packed popcount).
    Conv nodes keep canonical storage: the fused line-buffer gather reads
    unpacked rows.  Returns a new graph; rewritten nodes carry fresh
    params/attrs.
    """
    out = Graph()
    for node in graph:
        if node.op != "mvu" or "mvu" not in node.params:
            out.append(node)
            continue
        cfg: MVUConfig = node.attrs["config"]
        if not (cfg.packed or (force and packable(cfg))):
            out.append(node)
            continue
        params = node.params["mvu"]
        w = params.weights
        # idempotence: canonical non-xnor storage is int8 rows; the packed
        # forms are int32 words / uint8 lanes
        if cfg.mode != "xnor" and w.dtype == torch.int8:
            w = pack_mvu_weights(w, cfg.mode)
        new_params = MVUParams(weights=w, thresholds=params.thresholds,
                               out_scale=params.out_scale)
        new_cfg = (cfg if cfg.packed
                   else MVUConfig(**{**cfg.__dict__, "packed": True}))
        out.append(Node(node.op, node.name,
                        {**node.attrs, "config": new_cfg},
                        {**node.params, "mvu": new_params},
                        inputs=node.inputs))
    return out
