"""A layer-graph IR with explicit dataflow edges -- the FINN-ONNX analog.

FINN dataflow accelerators are streaming *graphs*: mostly linear chains of
compute units, but with fan-out (one producer feeding several consumers)
and fan-in (elementwise-binary joins) for residual/skip-connection
topologies.  The IR is a list of :class:`Node` objects; each node names
its producers in ``inputs``.  For plain chains ``inputs`` may be left
``None`` -- the edge to the previous list node is implied, so every
pre-DAG graph keeps working unchanged -- and :func:`as_graph` materializes
the implied edges.

Transformation passes (lowering.py) rewrite the graph exactly like FINN's
*Lowering and Conversion to HLS Layers* and *Streamlining* passes;
dataflow.py then plays the role of *Folding and Resource Estimation*.

Supported ops:
    input            attrs: shape, bits                 (0 inputs)
    conv             attrs: kernel, stride, pad; params: w (Kd,Kd,Cin,Cout)
    linear           attrs: -; params: w (N, K) float
    batchnorm        params: gamma, beta, mean, var
    quant_act        attrs: bits, act_scale
    maxpool          attrs: size, stride (defaults to size)
    flatten          attrs: -
    swu              attrs: kernel, stride, pad  (after lowering)
    mvu              attrs: MVUConfig; params: MVUParams (after lowering)
    conv_mvu         attrs: MVUConfig + kernel/stride/pad; params: MVUParams
                     (after ``lowering.fuse_swu`` collapses a swu+mvu pair)
    add / sub / mul  attrs: scales=(sa, sb) optional per-input integer
                     quantization-alignment scales (default (1, 1));
                     2 inputs, FINN elementwise-binary broadcast semantics
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any


@dataclasses.dataclass
class Node:
    op: str
    name: str
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    params: dict[str, Any] = dataclasses.field(default_factory=dict)
    # named producer edges; None = chain-implied (the previous list node)
    inputs: tuple[str, ...] | None = None


class Graph(list):
    """A graph is a list of nodes (list order = authoring order; use
    :func:`toposort` for dataflow order).  Subclassing ``list`` keeps every
    chain-era consumer -- iteration, indexing, ``isinstance(g, list)`` --
    working on DAGs unchanged."""


# the streaming elementwise-binary family (FINN ElementwiseBinaryOperation)
ELTWISE_OPS = ("add", "sub", "mul")

KNOWN_OPS = {
    "input", "conv", "linear", "batchnorm", "quant_act",
    "maxpool", "flatten", "swu", "mvu", "conv_mvu", *ELTWISE_OPS,
}


# ops that consume a spatial (H, W, C) activation; everything else takes
# whatever its producer yields
SPATIAL_OPS = ("conv", "swu", "conv_mvu", "maxpool")

# one DeprecationWarning per process for each legacy entry point (the
# EngineServer shim pattern)
_VALIDATE_CHAIN_WARNED = False
_PROPAGATE_SHIM_WARNED = False


def describe(node: Node) -> str:
    """The error-message handle for one node: its id (name) plus its op."""
    return f"node {node.name!r} ({node.op})"


# ------------------------------------------------------------- graph algebra
def as_graph(graph) -> Graph:
    """Materialize chain-implied edges: every returned node has explicit
    ``inputs`` (``()`` for input nodes).  Nodes that already carry explicit
    edges pass through untouched; implied ones are shallow-replaced, sharing
    their ``attrs``/``params`` dicts so in-place config rewrites (folding)
    still reach the caller's graph."""
    out = Graph()
    prev: Node | None = None
    for node in graph:
        if node.inputs is None:
            implied = () if node.op == "input" or prev is None else (prev.name,)
            node = dataclasses.replace(node, inputs=implied)
        out.append(node)
        prev = node
    return out


def producer_map(graph) -> dict[str, Node]:
    return {n.name: n for n in graph}


def consumer_map(graph) -> dict[str, list[Node]]:
    g = as_graph(graph)
    cons: dict[str, list[Node]] = {n.name: [] for n in g}
    for n in g:
        for src in n.inputs:
            if src in cons:
                cons[src].append(n)
    return cons


def toposort(graph) -> Graph:
    """Dataflow-ordered node list (stable: list order breaks ties).

    Raises ``ValueError`` naming the offending nodes when the graph has a
    cycle.  Dangling edges are ignored here -- :func:`validate_graph` turns
    them into a proper per-node diagnostic."""
    g = as_graph(graph)
    names = {n.name for n in g}
    done: set[str] = set()
    order = Graph()
    remaining = list(g)
    while remaining:
        rest: list[Node] = []
        for n in remaining:
            if all(s in done or s not in names for s in n.inputs):
                order.append(n)
                done.add(n.name)
            else:
                rest.append(n)
        if len(rest) == len(remaining):
            cyc = ", ".join(describe(n) for n in rest)
            raise ValueError(f"graph contains a cycle through {cyc}")
        remaining = rest
    return order


def graph_output(graph) -> Node:
    """The single sink node (the graph's output stream)."""
    cons = consumer_map(graph)
    sinks = [n for n in as_graph(graph) if not cons[n.name]]
    if len(sinks) != 1:
        names = ", ".join(describe(n) for n in sinks)
        raise ValueError(
            f"graph must have exactly one output (sink) node, found "
            f"{len(sinks)}: [{names}]")
    return sinks[0]


def edge_list(graph) -> list[list[str]]:
    """All ``[producer, consumer]`` edges, in graph list order (the
    BuildReport's serialized topology)."""
    return [[src, n.name] for n in as_graph(graph) for src in n.inputs]


def branch_labels(graph) -> dict[str, str]:
    """A human-readable branch path per node.

    The trunk (and every join, where branches merge back) is ``"main"``;
    the first node past a fan-out point starts a branch named
    ``"<fork-producer>/<entry-node>"`` which its single-input successors
    inherit -- the handle verification errors and reports use to say *which
    arm* of a fork a node sits on."""
    g = toposort(graph)
    cons = consumer_map(g)
    labels: dict[str, str] = {}
    for n in g:
        if not n.inputs or len(n.inputs) > 1:
            labels[n.name] = "main"
            continue
        src = n.inputs[0]
        if len(cons.get(src, ())) > 1:
            labels[n.name] = f"{src}/{n.name}"
        else:
            labels[n.name] = labels.get(src, "main")
    return labels


# -------------------------------------------------------------- validation
def validate_graph(graph) -> None:
    """Structural DAG validation with actionable, node-id-keyed errors.

    Every failure names the offending node (``node 'fc0' (linear)``) and
    what the graph expected of its producers/consumers, so a malformed
    graph fails at build time with a pointer to the node -- not deep inside
    a transform with a bare assert or a KeyError.  Checks: unique names,
    known ops, per-op input arity, dangling edges, acyclicity, at least one
    input node, exactly one sink (no dangling branches), spatial/flat
    domain rules per branch, swu->mvu streaming contract, elementwise
    broadcast legality, and shape/attr propagation."""
    if not graph:
        raise ValueError(
            "empty graph: a dataflow graph must contain an 'input' node")
    seen: dict[str, Node] = {}
    for n in graph:
        if n.name in seen:
            raise ValueError(
                f"{describe(n)}: duplicate node name (also a "
                f"{seen[n.name].op!r} node); edges are keyed by name, so "
                f"names must be unique")
        seen[n.name] = n
    g = as_graph(graph)
    prod = producer_map(g)
    for n in g:
        if n.op not in KNOWN_OPS:
            raise ValueError(
                f"{describe(n)}: unknown op; known ops are {sorted(KNOWN_OPS)}")
        for src in n.inputs:
            if src not in prod:
                raise ValueError(
                    f"{describe(n)}: dangling input edge from {src!r} -- no "
                    f"node of that name in the graph")
        want = 0 if n.op == "input" else 2 if n.op in ELTWISE_OPS else 1
        if len(n.inputs) != want:
            if n.op == "input":
                raise ValueError(
                    f"{describe(n)}: an 'input' node takes no inputs, got "
                    f"edges from {list(n.inputs)} (a mid-chain 'input' is "
                    f"illegal; start a second stream with an explicit "
                    f"edge-free input node instead)")
            raise ValueError(
                f"{describe(n)}: {n.op!r} takes exactly {want} "
                f"input{'s' if want > 1 else ''}, got {len(n.inputs)} "
                f"({list(n.inputs)})")
    if not any(n.op == "input" for n in g):
        raise ValueError(
            "graph has no 'input' node: a dataflow graph must read at "
            "least one streamed input")
    order = toposort(g)  # raises on cycles
    cons = consumer_map(g)
    sinks = [n for n in g if not cons[n.name]]
    if len(sinks) != 1:
        names = ", ".join(describe(n) for n in sinks)
        raise ValueError(
            f"graph must have exactly one output (sink) node, found "
            f"{len(sinks)}: [{names}] -- a dangling branch never reaches "
            f"the output stream")
    shapes: dict[str, tuple] = {}
    for n in order:
        ins = tuple(shapes[s] for s in n.inputs)
        if n.op in SPATIAL_OPS and n.inputs:
            for src, shp in zip(n.inputs, ins):
                if len(shp) != 3:
                    p = prod[src]
                    raise ValueError(
                        f"{describe(n)}: needs a spatial (H, W, C) "
                        f"activation, but producer {p.op!r} ({p.name!r}) "
                        f"yields shape {shp}")
        try:
            shapes[n.name] = propagate(n, *ins)
        except KeyError as e:
            raise ValueError(
                f"{describe(n)}: missing required attr/param "
                f"{e.args[0]!r} for this op") from None
        except ValueError as e:
            raise ValueError(f"{describe(n)}: {e}") from None
        if n.op == "swu":
            if not cons[n.name]:
                raise ValueError(
                    f"{describe(n)}: a sliding-window unit cannot terminate "
                    f"the graph; expected an 'mvu' consumer")
            for c in cons[n.name]:
                if c.op != "mvu":
                    raise ValueError(
                        f"{describe(c)}: a sliding-window unit must feed an "
                        f"'mvu' consumer (producer 'swu' {n.name!r} yields "
                        f"im2col windows)")


def validate_chain(graph) -> None:
    """Deprecated alias of :func:`validate_graph`.

    Chains are DAGs whose edges are all chain-implied; there is no separate
    linear validator any more.  Kept as a shim (one ``DeprecationWarning``
    per process, mirroring the ``EngineServer`` shim) so pre-DAG callers
    keep working; new code should call :func:`validate_graph`."""
    global _VALIDATE_CHAIN_WARNED
    if not _VALIDATE_CHAIN_WARNED:
        _VALIDATE_CHAIN_WARNED = True
        warnings.warn(
            "ir.validate_chain is deprecated: the IR is a DAG now -- call "
            "ir.validate_graph (chains validate identically through it)",
            DeprecationWarning, stacklevel=2)
    validate_graph(graph)


# ------------------------------------------------------- shape propagation
def broadcast_shapes(a: tuple, b: tuple) -> tuple:
    """FINN/numpy multidirectional broadcast of two per-sample shapes
    (trailing-dim alignment; the batch dim is outside this algebra)."""
    a, b = tuple(a), tuple(b)
    rank = max(len(a), len(b))
    pa = (1,) * (rank - len(a)) + a
    pb = (1,) * (rank - len(b)) + b
    out = []
    for da, db in zip(pa, pb):
        if da != db and 1 not in (da, db):
            raise ValueError(
                f"cannot broadcast per-sample shapes {a} and {b} "
                f"(dim {da} vs {db})")
        out.append(max(da, db))
    return tuple(out)


def _conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    """Output size of a sliding window (the SWU's size algebra)."""
    return (size + 2 * pad - kernel) // stride + 1


def propagate(node: Node, *input_shapes: tuple) -> tuple:
    """Multi-input shape inference for one node.

    Spatial activations are ``(H, W, C)`` tuples, flat ones ``(K,)`` -- the
    shared shape algebra behind :func:`validate_graph`,
    ``dataflow.schedule``, ``lowering.apply_folding``, and the engine's
    stream planning.  Elementwise-binary nodes take two input shapes and
    broadcast them; every other op takes at most one.

    The legacy chain signature ``propagate(shape, node)`` still works
    through a compat shim (one ``DeprecationWarning`` per process)."""
    if not isinstance(node, Node):
        # legacy (shape, node) calling convention
        global _PROPAGATE_SHIM_WARNED
        if not _PROPAGATE_SHIM_WARNED:
            _PROPAGATE_SHIM_WARNED = True
            warnings.warn(
                "ir.propagate(shape, node) is deprecated: call "
                "ir.propagate(node, *input_shapes)",
                DeprecationWarning, stacklevel=2)
        shape, legacy_node = node, input_shapes[0]
        return propagate(legacy_node,
                         *(() if shape is None else (tuple(shape),)))
    if node.op == "input":
        return tuple(node.attrs["shape"])
    if node.op in ELTWISE_OPS:
        if len(input_shapes) != 2:
            raise ValueError(
                f"{node.op!r} takes exactly 2 input shapes, got "
                f"{len(input_shapes)}")
        return broadcast_shapes(*input_shapes)
    shape = input_shapes[0] if input_shapes else None
    if node.op in ("conv", "swu", "conv_mvu", "maxpool"):
        h, w = shape[0], shape[1]
        if node.op == "maxpool":
            kd = node.attrs["size"]
            st, pd = node.attrs.get("stride", kd), 0
        else:
            kd = node.attrs["kernel"]
            st, pd = node.attrs["stride"], node.attrs["pad"]
        oh, ow = _conv_out(h, kd, st, pd), _conv_out(w, kd, st, pd)
        if node.op == "swu":
            return (oh, ow, kd * kd * shape[2])
        if node.op == "maxpool":
            return (oh, ow, shape[2])
        n = (node.params["w"].shape[-1] if node.op == "conv"
             else node.attrs["config"].out_features)
        return (oh, ow, n)
    if node.op == "flatten":
        size = 1
        for d in shape:
            size *= d
        return (size,)
    if node.op == "linear":
        return (node.params["w"].shape[0],)
    if node.op == "mvu":
        n = node.attrs["config"].out_features
        return (*shape[:-1], n) if len(shape) == 3 else (n,)
    return shape  # batchnorm / quant_act keep the shape


def infer_shapes(graph) -> dict[str, tuple]:
    """Per-node output shapes, keyed by node name (topo-order propagation)."""
    shapes: dict[str, tuple] = {}
    for node in toposort(graph):
        shapes[node.name] = propagate(node, *(shapes[s] for s in node.inputs))
    return shapes


def io_shapes(graph) -> list[tuple[Node, tuple[tuple, ...], tuple]]:
    """``(node, input_shapes, output_shape)`` for every node, in topo order.

    The one shape-walk every multi-node consumer (scheduling, folding,
    autotune keys, report tables) shares -- the DAG replacement for the
    chain era's running ``shape = propagate(shape, node)`` loops."""
    out: list[tuple[Node, tuple[tuple, ...], tuple]] = []
    shapes: dict[str, tuple] = {}
    for node in toposort(graph):
        ins = tuple(shapes[s] for s in node.inputs)
        shapes[node.name] = propagate(node, *ins)
        out.append((node, ins, shapes[node.name]))
    return out


def n_pixels(shape: tuple) -> int:
    """Output pixels an MVU processes per sample (1 for flat activations)."""
    return shape[0] * shape[1] if len(shape) == 3 else 1


def find(graph, op: str) -> list[Node]:
    return [n for n in graph if n.op == op]
