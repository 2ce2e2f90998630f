"""Streaming-dataflow schedule + executor (FINN backend analog).

FINN connects one compute unit per layer with AXI streams; throughput is set
by the slowest stage and small FIFOs decouple producer/consumer bursts
(paper section 5.3).  This module holds (a) the schedule -- per-stage cycle
counts, bottleneck stage, FIFO depths -- and (b) the eager interpreter,
``execute``: the behavioural model the fused engine is held to, integer
semantics end to end.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import autotune, ir, swu as swu_mod
from repro_torch.core.ir import Graph
from repro_torch.core.mvu import MVUConfig, MVULayer, MVUParams
from repro_torch.core.resource_model import NOMINAL_CLOCK_HZ, MVUResources
from repro_torch.kernels import mvu_xnor, ops, packing


@dataclasses.dataclass
class StageInfo:
    name: str
    cycles: int
    resources: MVUResources
    fifo_depth: int
    n_pixels: int = 1  # output pixels per sample (conv stages; 1 for dense)
    block_m: int = 128  # samples per stream burst of the stage
    branch: str = "main"  # which arm of a fork the stage sits on


@dataclasses.dataclass
class JoinInfo:
    """One fan-in point (elementwise-binary node) of a branched graph.

    ``fifo_depth`` balances the latency skew between the two joined arms:
    the branch latency difference over the pipeline's initiation interval,
    floored at the usual decoupling minimum of 2."""

    name: str
    branches: tuple[str, str]  # branch label of each joined input
    branch_latency: tuple[int, int]  # critical-path cycles into each input
    fifo_depth: int


@dataclasses.dataclass
class DataflowSchedule:
    stages: list[StageInfo]
    joins: list[JoinInfo] = dataclasses.field(default_factory=list)
    # critical-path latency through the DAG (equals the stage sum on
    # chains); None -> fall back to the chain-era sum
    critical_path_cycles: int | None = None

    @property
    def bottleneck(self) -> StageInfo:
        return max(self.stages, key=lambda s: s.cycles)

    @property
    def steady_state_interval(self) -> int:
        """Cycles between successive inferences once the pipeline is full."""
        return self.bottleneck.cycles

    @property
    def burst_samples(self) -> int:
        """Samples in the smallest stage burst (``block_m // n_pixels``
        whole samples, images for a conv stage; at least 1): the engine's
        heuristic microbatch, so what each of its launches gets."""
        return min(max(1, s.block_m // s.n_pixels) for s in self.stages)

    @property
    def latency_cycles(self) -> int:
        if self.critical_path_cycles is not None:
            return self.critical_path_cycles
        return sum(s.cycles for s in self.stages)

    def summary(self) -> dict:
        out = {
            "stages": len(self.stages),
            "latency_cycles": self.latency_cycles,
            "interval_cycles": self.steady_state_interval,
            "bottleneck": self.bottleneck.name,
            "total_bram_bytes": sum(s.resources.bram_bytes for s in self.stages),
            "total_lut_bytes": sum(s.resources.lut_bytes for s in self.stages),
        }
        if self.joins:
            out["joins"] = [{
                "name": j.name, "branches": list(j.branches),
                "branch_latency": list(j.branch_latency),
                "fifo_depth": j.fifo_depth,
            } for j in self.joins]
        return out


# The paper's nominal 200 MHz FPGA clock converts schedule cycles to time
# when no cycle time has been measured.
DEFAULT_CLOCK_HZ = NOMINAL_CLOCK_HZ


def interval_seconds(sched: DataflowSchedule, *, cache=None, device=None,
                     clock_hz: float = DEFAULT_CLOCK_HZ) -> float:
    """Wall-clock seconds per steady-state interval (one microbatch burst).

    This is the bridge from the schedule's cycle algebra to serving-time
    budgets: the continuous batcher flushes when a request's deadline slack
    shrinks to one engine interval (``repro_torch.serving.batcher``).  When
    the cache (default: ``autotune.default_cache()``) holds a *measured*
    cycle time under ``autotune.cycle_time_key(device)`` (recorded by
    ``repro_torch.serving.batcher.calibrate_cycle_time``), that measurement
    wins; otherwise the nominal ``clock_hz`` converts the analytic cycle
    count.  ``device`` is a torch device or a device kind string; None
    means the CUDA device.
    """
    if cache is None:
        cache = autotune.default_cache()
    if len(cache):  # an empty cache holds no measurement for any device
        ent = cache.get(autotune.cycle_time_key(device))
        if ent is not None and ent.get("s_per_cycle"):
            return sched.steady_state_interval * float(ent["s_per_cycle"])
    return sched.steady_state_interval / clock_hz


def schedule(graph: Graph) -> DataflowSchedule:
    info = ir.io_shapes(graph)
    branches = ir.branch_labels(graph)
    stages: list[StageInfo] = []
    # per-node bookkeeping threaded along edges: nearest upstream MVU
    # stage's cycle count, and the critical-path latency into each node
    upstream: dict[str, int | None] = {}
    lat: dict[str, int] = {}
    for node, _, out_shape in info:
        ins = node.inputs or ()
        prevs = [upstream.get(s) for s in ins]
        prev_cycles = max((p for p in prevs if p is not None), default=None)
        in_lat = max((lat[s] for s in ins), default=0)
        if node.op not in ("mvu", "conv_mvu"):
            upstream[node.name] = prev_cycles
            lat[node.name] = in_lat
            continue
        cfg: MVUConfig = node.attrs["config"]
        px = ir.n_pixels(out_shape)
        res = MVULayer(cfg).resources(n_pixels=px)
        # FIFO sizing: enough to absorb one producer burst while the
        # consumer drains at its own rate (paper 5.3.2's small FIFO).  At a
        # fan-in the slowest producer governs the drain ratio.
        fold = cfg.resolved_folding()
        burst = fold.pe  # outputs produced per cycle group
        drain = 1 if prev_cycles is None else max(1, res.cycles // max(prev_cycles, 1))
        fifo = max(2, burst * min(drain, 8))
        stages.append(StageInfo(node.name, res.cycles, res, fifo,
                                n_pixels=px, block_m=cfg.block_m,
                                branch=branches.get(node.name, "main")))
        upstream[node.name] = res.cycles
        lat[node.name] = in_lat + res.cycles
    interval = max((s.cycles for s in stages), default=1)
    joins = [
        JoinInfo(
            node.name,
            tuple(branches.get(s, "main") for s in node.inputs),
            tuple(lat[s] for s in node.inputs),
            max(2, -(-abs(lat[node.inputs[0]] - lat[node.inputs[1]])
                     // max(1, interval))),
        )
        for node, _, _ in info if node.op in ir.ELTWISE_OPS
    ]
    return DataflowSchedule(stages, joins=joins,
                            critical_path_cycles=max(lat.values(), default=0))


def node_runner(node):
    """Per-node semantics as ``(params, fn)`` with ``fn(params, *xs) -> x``.

    The eager interpreter (:func:`execute`) and the fused engine
    (``repro_torch.core.engine``) both apply nodes through this single
    definition, so the engine is bit-exact with the behavioural model by
    construction.  Single-input ops take one tensor; elementwise-binary ops
    take two.
    """
    if node.op == "input":
        return None, lambda p, x: x
    if node.op in ir.ELTWISE_OPS:
        sa, sb = node.attrs.get("scales", (1, 1))
        opf = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}[node.op]

        def run_eltwise(p, a, b):
            # FINN broadcast semantics on per-sample shapes: align trailing
            # dims, keeping the batch dim (axis 0) out of the broadcast by
            # padding singleton dims right after it.
            rank = max(a.ndim, b.ndim)
            a2 = a.reshape(a.shape[0], *((1,) * (rank - a.ndim)), *a.shape[1:])
            b2 = b.reshape(b.shape[0], *((1,) * (rank - b.ndim)), *b.shape[1:])
            # per-input integer quantization-alignment scales
            return opf(a2 * sa, b2 * sb)

        return None, run_eltwise
    if node.op == "swu":
        kd, st, pd = node.attrs["kernel"], node.attrs["stride"], node.attrs["pad"]

        def run_swu(p, x):
            # keep the spatial layout so conv stages chain: (B, OH, OW, K)
            b, h, w, _ = x.shape
            cols = swu_mod.sliding_window(x, kd, st, pd)  # (B, P, K)
            return cols.reshape(b, swu_mod.out_dim(h, kd, st, pd),
                                swu_mod.out_dim(w, kd, st, pd), cols.shape[-1])

        return None, run_swu
    if node.op == "conv_mvu":
        cfg: MVUConfig = node.attrs["config"]
        kd, st, pd = node.attrs["kernel"], node.attrs["stride"], node.attrs["pad"]
        blocks = cfg.kernel_blocks()  # the tile every launch of the stage takes

        def run_conv(p, x):
            b, h, w, _ = x.shape
            out = ops.conv_mvu(
                x, p.weights, kernel=kd, stride=st, pad=pd, mode=cfg.mode,
                k_bits=cfg.in_features if cfg.mode == "xnor" else None,
                thresholds=p.thresholds, out_scale=p.out_scale, backend=cfg.backend,
                **blocks,
            )  # (B, OH*OW, N)
            return out.reshape(b, swu_mod.out_dim(h, kd, st, pd),
                               swu_mod.out_dim(w, kd, st, pd), cfg.out_features)

        return node.params["mvu"], run_conv
    if node.op == "maxpool":
        size = node.attrs["size"]
        st = node.attrs.get("stride", size)

        def run_pool(p, x):
            # VALID windows (a ragged edge is dropped), as the JAX package's
            # reduce_window; amax over the window views needs no init value,
            # so integer streams stay exact on every device
            win = x.unfold(1, size, st).unfold(2, size, st)  # (B, OH, OW, C, s, s)
            return win.amax(dim=(-2, -1))

        return None, run_pool
    if node.op == "flatten":
        return None, lambda p, x: x.reshape(x.shape[0], -1)
    if node.op == "mvu":
        cfg: MVUConfig = node.attrs["config"]
        layer = MVULayer(cfg)
        if cfg.mode != "xnor":
            return node.params["mvu"], layer
        tile = ops.tile_kwargs("mvu_xnor_bits", **layer.blocks)

        def run_xnor(p, x):
            # activations stream between nodes as integer levels (int32, as
            # packed words are, so the dtype cannot tell the two apart): an
            # xnor stage packs its input's LSBs itself -- on the card in the
            # kernel (mvu_xnor_bits), on the CPU by pack_bits and the packed
            # plain version
            if cfg.backend == "cuda" and x.device.type != "cpu":
                out = mvu_xnor.mvu_xnor_bits(x.reshape(-1, x.shape[-1]), p.weights,
                                             p.thresholds, p.out_scale, **tile)
                return out.reshape(*x.shape[:-1], cfg.out_features)
            return layer(p, packing.pack_bits(x))

        return node.params["mvu"], run_xnor
    if node.op == "batchnorm":
        p = {k: node.params[k] for k in ("gamma", "beta", "mean", "var")}
        # separate ops, in the JAX reference's order: no fused multiply-add
        return p, lambda p, x: (
            (x - p["mean"]) * p["gamma"] / torch.sqrt(p["var"] + 1e-5) + p["beta"]
        )
    if node.op == "quant_act":
        bits = node.attrs["bits"]
        s = node.attrs.get("act_scale", 1.0)
        # round-half-up: level j iff x >= (j - 0.5) * s, the multi-threshold
        # unit's decision rule, so threshold fusion (streamline /
        # fuse_epilogues) is exact even at half-level ties.
        return None, lambda p, x: torch.clamp(
            torch.floor(x / s + 0.5), 0, 2**bits - 1
        ).to(torch.int32)
    raise ValueError(f"unknown op {node.op!r} ({node.name})")


def graph_to(graph: Graph, device) -> Graph:
    """The graph with every tensor parameter on ``device`` (a new graph;
    node attrs are shared, params are fresh dicts)."""
    def move(v):
        if isinstance(v, MVUParams):
            return v.to(device)
        return v.to(device) if isinstance(v, torch.Tensor) else v

    return Graph(dataclasses.replace(n, params={k: move(v) for k, v in n.params.items()})
                 for n in ir.as_graph(graph))


def graph_device(graph: Graph) -> torch.device:
    """The device the graph's integer parameters lie on (the first MVU
    node's weights); the CPU for a graph without one."""
    for n in graph:
        if "mvu" in n.params:
            return n.params["mvu"].weights.device
    return torch.device("cpu")


def trace(graph: Graph, x) -> dict[str, torch.Tensor]:
    """Run the graph eagerly and return EVERY node's output, keyed by name.

    ``x`` is one tensor when the graph has a single input node, or a
    ``{input-name: tensor}`` dict for multi-input graphs.
    """
    order = ir.toposort(graph)
    if isinstance(x, dict):
        feeds = dict(x)
    else:
        heads = [n for n in order if n.op == "input"]
        if len(heads) != 1:
            raise ValueError(
                f"graph has {len(heads)} input nodes; pass a "
                "{name: tensor} dict instead of one tensor")
        feeds = {heads[0].name: x}
    env: dict[str, torch.Tensor] = {}
    for node in order:
        params, fn = node_runner(node)
        if node.op == "input":
            if node.name not in feeds:
                raise ValueError(f"no feed for input node {node.name!r}")
            env[node.name] = fn(params, feeds[node.name])
        else:
            env[node.name] = fn(params, *(env[s] for s in node.inputs))
    return env


def execute(graph: Graph, x) -> torch.Tensor:
    """Run the lowered integer graph eagerly (behavioural model).

    x: (B, K) integers for MLPs, on the device the graph's params live on.
    The graph's single sink is the output.
    """
    return trace(graph, x)[ir.graph_output(graph).name]
