"""Fused streaming dataflow engine: the lowered graph as one stage chain.

The paper's central argument (section 5.3) is architectural: FINN
instantiates one MVU per layer, chains them with small AXI FIFOs, and lets
the slowest stage set the initiation interval.  ``dataflow.execute``
reproduces the *semantics* of that graph but runs the unfused graph node by
node, float batchnorm/quant epilogues included.  ``FusedEngine`` is the
runtime analog of the paper's dataflow build:

    paper (section 5.3)                      FusedEngine
    ------------------------------------     ------------------------------------
    MVTU: thresholds fused after the         ``lowering.fuse_epilogues`` folds
    accumulator (Fig. 3)                     batchnorm+quant_act into the MVU
                                             kernel's threshold epilogue
    one compute unit per layer               one kernel launch per MVU stage
    FIFO decoupling (5.3.2): small           microbatch streaming: the batch is
    buffers absorb producer bursts           split into ``StreamPlan.n_micro``
                                             chunks run through the chain
    II = bottleneck stage cycles             ``DataflowSchedule.steady_state_
                                             interval`` sizes the microbatch plan

One microbatch is the bottleneck stage's burst (``MVUConfig.block_m``
samples), so every stage's kernel sees M = one burst per launch, unless
a tuned engine entry (``autotune.tune_engine``) sets the tile.  The
engine is an ``nn.Module``: each stage's tensors are registered buffers,
so ``engine.to(device)`` moves them all.

On a CUDA device the whole microbatch stream is one compiled program,
the counterpart of the JAX engine's ``jax.jit(self._stream)``: the first
``dispatch`` of a key runs the stream eagerly (building and loading the
kernels, as jit's trace does) and captures it as a CUDA graph, and every
later call of that key replays the graph (:class:`_GraphCache`).  A CPU
engine runs the stream eagerly on the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch
from torch import nn

from repro_torch.core import dataflow, ir, lowering
from repro_torch.core.ir import Graph
from repro_torch.core.mvu import MVUParams
from repro_torch.kernels import ops
from repro_torch.kernels._common import pad_to


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Microbatch schedule for one engine invocation (FINN FIFO analog)."""

    n_micro: int  # microbatches streamed through the stage chain
    microbatch: int  # samples per microbatch (batch padded up to n*mb)
    interval_cycles: int  # bottleneck stage cycles (steady-state II)
    fifo_bound: int  # smallest inter-stage FIFO depth (pipeline in-flight cap)


class _StageParams(nn.Module):
    """One stage's tensors as buffers; ``value()`` rebuilds what the stage's
    runner takes (MVUParams, a dict of tensors, or None)."""

    def __init__(self, params):
        super().__init__()
        self.kind = type(params).__name__
        fields = (dataclasses.asdict(params) if isinstance(params, MVUParams)
                  else params or {})
        self.names = tuple(fields)
        for name, t in fields.items():
            self.register_buffer(name, t)

    def value(self):
        if self.kind == "MVUParams":
            return MVUParams(*(getattr(self, n) for n in self.names))
        if self.kind == "dict":
            return {n: getattr(self, n) for n in self.names}
        return None


def _tensors(p) -> list[torch.Tensor]:
    # fields read one by one: dataclasses.asdict would deep-copy the tensors
    vals = ([getattr(p, f.name) for f in dataclasses.fields(p)] if isinstance(p, MVUParams)
            else list((p or {}).values()))
    return [t for t in vals if isinstance(t, torch.Tensor)]


def _params_to(p, device):
    if isinstance(p, MVUParams):
        return p.to(device)
    if isinstance(p, dict):
        return {k: v.to(device) for k, v in p.items()}
    return p


def resolve_device(d) -> torch.device:
    """``d`` as a torch device; ``cuda`` without an index names the
    current card, as a tensor's device does."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class StageParams(tuple):
    """The stage parameters a chain runs with (MVUParams, a dict of tensors,
    or None per stage), with what a dispatch reads of them computed once:
    :attr:`device` and :attr:`addresses` (the graph key's part).  A tuple,
    so the stages cannot be swapped under the cached values."""

    @functools.cached_property
    def addresses(self) -> tuple[int, ...]:
        """The address of every tensor, in stage order."""
        return tuple(t.data_ptr() for p in self for t in _tensors(p))

    @functools.cached_property
    def device(self) -> torch.device | None:
        """The one device the tensors live on (None when there is no
        tensor); tensors on several devices raise."""
        devices = {t.device for p in self for t in _tensors(p)}
        if len(devices) > 1:
            raise ValueError(
                f"stage parameters lie on several devices {sorted(map(str, devices))}; "
                "a replica's parameters must all be on one device")
        return devices.pop() if devices else None


def _current_stream_id(device: torch.device) -> int:
    # torch.cuda.current_stream(device).stream_id, without building the
    # Stream object (a replay's host cost)
    return torch._C._cuda_getCurrentStream(device.index)[0]


def capture_cuda_graph(fn, x: torch.Tensor, pool, stream: torch.cuda.Stream):
    """``fn(x)`` captured on ``stream`` as a CUDA graph in the memory pool
    ``pool``; returns ``(replay, out)``: ``replay()`` reruns the captured
    work on the current stream, rewriting the static output ``out``.
    Captures that share a pool reuse each other's freed blocks only when
    they also share the capture stream (the caching allocator keeps a
    freed block for its stream)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        out = fn(x)
    return graph.replay, out


@dataclasses.dataclass(frozen=True)
class _Home:
    """What the graphs of one CUDA device share."""

    pool: tuple  # their memory pool (torch.cuda.graph_pool_handle())
    capture: torch.cuda.Stream  # the stream every capture runs on
    replay: int  # the stream id every replay goes to


@dataclasses.dataclass
class _Graph:
    replay: Callable[[], object]
    x: torch.Tensor  # the static input every replay reads
    out: torch.Tensor  # the static output every replay rewrites
    launches: dict[str, int]  # kernel name -> its launches in one replay
    stream: int | None  # the stream id every replay goes to; None off CUDA
    params: StageParams  # the captured parameters, kept alive: the graph reads their addresses


class _GraphCache:
    """One engine's compiled executables: a captured stream per key.

    The key (:meth:`key`) is what a replay bakes in: the device, the
    input's shape and dtype, ``n_micro`` and the address of every
    parameter tensor, so a replica's ``params_on`` copy or a retuned
    microbatch gets a graph of its own.  What each stage launches (its
    kernel and tile) is not in the key: an engine fixes its stages in
    ``__init__`` and owns its cache, so a retuned or refolded build, even
    on the same parameter tensors, is a new engine with a new cache.
    :meth:`run` on a new key runs the stream eagerly, which is that call's
    result (it builds and loads the kernel libraries and modules and
    caches the launch plans, so none of that happens while the stream
    captures), then captures it with
    ``capture(fn, static_x, pool, stream) -> (replay, static_out)``.  A
    later call copies its input into the static input, replays, and
    returns a clone of the static output: batches in flight never share
    an output.  A failed capture or replay raises; nothing reruns it
    eagerly.

    The graphs of one device share one memory pool and one capture
    stream, so a capture reuses the blocks earlier captures freed: the
    pool holds the largest graph's intermediates, not their sum, and a
    key adds its static input and output.  They all replay on one stream,
    the caller's current stream at the device's first capture, so no two
    replays overlap and each replay's output is cloned before the next
    starts; a replay from another stream raises.  A replay makes no
    wrapper call, so the launch counters the capture added are taken back
    and every replay adds them again.
    """

    def __init__(self, capture=None):
        self._capture = capture if capture is not None else capture_cuda_graph
        self._graphs: dict = {}
        self._homes: dict[torch.device, _Home] = {}

    def __len__(self) -> int:
        return len(self._graphs)

    @staticmethod
    def applies(device: torch.device) -> bool:
        """Whether a stream on ``device`` is captured: on CUDA only."""
        return device.type == "cuda"

    @staticmethod
    def key(params: StageParams, x: torch.Tensor, n_micro: int) -> tuple:
        """What a replay of the stream over ``params`` on ``x`` bakes in."""
        return (x.device, tuple(x.shape), x.dtype, n_micro, params.addresses)

    def run(self, fn, params: StageParams, x: torch.Tensor, n_micro: int) -> torch.Tensor:
        """``fn(x)``, the stream over ``params`` in ``n_micro`` microbatches,
        through the graph of its key (captured on the key's first call)."""
        key = self.key(params, x, n_micro)
        g = self._graphs.get(key)
        if g is None:
            out = fn(x)
            self._graphs[key] = self._record(fn, params, x)
            return out
        if g.stream is not None and _current_stream_id(x.device) != g.stream:
            raise RuntimeError(
                f"the engine's graphs on {x.device} replay on stream {g.stream}, the caller's "
                f"stream at their first capture; this call is on stream "
                f"{_current_stream_id(x.device)}")
        g.x.copy_(x)
        g.replay()
        ops.add_launch_counts(g.launches)
        return g.out.clone()

    def _record(self, fn, params: StageParams, x: torch.Tensor) -> _Graph:
        home = None
        if x.device.type == "cuda":
            if x.device not in self._homes:
                self._homes[x.device] = _Home(torch.cuda.graph_pool_handle(),
                                              torch.cuda.Stream(x.device),
                                              _current_stream_id(x.device))
            home = self._homes[x.device]
        static_x = x.clone()
        before = ops.launch_counts()
        if home is None:
            replay, out = self._capture(fn, static_x, None, None)
        else:
            with torch.cuda.device(x.device):
                replay, out = self._capture(fn, static_x, home.pool, home.capture)
        launches = {k: n - before[k] for k, n in ops.launch_counts().items()
                    if n != before[k]}
        ops.add_launch_counts({k: -n for k, n in launches.items()})
        return _Graph(replay, static_x, out, launches,
                      None if home is None else home.replay, params)


class FusedEngine(nn.Module):
    """A lowered :class:`~repro_torch.core.ir.Graph` as a microbatch-streaming
    stage chain, bit-exact with ``dataflow.execute`` on the unfused graph
    (both apply nodes through ``dataflow.node_runner``).

    ``tune="cache"`` pins the schedules of ``cache`` (default
    ``autotune.default_cache()``) onto the fused graph's nodes and takes
    the engine's microbatch tile from its ``engine_key`` entry;
    ``tune="auto"`` first measures the node entries it misses
    (``autotune.tune_graph``, ``tune_kwargs`` forwarded, ``"device"`` the
    cache scope)."""

    TUNE_MODES = ("off", "cache", "auto")

    def __init__(self, graph: Graph, *, fuse: bool = True,
                 microbatches: int | None = None, tune: str = "off",
                 cache=None, tune_kwargs: dict | None = None):
        super().__init__()
        if tune not in self.TUNE_MODES:
            raise ValueError(f"tune must be one of {self.TUNE_MODES}, got {tune!r}")
        g = lowering.fuse_epilogues(graph) if fuse else ir.as_graph(graph)
        self.graph = lowering.fuse_swu(g) if fuse else g
        self._tile: int | None = None
        if tune != "off":
            # tune="cache" only looks up (no timer runs); tune="auto"
            # measures misses on the graph's device and records them
            from repro_torch.core import autotune

            cache = cache if cache is not None else autotune.default_cache()
            self.graph = autotune.tune_graph(self.graph, cache=cache, mode=tune,
                                             **(tune_kwargs or {}))
            # the engine entry, keyed on the fused graph, lives in the node
            # entries' scope: a scope override applies to both lookups
            ent = cache.get(autotune.engine_key(
                self.graph, device=(tune_kwargs or {}).get("device")))
            if ent is not None:
                self._tile = max(1, int(ent["microbatch"]))
        self.schedule = dataflow.schedule(self.graph)
        # stage order is the dataflow (topological) order
        order = ir.toposort(self.graph)
        runners = [dataflow.node_runner(n) for n in order]
        self._fns = tuple(fn for _, fn in runners)
        self.stage_params = nn.ModuleList(_StageParams(p) for p, _ in runners)
        self._names = tuple(n.name for n in order)
        self._in_names = tuple(n.inputs for n in order)
        self._out_name = ir.graph_output(self.graph).name
        self._microbatches = microbatches
        self._graphs = _GraphCache()
        self._own: StageParams | None = None  # self.params, built on first use

    def _apply(self, fn, *args, **kwargs):
        self._own = None  # the buffers move (.to(), .cuda(), ...): rebuild the params
        return super()._apply(fn, *args, **kwargs)

    @property
    def device(self) -> torch.device:
        for b in self.buffers():
            return b.device
        return torch.device("cpu")

    # ------------------------------------------------------------- schedule
    def plan(self, batch: int) -> StreamPlan:
        """Derive the microbatch schedule from the dataflow schedule.

        The microbatch is the bottleneck MVU's burst (its ``block_m``
        samples; ``block_m // n_pixels`` whole images for a conv stage), so
        each streamed microbatch is one producer burst.  ``n_micro`` is the
        number of bursts the batch decomposes into; ``fifo_bound`` (smallest
        FIFO depth) caps in-flight microbatches on a multi-device pipeline.
        """
        s = self.schedule
        if not s.stages or batch <= 1:
            interval = s.steady_state_interval if s.stages else 0
            return StreamPlan(1, max(batch, 1), interval, 0)
        fifo_bound = max(2, min(st.fifo_depth for st in s.stages))
        # an engine-level autotune entry (autotune.tune_engine) overrides
        # the heuristic tile; microbatches= overrides both
        tile = self._tile or s.burst_samples
        n_micro = max(1, min(math.ceil(batch / tile), batch))
        if self._microbatches is not None:
            n_micro = max(1, min(self._microbatches, batch))
        return StreamPlan(
            n_micro, -(-batch // n_micro), s.steady_state_interval, fifo_bound
        )

    # -------------------------------------------------------------- forward
    def _chain(self, params, x):
        env: dict = {}
        for name, ins, p, fn in zip(self._names, self._in_names,
                                    params, self._fns):
            args = (x,) if not ins else tuple(env[s] for s in ins)
            env[name] = fn(p, *args)
        return env[self._out_name]

    def _stream(self, params, x, n_micro: int):
        if n_micro <= 1:
            return self._chain(params, x)
        b = x.shape[0]
        mb = -(-b // n_micro)
        # zero samples pad the batch to n_micro whole microbatches; every
        # op is per-sample, so the pad rows never reach the real outputs
        xs = pad_to(x, 0, n_micro * mb)
        ys = [self._chain(params, xs[i * mb:(i + 1) * mb]) for i in range(n_micro)]
        return torch.cat(ys)[:b]

    def _run(self, params, x, n_micro: int):
        if not self._graphs.applies(x.device):
            return self._stream(params, x, n_micro)
        return self._graphs.run(lambda xs: self._stream(params, xs, n_micro),
                                params, x, n_micro)

    @property
    def captured_graphs(self) -> int:
        """How many CUDA graphs this engine has captured (one a key)."""
        return len(self._graphs)

    @property
    def params(self) -> StageParams:
        """The stage parameters the chain runs with (MVUParams, a dict of
        tensors, or None per stage), resident on the engine's device: one
        shared :class:`StageParams`, built once (again after ``.to()``)."""
        if self._own is None:
            self._own = StageParams(sp.value() for sp in self.stage_params)
        return self._own

    def params_on(self, device) -> StageParams:
        """The stage parameters on ``device``: the engine's own on its own
        device, else a ``.to(device)`` copy of each stage's tensors (a
        serving replica's resident copy)."""
        device = resolve_device(device)
        if device == self.device:
            return self.params
        return StageParams(_params_to(p, device) for p in self.params)

    def dispatch(self, x, *, params=None, tracer=None) -> tuple[torch.Tensor, StreamPlan]:
        """Non-blocking submit: enqueue one batch, return the output tensor
        (not yet synchronised) and the stream plan it runs under.

        ``params`` overrides the engine's resident parameters with a
        replica's copy (``repro_torch.serving.pool`` places them per device,
        see :meth:`params_on`; a :class:`StageParams` is read once, any
        other sequence on every call); ``x`` is moved to the device the
        parameters live on, and parameters spread over several devices
        raise.

        On a CUDA device the first call of a key (device, ``x``'s shape and
        dtype, ``n_micro``, the parameters' addresses) runs the stream
        eagerly and captures it; later calls replay the captured graph
        (:class:`_GraphCache`).  A CPU engine runs the stream eagerly.

        ``tracer`` (a :class:`repro_torch.telemetry.Tracer`) records the
        host-side enqueue as an ``engine.dispatch`` span -- on the card its
        duration is submit cost, not compute (the call does not
        synchronise); per-node spans come from :meth:`profile`.
        """
        if params is None:
            params = self.params
        elif not isinstance(params, StageParams):
            params = StageParams(params)
        x = torch.as_tensor(x, device=params.device or self.device).contiguous()
        plan = self.plan(int(x.shape[0]))
        if tracer is None:
            return self._run(params, x, plan.n_micro), plan
        with tracer.span("engine.dispatch", cat="engine",
                         batch=int(x.shape[0]), n_micro=plan.n_micro,
                         microbatch=plan.microbatch,
                         interval_cycles=plan.interval_cycles):
            out = self._run(params, x, plan.n_micro)
        return out, plan

    def forward(self, x) -> torch.Tensor:
        return self.dispatch(x)[0]

    def profile(self, x, tracer, *, drift=None) -> tuple[torch.Tensor, StreamPlan]:
        """Instrumented run: per-node, per-microbatch duration spans.

        Re-runs the SAME node runners (``dataflow.node_runner``) as
        :meth:`dispatch`, microbatch by microbatch and eagerly (never a
        captured graph), and on a CUDA engine
        synchronises the card after each node, so a node's span covers its
        host dispatch and its device work.  Every op is per-sample, so the
        output is bit-exact with :meth:`dispatch`; only the timing differs
        (each node pays a synchronisation, so the spans do not add up to
        an ``acc(x)`` time).  Span tree::

            engine.profile
              micro0
                <node name>   one span per graph node, cat="node"
              micro1
                ...

        ``drift`` (a :class:`repro_torch.telemetry.DriftMonitor`) receives
        each node span duration keyed by node name -- with predictions
        from ``DriftMonitor.from_schedule(engine.schedule, s_per_cycle)``
        this compares measured per-node intervals against the cycle model
        online.
        """
        x = torch.as_tensor(x, device=self.device).contiguous()
        b = int(x.shape[0])
        plan = self.plan(b)
        mb = plan.microbatch
        xs = pad_to(x, 0, plan.n_micro * mb)
        params = self.params
        dev = self.device
        sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
                else (lambda: None))
        outs = []
        with tracer.span("engine.profile", cat="engine", batch=b,
                         n_micro=plan.n_micro, microbatch=mb):
            for m in range(plan.n_micro):
                with tracer.span(f"micro{m}", cat="engine"):
                    env: dict = {}
                    for name, ins, p, fn in zip(self._names, self._in_names,
                                                params, self._fns):
                        with tracer.span(name, cat="node", micro=m) as sp:
                            args = ((xs[m * mb:(m + 1) * mb],) if not ins
                                    else tuple(env[s] for s in ins))
                            env[name] = fn(p, *args)
                            sync()
                        if drift is not None:
                            drift.observe(name, sp.dur)
                    outs.append(env[self._out_name])
        return torch.cat(outs)[:b], plan

    # ---------------------------------------------------------- multi-stage
    def as_pipeline(self, devices, *, tracer=None):
        """Map the chain onto GPipe stages, one contiguous layer range per
        entry of ``devices`` (a device may repeat: on one card each stage
        is a CUDA stream of it), reusing
        :func:`repro_torch.distributed.pipeline.run_stages` (events
        between stage streams as the AXI links).

        Stacking per-stage params requires a homogeneous chain: every node an
        MVU of the same (N, K) and mode (not xnor — its static packed width
        breaks stacking) with a uniform epilogue and canonical (unpacked)
        weights.  Heterogeneous graphs run on one stream via ``__call__``.
        Every stage launches the tile of the first node's schedule.  Returns
        ``run(xs)`` taking microbatched input ``(n_micro, mb, K)``; a CUDA
        stage launches the hand kernel or raises.  The run is eager: no
        CUDA graph captures it.  ``run(xs, stage_streams=False)`` runs the
        same ticks on the caller's stream with no events: the yardstick for
        what the stage streams cost.

        With ``tracer``, each ``run`` records a ``pipeline.run`` span (every
        stage device synchronised before it closes) plus reconstructed
        per-stage occupancy lanes: the measured wall interval is overlaid
        with the static GPipe schedule -- busy ``microN`` spans and
        ``bubble`` fill/drain spans per stage, with the occupancy fraction
        in the span args (see
        :func:`repro_torch.distributed.pipeline.emit_schedule_spans`).
        """
        from repro_torch.distributed.pipeline import (
            emit_schedule_spans,
            place_stages,
            run_stages,
            stage_params_split,
        )

        non_input = [n for n in self.graph if n.op != "input"]
        if any(n.op != "mvu" for n in non_input):
            raise ValueError(
                "as_pipeline needs a pure MVU chain; fuse_epilogues removes "
                f"bn/quant nodes, got ops {[n.op for n in non_input]}"
            )
        cfgs = [n.attrs["config"] for n in non_input]
        shapes = {(c.mode, c.out_features, c.in_features) for c in cfgs}
        if len(shapes) != 1 or cfgs[0].mode == "xnor":
            raise ValueError(f"stages must be homogeneous non-xnor MVUs, got {shapes}")
        own = dict(zip(self._names, self.params))  # the engine's resident tensors
        mvus = [own[n.name] for n in non_input]
        thr = [p.thresholds for p in mvus]
        scl = [p.out_scale for p in mvus]
        for part in (thr, scl):
            if any(p is None for p in part) and not all(p is None for p in part):
                raise ValueError("stages must share one epilogue form")
        if any(c.packed for c in cfgs):
            # the JAX package's as_pipeline hands the packed storage to the
            # canonical kernel, whose shape check fails
            raise ValueError(
                "as_pipeline runs canonical weights; this chain was built with packed "
                "weight storage (pack='always' or a tuned packed schedule): build it "
                "with pack='never'")
        stacked = {"w": torch.stack([p.weights for p in mvus])}
        if thr[0] is not None:
            stacked["t"] = torch.stack(thr)
        if scl[0] is not None:
            stacked["s"] = torch.stack(scl)
        layer_fn = ops.mvu_layer_fn(
            cfgs[0].mode, backend=cfgs[0].backend, **cfgs[0].kernel_blocks()
        )
        devices = [resolve_device(d) for d in devices]
        n_stages = len(devices)
        # each stage's layers placed on its device once, not on every run
        stages = place_stages(stage_params_split(stacked, n_stages), devices)
        cards = sorted({d for d in devices if d.type == "cuda"}, key=str)

        def run(xs, *, stage_streams: bool = True) -> torch.Tensor:
            xs = torch.as_tensor(xs)
            if tracer is None:
                return run_stages(layer_fn, stages, xs, devices, stage_streams=stage_streams)
            n_micro = int(xs.shape[0])
            with tracer.span("pipeline.run", cat="pipeline",
                             n_stages=n_stages, n_micro=n_micro) as sp:
                out = run_stages(layer_fn, stages, xs, devices, stage_streams=stage_streams)
                for d in cards:
                    torch.cuda.synchronize(d)
            occ = emit_schedule_spans(tracer, n_stages, n_micro, sp.t0, sp.t1)
            sp.args.update(occupancy=occ["occupancy"],
                           bubble_ticks=occ["bubble_ticks_per_stage"])
            return out

        return run
