"""The empirical autotuner of the JAX package's ``repro.core.autotune``,
on the H100: cache keys, the persistent schedule cache, and the tuning
search over what the hand-written kernels can tell apart.

The search, as in the JAX package:

  1. enumerate candidate schedules per MVU / conv-MVU node
     (:func:`enumerate_candidates`: the JAX package's tile candidates,
     each mapped onto the compiled tile it launches, one candidate a
     launched tile, in both storage forms of a packable dense node),
  2. prune them on the launch plan's dynamic shared memory against the
     card's ``_cuda.SMEM_BYTES`` (the JAX package's VMEM budget), order
     them by the cycle model and cap them at ``max_measure``, then add the
     node's own (folding) tile and the default 32 tile,
  3. measure them with the paired interleaved timer (:func:`paired_times`,
     on the card's clock), at the samples each of the engine's launches
     gets, against the default 32 tile on the node's own storage (what
     the node launched before the folding set its tile), keeping only
     bit-exact winners that beat it by ``margin``,
  4. record winners in a :class:`ScheduleCache` keyed by ``(device kind,
     op / conv geometry, mode, N, K, epilogue form, n_pixels)``, with a
     ``|packed`` suffix for packed storage.

:func:`tune_graph` pins every node's entry (``tune="cache"`` only looks
up, ``tune="auto"`` measures misses at the engine's heuristic microbatch);
:func:`tune_engine` then races the engine's microbatch tile on the host's
clock, records it under :func:`engine_key`, and races every node again at
the samples a launch gets under that tile.

How the JAX package's search space maps onto the card:

    JAX axis                 on the H100
    -----------------------  ---------------------------------------------
    backend="pallas"         backend="cuda": the hand-written kernels
    backend="xla"            not a candidate: the port's backend="torch" is
                             the plain reference, and an entry naming it
                             raises on a node off the CPU (:func:`apply_entry`)
    block_n / block_k /      raced: each candidate rounded up onto the
    block_kw / rows_per_tile kernels' compiled tiles (:func:`launched_tile`;
                             ``dense_mvu.DENSE_TILES``,
                             ``swu_mvu.CONV_TILES``); candidates that launch
                             one tile are one candidate, so nothing is timed
                             against itself.  The entry records the launched
                             tile; a dense candidate pins its output rows
                             a block in ``rows_per_tile``
    block_m                  a node candidate carries the node's own: the
                             microbatch is :func:`tune_engine`'s axis, and
                             a node is raced at the samples (dense rows,
                             conv images) a launch gets under it
    packed                   raced on the card's clock: ``mvu_int`` vs
                             ``mvu_int2_packed``, ``mvu_binary`` vs
                             ``mvu_binary_packed``; xnor is natively packed
    VMEM pruning             the candidate's launch plan's ``smem_bytes``

A candidate runs on the device its node's parameters lie on: on a CUDA
tensor the kernels launch (or raise), on a CPU tensor their plain
versions run.  A cache scope (``device=``) is a device-kind string as it
is (``"cpu"``, ``"nvidia-h100-80gb-hbm3"``), a torch device's kind, or,
where a graph is at hand and None is given, the kind of the device its
parameters lie on -- so a CPU build keys ``cpu|...`` and its entries never
apply on the card.  :func:`default_cache` merges only the user's cache
file, none of the JAX package's committed ``TUNED_SCHEDULES``: they were
measured on another device.  :func:`synth_input` gives seeded activations
for a graph's input (the serving warm-up and canary use it too).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.core.folding import Folding, block_candidates, divisors
from repro_torch.core.ir import Graph, Node
from repro_torch.core.lowering import pack_weights, packable
from repro_torch.core.mvu import KernelBlocks, MVUConfig, MVUParams
from repro_torch.core.swu import out_dim
from repro_torch.kernels import ops, packing
from repro_torch.kernels.ops import BACKEND_NAMES
from repro_torch.kernels._cuda import BLOCK_K, BLOCK_N, SMEM_BYTES
from repro_torch.kernels.dense_mvu import CODING, dense_launch_plan
from repro_torch.kernels.mvu_packed import pack_mvu_weights, unpack_mvu_weights
from repro_torch.kernels.swu_mvu import conv_launch_plan, conv_rows_per_tile

CACHE_VERSION = 1
DEFAULT_CACHE_PATH = os.path.join("experiments", "autotune", "cache.json")
CACHE_PATH_ENV = "REPRO_AUTOTUNE_CACHE"


# --------------------------------------------------------------------- keys
def device_kind(device=None) -> str:
    """Stable cache device key of a torch device: ``cpu``, or the card's
    name normalised as the JAX package does (``NVIDIA H100 80GB HBM3`` ->
    ``nvidia-h100-80gb-hbm3``).  ``None`` means the CUDA device, and
    raises where CUDA is absent (pass ``torch.device("cpu")`` there)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available and no device was given: pass "
                "device=torch.device('cpu') to key the CPU")
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type == "cpu":
        kind = "cpu"
    elif device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
    else:
        raise ValueError(f"no device kind for a {device.type!r} device")
    return str(kind).strip().lower().replace(" ", "-")


def _scope(device) -> str:
    """A cache scope: a device-kind string as it is ("" included: the
    device-less scope of :func:`engine_key`'s digest parts), else the kind
    of a torch device (None: the CUDA device, see :func:`device_kind`)."""
    return device if isinstance(device, str) else device_kind(device)


def _graph_scope(graph: Graph, device) -> str:
    """The scope of a graph's entries: ``device`` as :func:`_scope` reads
    it, or, for None, the kind of the device the graph's parameters lie on
    (a CPU graph keys ``cpu|...``, never the card's)."""
    if device is None:
        from repro_torch.core.dataflow import graph_device

        device = graph_device(graph)
    return _scope(device)


def epilogue_form(params) -> str:
    """``thresh`` / ``scale`` / ``raw`` -- the MVTU epilogue variant."""
    if params is None:
        return "raw"
    if getattr(params, "thresholds", None) is not None:
        return "thresh"
    if getattr(params, "out_scale", None) is not None:
        return "scale"
    return "raw"


def op_tag(node: Node, in_shape: tuple | None = None) -> str:
    """Distinguish op kind and conv geometry in cache keys: dense nodes are
    all ``mvu``; conv nodes with the same (mode, N, K, n_pixels) can still
    differ in kernel / stride / pad and the input image."""
    if node.op != "conv_mvu":
        return "mvu"
    kd, st, pd = node.attrs["kernel"], node.attrs["stride"], node.attrs["pad"]
    hwc = "x".join(str(d) for d in (in_shape or ()))
    return f"conv{kd}s{st}p{pd}@{hwc}"


def node_key(cfg: MVUConfig, *, epilogue: str = "raw", n_pixels: int = 1,
             device=None, op: str = "mvu") -> str:
    """One node's cache key, the JAX package's string.  ``device`` is a
    scope (see :func:`_scope`); packed storage gets its own key space (the
    ``|packed`` suffix), so a packed schedule never aliases the canonical
    one."""
    key = "|".join([
        _scope(device), op, cfg.mode, f"n{cfg.out_features}", f"k{cfg.in_features}",
        epilogue, f"px{n_pixels}",
    ])
    return key + "|packed" if cfg.packed else key


def _tunable(node: Node) -> bool:
    return node.op in ("mvu", "conv_mvu") and "mvu" in node.params


def _key_of(node: Node, ins, out_shape, device: str) -> str:
    return node_key(node.attrs["config"], epilogue=epilogue_form(node.params["mvu"]),
                    n_pixels=ir.n_pixels(out_shape), device=device,
                    op=op_tag(node, ins[0] if ins else None))


def graph_node_keys(graph: Graph, *, device=None) -> list[str]:
    """The cache keys :func:`tune_graph` looks up, one per finalized
    ``mvu`` / ``conv_mvu`` node, in dataflow order (the build's cache-hit
    accounting reads them)."""
    scope = _graph_scope(graph, device)
    return [_key_of(node, ins, out_shape, scope)
            for node, ins, out_shape in ir.io_shapes(graph) if _tunable(node)]


def cycle_time_key(device=None) -> str:
    """Cache key for the measured wall-clock seconds per schedule cycle.

    ``device`` is a device kind string (used as it is, as in the JAX
    package), a torch device (keyed by its :func:`device_kind`), or None
    (the CUDA device).  Recorded by
    ``repro_torch.serving.batcher.calibrate_cycle_time``; consumed by
    ``dataflow.interval_seconds`` to turn the steady-state interval into
    the serving batcher's flush time budget.
    """
    return f"cycletime|{_scope(device)}"


def engine_key(graph: Graph, *, device=None) -> str:
    """Cache key for the engine-level (microbatch) entry of one graph.

    The digest is made of device-less node keys, so the same graph gets
    the JAX package's digest on every host; only the ``engine|<scope>|``
    prefix scopes the entry.  Take it on the engine's graph
    (``FusedEngine.graph``, after the fusions), as the JAX package does.
    """
    parts = [_key_of(node, ins, out_shape, "")
             for node, ins, out_shape in ir.io_shapes(graph) if _tunable(node)]
    digest = hashlib.sha1("~".join(parts).encode()).hexdigest()[:12]
    return f"engine|{_graph_scope(graph, device)}|{digest}"


# -------------------------------------------------------------------- cache
class ScheduleCache:
    """Persistent key -> entry store (JSON on disk).

    Entries are plain dicts so the cache file diffs cleanly; ``merge``
    lets several caches coexist, later entries winning.
    """

    def __init__(self, entries: dict | None = None, path: str | None = None):
        self.entries: dict[str, dict] = {k: dict(v) for k, v in (entries or {}).items()}
        self.path = path

    def get(self, key: str) -> dict | None:
        return self.entries.get(key)

    def put(self, key: str, entry: dict) -> None:
        self.entries[key] = dict(entry)

    def merge(self, other: "ScheduleCache") -> "ScheduleCache":
        self.entries.update({k: dict(v) for k, v in other.entries.items()})
        return self

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    @classmethod
    def load(cls, path: str) -> "ScheduleCache":
        with open(path) as f:
            payload = json.load(f)
        if payload.get("version") != CACHE_VERSION:
            raise ValueError(
                f"autotune cache {path} has version {payload.get('version')!r}, "
                f"expected {CACHE_VERSION}")
        return cls(payload.get("entries", {}), path=path)

    def save(self, path: str | None = None) -> str:
        path = path or self.path
        if path is None:
            raise ValueError("no cache path to save to")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"version": CACHE_VERSION, "entries": self.entries},
                      f, indent=2, sort_keys=True)
            f.write("\n")
        self.path = path
        return path


def default_cache() -> ScheduleCache:
    """The user's persistent cache -- ``$REPRO_AUTOTUNE_CACHE`` or
    ``experiments/autotune/cache.json`` -- when the file exists, else an
    empty cache.  No committed schedules are merged (see the module doc)."""
    cache = ScheduleCache()
    path = os.environ.get(CACHE_PATH_ENV, DEFAULT_CACHE_PATH)
    if os.path.exists(path):
        cache.merge(ScheduleCache.load(path))
        cache.path = path
    return cache


# --------------------------------------------------------------- candidates
@dataclasses.dataclass(frozen=True)
class Candidate:
    backend: str
    blocks: KernelBlocks
    predicted_cycles: int
    smem_bytes: int  # the launch plan's dynamic shared memory a block
    packed: bool = False  # bit-packed weight storage + packed kernel

    def entry(self, **extra) -> dict:
        out = {
            "backend": self.backend,
            **dataclasses.asdict(self.blocks),
            "predicted_cycles": int(self.predicted_cycles),
            **extra,
        }
        if self.packed:  # unpacked entries stay byte-identical to the JAX package's
            out["packed"] = True
        return out


def _heuristic_blocks(cfg: MVUConfig) -> KernelBlocks:
    """The node's own schedule, its burst (``cfg.block_m``) pinned."""
    return KernelBlocks.from_blocks({**cfg.kernel_blocks(), "block_m": cfg.block_m})


def _default_blocks(cfg: MVUConfig) -> KernelBlocks:
    """The default 32 tile at the node's burst: what every layer launched
    before the folding set the tile."""
    return KernelBlocks(block_m=cfg.block_m, block_n=BLOCK_N, block_k=BLOCK_K, block_kw=BLOCK_K)


def natively_packed(cfg: MVUConfig, backend: str) -> bool:
    """Whether this (coding, backend) kernel already IS the packed datapath:
    the xnor kernel takes packed words for both operands (paper Fig. 4a)."""
    return cfg.mode == "xnor" and backend == "cuda"


def launched_tile(cfg: MVUConfig, blocks: KernelBlocks, packed: bool, *, m: int | None = None,
                  conv: dict | None = None, in_shape: tuple | None = None):
    """``(tile, smem_bytes)``: what a candidate launches on ``m`` samples
    (dense rows, conv images; None: the node's burst, ``cfg.block_m``
    rows or one image) -- the launch plan's arrangement and compiled tile,
    and its dynamic shared memory.  A dense launch of at most 8 rows runs
    the gemv arrangement, which has no tile."""
    kw = blocks.as_kwargs(cfg.mode, packed)
    n, k = cfg.out_features, cfg.in_features
    if conv is not None:
        h, w, c = in_shape
        plan = conv_launch_plan(m or 1, h, w, c, n, conv["kernel"], conv["stride"], conv["pad"],
                                block_n=kw["block_n"], rows_per_tile=kw.get("rows_per_tile"))
        return (plan.arrangement, plan.tile_m, plan.tile_n), plan.smem_bytes
    kernel = ops.kernel_name(cfg.mode, packed)
    units = packing.num_words(k) if CODING[kernel] == "words" else k
    tile = ops.tile_kwargs(kernel, **kw)
    plan = dense_launch_plan(m or cfg.block_m, n, units, CODING[kernel], block_n=tile["block_n"],
                             block_k=tile.get("block_k", tile.get("block_kw")),
                             rows_per_tile=tile["rows_per_tile"])
    return (plan.arrangement, plan.tile_m, plan.tile_n, plan.kstep), plan.smem_bytes


def _tile_candidates(cfg: MVUConfig, conv: dict | None, in_shape: tuple | None,
                     packed: bool) -> list[KernelBlocks]:
    """The JAX package's tile candidates for a node, at its own burst: for
    a dense node ``folding.block_candidates`` over the output rows a block
    (``rows_per_tile``); for a conv node ``block_n`` over the divisors of N
    and the pixel tile of ``block_m`` in (32, 128, 256), as the JAX search
    makes them, and the untuned 32-pixel tile."""
    n, k = cfg.out_features, cfg.in_features
    if conv is not None:
        h, w, _ = in_shape
        oh = out_dim(h, conv["kernel"], conv["stride"], conv["pad"])
        ow = out_dim(w, conv["kernel"], conv["stride"], conv["pad"])
        rows = [None, *(conv_rows_per_tile(oh, ow, bm) for bm in (32, 128, 256))]
        return [KernelBlocks(block_m=cfg.block_m, block_n=bn, rows_per_tile=r) for r in rows
                for bn in sorted({max(8, d) for d in divisors(n)} | {128}) if bn <= 512]
    return [KernelBlocks.from_blocks({**blk, "block_m": cfg.block_m, "rows_per_tile": rows})
            for blk in block_candidates(n, k, cfg.mode, block_ms=(cfg.block_m,), packed=packed)
            for rows in (32, 64)]


def enumerate_candidates(
    cfg: MVUConfig,
    *,
    m: int | None = None,
    n_pixels: int = 1,
    in_shape: tuple | None = None,
    conv: dict | None = None,
    smem_bytes: int = SMEM_BYTES,
    max_measure: int = 8,
) -> list[Candidate]:
    """One node's candidates on the card, every one ``backend="cuda"`` at
    the node's own ``block_m``, one for each compiled tile it launches on
    ``m`` samples (:func:`launched_tile`).

    The JAX package's tile candidates (:func:`_tile_candidates`), in both
    storage forms of a packable dense node that is not xnor (natively
    packed), are mapped onto their launched tiles and pinned there (the
    entry records the launched tile); those whose launch plan needs more
    than ``smem_bytes`` of shared memory are dropped, the rest ordered by
    the cycle model on the launched tile (output columns a block as PE, K
    step as SIMD, as the JAX search orders by its blocks' folding; ties by
    shared memory) and capped at ``max_measure``.  Then the default 32
    tile (:func:`tune_node`'s incumbent), the packed datapath at the
    node's own tile (a packable node; pruned on ``smem_bytes`` too) and,
    last, the node's own schedule (its folding's tile) take the place of
    any candidate that launches their tile: the default and the folding's
    are never pruned, so a tuned plan can only match or beat them.
    """
    launch = functools.partial(launched_tile, cfg, m=m, conv=conv, in_shape=in_shape)
    n, k = cfg.out_features, cfg.in_features
    storage = cfg.packed or natively_packed(cfg, "cuda")  # the node's own datapath

    def tile_of(c: Candidate) -> tuple:
        return c.packed, launch(c.blocks, c.packed)[0]

    twin = conv is None and packable(cfg) and cfg.mode != "xnor"  # a packed datapath to race
    forms = [False, True] if twin else [False]
    found: dict[tuple, Candidate] = {}
    for pk in forms:
        for blocks in _tile_candidates(cfg, conv, in_shape, pk):
            tile, smem = launch(blocks, pk)
            tn, step = tile[2], (32 if conv is not None else tile[3])  # conv: 32 taps a step
            pinned = KernelBlocks(block_m=cfg.block_m, block_n=tn, block_k=step, block_kw=step,
                                  rows_per_tile=blocks.rows_per_tile if conv is not None
                                  else tile[1])
            cand = Candidate("cuda", pinned, Folding(tn, step).cycles(n, k, n_pixels), smem,
                             packed=pk or natively_packed(cfg, "cuda"))
            if smem <= smem_bytes:
                found.setdefault(tile_of(cand), cand)
    shortlist = sorted(found.values(), key=lambda c: (c.predicted_cycles, c.smem_bytes))
    shortlist = shortlist[:max_measure]
    own = _heuristic_blocks(cfg)
    fixed = [(_default_blocks(cfg), storage, Folding(BLOCK_N, BLOCK_K).cycles(n, k, n_pixels))]
    if twin and not storage:  # the packed datapath at the node's own tile
        fixed.append((own, True, cfg.resolved_folding().cycles(n, k, n_pixels)))
    fixed.append((own, storage, cfg.resolved_folding().cycles(n, k, n_pixels)))
    for blocks, pk, cycles in fixed:
        smem = launch(blocks, pk)[1]
        cand = Candidate("cuda", blocks, cycles, smem, packed=pk)
        if pk != storage and smem > smem_bytes:
            continue
        shortlist = [c for c in shortlist if tile_of(c) != tile_of(cand)] + [cand]
    return shortlist


# -------------------------------------------------------------------- timer
def _wait(out):
    """Block until ``out`` is computed: a CUDA tensor synchronises its card."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out


# cycles of the spin kernel that holds the card while the host enqueues a
# device-clocked side (~2 ms at the H100's clocks); doubled while it falls
# short of the host's enqueue
SPIN_CYCLES = 1 << 22


def _device_seconds(fn, args, device: torch.device) -> float:
    """One call of ``fn`` timed on the card alone: CUDA events around its
    launches, recorded behind a spin kernel that keeps the card busy while
    the host enqueues them, so the host's launch overhead and its noise
    stay out of the time.  Where the host's enqueue outlasts the spin (the
    card then waited on the host inside the events), the spin doubles and
    the call is timed again."""
    spin = SPIN_CYCLES
    with torch.cuda.device(device):
        for _ in range(8):
            e_spin, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            e_spin.record()
            torch.cuda._sleep(spin)
            t0 = time.perf_counter()
            e0.record()
            fn(*args)
            e1.record()
            host_s = time.perf_counter() - t0
            e1.synchronize()
            if host_s * 1e3 < e_spin.elapsed_time(e0):
                return e0.elapsed_time(e1) / 1e3
            spin *= 2
    raise RuntimeError(f"a {spin // 2}-cycle spin did not cover the host's enqueue "
                       f"of {fn!r}")


def _cuda_device(args) -> torch.device | None:
    """The CUDA device of the first CUDA tensor among ``args``, else None."""
    return next((a.device for a in args if isinstance(a, torch.Tensor) and a.is_cuda), None)


def paired_times(fn_a, fn_b, *args, reps: int = 3, warmup: int = 1, clock: str = "wall"):
    """Paired interleaved A/B timer: ``(t_a, t_b, speedup_of_b_over_a)``.

    Each rep times both callables back to back, so slowdowns of the shared
    host hit both sides of the ratio; the speedup is the median of per-rep
    ratios and the times are the per-side minima (the JAX package's
    estimator).  ``clock="wall"`` times each side on the host's clock to
    its last result on the card (``torch.cuda.synchronize``): what a
    caller waits, the engine tile's measure.  ``clock="device"`` times each
    side on the card alone (:func:`_device_seconds`), leaving out the
    host's launch overhead, which is the same on both sides of a node's
    race; on CPU tensors it is the wall clock.  The warm-up calls absorb
    the first build and load of a kernel library.
    """
    if clock not in ("wall", "device"):
        raise ValueError(f"clock must be 'wall' or 'device', got {clock!r}")
    device = _cuda_device(args) if clock == "device" else None
    for _ in range(warmup):
        _wait(fn_a(*args))
        _wait(fn_b(*args))

    def timed(fn):
        if device is not None:
            return _device_seconds(fn, args, device)
        t0 = time.perf_counter()
        _wait(fn(*args))
        return time.perf_counter() - t0

    tas, tbs, ratios = [], [], []
    for _ in range(reps):
        ta = timed(fn_a)
        tb = timed(fn_b)
        tas.append(ta)
        tbs.append(tb)
        ratios.append(ta / tb)
    return float(np.min(tas)), float(np.min(tbs)), float(np.median(ratios))


# the name tune_node / tune_engine resolve (and tests stub) at call time
paired_timer = paired_times


# -------------------------------------------------------------- measurement
def _synth_activations(cfg: MVUConfig, m: int, in_shape: tuple | None,
                       conv: dict | None, device, seed: int = 0) -> torch.Tensor:
    """Seeded activations for one node's candidates, on ``device``: ``m``
    images for a conv node, else ``m`` rows (packed words for xnor)."""
    rng = np.random.default_rng(seed)
    if conv is not None:
        h, w, c = in_shape
        hi = 2 if cfg.mode == "xnor" else 2**cfg.act_bits
        x = rng.integers(0, hi, (m, h, w, c))
    elif cfg.mode == "xnor":
        x = rng.integers(0, 2, (m, cfg.in_features))
    else:
        x = rng.integers(-8, 8, (m, cfg.in_features))
    x = torch.as_tensor(x, dtype=torch.int32, device=device)
    return packing.pack_bits(x) if conv is None and cfg.mode == "xnor" else x


def _node_fn(cfg: MVUConfig, params, cand: Candidate, conv: dict | None):
    """The candidate's launch on the node's parameters, as ``fn(x)``."""
    blocks = cand.blocks.as_kwargs(cfg.mode, cand.packed)
    if conv is not None:
        def fn(x):
            return ops.conv_mvu(
                x, params.weights, kernel=conv["kernel"], stride=conv["stride"],
                pad=conv["pad"], mode=cfg.mode,
                k_bits=cfg.in_features if cfg.mode == "xnor" else None,
                thresholds=params.thresholds, out_scale=params.out_scale,
                backend=cand.backend, **blocks)
        return fn

    if cand.packed:
        # pack once outside the timed fn: at run time the packed storage is
        # what lives on the card (the pack_weights build step)
        w_packed = (params.weights if cfg.packed
                    else pack_mvu_weights(params.weights, cfg.mode))

        def fn(x):
            return ops.mvu(
                x, w_packed, cfg.mode, k_bits=cfg.in_features,
                thresholds=params.thresholds, out_scale=params.out_scale,
                backend=cand.backend, packed=True, **blocks)
        return fn

    def fn(x):
        return ops.mvu(
            x, params.weights, cfg.mode,
            k_bits=cfg.in_features if cfg.mode == "xnor" else None,
            thresholds=params.thresholds, out_scale=params.out_scale,
            backend=cand.backend, **blocks)
    return fn


def tune_node(
    node: Node,
    in_shape: tuple | None = None,
    *,
    smem_bytes: int = SMEM_BYTES,
    sample_m: int | None = None,
    reps: int = 3,
    max_measure: int = 8,
    margin: float = 0.05,
    timer=None,
    seed: int = 0,
    allow_packed: bool = True,
) -> dict:
    """Measure the pruned shortlist for one finalized mvu / conv_mvu node,
    on the device its parameters lie on; returns the winning cache entry.

    The race runs on ``sample_m`` samples, what each of the engine's
    launches gets: rows of a dense node, images of a conv node (None: the
    node's own burst, ``block_m // n_pixels`` samples); a tile that wins
    on other rows can lose on these.  The incumbent is the default 32
    tile on the node's own storage, the launch before the folding set the
    tile, so a tuned node never falls behind it by more than the timer's
    noise.  A candidate whose output is not bit-exact with the
    incumbent's is discarded, and a challenger must beat the incumbent by
    ``margin``.  Candidates are timed on the card's clock
    (``clock="device"``): the kernels differ there, while the host's
    launch path is the same.  A candidate that launches the incumbent's
    kernel and tile is not timed.  No candidate's build or launch is
    guarded: a kernel that fails to build or launch fails the tune.  The
    entry records ``sample_m``.
    """
    timer = timer if timer is not None else paired_timer
    cfg: MVUConfig = node.attrs["config"]
    params = node.params["mvu"]
    conv = None
    n_pixels = 1
    if node.op == "conv_mvu":
        conv = {k: node.attrs[k] for k in ("kernel", "stride", "pad")}
        n_pixels = ir.n_pixels(ir.propagate(node, in_shape))
    m = sample_m or max(1, cfg.block_m // n_pixels)
    cands = enumerate_candidates(cfg, m=m, n_pixels=n_pixels, in_shape=in_shape, conv=conv,
                                 smem_bytes=smem_bytes, max_measure=max_measure)

    x = _synth_activations(cfg, m, in_shape, conv, params.weights.device, seed=seed)
    base = Candidate(cfg.backend, _default_blocks(cfg),
                     Folding(BLOCK_N, BLOCK_K).cycles(cfg.out_features, cfg.in_features, n_pixels),
                     0, packed=cfg.packed or natively_packed(cfg, cfg.backend))
    base_fn = _node_fn(cfg, params, base, conv)
    want = _wait(base_fn(x))

    def effective(c: Candidate) -> tuple:
        """What the launch consumes: the kernel (backend and storage) and
        the compiled tile it launches."""
        return (c.backend, c.packed,
                launched_tile(cfg, c.blocks, c.packed, m=m, conv=conv, in_shape=in_shape)[0])

    best, best_speed = base, 1.0
    measured = 0
    seen_eff = {effective(base)}
    for cand in cands:
        if cfg.packed and not cand.packed:
            continue  # packed storage cannot feed the canonical kernels
        if cand.packed and not allow_packed and cfg.mode != "xnor":
            continue  # pack="never": the storage rewrite is excluded by policy
        if effective(cand) in seen_eff:
            continue
        seen_eff.add(effective(cand))
        fn = _node_fn(cfg, params, cand, conv)
        got = _wait(fn(x))
        if got.dtype != want.dtype or not torch.equal(got, want):
            continue  # never accept a schedule that changes the numbers
        _, _, speedup = timer(base_fn, fn, x, reps=reps, clock="device")
        measured += 1
        if speedup > best_speed * (1.0 + margin):
            best, best_speed = cand, speedup
    return best.entry(
        speedup=float(best_speed),
        measured_candidates=measured,
        epilogue=epilogue_form(params),
        n_pixels=int(n_pixels),
        sample_m=int(m),
    )


def apply_entry(cfg: MVUConfig, entry: dict, *, device=None) -> MVUConfig:
    """Pin a cache entry's schedule onto an MVUConfig.  The JAX package's
    backend names map to the port's; ``"packed": true`` selects the packed
    datapath, whose storage the ``pack_weights`` build step rewrites.

    ``device`` is where the node's parameters lie: off the CPU an entry
    whose backend is not ``cuda`` (``xla`` or ``torch``, the plain
    reference) raises, so that a cache never moves a node of a card's
    graph off the hand kernels unseen.
    """
    if "backend" in entry and device is not None and torch.device(device).type != "cpu" \
            and BACKEND_NAMES[entry["backend"]] != "cuda":
        raise ValueError(
            f"cache entry backend {entry['backend']!r} would run the plain reference on "
            f"{device}; a node on the card takes only backend 'cuda' (or 'pallas') entries")
    blocks = KernelBlocks.from_blocks(entry)
    return MVUConfig(**{
        **cfg.__dict__,
        "backend": BACKEND_NAMES[entry.get("backend", cfg.backend)],
        "packed": bool(entry.get("packed", cfg.packed)),
        "blocks": blocks,
        "block_m": blocks.block_m,
    })


def tune_graph(
    graph: Graph,
    *,
    cache: ScheduleCache | None = None,
    mode: str = "cache",
    device=None,
    timer=None,
    smem_bytes: int = SMEM_BYTES,
    allow_packed: bool = True,
    **tune_kwargs,
) -> Graph:
    """Pin every finalized mvu / conv_mvu node's schedule from the cache.

    ``mode="cache"`` is a pure lookup: hits rewrite the node's config,
    misses keep its schedule, nothing is measured.  ``mode="auto"``
    measures misses with :func:`tune_node` (on the device the graph's
    parameters lie on; by default at the engine's heuristic microbatch,
    ``DataflowSchedule.burst_samples``) and fills the cache.  ``device`` is the cache scope
    (see the module doc; None: the graph's device).  Returns a new graph;
    the caller's keeps its configs.
    """
    if mode not in ("cache", "auto"):
        raise ValueError(f"tune mode must be 'cache' or 'auto', got {mode!r}")
    cache = cache if cache is not None else default_cache()
    scope = _graph_scope(graph, device)
    out = Graph()
    for node, ins, out_shape in ir.io_shapes(graph):
        if not _tunable(node):
            out.append(node)
            continue
        cfg: MVUConfig = node.attrs["config"]
        if cfg.packed and cfg.blocks is not None:
            # already pinned to a packed schedule (apply_entry ran): its
            # |packed key would re-measure on every later pass
            out.append(node)
            continue
        key = _key_of(node, ins, out_shape, scope)
        entry = cache.get(key)
        if (entry is not None and entry.get("packed")
                and not allow_packed and cfg.mode != "xnor"):
            # pack="never": a packed winner would need the forbidden storage
            # rewrite (xnor storage is words either way)
            entry = None
        elif entry is None and mode == "auto":
            if tune_kwargs.get("sample_m") is None:
                from repro_torch.core.dataflow import schedule

                tune_kwargs = {**tune_kwargs, "sample_m": schedule(graph).burst_samples}
            entry = tune_node(node, ins[0] if ins else None, timer=timer,
                              smem_bytes=smem_bytes, allow_packed=allow_packed,
                              **tune_kwargs)
            cache.put(key, entry)
        if entry is None:
            out.append(node)
            continue
        cfg = apply_entry(cfg, entry, device=node.params["mvu"].weights.device)
        out.append(Node(node.op, node.name, {**node.attrs, "config": cfg},
                        node.params, inputs=node.inputs))
    return out


# ------------------------------------------------------------ engine level
def synth_input(graph: Graph, batch: int, seed: int = 0, *,
                device=None) -> torch.Tensor:
    """Random integer activations matching the graph's input node: the JAX
    package's numpy draws (same seed, same integers), as an int32 tensor on
    ``device`` (default the CPU)."""
    heads = [n for n in graph if n.op == "input"]
    if len(heads) != 1:
        raise ValueError(
            f"graph must have exactly one input node, found {len(heads)}")
    head = heads[0]
    shape = tuple(head.attrs["shape"])
    bits = head.attrs.get("bits", 1)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.integers(0, 2**bits, (batch, *shape)), dtype=torch.int32)
    return x if device is None else x.to(device)


def _canonical(node: Node) -> Node:
    """A tuned node as the build's tune step raced it: its folding's
    schedule on canonical storage (a packed node's weights unpacked)."""
    cfg: MVUConfig = node.attrs["config"]
    params = node.params["mvu"]
    w = params.weights
    if cfg.packed:
        w = unpack_mvu_weights(w, cfg.mode, cfg.in_features)
    return Node(node.op, node.name,
                {**node.attrs,
                 "config": MVUConfig(**{**cfg.__dict__, "blocks": None, "packed": False})},
                {**node.params, "mvu": MVUParams(w, params.thresholds, params.out_scale)},
                inputs=node.inputs)


def tune_engine(
    graph: Graph,
    batch: int,
    *,
    cache: ScheduleCache,
    device=None,
    tiles: tuple[int, ...] | None = None,
    reps: int = 5,
    margin: float = 0.1,
    timer=None,
    seed: int = 0,
    pack: str = "auto",
    node_kwargs: dict | None = None,
) -> dict:
    """Race the engine's microbatch tile (FINN's FIFO-depth analog) on the
    device the graph's parameters lie on, then race every node again at
    the samples a launch gets under the winner.

    Builds cache-tuned engines over the candidate tiles (default: the
    heuristic tile h and 2h, 4h, 8h and the whole batch), holds each to
    the heuristic plan's output bit for bit, times each against it with
    the paired timer and keeps the winner.  Each engine's first call (the
    bit-exactness check) captures its CUDA graph on the card, so the timer
    races replays, as the JAX tuner races jitted programs.  The node
    entries race in ``cache`` as they stand (missing ones keep their
    schedules); a prior engine entry there is ignored, so the speedup is
    always against the heuristic plan.  A challenger must beat the
    incumbent by ``margin``.

    Then every node (once a cache key), on its folding's schedule, is
    raced again with :func:`tune_node` (``seed`` and ``node_kwargs``, its
    ``timer`` among them) on the samples each launch gets at the winning
    tile, and its entry replaced: a tile or datapath raced on other rows
    can lose on these.  ``pack`` is the build's policy
    (``BuildConfig.pack``), so the node races what the build will run:
    ``"auto"`` both storage forms from canonical weights (a packed node's
    unpacked), ``"never"`` canonical storage alone, ``"always"`` a
    packable node's packed storage alone.  The engine entry goes under
    :func:`engine_key` of the graph those entries and ``pack`` give,
    which a ``tune="cache"`` rebuild looks up.
    """
    if pack not in ("auto", "never", "always"):
        raise ValueError(f"pack must be 'auto', 'never' or 'always', got {pack!r}")
    from repro_torch.core.engine import FusedEngine

    timer = timer if timer is not None else paired_timer
    node_cache = ScheduleCache({k: v for k, v in cache.entries.items()
                                if not k.startswith("engine|")})
    base = FusedEngine(graph, tune="cache", cache=node_cache,
                       tune_kwargs=None if device is None else {"device": device})
    heur_tile = base.plan(batch).microbatch
    if tiles is None:
        tiles = tuple(sorted({heur_tile, heur_tile * 2, heur_tile * 4,
                              heur_tile * 8, batch}))
    x = synth_input(graph, batch, seed=seed, device=base.device)
    want = _wait(base(x))

    best, best_tile, best_speed = base, heur_tile, 1.0
    for tile in tiles:
        if tile == heur_tile or tile < 1:
            continue
        cand = FusedEngine(graph, tune="cache", cache=node_cache,
                           tune_kwargs=None if device is None else {"device": device})
        cand._tile = int(tile)
        got = _wait(cand(x))
        if got.dtype != want.dtype or not torch.equal(got, want):
            continue
        _, _, speedup = timer(base, cand, x, reps=reps)
        if speedup > best_speed * (1.0 + margin):
            best, best_tile, best_speed = cand, int(tile), speedup
    samples = best.plan(batch).microbatch
    canonical = Graph()
    for node in base.graph:
        canonical.append(_canonical(node) if _tunable(node) else node)
    scope = _graph_scope(canonical, device)
    raced = set()
    for node, ins, out_shape in ir.io_shapes(canonical):
        key = _key_of(node, ins, out_shape, scope) if _tunable(node) else None
        if key is None or key in raced:
            continue
        raced.add(key)
        if pack == "always":
            node = pack_weights(Graph([node]), force=True)[0]
        cache.put(key, tune_node(node, ins[0] if ins else None, sample_m=samples, seed=seed,
                                 allow_packed=pack != "never", **(node_kwargs or {})))
    tuned = tune_graph(canonical, cache=cache, mode="cache", device=device,
                       allow_packed=pack != "never")
    if pack != "never":
        tuned = pack_weights(tuned, force=pack == "always")
    entry = {"microbatch": int(best_tile), "speedup": float(best_speed),
             "batch": int(batch)}
    cache.put(engine_key(tuned, device=device), entry)
    return entry
