"""Deterministic fault injection for the serving path.

The validation workload the paper targets (an always-on network-intrusion
-detection MLP) fails in ways a throughput benchmark never exercises:
dispatches raise, outputs silently corrupt (the FPGA analog: SEU bit
flips), replicas straggle, hang, or die.  ``FaultPlan`` is the *test
substrate* for all of it -- a seeded, reproducible schedule of injected
faults consulted by :class:`~repro_torch.serving.pool.ReplicaPool` at every
dispatch:

* **explicit events** fire at a named replica's k-th dispatch (``"the
  pool's replica 2 hangs on its 8th launch"``), and
* **background rates** draw per-(replica, dispatch-index) from a
  counter-keyed RNG, so the same plan JSON replays the same fault at the
  same dispatch regardless of wall-clock timing or host load.

Fault kinds: ``error`` (the dispatch raises), ``corrupt`` (the resolved
output is bit-flipped out of the graph's value range), ``straggle`` (the
result is withheld for ``delay_s``), ``hang`` (the result never becomes
ready -- only a dispatch timeout recovers it), ``die`` (this and every
later dispatch on the replica raises).

The module also owns the **integrity guard**: because every target in
this repo is bit-exact by construction, the output of a healthy replica
is *exactly* the interval-arithmetic bound of the lowered graph --
``infer_output_range`` propagates value intervals through the MVU chain
and ``check_integrity`` rejects any resolved batch with a wrong dtype, a
non-finite value, or a value outside the graph's reachable range.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

FAULT_KINDS = ("error", "corrupt", "straggle", "hang", "die")


class DispatchError(RuntimeError):
    """An (injected or real) failure enqueueing a batch on a replica."""

    def __init__(self, msg: str, *, replica: int | None = None):
        super().__init__(msg)
        self.replica = replica


class IntegrityError(RuntimeError):
    """A resolved batch failed the output integrity guard."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault: ``kind`` at ``replica``'s ``at_dispatch``-th
    dispatch (0-based, counted per replica).  ``delay_s`` only applies to
    ``straggle``."""

    kind: str
    replica: int
    at_dispatch: int
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind must be one of {FAULT_KINDS}, got {self.kind!r}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "FaultEvent":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, reproducible fault schedule.

    rates: background per-dispatch probabilities ``{kind: p}``; drawn from
        an RNG keyed on ``(seed, replica, dispatch_index)`` so the draw for
        a given dispatch is a pure function of the plan -- reordering other
        replicas' traffic never changes it.
    events: explicit :class:`FaultEvent` list, consulted before the rates
        (an event at a dispatch suppresses the background draw).
    replicas: when set, background rates only apply to these replica
        indices (events carry their own replica).
    straggle_delay_s: withhold duration for rate-drawn ``straggle`` faults.
    """

    seed: int = 0
    rates: dict = dataclasses.field(default_factory=dict)
    events: tuple = ()
    replicas: tuple | None = None
    straggle_delay_s: float = 0.05

    def __post_init__(self):
        for kind, p in self.rates.items():
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"rate kind must be one of {FAULT_KINDS}, got {kind!r}")
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"rate for {kind!r} must be in [0, 1], got {p}")
        object.__setattr__(self, "events", tuple(
            e if isinstance(e, FaultEvent) else FaultEvent(**e)
            for e in self.events))
        if self.replicas is not None:
            object.__setattr__(self, "replicas", tuple(self.replicas))

    # ------------------------------------------------------------------ draw
    def draw(self, replica: int, dispatch_index: int) -> FaultEvent | None:
        """The fault (if any) for ``replica``'s ``dispatch_index``-th
        dispatch.  Deterministic: same plan, same arguments, same answer."""
        for ev in self.events:
            if ev.replica == replica and ev.at_dispatch == dispatch_index:
                return ev
        if not self.rates:
            return None
        if self.replicas is not None and replica not in self.replicas:
            return None
        # counter-keyed RNG: the draw depends only on (seed, replica, k)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, replica, dispatch_index]))
        u = rng.uniform()
        edge = 0.0
        for kind in FAULT_KINDS:  # fixed order keeps the draw stable
            p = self.rates.get(kind, 0.0)
            if p <= 0.0:
                continue
            edge += p
            if u < edge:
                delay = self.straggle_delay_s if kind == "straggle" else 0.0
                return FaultEvent(kind, replica, dispatch_index, delay)
        return None

    def corruption_rng(self, replica: int, dispatch_index: int):
        """Seeded RNG for reproducible output corruption of one dispatch."""
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, 7919, replica, dispatch_index]))

    # ------------------------------------------------------------------ json
    def to_json(self) -> dict:
        return {
            "seed": self.seed,
            "rates": dict(self.rates),
            "events": [e.to_json() for e in self.events],
            "replicas": None if self.replicas is None else list(self.replicas),
            "straggle_delay_s": self.straggle_delay_s,
        }

    @classmethod
    def from_json(cls, d: dict) -> "FaultPlan":
        d = dict(d)
        d["events"] = tuple(FaultEvent.from_json(e) for e in d.get("events", ()))
        if d.get("replicas") is not None:
            d["replicas"] = tuple(d["replicas"])
        return cls(**d)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
            f.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))


# --------------------------------------------------------------- corruption
def corrupt_array(y: np.ndarray, rng, *, fraction: float = 0.25) -> np.ndarray:
    """Deterministically corrupt a copy of ``y`` (never in place).

    Integer outputs get SEU-style high-bit flips (XOR with bit 30 -- the
    value blasts out of any reachable accumulator range, which is exactly
    what the integrity guard's interval bound catches); float outputs get
    NaNs.  At least one element is always corrupted.
    """
    out = np.array(y, copy=True)
    flat = out.reshape(-1)
    n = max(1, int(fraction * flat.size))
    idx = rng.choice(flat.size, size=n, replace=False)
    if np.issubdtype(out.dtype, np.integer):
        flat[idx] = flat[idx] ^ np.array(1 << 30, dtype=out.dtype)
    else:
        flat[idx] = np.nan
    return out


# ----------------------------------------------------------- integrity guard
def _host(v, dtype=None) -> np.ndarray:
    """A parameter as a host array (a tensor on any device is copied to
    the host first)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=dtype)


def _mvu_interval(node, lo: float, hi: float) -> tuple[float, float] | None:
    """Output interval of an mvu/conv_mvu node given input interval."""
    p = node.params.get("mvu")
    if p is None:
        return None
    if getattr(p, "thresholds", None) is not None:
        # multi-threshold epilogue: output is the threshold level count
        t = _host(p.thresholds)
        return (0.0, float(t.shape[-1]))
    cfg = node.attrs.get("config")
    mode = getattr(cfg, "mode", "standard")
    if mode == "xnor":
        # bipolar popcount dot: |y| <= K
        k = float(getattr(cfg, "in_features", 0) or 0)
        ylo, yhi = -k, k
    else:
        w = _host(p.weights)
        if w.dtype == np.int32 and getattr(cfg, "packed", False):
            w = w.view(np.uint32)  # packed words as the JAX package's uint32
        w = w.astype(np.float64)
        if w.ndim != 2:
            return None
        wpos = np.clip(w, 0.0, None)
        wneg = np.clip(w, None, 0.0)
        yhi = float((wpos * hi + wneg * lo).sum(axis=1).max())
        ylo = float((wpos * lo + wneg * hi).sum(axis=1).min())
    scale = getattr(p, "out_scale", None)
    if scale is not None:
        s = _host(scale, np.float64)
        smax = float(np.abs(s).max()) if s.size else 1.0
        bound = max(abs(ylo), abs(yhi)) * smax
        return (-bound, bound)
    return (ylo, yhi)


def infer_output_range(graph) -> tuple[float, float] | None:
    """Conservative (lo, hi) bound on the graph's output values.

    Scalar interval arithmetic over the lowered op set -- exact enough to
    catch high-bit corruption (an SEU flip lands ~2^30 past any reachable
    accumulator), cheap enough to precompute once at pool construction.
    Returns None when the graph contains an op the propagation does not
    model (the range check is then disabled; dtype/finite checks remain).
    """
    from repro_torch.core import ir

    try:
        graph = ir.as_graph(graph)
        order = ir.toposort(graph)
        sink = ir.graph_output(graph).name
    except Exception:
        return None
    ranges: dict[str, tuple[float, float]] = {}
    for node in order:
        ins = [ranges.get(src) for src in (node.inputs or ())]
        if node.op == "input":
            bits = int(node.attrs.get("bits", 1))
            r = (0.0, float(2 ** bits - 1))
        elif node.op in ("mvu", "conv_mvu"):
            if not ins or ins[0] is None:
                return None
            r = _mvu_interval(node, *ins[0])
        elif node.op == "quant_act":
            bits = int(node.attrs["bits"])
            r = (0.0, float(2 ** bits - 1))
        elif node.op in ("flatten", "maxpool", "swu"):
            r = ins[0] if ins else None
        elif node.op == "batchnorm":
            if not ins or ins[0] is None:
                return None
            lo, hi = ins[0]
            g = _host(node.params["gamma"], np.float64)
            b = _host(node.params["beta"], np.float64)
            m = _host(node.params["mean"], np.float64)
            v = _host(node.params["var"], np.float64)
            a = g / np.sqrt(v + 1e-5)
            cands = np.stack([a * (lo - m) + b, a * (hi - m) + b])
            r = (float(cands.min()), float(cands.max()))
        elif node.op in ("add", "sub", "mul"):
            if len(ins) != 2 or ins[0] is None or ins[1] is None:
                return None
            sa, sb = node.attrs.get("scales", (1, 1))
            (alo, ahi), (blo, bhi) = ins
            alo, ahi = sorted((alo * sa, ahi * sa))
            blo, bhi = sorted((blo * sb, bhi * sb))
            if node.op == "add":
                r = (alo + blo, ahi + bhi)
            elif node.op == "sub":
                r = (alo - bhi, ahi - blo)
            else:
                prods = [alo * blo, alo * bhi, ahi * blo, ahi * bhi]
                r = (min(prods), max(prods))
        else:
            return None
        if r is None:
            return None
        ranges[node.name] = r
    return ranges.get(sink)


def check_integrity(ys: np.ndarray, *, dtype=None,
                    value_range: tuple[float, float] | None = None) -> str | None:
    """Cheap per-batch output checks; returns a reason string on failure,
    None when the batch is clean.  O(batch) numpy reductions -- run on
    every resolved batch without denting throughput."""
    ys = np.asarray(ys)
    if dtype is not None and ys.dtype != np.dtype(dtype):
        return f"output dtype {ys.dtype} != expected {np.dtype(dtype)}"
    if np.issubdtype(ys.dtype, np.floating) and not np.isfinite(ys).all():
        return "non-finite values in output"
    if value_range is not None and ys.size:
        lo, hi = value_range
        ymin, ymax = float(ys.min()), float(ys.max())
        if ymin < lo or ymax > hi:
            return (f"output values [{ymin:.6g}, {ymax:.6g}] escape the "
                    f"graph's reachable range [{lo:.6g}, {hi:.6g}]")
    return None
