"""Time-series metrics primitives: log-bucketed histograms, windowed rates,
and a Prometheus-style text exposition.

``LogHistogram`` replaces the serving latency reservoir: instead of keeping
the last N raw samples, it keeps counts in geometrically spaced buckets
(``lo * growth**i``), so memory is O(buckets touched) regardless of how
long the server runs, and two histograms merge exactly (reservoirs don't).
With ``growth = 2**(1/16)`` each bucket is ~4.4% wide, so a percentile
read off the geometric bucket midpoint is within ~2.2% of the true value
-- comfortably inside the 5% tolerance the serving tests assert.

``WindowedRate`` is a slotted ring: events land in coarse time slots and
the rate is the sum of the slots still inside the window -- a "requests
per second over the last 10s" gauge with O(slots) memory.

``render_prometheus`` turns counters / gauges / histograms into the
Prometheus text exposition format (one scrape-able string), complementing
the JSON ``snapshot()``.
"""

from __future__ import annotations

import math
import time

# 16 buckets per octave: relative bucket width ~4.4%, midpoint error ~2.2%.
DEFAULT_GROWTH = 2.0 ** (1.0 / 16.0)
DEFAULT_LO = 1e-6  # 1 us: well below any engine call this repo makes


class LogHistogram:
    """Log-bucketed histogram over positive values (seconds, typically).

    Values ``<= lo`` land in the underflow bucket (index -1) and are
    counted in ``count``/``sum`` but contribute ``lo`` to percentiles --
    with ``lo`` at 1 us nothing real ever lands there.
    """

    __slots__ = ("lo", "growth", "_log_growth", "buckets", "count", "sum",
                 "min", "max")

    def __init__(self, *, lo: float = DEFAULT_LO,
                 growth: float = DEFAULT_GROWTH):
        if lo <= 0 or growth <= 1.0:
            raise ValueError(f"need lo > 0 and growth > 1, got {lo}, {growth}")
        self.lo = lo
        self.growth = growth
        self._log_growth = math.log(growth)
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, value: float) -> int:
        if value <= self.lo:
            return -1
        return int(math.log(value / self.lo) / self._log_growth)

    def _midpoint(self, index: int) -> float:
        if index < 0:
            return self.lo
        # geometric midpoint of [lo*g^i, lo*g^(i+1))
        return self.lo * self.growth ** (index + 0.5)

    def upper_edge(self, index: int) -> float:
        return self.lo * self.growth ** (index + 1)

    def observe(self, value: float, n: int = 1) -> None:
        idx = self._index(value)
        self.buckets[idx] = self.buckets.get(idx, 0) + n
        self.count += n
        self.sum += value * n
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def percentile(self, p: float) -> float | None:
        """Value at percentile ``p`` (0..100), or None when empty."""
        if self.count == 0:
            return None
        # rank in [1, count]: matches the "p% of mass at or below" reading
        target = max(1.0, math.ceil(p / 100.0 * self.count))
        cum = 0
        for idx in sorted(self.buckets):
            cum += self.buckets[idx]
            if cum >= target:
                # clamp the midpoint estimate into the observed range so a
                # single-sample histogram answers exactly that sample
                return min(max(self._midpoint(idx), self.min), self.max)
        return self.max

    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        if (other.lo, other.growth) != (self.lo, self.growth):
            raise ValueError("cannot merge histograms with different buckets")
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def to_json(self) -> dict:
        return {"lo": self.lo, "growth": self.growth, "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "buckets": {str(k): v for k, v in sorted(self.buckets.items())}}

    @classmethod
    def from_json(cls, d: dict) -> "LogHistogram":
        h = cls(lo=d["lo"], growth=d["growth"])
        h.buckets = {int(k): v for k, v in d["buckets"].items()}
        h.count = d["count"]
        h.sum = d["sum"]
        h.min = d["min"] if d["min"] is not None else math.inf
        h.max = d["max"] if d["max"] is not None else -math.inf
        return h


class WindowedRate:
    """Events-per-second over a sliding window, via a slotted ring.

    ``window_s`` is split into ``slots`` coarse slots; each event lands in
    the slot for its timestamp and ``rate()`` sums the slots still inside
    the window.  Accuracy is one slot width; memory is O(slots).
    """

    __slots__ = ("window_s", "slot_s", "_slots", "clock")

    def __init__(self, window_s: float = 10.0, *, slots: int = 20,
                 clock=time.perf_counter):
        if window_s <= 0 or slots <= 0:
            raise ValueError(f"need positive window/slots, got {window_s}, {slots}")
        self.window_s = window_s
        self.slot_s = window_s / slots
        self._slots: dict[int, float] = {}
        self.clock = clock

    def _prune(self, now: float) -> None:
        horizon = int((now - self.window_s) / self.slot_s)
        if len(self._slots) > 2 * int(self.window_s / self.slot_s):
            for k in [k for k in self._slots if k <= horizon]:
                del self._slots[k]

    def add(self, n: float = 1.0, *, now: float | None = None) -> None:
        now = self.clock() if now is None else now
        key = int(now / self.slot_s)
        self._slots[key] = self._slots.get(key, 0.0) + n
        self._prune(now)

    def rate(self, *, now: float | None = None) -> float:
        now = self.clock() if now is None else now
        horizon = int((now - self.window_s) / self.slot_s)
        total = sum(v for k, v in self._slots.items() if k > horizon)
        return total / self.window_s


def _fmt(value) -> str:
    if value is None:
        return "NaN"  # Prometheus exposition spells missing values NaN
    return repr(float(value))


def render_prometheus(*, counters: dict | None = None,
                      gauges: dict | None = None,
                      histograms: dict[str, LogHistogram] | None = None,
                      prefix: str = "repro") -> str:
    """Prometheus text exposition (v0.0.4) for a set of metrics.

    Counters get a ``_total`` suffix; histograms render cumulative ``le``
    buckets (upper bucket edges, in the histogram's native unit) plus
    ``_sum``/``_count``, the standard histogram contract.
    """
    lines: list[str] = []
    for name, v in sorted((counters or {}).items()):
        full = f"{prefix}_{name}_total"
        lines.append(f"# TYPE {full} counter")
        lines.append(f"{full} {_fmt(v)}")
    for name, v in sorted((gauges or {}).items()):
        full = f"{prefix}_{name}"
        lines.append(f"# TYPE {full} gauge")
        lines.append(f"{full} {_fmt(v)}")
    for name, h in sorted((histograms or {}).items()):
        full = f"{prefix}_{name}"
        lines.append(f"# TYPE {full} histogram")
        cum = 0
        for idx in sorted(h.buckets):
            cum += h.buckets[idx]
            le = _fmt(h.upper_edge(idx))
            lines.append(f'{full}_bucket{{le="{le}"}} {cum}')
        lines.append(f'{full}_bucket{{le="+Inf"}} {h.count}')
        lines.append(f"{full}_sum {_fmt(h.sum)}")
        lines.append(f"{full}_count {h.count}")
    return "\n".join(lines) + "\n"
