"""Serving metrics: latency percentiles, throughput, queue depth, padding.

One ``ServingMetrics`` instance is shared by the admission queue, the
continuous batcher, and the replica pool -- and by whatever harvest /
monitoring threads a deployment runs around them, so every mutation takes
the instance lock (a counter bumped from two threads must never lose an
increment).  Latencies live in a :class:`repro_torch.telemetry.LogHistogram`:
bounded memory regardless of uptime (the FINN FIFO rule applied to the
bookkeeping itself), mergeable across instances, and percentiles within
the bucket width (~4.4%) of exact.  A :class:`repro_torch.telemetry.WindowedRate`
tracks recent completion rate alongside the all-time throughput.

``snapshot()`` condenses everything into a plain JSON-safe dict (empty
percentiles are ``None``, never NaN -- ``json.dumps(float("nan"))`` emits
a token no strict JSON parser accepts); ``prometheus()`` renders the same
state in the Prometheus text exposition format.
"""

from __future__ import annotations

import threading
import time

from repro_torch.telemetry.metrics import LogHistogram, WindowedRate, render_prometheus

PERCENTILES = (50.0, 95.0, 99.0)


class ServingMetrics:
    """Thread-safe counters + gauges + a latency histogram with snapshots.

    ``window_s`` sizes the recent-completions rate window.  ``reservoir``
    is accepted for back-compat with the old bounded-reservoir API and
    ignored (the histogram is bounded by construction).
    """

    COUNTERS = (
        "requests", "completed", "rejected", "shed", "flushes",
        "padded_samples", "deadline_misses", "dispatched_samples",
        # failure handling (repro_torch.serving.faults / health)
        "dispatch_failures", "retries", "hedges", "hedge_wins", "timeouts",
        "corrupt_batches", "quarantines", "recoveries", "probes",
        "brownout_shed",
    )

    def __init__(self, *, reservoir: int | None = None,
                 clock=time.perf_counter, window_s: float = 10.0):
        del reservoir  # legacy knob: histogram memory is bounded regardless
        self.counters: dict[str, int] = {k: 0 for k in self.COUNTERS}
        self._lock = threading.Lock()
        self.latency = LogHistogram()
        self._rate = WindowedRate(window_s, clock=clock)
        self._clock = clock
        self._t_first: float | None = None
        self._t_last: float | None = None
        self.queue_depth = 0
        self.max_queue_depth = 0
        self.healthy_replicas: int | None = None
        self.total_replicas: int | None = None
        self.brownout_level = 0

    # ------------------------------------------------------------- recording
    def count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def observe_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depth = depth
            self.max_queue_depth = max(self.max_queue_depth, depth)

    def observe_health(self, healthy: int, total: int) -> None:
        with self._lock:
            self.healthy_replicas = healthy
            self.total_replicas = total

    def observe_brownout(self, level: int) -> None:
        with self._lock:
            self.brownout_level = level

    def observe_latency(self, seconds: float, *, now: float | None = None) -> None:
        now = self._clock() if now is None else now
        with self._lock:
            if self._t_first is None:
                self._t_first = now
            self._t_last = now
            self.latency.observe(seconds)
            self._rate.add(now=now)
            self.counters["completed"] += 1

    # -------------------------------------------------------------- snapshot
    def latency_percentiles(self) -> dict[str, float | None]:
        """Histogram percentiles in ms; ``None`` (JSON null, not NaN) when
        nothing has completed yet."""
        with self._lock:
            out = {}
            for p in PERCENTILES:
                v = self.latency.percentile(p)
                out[f"p{int(p)}_ms"] = None if v is None else v * 1e3
            return out

    def throughput(self) -> float:
        """Completed samples per second over the observed completion window."""
        with self._lock:
            if self._t_first is None or self._t_last is None:
                return 0.0
            span = self._t_last - self._t_first
            if span <= 0:
                return 0.0
            return self.counters["completed"] / span

    def recent_rate(self, *, now: float | None = None) -> float:
        """Completions per second over the recent sliding window."""
        with self._lock:
            return self._rate.rate(now=now)

    def padding_overhead(self) -> float:
        """Fraction of dispatched engine slots that were padding."""
        with self._lock:
            total = self.counters["dispatched_samples"]
            if total <= 0:
                return 0.0
            return self.counters["padded_samples"] / total

    def availability(self) -> float:
        """Fraction of admitted requests that completed with a result (the
        complement of shed/abandoned traffic); 1.0 when nothing arrived."""
        with self._lock:
            reqs = self.counters["requests"]
            if reqs <= 0:
                return 1.0
            return self.counters["completed"] / reqs

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
        return {
            **counters,
            **self.latency_percentiles(),
            "samples_per_s": self.throughput(),
            "recent_samples_per_s": self.recent_rate(),
            "queue_depth": self.queue_depth,
            "max_queue_depth": self.max_queue_depth,
            "padding_overhead": self.padding_overhead(),
            "availability": self.availability(),
            "healthy_replicas": self.healthy_replicas,
            "total_replicas": self.total_replicas,
            "brownout_level": self.brownout_level,
        }

    def prometheus(self, *, prefix: str = "repro_serving") -> str:
        """The same state as :meth:`snapshot`, rendered in the Prometheus
        text exposition format (counters ``_total``, latency as a native
        histogram with cumulative ``le`` buckets in seconds)."""
        pct = self.latency_percentiles()
        with self._lock:
            counters = dict(self.counters)
            gauges = {
                "queue_depth": self.queue_depth,
                "max_queue_depth": self.max_queue_depth,
                "brownout_level": self.brownout_level,
            }
            if self.healthy_replicas is not None:
                gauges["healthy_replicas"] = self.healthy_replicas
            if self.total_replicas is not None:
                gauges["total_replicas"] = self.total_replicas
            hist = {"latency_seconds": self.latency}
            text = render_prometheus(counters=counters, gauges={
                **gauges,
                "samples_per_s": self.counters["completed"] /
                    (self._t_last - self._t_first)
                    if self._t_first is not None
                    and self._t_last is not None
                    and self._t_last > self._t_first else 0.0,
                **{f"latency_{k}": v for k, v in pct.items()},
            }, histograms=hist, prefix=prefix)
        return text
