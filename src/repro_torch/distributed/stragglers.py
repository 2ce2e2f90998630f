"""Shared straggler detection: trailing-median outlier test over a window.

A copy of the JAX package's ``repro.distributed.stragglers`` (pure
Python, so the port keeps its own rather than importing it).  Its
consumer here is the serving-side replica health machine
(:mod:`repro_torch.serving.health`), which flags replica dispatches whose
resolve latency straggles relative to the replica's own recent history,
and the training-side step watchdog
(:class:`repro_torch.distributed.fault_tolerance.StepWatchdog`).

The trailing *median* (not mean) is the robust center: a single straggler
landing in the window must not drag the threshold up and mask the next
one.  An EWMA is maintained alongside as a cheap smoothed-latency gauge
(hedging decisions want "typical recent latency" without a full sort).
"""

from __future__ import annotations

import collections
import statistics


class TrailingStats:
    """Bounded window of durations with a trailing-median straggler test.

    ``observe(dt)`` answers "is this observation a straggler relative to
    the window *before* it?" -- the sample is tested against the trailing
    median first and appended after, so one outlier never vouches for
    itself.  No verdict is issued until ``min_samples`` observations have
    accumulated (early measurements are compile/warmup noise).
    """

    def __init__(self, *, window: int = 32, factor: float = 3.0,
                 min_samples: int = 8, ewma_alpha: float = 0.25):
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        if factor <= 1.0:
            raise ValueError(f"factor must exceed 1.0, got {factor}")
        self.times: collections.deque[float] = collections.deque(maxlen=window)
        self.factor = factor
        self.min_samples = min_samples
        self._ewma_alpha = ewma_alpha
        self._ewma: float | None = None
        self.stragglers = 0

    def __len__(self) -> int:
        return len(self.times)

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0

    @property
    def ewma(self) -> float:
        """Exponentially-weighted moving average of the observations."""
        return 0.0 if self._ewma is None else self._ewma

    def threshold(self) -> float | None:
        """Current straggler cutoff, or None while under ``min_samples``."""
        if len(self.times) < self.min_samples:
            return None
        return self.factor * statistics.median(self.times)

    def would_flag(self, dt: float) -> bool:
        """The straggler test alone -- no recording (probe before commit)."""
        cut = self.threshold()
        return cut is not None and dt > cut

    def observe(self, dt: float) -> bool:
        """Record one duration; True when it straggled vs the trailing
        window (tested before appending, counted in ``stragglers``)."""
        flagged = self.would_flag(dt)
        if flagged:
            self.stragglers += 1
        self.times.append(dt)
        if self._ewma is None:
            self._ewma = dt
        else:
            a = self._ewma_alpha
            self._ewma = a * dt + (1.0 - a) * self._ewma
        return flagged
