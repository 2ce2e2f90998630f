"""Drift monitor: the paper's critical-path analysis made live.

The build calibrates a cycle model -- per-stage initiation intervals from
``repro_torch.core.dataflow.schedule`` times a measured ``s_per_cycle`` -- and
everything downstream (batcher deadlines, pipeline occupancy, the
EXPERIMENTS tables) trusts it.  ``DriftMonitor`` closes the loop: every
measured interval is compared online against its prediction, per key
(a stage name, a ``replica:N``), and a key whose measured/predicted ratio
leaves the band is *flagged* -- a stalled stage, a FIFO backing up, or a
replica quietly running slower than the model is visible the moment it
happens instead of when a benchmark gate trips.

Two details matter in practice:

* **EWMA, not last-sample**: one noisy host-side hiccup should not flag a
  stage; the exponentially weighted ratio has to leave the band.
* **Censored observations**: a straggling primary whose hedge wins never
  resolves, so its true duration is unobservable -- but its *age so far*
  is a lower bound.  ``observe(..., censored=True)`` accepts such lower
  bounds and only counts ones that are already conclusive (the bound
  alone exceeds the band's high edge).  This is what lets an injected
  straggle replica be flagged even though hedging hides its completions.
"""

from __future__ import annotations

import math

DEFAULT_BAND = (0.5, 3.0)


class DriftMonitor:
    """Online measured-vs-predicted interval tracking with banded flagging.

    predictions: key -> predicted seconds (``observe`` may also pass an
        explicit ``predicted_s``, e.g. per-bucket serving predictions).
    band: (low, high) acceptable measured/predicted ratio; outside on the
        high side means slower than the model, low side faster (a model
        that overestimates is drift too -- FIFO sizing built on it is
        wasteful).
    alpha: EWMA weight of the newest ratio.
    min_samples: observations required for a key before it can flag.
    """

    def __init__(self, predictions: dict[str, float] | None = None, *,
                 band: tuple[float, float] = DEFAULT_BAND,
                 alpha: float = 0.3, min_samples: int = 1):
        lo, hi = band
        if not (0.0 < lo < hi):
            raise ValueError(f"need 0 < band_low < band_high, got {band}")
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"need 0 < alpha <= 1, got {alpha}")
        self.predictions = dict(predictions or {})
        self.band = (float(lo), float(hi))
        self.alpha = alpha
        self.min_samples = min_samples
        self._state: dict[str, dict] = {}
        # keys that were EVER flagged: the live flag clears when the EWMA
        # re-enters the band (recovery), but "did this replica drift at any
        # point in the run" is the question a post-mortem / chaos gate asks
        self._ever: set[str] = set()

    @classmethod
    def from_schedule(cls, schedule, s_per_cycle: float, **kwargs
                      ) -> "DriftMonitor":
        """Predictions from a :class:`DataflowSchedule` and the calibrated
        cycle time: per-stage predicted interval = cycles x s_per_cycle."""
        preds = {s.name: s.cycles * s_per_cycle for s in schedule.stages}
        return cls(preds, **kwargs)

    # ------------------------------------------------------------- recording
    def observe(self, key: str, measured_s: float, *,
                predicted_s: float | None = None,
                censored: bool = False) -> float | None:
        """Record one measured interval; returns the ratio (None if the
        observation was discarded as uninformative).

        ``censored=True`` marks ``measured_s`` as a lower bound on the true
        duration (an unresolved flight's age).  A censored bound inside the
        band proves nothing and is dropped; one already above the high edge
        is conclusive and recorded at its bound value.
        """
        if predicted_s is None:
            predicted_s = self.predictions.get(key)
        if predicted_s is None or predicted_s <= 0 or measured_s < 0:
            return None
        ratio = measured_s / predicted_s
        st = self._state.get(key)
        if censored and ratio <= self.band[1]:
            if st is not None:
                st["censored_dropped"] += 1
            return None
        if st is None:
            st = self._state[key] = {
                "count": 0, "ewma": ratio, "last": ratio,
                "predicted_s": predicted_s,
                "censored_hits": 0, "censored_dropped": 0,
            }
        st["count"] += 1
        st["last"] = ratio
        st["predicted_s"] = predicted_s
        st["ewma"] += self.alpha * (ratio - st["ewma"])
        if censored:
            st["censored_hits"] += 1
            # an accepted censored bound is conclusive on its own (the TRUE
            # duration is at least this far above the band), so it latches
            # the ever-flag even if later clean samples pull the EWMA back
            self._ever.add(key)
        elif st["count"] >= self.min_samples and not self._in_band(st):
            self._ever.add(key)
        return ratio

    # -------------------------------------------------------------- reading
    def _in_band(self, st: dict) -> bool:
        return self.band[0] <= st["ewma"] <= self.band[1]

    def flagged(self) -> list[str]:
        """Keys whose EWMA ratio is outside the band (enough samples seen)."""
        return sorted(k for k, st in self._state.items()
                      if st["count"] >= self.min_samples
                      and not self._in_band(st))

    def flagged_ever(self) -> list[str]:
        """Keys flagged at ANY point so far (latched; survives recovery)."""
        return sorted(self._ever)

    def ratio(self, key: str) -> float | None:
        st = self._state.get(key)
        return st["ewma"] if st else None

    def status(self) -> dict:
        """Full per-key state plus the flag list -- JSON-serializable."""
        keys = {}
        for k, st in sorted(self._state.items()):
            keys[k] = {
                "predicted_s": st["predicted_s"],
                "count": st["count"],
                "ratio_ewma": round(st["ewma"], 4),
                "ratio_last": round(st["last"], 4),
                "in_band": self._in_band(st),
                "censored_hits": st["censored_hits"],
                "censored_dropped": st["censored_dropped"],
            }
        return {"band": list(self.band), "alpha": self.alpha,
                "min_samples": self.min_samples,
                "flagged": self.flagged(),
                "flagged_ever": self.flagged_ever(), "keys": keys}

    def __repr__(self) -> str:
        flagged = self.flagged()
        return (f"DriftMonitor(keys={len(self._state)}, band={self.band}, "
                f"flagged={flagged!r})")
