"""Replica health state machine, fault policy, and brownout controller.

The serving failure model (the counterpart of the FPGA deployment
frameworks' validation hooks): every replica carries a health state

    healthy -> suspect -> quarantined -> (canary probe) -> healthy

driven by three signals --

* **consecutive dispatch failures** (raised exceptions / dead replicas),
* **straggler latencies** via the shared trailing-median detector
  (:class:`repro_torch.distributed.stragglers.TrailingStats`, the JAX
  package's shared trailing-median test), and
* **integrity violations / timeouts**, which quarantine immediately --
  a replica that returned corrupt bits or hung once is not trusted again
  until it proves itself.

Quarantined replicas are skipped by the pool's ``pick`` and re-probed on
a capped-exponential-backoff schedule with a **golden canary**: a fixed
synthetic input whose expected output is bit-exact from the build's
reference, so recovery is proven exactly, never statistically.

:class:`FaultPolicy` is the single knob set for all of it (retry budgets,
timeouts, hedging, brownout thresholds); ``FaultPolicy.disabled()``
reproduces the pre-hardening serving behavior for A/B chaos benchmarks.

:class:`BrownoutController` implements graceful degradation: under
sustained replica loss or queue pressure it tiers admission (gold vs
best-effort -- the seed of the fleet-level SLO tiers), sheds best-effort
traffic first, and shrinks the active bucket grid so gold-tier flush
latency stays bounded by smaller launches.
"""

from __future__ import annotations

import dataclasses

from repro_torch.distributed.stragglers import TrailingStats

HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"

GOLD = "gold"
BEST_EFFORT = "best_effort"
TIERS = (GOLD, BEST_EFFORT)


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Failure-handling knobs for the serving path (plain data).

    enabled: master switch; ``disabled()`` replays the pre-hardening
        behavior (no retries, no timeouts, no health, no integrity) for
        chaos A/B baselines.  Failed dispatches still resolve their
        entries as shed -- a rid is never silently dropped either way.
    max_retries: per-request re-dispatch budget after a failed / timed-out
        / corrupted launch; exhausted or past-deadline requests complete
        as shed (``CompletedRequest.shed``), never retried past their SLO.
    retry_backoff_s: base delay before a retry launch; doubles per attempt.
    dispatch_timeout_s: wall-clock bound on one launch; an un-ready batch
        past it quarantines its replica and re-dispatches elsewhere, so
        ``harvest``/``drain`` can never block forever on a hung replica.
    hedge_after_s: duplicate a straggling launch onto a second healthy
        replica after this long; first bit-exact result wins.  ``None``
        derives it from the replica's own EWMA latency
        (``hedge_factor`` x), which needs a few clean resolves to arm.
    suspect_after / quarantine_after: consecutive dispatch failures before
        healthy -> suspect and suspect -> quarantined.
    straggler_factor / straggler_window: trailing-median straggler test per
        replica (shared :class:`TrailingStats` semantics); a straggling
        replica goes suspect, repeated straggles quarantine it.
    probe_backoff_s / probe_backoff_cap_s: capped-exponential canary-probe
        schedule for quarantined replicas; probe_timeout_s bounds one probe.
    integrity: run the output guard on every resolved batch (dtype /
        finite / reachable-range); a corrupt batch quarantines its replica
        and re-executes on a healthy one.
    brownout: enable the degradation controller; *_frac thresholds below.
    """

    enabled: bool = True
    # request-level resilience
    max_retries: int = 2
    retry_backoff_s: float = 0.0
    dispatch_timeout_s: float | None = 30.0
    hedge_after_s: float | None = None
    hedge_factor: float = 4.0
    hedging: bool = False
    # replica health
    suspect_after: int = 1
    quarantine_after: int = 3
    straggler_factor: float = 4.0
    straggler_window: int = 32
    straggler_min_samples: int = 8
    straggles_to_quarantine: int = 3
    # canary probing
    probe_backoff_s: float = 0.05
    probe_backoff_cap_s: float = 2.0
    probe_timeout_s: float = 5.0
    # integrity guard
    integrity: bool = True
    # brownout
    brownout: bool = True
    brownout_healthy_frac: float = 0.5
    brownout_depth_frac: float = 0.75
    severe_healthy_frac: float = 0.25
    brownout_cooldown_s: float = 0.25

    @classmethod
    def disabled(cls) -> "FaultPolicy":
        """The pre-hardening serving behavior (chaos-benchmark baseline)."""
        return cls(enabled=False, max_retries=0, dispatch_timeout_s=None,
                   hedging=False, integrity=False, brownout=False)

    def hedge_delay(self, ewma_latency: float) -> float | None:
        """Seconds after which a launch is hedge-worthy, or None (never)."""
        if not (self.enabled and self.hedging):
            return None
        if self.hedge_after_s is not None:
            return self.hedge_after_s
        if ewma_latency <= 0.0:
            return None  # EWMA not armed yet: nothing to compare against
        return self.hedge_factor * ewma_latency


class ReplicaHealth:
    """Per-replica health state machine (see module docstring)."""

    def __init__(self, policy: FaultPolicy):
        self.policy = policy
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.straggles = 0
        self.latency = TrailingStats(
            window=policy.straggler_window, factor=policy.straggler_factor,
            min_samples=policy.straggler_min_samples)
        self.quarantined_at: float | None = None
        self.quarantine_reason: str | None = None
        self.probe_failures = 0
        self.next_probe_at: float | None = None
        self.recoveries = 0
        self.dead = False  # set by an injected 'die' fault (permanent)

    # ------------------------------------------------------------- queries
    @property
    def usable(self) -> bool:
        """Eligible for regular dispatch (quarantined replicas are not)."""
        return self.state != QUARANTINED

    def due_probe(self, now: float) -> bool:
        return (self.state == QUARANTINED and self.next_probe_at is not None
                and now >= self.next_probe_at)

    # ---------------------------------------------------------- transitions
    def record_success(self, latency_s: float) -> str | None:
        """A clean resolve.  Returns None (fine), ``"straggle"`` (the
        latency straggled vs the trailing median), or ``"quarantine"``
        (straggled often enough that the caller should quarantine)."""
        self.consecutive_failures = 0
        if not self.latency.observe(latency_s):
            if self.state == SUSPECT:
                self.state = HEALTHY  # a clean, on-time resolve clears suspicion
                self.straggles = 0
            return None
        self.straggles += 1
        if self.straggles >= self.policy.straggles_to_quarantine:
            return "quarantine"
        if self.state == HEALTHY:
            self.state = SUSPECT
        return "straggle"

    def record_failure(self, now: float, reason: str) -> None:
        self.consecutive_failures += 1
        if self.state == QUARANTINED:
            return
        if self.consecutive_failures >= self.policy.quarantine_after:
            self.quarantine(now, reason)
        elif self.consecutive_failures >= self.policy.suspect_after:
            self.state = SUSPECT

    def quarantine(self, now: float, reason: str) -> None:
        """Hard transition (timeouts, corruption, failure threshold)."""
        if self.state != QUARANTINED:
            self.state = QUARANTINED
            self.quarantined_at = now
            self.probe_failures = 0
            self.next_probe_at = now + self.policy.probe_backoff_s
        self.quarantine_reason = reason

    def note_probe(self, ok: bool, now: float) -> bool:
        """Record a canary-probe outcome; True on recovery."""
        if ok:
            self.state = HEALTHY
            self.consecutive_failures = 0
            self.straggles = 0
            self.probe_failures = 0
            self.quarantined_at = self.next_probe_at = None
            self.quarantine_reason = None
            self.recoveries += 1
            return True
        self.probe_failures += 1
        backoff = min(
            self.policy.probe_backoff_s * (2 ** self.probe_failures),
            self.policy.probe_backoff_cap_s)
        self.next_probe_at = now + backoff
        return False

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "straggles": self.straggles,
            "median_latency_s": self.latency.median,
            "ewma_latency_s": self.latency.ewma,
            "quarantine_reason": self.quarantine_reason,
            "recoveries": self.recoveries,
            "dead": self.dead,
        }


class BrownoutController:
    """Graceful degradation under replica loss / overload.

    Levels: 0 normal; 1 brownout (best-effort admission shed, queued
    best-effort dropped); 2 severe (additionally the active bucket grid
    shrinks below the largest bucket, so each gold launch is smaller and
    its flush latency bounded).  Entry is immediate on pressure; exit
    requires the pressure gone for ``brownout_cooldown_s`` (hysteresis --
    flapping between levels would churn the active bucket grid)."""

    def __init__(self, policy: FaultPolicy, *, tracer=None):
        self.policy = policy
        self.level = 0
        self._calm_since: float | None = None
        # repro_torch.telemetry.Tracer or None: level transitions are instants
        # (entering brownout is exactly the event an operator scrubs for)
        self.tracer = tracer

    def update(self, *, healthy_frac: float, depth_frac: float,
               now: float) -> int:
        """Advance the controller one tick; returns the (new) level."""
        p = self.policy
        if not (p.enabled and p.brownout):
            self.level = 0
            return 0
        before = self.level
        want = 0
        if healthy_frac <= p.brownout_healthy_frac or depth_frac >= p.brownout_depth_frac:
            want = 1
        if healthy_frac <= p.severe_healthy_frac or depth_frac >= 1.0:
            want = 2
        if want >= self.level:
            if want > self.level:
                self.level = want
            self._calm_since = None
        else:
            # de-escalate only after a calm cooldown window
            if self._calm_since is None:
                self._calm_since = now
            elif now - self._calm_since >= p.brownout_cooldown_s:
                self.level = want
                self._calm_since = None
        if self.tracer is not None and self.level != before:
            self.tracer.instant("brownout", cat="health", level=self.level,
                                previous=before, healthy_frac=healthy_frac,
                                depth_frac=depth_frac)
        return self.level

    @property
    def shedding_best_effort(self) -> bool:
        return self.level >= 1

    @property
    def shrink_buckets(self) -> bool:
        return self.level >= 2
