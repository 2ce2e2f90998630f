"""Continuous batcher: SLO-aware flushing derived from the dataflow schedule.

The flush policy is the FINN FIFO-sizing rule applied to wall-clock time
(paper section 5.3): steady-state throughput is set by the bottleneck
stage's initiation interval, small buffers absorb bursts, and a burst is
released downstream as soon as either

* a **bucket fills** -- one full producer burst is ready, ship it,
* the **pipeline is idle** -- holding work while the engine sits empty buys
  nothing (the continuous-batching insight: waiting is only useful when the
  device is busy), or
* the **oldest request's slack runs out** -- the time left to its deadline
  has shrunk to one engine flush budget (``DataflowSchedule.
  steady_state_interval`` converted to seconds via
  ``dataflow.interval_seconds``, times the bucket's microbatch count), so
  deferring any further would miss the SLO.

``ContinuousBatcher`` owns an :class:`~repro_torch.serving.queue.AdmissionQueue`
(bounded, validating, backpressured), a
:class:`~repro_torch.serving.pool.ReplicaPool` (async least-loaded dispatch) and
a :class:`~repro_torch.serving.metrics.ServingMetrics`; ``poll`` advances the
whole machine one non-blocking step and is the only method a serving loop
needs to call.

Hardened against the serving failure model (``fault_policy``):

* a failed dispatch **never loses its batch** -- entries re-enqueue for
  retry (per-request budgets, exponential backoff) or complete as shed,
* every launch has a **dispatch timeout**: a hung replica is quarantined
  and its batch re-dispatched, so ``harvest``/``drain`` cannot block
  forever (and both take an explicit ``timeout`` raising
  :class:`TimeoutError` naming the stuck replica),
* straggling launches can be **hedged** onto a second healthy replica --
  the first bit-exact result wins,
* retries are **deadline-aware**: a request is never retried past its
  deadline; it completes as shed (``CompletedRequest.shed``),
* an **integrity guard** checks every resolved batch (dtype / finite /
  reachable value range); a corrupt batch quarantines its replica and
  re-executes on a healthy one -- no corrupted result is ever delivered,
* a **brownout controller** sheds best-effort-tier traffic first and
  shrinks the active bucket grid under sustained replica loss or
  overload, keeping gold-tier latency bounded.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import dataflow
from repro_torch.serving import faults as faults_mod
from repro_torch.serving.faults import DispatchError
from repro_torch.serving.health import (
    BEST_EFFORT,
    GOLD,
    BrownoutController,
    FaultPolicy,
)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.pool import NoHealthyReplicas, PendingBatch, ReplicaPool
from repro_torch.serving.queue import AdmissionQueue, Entry, InputSpec, QueueFull

_TICK_S = 2e-4  # blocking-harvest poll tick


@dataclasses.dataclass(frozen=True)
class CompletedRequest:
    """A finished request: output row + the timestamps the SLO math needs.

    A request dropped by the queue's shed policy also resolves here, with
    ``out is None`` (``shed`` True) -- so a ``pop_result``/``poll`` wait
    loop always terminates, it never spins on a rid that left the system.
    The same contract covers failure handling: a request whose retry
    budget or deadline ran out completes as shed, never silently vanishes.
    """

    rid: int
    out: np.ndarray | None
    t_submit: float
    t_done: float
    deadline: float

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    @property
    def missed_deadline(self) -> bool:
        return self.t_done > self.deadline

    @property
    def shed(self) -> bool:
        return self.out is None


class _Flight:
    """One logical launch: its entries + sample rows, the primary pending
    batch, and (optionally) a hedged duplicate racing it."""

    __slots__ = ("entries", "xs", "primary", "hedge")

    def __init__(self, entries: list[Entry], xs: np.ndarray,
                 primary: PendingBatch):
        self.entries = entries
        self.xs = xs  # unpadded (len(entries), *spec.shape) rows
        self.primary = primary
        self.hedge: PendingBatch | None = None

    def pendings(self):
        return [p for p in (self.primary, self.hedge) if p is not None]


def calibrate_cycle_time(engine, *, batch: int = 128, reps: int = 3,
                         cache=None, device=None) -> dict:
    """Measure the engine's realized wall-clock seconds per schedule cycle.

    The analytic schedule counts cycles; serving deadlines are seconds.  One
    timed run of the fused engine divides measured time by the plan's
    ``n_micro * steady_state_interval`` to get the device's realized cycle
    time, recorded under :func:`repro_torch.core.autotune.cycle_time_key`
    of ``device`` (default: the engine's device) so
    ``dataflow.interval_seconds`` (and every batcher built afterwards) uses
    the measurement instead of the nominal clock.  On a CUDA engine the
    warm-up call and each timed call end in ``torch.cuda.synchronize``; the
    warm-up captures the batch's graph, so the timed calls are replays.
    """
    from repro_torch.core import autotune

    dev = engine.device
    x = autotune.synth_input(engine.graph, batch, device=dev)

    def run():
        engine(x)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run()  # first-use kernel builds, plan lookups and the capture outside the timed region
    ts = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    plan = engine.plan(batch)
    cycles = max(1, plan.n_micro * max(plan.interval_cycles, 1))
    entry = {
        "s_per_cycle": float(min(ts)) / cycles,
        "batch": int(batch),
        "n_micro": int(plan.n_micro),
        "measured_s": float(min(ts)),
    }
    if cache is not None:
        cache.put(autotune.cycle_time_key(dev if device is None else device), entry)
    return entry


class ContinuousBatcher:
    """Continuous batching front-end over one :class:`FusedEngine`.

    Parameters
    ----------
    batch_buckets: the padded launch shapes: a launch pads up to the
        smallest bucket holding it, so the launch plans stay a bounded set
        under any traffic pattern.
    slo_s: default per-request latency budget; ``submit(deadline=...)``
        overrides per request.  ``None`` disables deadline-triggered
        flushing (bucket-fill and idle-greedy still apply).
    queue_capacity / policy: admission bound and overflow behavior
        (``"reject"`` raises :class:`QueueFull`, ``"shed"`` drops the
        oldest).  Defaults to 8 max-size bursts -- the decoupling-FIFO
        bound; a deeper queue only hides latency the SLO already lost.
    interval_s: seconds per steady-state interval; defaults to
        ``dataflow.interval_seconds`` (measured cycle time when the
        autotune ``cache`` holds one, nominal clock otherwise).
    greedy_when_idle: flush a partial bucket whenever no replica has work
        in flight (set False to batch strictly by deadline/bucket -- the
        legacy manual-flush behavior).
    fault_policy: failure-handling knobs (:class:`FaultPolicy`); the
        default enables retries, dispatch timeouts, the integrity guard
        and brownout with conservative settings (zero overhead while
        replicas are healthy).  ``FaultPolicy.disabled()`` reproduces the
        pre-hardening behavior.
    faults: optional :class:`~repro_torch.serving.faults.FaultPlan` injected
        into the pool (chaos testing); ignored when ``pool`` is given.
    tracer: optional :class:`repro_torch.telemetry.Tracer`.  Records the full
        request lifecycle -- an async ``request`` interval per rid from
        admission to resolution, ``dispatch``/``resolve`` duration spans,
        and ``retry``/``hedge``/``timeout``/``corrupt_batch`` instants
        (quarantine/probe/brownout instants come from the pool and the
        brownout controller, which share this tracer when the batcher
        constructs them).  ``None`` (the default) costs one identity test
        per site -- the zero-overhead-when-disabled contract.
    drift: optional :class:`repro_torch.telemetry.DriftMonitor`.  Every resolved
        launch contributes a measured-vs-predicted observation keyed
        ``replica:N`` (predicted = the launch plan's ``n_micro`` x
        ``interval_s``, the same cycle-model arithmetic the flush budgets
        use); hedged-away, abandoned and timed-out launches contribute
        *censored* lower bounds, so a straggling replica is flagged even
        when hedging hides its completions.
    """

    def __init__(self, engine, *, batch_buckets: tuple[int, ...] = (1, 8, 32, 128),
                 slo_s: float | None = None, queue: AdmissionQueue | None = None,
                 pool: ReplicaPool | None = None, metrics: ServingMetrics | None = None,
                 cache=None, interval_s: float | None = None,
                 greedy_when_idle: bool = True, safety: float = 2.0,
                 queue_capacity: int | None = None, policy: str = "reject",
                 result_capacity: int = 8192, clock=time.perf_counter,
                 fault_policy: FaultPolicy | None = None,
                 faults=None, tracer=None, drift=None):
        if not batch_buckets or any(b <= 0 for b in batch_buckets):
            raise ValueError(f"need positive bucket sizes, got {batch_buckets}")
        self.engine = engine
        self.buckets = tuple(sorted(set(batch_buckets)))
        self.spec = InputSpec.from_graph(engine.graph)
        self._clock = clock
        self.tracer = tracer
        self.drift = drift
        self.metrics = metrics if metrics is not None else ServingMetrics(clock=clock)
        if queue_capacity is None:
            queue_capacity = 8 * self.buckets[-1]
        self.queue = queue if queue is not None else AdmissionQueue(
            self.spec, capacity=queue_capacity, policy=policy,
            default_slo_s=slo_s, clock=clock, tracer=tracer)
        self.fault_policy = fault_policy if fault_policy is not None else FaultPolicy()
        self.pool = pool if pool is not None else ReplicaPool(
            engine, clock=clock, faults=faults, policy=self.fault_policy,
            tracer=tracer)
        if pool is not None and tracer is not None and pool.tracer is None:
            # a caller-built pool joins the batcher's trace unless it
            # already carries its own tracer
            pool.tracer = tracer
        self._brownout = BrownoutController(self.fault_policy, tracer=tracer)
        self.greedy_when_idle = greedy_when_idle
        if interval_s is None:
            interval_s = dataflow.interval_seconds(engine.schedule, cache=cache,
                                                   device=engine.device)
        self.interval_s = float(interval_s)
        # flush budget per bucket: the wall-clock the engine needs to stream
        # that bucket (n_micro bursts at one interval each), padded by a
        # safety factor for dispatch overhead -- when a request's deadline
        # slack shrinks to this, the batch must leave NOW to meet its SLO.
        self.budgets = {b: engine.plan(b).n_micro * self.interval_s * safety
                        for b in self.buckets}
        self._inflight: list[_Flight] = []
        # retry buffer: (not_before, entries, xs) batches awaiting
        # re-dispatch after a failed / timed-out / corrupted launch
        self._retry: collections.deque[tuple[float, list[Entry], np.ndarray]] = (
            collections.deque())
        # bounded like every other buffer in the system: results a client
        # never collects evict oldest-first once result_capacity is reached
        # (the abandoned-rid leak guard; metrics' reservoir bounds the same
        # way), so a long-running server's memory stays flat
        self.result_capacity = result_capacity
        self.results: dict[int, CompletedRequest] = {}
        self.shed: list[int] = []
        self._depth_emitted: int | None = None  # last queue_depth counter sample

    def warmup(self) -> "ContinuousBatcher":
        """Run every bucket shape on every replica once (startup cost,
        never paid inside the serving loop)."""
        self.pool.warmup(self.buckets)
        return self

    # ------------------------------------------------------------ admission
    def submit(self, x, *, deadline: float | None = None,
               now: float | None = None, tier: str = GOLD) -> int:
        """Validate + enqueue one sample; returns its request id."""
        if tier == BEST_EFFORT and self._brownout.shedding_best_effort:
            return self._shed_at_door(1, deadline, now)[0]
        try:
            rid = self.queue.admit(x, deadline=deadline, now=now, tier=tier)
        except QueueFull:
            self.metrics.count("rejected")
            if self.tracer is not None:
                self.tracer.instant("reject", cat="request", tier=tier)
            raise
        self.metrics.count("requests")
        if self.tracer is not None:
            self.tracer.begin_async("request", rid, cat="request", tier=tier)
        self._note_shed(now)
        self.metrics.observe_depth(self.queue.depth)
        return rid

    def submit_batch(self, xs, *, deadline: float | None = None,
                     now: float | None = None, tier: str = GOLD) -> list[int]:
        """Enqueue a (B, *spec.shape) batch as one block; per-sample rids."""
        if tier == BEST_EFFORT and self._brownout.shedding_best_effort:
            return self._shed_at_door(np.asarray(xs).shape[0], deadline, now)
        try:
            rids = self.queue.admit_batch(xs, deadline=deadline, now=now,
                                          tier=tier)
        except QueueFull:
            self.metrics.count("rejected", np.asarray(xs).shape[0])
            if self.tracer is not None:
                self.tracer.instant("reject", cat="request", tier=tier,
                                    n=int(np.asarray(xs).shape[0]))
            raise
        self.metrics.count("requests", len(rids))
        if self.tracer is not None:
            for rid in rids:
                self.tracer.begin_async("request", rid, cat="request",
                                        tier=tier)
        self._note_shed(now)
        self.metrics.observe_depth(self.queue.depth)
        return rids

    def _shed_at_door(self, n: int, deadline: float | None,
                      now: float | None) -> list[int]:
        """Brownout: best-effort arrivals get real rids but resolve as shed
        immediately (admission tiering -- gold capacity is protected)."""
        now = self._clock() if now is None else now
        rids = self.queue.take_rids(n)
        dl = deadline if deadline is not None else np.inf
        for rid in rids:
            if self.tracer is not None:
                self.tracer.begin_async("request", rid, cat="request",
                                        tier=BEST_EFFORT, t=now)
            self._record(CompletedRequest(rid, None, now, now, dl))
        self.shed.extend(rids)
        self.metrics.count("requests", n)
        self.metrics.count("shed", n)
        self.metrics.count("brownout_shed", n)
        return rids

    def _note_shed(self, now: float | None = None) -> None:
        dropped = self.queue.drain_shed()
        if dropped:
            now = self._clock() if now is None else now
            for e in dropped:
                # a shed request resolves with out=None so result waiters
                # terminate instead of spinning on a rid that left the system
                self._record(CompletedRequest(
                    e.rid, None, e.t_submit, now, e.deadline))
            self.shed.extend(e.rid for e in dropped)
            self.metrics.count("shed", len(dropped))

    # -------------------------------------------------------------- buckets
    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"group of {n} exceeds the largest bucket {self.buckets[-1]}; "
            "oversized backlogs split across max-size bucket launches"
        )

    @property
    def active_buckets(self) -> tuple[int, ...]:
        """The bucket grid launches currently size against.  Under severe
        brownout the largest bucket is retired, so each launch is smaller
        and the per-flush latency bound tighter (gold p99 protection)."""
        if self._brownout.shrink_buckets and len(self.buckets) > 1:
            return self.buckets[:-1]
        return self.buckets

    # ------------------------------------------------------------- dispatch
    def _pad(self, xs: np.ndarray, n: int) -> np.ndarray:
        bucket = self.bucket_for(n)
        pad = bucket - n
        if pad:
            xs = np.concatenate([xs, np.zeros((pad, *xs.shape[1:]), xs.dtype)])
        return xs

    def _dispatch(self, entries: list[Entry], xs: np.ndarray,
                  now: float | None = None) -> _Flight | None:
        """One launch attempt; on dispatch failure the batch re-enqueues
        for retry (or sheds) -- entries are never dropped."""
        bucket = self.bucket_for(len(entries))
        padded = self._pad(xs, len(entries))
        try:
            if self.tracer is None:
                pending = self.pool.dispatch(padded, entries,
                                             n_valid=len(entries))
            else:
                with self.tracer.span("dispatch", cat="serving",
                                      bucket=bucket, n=len(entries)) as sp:
                    pending = self.pool.dispatch(padded, entries,
                                                 n_valid=len(entries))
                    sp.args["replica"] = pending.replica.index
        except (DispatchError, NoHealthyReplicas) as e:
            self.metrics.count("dispatch_failures")
            if self.tracer is not None:
                self.tracer.instant("dispatch_failure", cat="serving",
                                    bucket=bucket, n=len(entries),
                                    replica=getattr(e, "replica", None))
            self._requeue(entries, xs, self._clock() if now is None else now)
            return None
        flight = _Flight(entries, xs, pending)
        self._inflight.append(flight)
        self.metrics.count("flushes")
        self.metrics.count("padded_samples", bucket - len(entries))
        self.metrics.count("dispatched_samples", bucket)
        self.metrics.observe_depth(self.queue.depth)
        return flight

    def _launch(self, n: int, now: float | None = None) -> _Flight | None:
        entries, xs = self.queue.pop(n)
        if not entries:
            return None
        return self._dispatch(entries, xs, now)

    def _requeue(self, entries: list[Entry], xs: np.ndarray,
                 now: float) -> None:
        """Failed-launch recovery: bump each entry's attempt count, shed
        what is out of budget or past deadline, buffer the rest for a
        backed-off re-dispatch."""
        policy = self.fault_policy
        keep_entries: list[Entry] = []
        keep_rows: list[int] = []
        for i, e in enumerate(entries):
            e = dataclasses.replace(e, attempts=e.attempts + 1)
            # deadline-aware: a retry that cannot land before the request's
            # deadline is pointless -- complete as shed instead
            if (e.attempts > policy.max_retries or now >= e.deadline):
                self._record(CompletedRequest(
                    e.rid, None, e.t_submit, now, e.deadline))
                self.shed.append(e.rid)
                self.metrics.count("shed")
            else:
                keep_entries.append(e)
                keep_rows.append(i)
        if not keep_entries:
            return
        attempts = min(e.attempts for e in keep_entries)
        backoff = policy.retry_backoff_s * (2 ** (attempts - 1))
        self._retry.append((now + backoff, keep_entries, xs[keep_rows]))
        self.metrics.count("retries", len(keep_entries))
        if self.tracer is not None:
            self.tracer.instant("retry", cat="serving", n=len(keep_entries),
                                attempts=attempts, backoff_s=backoff)

    def _launch_retries(self, now: float) -> None:
        """Re-dispatch every retry batch whose backoff has elapsed."""
        n = len(self._retry)
        for _ in range(n):
            not_before, entries, xs = self._retry.popleft()
            if now >= not_before:
                self._dispatch(entries, xs, now)
            else:
                self._retry.append((not_before, entries, xs))

    # -------------------------------------------------------------- harvest
    def _complete(self, flight: _Flight, ys: np.ndarray, now: float) -> list[int]:
        done = []
        for entry, y in zip(flight.entries, ys):
            self._record(CompletedRequest(
                entry.rid, y, entry.t_submit, now, entry.deadline))
            self.metrics.observe_latency(now - entry.t_submit, now=now)
            if now > entry.deadline:
                self.metrics.count("deadline_misses")
            done.append(entry.rid)
        return done

    def _abandon_loser(self, loser: PendingBatch, now: float) -> None:
        """Drop the losing side of a hedge race; if it had already blown
        the dispatch timeout (a hang the hedge papered over), quarantine
        its replica too."""
        t = self.fault_policy.dispatch_timeout_s
        if (self.fault_policy.enabled and t is not None
                and loser.age(now) > t):
            self.pool.quarantine(loser.replica, "timed out (lost hedge race)")
        # the loser's true duration is unobservable from here on; its age is
        # a censored lower bound the drift monitor can still learn from
        self._drift_censored(loser, now)
        loser.abandon()

    # ------------------------------------------------------- drift plumbing
    def _predicted_s(self, pending: PendingBatch) -> float:
        """Cycle-model prediction for one launch: the plan's microbatch
        count times the calibrated steady-state interval -- the same
        arithmetic the flush budgets use (without the safety factor)."""
        return max(pending.plan.n_micro, 1) * self.interval_s

    def _drift_censored(self, pending: PendingBatch, now: float) -> None:
        if self.drift is not None:
            self.drift.observe(f"replica:{pending.replica.index}",
                               pending.age(now),
                               predicted_s=self._predicted_s(pending),
                               censored=True)

    def _maybe_hedge(self, flight: _Flight, now: float) -> None:
        if flight.hedge is not None or len(self.pool) < 2:
            return
        delay = self.fault_policy.hedge_delay(
            flight.primary.replica.health.latency.ewma)
        if delay is None or flight.primary.age(now) <= delay:
            return
        try:
            flight.hedge = self.pool.dispatch(
                self._pad(flight.xs, len(flight.entries)), flight.entries,
                n_valid=len(flight.entries),
                exclude=(flight.primary.replica.index,))
            self.metrics.count("hedges")
            if self.tracer is not None:
                self.tracer.instant(
                    "hedge", cat="serving",
                    primary=flight.primary.replica.index,
                    hedge=flight.hedge.replica.index,
                    primary_age_s=flight.primary.age(now))
            # hedge-worthiness itself is drift evidence: the primary has
            # already run ``delay`` without resolving, a censored bound
            self._drift_censored(flight.primary, now)
        except (DispatchError, NoHealthyReplicas):
            self.metrics.count("dispatch_failures")

    def _check(self, ys: np.ndarray) -> str | None:
        if not (self.fault_policy.enabled and self.fault_policy.integrity):
            return None
        return faults_mod.check_integrity(
            ys, dtype=self.pool.output_dtype,
            value_range=self.pool.output_range)

    def _harvest_once(self, done: list[int], now: float) -> bool:
        """One pass over the in-flight launches; returns True if any
        flight made progress (resolved, timed out, or was requeued)."""
        policy = self.fault_policy
        timeout = policy.dispatch_timeout_s if policy.enabled else None
        progressed = False
        still: list[_Flight] = []
        for flight in self._inflight:
            resolved = False
            # first ready result wins the (possibly hedged) race
            for pending in flight.pendings():
                if not pending.ready(now):
                    continue
                if self.tracer is None:
                    ys = pending.resolve()
                else:
                    with self.tracer.span(
                            "resolve", cat="serving",
                            replica=pending.replica.index,
                            n=len(flight.entries),
                            hedged=pending is flight.hedge):
                        ys = pending.resolve()
                latency = now - pending.t_dispatch
                if self.drift is not None:
                    self.drift.observe(f"replica:{pending.replica.index}",
                                       latency,
                                       predicted_s=self._predicted_s(pending))
                reason = self._check(ys)
                if reason is None:
                    self.pool.note_result(pending, latency, ok=True)
                    if pending is flight.hedge:
                        self.metrics.count("hedge_wins")
                    for other in flight.pendings():
                        if other is not pending:
                            self._abandon_loser(other, now)
                    done.extend(self._complete(flight, ys, now))
                    resolved = progressed = True
                    break
                # corrupted batch: quarantine the replica, never deliver
                self.metrics.count("corrupt_batches")
                if self.tracer is not None:
                    self.tracer.instant("corrupt_batch", cat="serving",
                                        replica=pending.replica.index,
                                        reason=reason)
                self.pool.note_result(pending, latency, ok=False,
                                      reason=f"integrity: {reason}")
                progressed = True
                if pending is flight.primary and flight.hedge is not None:
                    flight.primary, flight.hedge = flight.hedge, None
                elif pending is flight.hedge:
                    flight.hedge = None
                else:
                    # no twin racing: re-execute on a healthy replica
                    self._requeue(flight.entries, flight.xs, now)
                    resolved = True
                break
            if resolved:
                continue
            # dispatch timeout: a hung launch quarantines its replica and
            # the batch re-dispatches -- harvest can never block forever
            if timeout is not None and flight.pendings() and all(
                    p.age(now) > timeout for p in flight.pendings()):
                for p in flight.pendings():
                    self.pool.quarantine(
                        p.replica,
                        f"dispatch timed out after {timeout:.3g}s")
                    # the hang's duration is unbounded; its age at timeout
                    # is the censored lower bound we get to keep
                    self._drift_censored(p, now)
                    p.abandon()
                self.metrics.count("timeouts")
                if self.tracer is not None:
                    self.tracer.instant(
                        "timeout", cat="serving", timeout_s=timeout,
                        replicas=[p.replica.index
                                  for p in flight.pendings()])
                self._requeue(flight.entries, flight.xs, now)
                progressed = True
                continue
            self._maybe_hedge(flight, now)
            still.append(flight)
        self._inflight = still
        return progressed

    def harvest(self, *, block: bool = False, timeout: float | None = None,
                now: float | None = None) -> list[int]:
        """Collect finished launches; non-blocking unless ``block``.

        ``timeout`` (with ``block=True``) bounds the wait: expiry raises
        :class:`TimeoutError` naming the replica(s) still holding work --
        the un-hardened failure mode this replaces was an unbounded block
        on a hung replica.
        """
        done: list[int] = []
        t_end = None if timeout is None else self._clock() + timeout
        while True:
            # blocking waits must advance real time even under a caller-
            # supplied (fake) now, or an un-ready flight would spin forever
            t = now if (now is not None and not block) else self._clock()
            self._harvest_once(done, t)
            if not block or not self._inflight:
                return done
            if t_end is not None and self._clock() >= t_end:
                stuck = sorted({p.replica.index for f in self._inflight
                                for p in f.pendings()})
                raise TimeoutError(
                    f"harvest timed out after {timeout:.3g}s with "
                    f"{len(self._inflight)} launch(es) still un-resolved on "
                    f"replica(s) {stuck} -- likely hung; quarantine via "
                    f"FaultPolicy.dispatch_timeout_s recovers automatically")
            time.sleep(_TICK_S)

    def poll(self, now: float | None = None) -> list[int]:
        """One non-blocking serving step: harvest, maintain health, then
        flush what's due.

        Full buckets always ship; a partial bucket ships when every replica
        is idle (``greedy_when_idle``) or when the oldest request's deadline
        slack has shrunk to the bucket's flush budget.  Quarantined
        replicas get their due canary probes, ripe retry batches re-launch,
        and the brownout controller advances.  Returns the rids completed
        this step (their results are in :attr:`results`).
        """
        now = self._clock() if now is None else now
        done = self.harvest(now=now)
        self._note_shed(now)
        self._maintain(now)
        self._launch_retries(now)
        top = self.active_buckets[-1]
        while self.queue.depth >= top:
            self._launch(top, now)
        depth = self.queue.depth
        if depth:
            # the tightest deadline anywhere in the queue, not the FIFO
            # head's: a later arrival may carry an urgent override, and the
            # launch drains the whole (FIFO) backlog up to it anyway
            slack = self.queue.min_deadline() - now
            if ((self.greedy_when_idle and self.pool.idle)
                    or slack <= self.budgets[self.bucket_for(min(depth, top))]):
                self._launch(min(depth, top), now)
        return done

    def _maintain(self, now: float) -> None:
        """Health upkeep: canary probes for due quarantined replicas, pool
        counter sync, and one brownout-controller tick."""
        if self.tracer is not None:
            # change-triggered counter track (not per-tick: a busy poll loop
            # would otherwise flood the bounded trace buffer with no-ops)
            depth = self.queue.depth
            if depth != self._depth_emitted:
                self.tracer.counter("queue_depth", depth, cat="serving")
                self._depth_emitted = depth
        if not self.fault_policy.enabled:
            return
        self.pool.maintain(now)
        # the pool is the single source of truth for its own lifecycle
        # counters; mirror them instead of double-counting
        self.metrics.counters["quarantines"] = self.pool.quarantines
        self.metrics.counters["probes"] = self.pool.probes
        self.metrics.counters["recoveries"] = self.pool.recoveries
        self.metrics.observe_health(self.pool.healthy_count, len(self.pool))
        before = self._brownout.level
        level = self._brownout.update(
            healthy_frac=self.pool.healthy_frac,
            depth_frac=self.queue.depth / self.queue.capacity, now=now)
        self.metrics.observe_brownout(level)
        if level >= 1 and before < 1:
            # entering brownout: queued best-effort work goes first
            dropped = self.queue.shed_tier(BEST_EFFORT)
            if dropped:
                self.metrics.count("brownout_shed", dropped)
                self._note_shed(now)

    def flush_all(self) -> None:
        """Launch every queued request immediately (bucket-split)."""
        while self.queue.depth:
            if self._launch(min(self.queue.depth, self.buckets[-1])) is None:
                break  # dispatch failed; entries moved to the retry buffer

    def drain(self, timeout: float | None = None) -> list[int]:
        """Flush and resolve everything outstanding (blocking).

        ``timeout`` bounds the whole drain; expiry raises
        :class:`TimeoutError` naming any stuck replica.  Retry backoffs
        are honored (the drain sleeps until the next batch is ripe).
        """
        done: list[int] = []
        t_end = None if timeout is None else self._clock() + timeout
        while self.queue.depth or self._inflight or self._retry:
            now = self._clock()
            if t_end is not None and now >= t_end:
                stuck = sorted({p.replica.index for f in self._inflight
                                for p in f.pendings()})
                raise TimeoutError(
                    f"drain timed out after {timeout:.3g}s with "
                    f"{self.outstanding} request(s) outstanding"
                    + (f" on replica(s) {stuck}" if stuck else ""))
            self._launch_retries(now)
            self.flush_all()
            if self._inflight:
                remaining = None if t_end is None else max(t_end - self._clock(), 1e-9)
                done.extend(self.harvest(block=True, timeout=remaining))
            self._note_shed()
            self._maintain(self._clock())
            if self._retry and not self._inflight and not self.queue.depth:
                ripe_at = min(nb for nb, _, _ in self._retry)
                wait = ripe_at - self._clock()
                if wait > 0:
                    time.sleep(min(wait, _TICK_S * 10))
        self._note_shed()
        return done

    # --------------------------------------------------------------- results
    def _record(self, req: CompletedRequest) -> None:
        if self.tracer is not None:
            self.tracer.end_async("request", req.rid, cat="request",
                                  t=req.t_done, shed=req.shed,
                                  missed_deadline=bool(req.missed_deadline))
        self.results[req.rid] = req
        while len(self.results) > self.result_capacity:
            self.results.pop(next(iter(self.results)))  # evict oldest

    @property
    def outstanding(self) -> int:
        """Samples admitted but not yet resolved (queued + in flight +
        awaiting retry)."""
        return (self.queue.depth
                + sum(len(f.entries) for f in self._inflight)
                + sum(len(e) for _, e, _ in self._retry))

    def pop_result(self, rid: int) -> CompletedRequest | None:
        return self.results.pop(rid, None)
