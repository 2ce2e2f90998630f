"""Multi-replica engine pool: least-loaded async dispatch over devices.

The paper scales one dataflow build across SLRs/FPGAs by replication; the
runtime analog keeps the fused engine's parameters resident on every
replica's device (a ``.to(device)`` copy once, at pool construction; a
replica on the engine's own device shares the engine's tensors) and
dispatches bucket batches to the least-loaded replica.  A launch on the
card is asynchronous: ``dispatch`` returns once the stage chain's kernels
are enqueued on the device's current stream and a ``torch.cuda.Event`` is
recorded behind them, so the host thread goes straight back to admitting
requests -- blocking happens only at result *resolution*
(``PendingBatch.resolve`` synchronises the event and copies the valid rows
to the host), and ``PendingBatch.ready`` polls the event without blocking.
On the CPU the work is done when ``dispatch`` returns.

Hardened (this layer is where the serving failure model lives):

* every replica carries a :class:`~repro_torch.serving.health.ReplicaHealth`
  state machine; ``pick`` skips quarantined replicas,
* an optional :class:`~repro_torch.serving.faults.FaultPlan` injects
  dispatch exceptions, output corruption, stragglers, hangs and replica
  death on a reproducible schedule (the chaos-test substrate),
* quarantined replicas are re-probed on capped exponential backoff with a
  **golden canary** whose expected output is bit-exact from the engine
  (``maintain``), and
* ``note_result`` feeds resolve latencies into the shared trailing-median
  straggler detector.

A launch that raises is a replica failure (recorded, then re-raised as
:class:`DispatchError` for the batcher to retry elsewhere): that is the
serving semantics, and no path reruns a batch on a kernel's plain version.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.serving import faults as faults_mod
from repro_torch.serving.faults import DispatchError, FaultPlan
from repro_torch.serving.health import QUARANTINED, FaultPolicy, ReplicaHealth
from repro_torch.serving.queue import Entry


@dataclasses.dataclass
class Replica:
    index: int
    device: torch.device
    params: list  # the engine's stage parameters, resident on ``device``
    inflight: int = 0
    dispatched: int = 0
    health: ReplicaHealth | None = None


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PendingBatch:
    """One in-flight engine launch: an un-synchronised output tensor, the
    CUDA event recorded behind it (None on the CPU) + bookkeeping.

    Injected faults ride along: a ``straggle`` withholds readiness for its
    delay, a ``hang`` never becomes ready (only a dispatch timeout or
    ``abandon`` recovers the batch), and a ``corrupt`` deterministically
    corrupts the resolved copy (the device result itself is untouched --
    the injection models a corrupted readback, not a broken build).
    """

    def __init__(self, out: torch.Tensor, entries: list[Entry], n_valid: int,
                 replica: Replica, plan, t_dispatch: float, *, event=None,
                 fault=None, corrupt_rng=None, clock=time.perf_counter):
        self.out = out
        self.event = event  # torch.cuda.Event after the launch; None on the CPU
        self.entries = entries
        self.n_valid = n_valid  # leading rows that are real samples (rest pad)
        self.replica = replica
        self.plan = plan
        self.t_dispatch = t_dispatch
        self.fault = fault
        self._corrupt_rng = corrupt_rng
        self._clock = clock
        self._resolved: np.ndarray | None = None
        self._abandoned = False

    @property
    def abandoned(self) -> bool:
        return self._abandoned

    def age(self, now: float | None = None) -> float:
        return (self._clock() if now is None else now) - self.t_dispatch

    def ready(self, now: float | None = None) -> bool:
        """True when the device result can be resolved without blocking."""
        if self._resolved is not None:
            return True
        if self._abandoned:
            return False
        if self.fault is not None:
            if self.fault.kind == "hang":
                return False
            if self.fault.kind == "straggle" and self.age(now) < self.fault.delay_s:
                return False
        return True if self.event is None else bool(self.event.query())

    def resolve(self) -> np.ndarray:
        """Block until done; returns the valid (un-padded) output rows."""
        if self._resolved is None:
            if self._abandoned:
                raise RuntimeError(
                    f"batch abandoned on replica {self.replica.index} "
                    "(timed out / superseded); it cannot be resolved")
            if self.fault is not None and self.fault.kind == "hang":
                raise RuntimeError(
                    f"replica {self.replica.index} hung on this dispatch "
                    "(injected); resolve would block forever -- harvest "
                    "with a timeout instead")
            if self.event is not None:
                self.event.synchronize()
            ys = self.out[: self.n_valid].cpu().numpy()
            if self.fault is not None and self.fault.kind == "straggle":
                lag = self.fault.delay_s - self.age()
                if lag > 0:
                    time.sleep(lag)
            if self.fault is not None and self.fault.kind == "corrupt":
                ys = faults_mod.corrupt_array(ys, self._corrupt_rng)
            self._resolved = ys
            self.replica.inflight -= 1
        return self._resolved

    def abandon(self) -> None:
        """Stop tracking this launch (timeout / lost hedge race).  The
        device computation, if real, completes on its own; the replica's
        inflight accounting is released exactly once."""
        if self._resolved is None and not self._abandoned:
            self._abandoned = True
            self.replica.inflight -= 1


class NoHealthyReplicas(RuntimeError):
    """Every replica is quarantined and forced dispatch is disallowed."""


class ReplicaPool:
    """Engine parameters resident on each replica's device, least-loaded
    dispatch.

    ``devices`` may repeat a device: replicas are *logical* (the chaos
    run serves 3 replicas on one card; a host with several cards runs one
    per card).  ``None`` means every visible card for an engine on a CUDA
    device, and the engine's own device for an engine the caller built on
    the CPU.  ``faults`` injects the reproducible chaos schedule;
    ``policy`` configures the health machine (``FaultPolicy.disabled()``
    turns all of it off -- the pre-hardening pool).
    """

    def __init__(self, engine, devices: list | None = None, *,
                 clock=time.perf_counter, faults: FaultPlan | None = None,
                 policy: FaultPolicy | None = None, tracer=None):
        if devices is None:
            home = engine.device
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       if home.type == "cuda" else [home])
        devices = [resolve_device(d) for d in devices]
        if not devices:
            raise ValueError("need at least one device for the replica pool")
        self.engine = engine
        self._clock = clock
        self.policy = policy if policy is not None else FaultPolicy()
        self.faults = faults
        # repro_torch.telemetry.Tracer or None; every emission is guarded so
        # the disabled (None) pool pays one attribute test, nothing more
        self.tracer = tracer
        resident = {d: engine.params_on(d) for d in set(devices)}
        self.replicas = [
            Replica(i, d, resident[d], health=ReplicaHealth(self.policy))
            for i, d in enumerate(devices)
        ]
        self.probes = 0
        self.recoveries = 0
        self.quarantines = 0
        # integrity-guard inputs, precomputed once: the canonical output
        # dtype and the interval-arithmetic value bound of the graph
        self.output_range = (faults_mod.infer_output_range(engine.graph)
                             if self.policy.enabled and self.policy.integrity
                             else None)
        self.output_dtype = None
        self._canary: tuple[np.ndarray, np.ndarray] | None = None

    def __len__(self) -> int:
        return len(self.replicas)

    @property
    def total_inflight(self) -> int:
        return sum(r.inflight for r in self.replicas)

    @property
    def idle(self) -> bool:
        return self.total_inflight == 0

    @property
    def healthy_count(self) -> int:
        return sum(1 for r in self.replicas if r.health.state != QUARANTINED)

    @property
    def healthy_frac(self) -> float:
        return self.healthy_count / len(self.replicas)

    # ----------------------------------------------------------------- pick
    def pick(self, exclude: tuple = ()) -> Replica:
        """Least-loaded usable replica.  Quarantined replicas are skipped;
        when *every* candidate is quarantined the least-loaded one is used
        anyway (dispatching somewhere beats deadlocking the queue) unless
        every replica is excluded."""
        candidates = [r for r in self.replicas if r.index not in exclude]
        if not candidates:
            raise NoHealthyReplicas(
                f"no replica available outside exclude={sorted(exclude)}")
        usable = [r for r in candidates if r.health.usable]
        pool = usable if usable else candidates
        # tiebreak on total dispatches: equally-idle replicas round-robin
        # instead of piling onto the lowest index (even wear, and fresh
        # work keeps exercising every replica's health signal)
        return min(pool, key=lambda r: (r.inflight, r.dispatched, r.index))

    # ------------------------------------------------------------- dispatch
    def dispatch(self, xs: np.ndarray, entries: list[Entry],
                 n_valid: int | None = None, *,
                 exclude: tuple = ()) -> PendingBatch:
        """Enqueue one bucket batch on the least-loaded replica (non-blocking).

        Raises :class:`DispatchError` (carrying ``.replica``) on an
        injected or real submit failure; the failure is recorded in the
        replica's health state before raising, so the caller only has to
        retry.
        """
        replica = self.pick(exclude)
        k = replica.dispatched
        fault = None
        if self.faults is not None:
            fault = self.faults.draw(replica.index, k)
            if fault is not None and fault.kind == "die":
                replica.health.dead = True
        replica.dispatched += 1
        if replica.health.dead:
            self._record_failure(replica, "dead")
            raise DispatchError(
                f"replica {replica.index} is dead (injected)",
                replica=replica.index)
        if fault is not None and fault.kind == "error":
            self._record_failure(replica, "dispatch error (injected)")
            raise DispatchError(
                f"injected dispatch failure on replica {replica.index} "
                f"(dispatch #{k})", replica=replica.index)
        try:
            x = torch.from_numpy(np.ascontiguousarray(xs)).to(replica.device)
            # only pass tracer= when live: duck-typed engines (tests
            # monkeypatch dispatch) need not grow the keyword to stay usable
            if self.tracer is None:
                out, plan = self.engine.dispatch(x, params=replica.params)
            else:
                out, plan = self.engine.dispatch(x, params=replica.params,
                                                 tracer=self.tracer)
            event = None
            if replica.device.type == "cuda":
                # behind the launch on the stream the kernels went to
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(replica.device))
        except Exception as e:  # a *real* submit failure
            self._record_failure(replica, f"dispatch raised: {e}")
            raise DispatchError(
                f"dispatch failed on replica {replica.index}: {e}",
                replica=replica.index) from e
        replica.inflight += 1
        corrupt_rng = (self.faults.corruption_rng(replica.index, k)
                       if fault is not None and fault.kind == "corrupt" else None)
        return PendingBatch(out, entries,
                            len(entries) if n_valid is None else n_valid,
                            replica, plan, self._clock(), event=event,
                            fault=fault, corrupt_rng=corrupt_rng,
                            clock=self._clock)

    def _record_failure(self, replica: Replica, reason: str) -> None:
        if not self.policy.enabled:
            return
        before = replica.health.state
        replica.health.record_failure(self._clock(), reason)
        if replica.health.state == QUARANTINED and before != QUARANTINED:
            self.quarantines += 1
            if self.tracer is not None:
                self.tracer.instant("quarantine", cat="health",
                                    replica=replica.index, reason=reason)

    # ------------------------------------------------------- health plumbing
    def note_result(self, pending: PendingBatch, latency_s: float,
                    *, ok: bool, reason: str = "") -> None:
        """Feed one resolved launch back into the replica's health state."""
        if not self.policy.enabled:
            return
        replica = pending.replica
        if ok:
            verdict = replica.health.record_success(latency_s)
            if verdict == "quarantine":
                self.quarantine(replica, "persistent straggler")
        else:
            self.quarantine(replica, reason or "bad result")

    def quarantine(self, replica: Replica, reason: str) -> None:
        if not self.policy.enabled:
            return
        if replica.health.state != QUARANTINED:
            self.quarantines += 1
            if self.tracer is not None:
                self.tracer.instant("quarantine", cat="health",
                                    replica=replica.index, reason=reason)
        replica.health.quarantine(self._clock(), reason)

    # --------------------------------------------------------- canary probes
    def _golden(self) -> tuple[np.ndarray, np.ndarray]:
        """(canary input, bit-exact expected output), computed once from
        the engine's resident (reference) parameters."""
        if self._canary is None:
            from repro_torch.core import autotune

            x = autotune.synth_input(self.engine.graph, 1).numpy()
            out = self.engine(torch.from_numpy(x))
            _synchronize(out.device)
            want = out.cpu().numpy()
            self.output_dtype = want.dtype
            self._canary = (x, want)
        return self._canary

    def probe(self, replica: Replica, *, timeout_s: float | None = None,
              now: float | None = None) -> bool:
        """One golden-canary probe of ``replica``: dispatch the canary
        through the regular (fault-injected) path and require a bit-exact
        match with the engine's reference output."""
        timeout_s = (self.policy.probe_timeout_s if timeout_s is None
                     else timeout_s)
        now = self._clock() if now is None else now
        self.probes += 1
        x, want = self._golden()
        try:
            pending = self.dispatch(x, [], n_valid=1,
                                    exclude=tuple(r.index for r in self.replicas
                                                  if r is not replica))
        except (DispatchError, NoHealthyReplicas):
            recovered = bool(replica.health.note_probe(False, self._clock()))
            if self.tracer is not None:
                self.tracer.instant("probe", cat="health",
                                    replica=replica.index, ok=False,
                                    recovered=recovered)
            return recovered
        deadline = self._clock() + timeout_s
        ok = True
        while not pending.ready():
            if self._clock() >= deadline:
                pending.abandon()
                ok = False
                break
            time.sleep(min(1e-4, timeout_s / 10))
        if ok:
            got = pending.resolve()
            ok = bool(np.array_equal(got, want))
        recovered = replica.health.note_probe(ok, self._clock())
        if recovered:
            self.recoveries += 1
        if self.tracer is not None:
            self.tracer.instant("probe", cat="health", replica=replica.index,
                                ok=ok, recovered=recovered)
        return recovered

    def maintain(self, now: float | None = None) -> list[dict]:
        """Probe every quarantined replica whose backoff is due; returns
        the probe outcomes (the batcher folds them into its metrics)."""
        if not self.policy.enabled:
            return []
        now = self._clock() if now is None else now
        events = []
        for r in self.replicas:
            if r.health.due_probe(now):
                recovered = self.probe(r, now=now)
                events.append({"replica": r.index, "recovered": recovered})
        return events

    # -------------------------------------------------------------- warmup
    def warmup(self, batch_sizes) -> None:
        """Run the bucket shape grid through the real dispatch path once per
        (bucket, replica), synchronised, at startup: the kernels' first-use
        build, each launch plan's first lookup and, on a CUDA engine, the
        capture of each bucket's graph (one per bucket and resident
        parameter copy, as the JAX pool compiles one program per bucket and
        replica) land here, never inside the serving loop.
        """
        from repro_torch.core import autotune

        for b in sorted(set(batch_sizes)):
            x0 = autotune.synth_input(self.engine.graph, b)
            for r in self.replicas:
                out, _ = self.engine.dispatch(x0.to(r.device), params=r.params)
                _synchronize(out.device)
        if self.policy.enabled:
            # prime the golden canary too: its reference output runs the
            # engine at batch 1, and that must land at startup, not inside
            # the first mid-traffic probe
            self._golden()

    def load(self) -> dict[int, int]:
        """Replica index -> total batches dispatched (load-spread probe)."""
        return {r.index: r.dispatched for r in self.replicas}

    def health_snapshot(self) -> dict:
        return {
            "replicas": {r.index: r.health.snapshot() for r in self.replicas},
            "healthy": self.healthy_count,
            "total": len(self.replicas),
            "quarantines": self.quarantines,
            "probes": self.probes,
            "recoveries": self.recoveries,
        }
