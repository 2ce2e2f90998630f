"""Production serving over :class:`repro_torch.core.engine.FusedEngine`: the
port of the JAX package's ``repro.serving``, module for module.

The paper's dataflow argument made operational: steady-state throughput is
set by the bottleneck stage's initiation interval, small FIFOs absorb
bursts, and nothing is allowed to grow without bound.  The serving layer
honors the same contract at the front door:

* :mod:`repro_torch.serving.queue` -- bounded admission queue with
  backpressure (reject / shed policies), per-request deadlines, SLO tiers,
  and input validation against the engine graph's spec,
* :mod:`repro_torch.serving.batcher` -- continuous batcher whose flush
  policy is derived from the dataflow schedule (flush when a bucket fills,
  when the pipeline is idle, or when the oldest request's deadline slack
  shrinks to one engine flush budget),
* :mod:`repro_torch.serving.pool` -- replica pool (the engine's parameters
  resident on each replica's device, least-loaded dispatch that returns
  once the kernels are enqueued, a CUDA event per launch polled for
  readiness, blocking only at result resolution),
* :mod:`repro_torch.serving.metrics` -- thread-safe p50/p95/p99 latency
  (log-bucketed histogram), throughput + windowed rates, queue-depth,
  padding, fault/retry/hedge/quarantine and availability counters with
  JSON ``snapshot()`` and Prometheus text ``prometheus()`` exposition,
* :mod:`repro_torch.serving.faults` -- deterministic seeded fault injection
  (:class:`FaultPlan`) plus the output integrity guard (the chaos-test
  substrate), and
* :mod:`repro_torch.serving.health` -- replica health state machine
  (healthy -> suspect -> quarantined -> recovered via golden canary
  probes), :class:`FaultPolicy` (retries, timeouts, hedging) and the
  graceful-brownout controller.

Quickstart::

    from repro_torch.build import build

    acc = build(graph, target="serving", device="cuda", ...)  # calibrates
    batcher = acc.serve(batch_buckets=(1, 8, 32, 128), slo_s=0.05)
    rid = batcher.submit(x)            # validated, bounded admission
    while batcher.pop_result(rid) is None:
        batcher.poll()                 # harvest + SLO-aware flushing
    print(batcher.metrics.snapshot())  # p99, throughput, padding overhead

Observability: every component takes ``tracer=None`` (a
:class:`repro_torch.telemetry.Tracer`) and the batcher takes
``drift=None`` (a :class:`repro_torch.telemetry.DriftMonitor`, e.g.
``acc.drift_monitor()``); with both wired a run yields a Chrome trace of
the full request lifecycle -- admit, dispatch, resolve, retries, hedges,
quarantines as annotated events -- plus live measured-vs-predicted
cycle-model drift per replica.  ``None`` costs one identity test per site.

The JAX package's deprecated ``repro.launch.serve.EngineServer`` shim is
ported as :class:`repro_torch.launch.serve.EngineServer`, a thin
manual-flush front end over :class:`ContinuousBatcher`.
"""

from repro_torch.serving.batcher import (
    CompletedRequest,
    ContinuousBatcher,
    calibrate_cycle_time,
)
from repro_torch.serving.faults import (
    DispatchError,
    FaultEvent,
    FaultPlan,
    IntegrityError,
    check_integrity,
    infer_output_range,
)
from repro_torch.serving.health import (
    BEST_EFFORT,
    GOLD,
    TIERS,
    BrownoutController,
    FaultPolicy,
    ReplicaHealth,
)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.pool import (
    NoHealthyReplicas,
    PendingBatch,
    Replica,
    ReplicaPool,
)
from repro_torch.serving.queue import (
    AdmissionQueue,
    Block,
    Entry,
    InputSpec,
    QueueFull,
)

__all__ = [
    "AdmissionQueue",
    "BEST_EFFORT",
    "Block",
    "BrownoutController",
    "CompletedRequest",
    "ContinuousBatcher",
    "DispatchError",
    "Entry",
    "FaultEvent",
    "FaultPlan",
    "FaultPolicy",
    "GOLD",
    "InputSpec",
    "IntegrityError",
    "NoHealthyReplicas",
    "PendingBatch",
    "QueueFull",
    "Replica",
    "ReplicaHealth",
    "ReplicaPool",
    "ServingMetrics",
    "TIERS",
    "calibrate_cycle_time",
    "check_integrity",
    "infer_output_range",
]
