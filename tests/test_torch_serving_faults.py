"""The port's self-healing serving path against the JAX package's, on the CPU.

Mirrors ``tests/test_serving_faults.py``: injected dispatch failures,
hangs, stragglers, corruption and replica death against the hardened
``ContinuousBatcher`` + ``ReplicaPool`` over logical replicas on one
device, and the A/B contract that ``FaultPolicy.disabled()`` reproduces
the pre-hardening behaviour (minus silently dropped rids).  Where a
scenario does not depend on wall-clock time it runs through both packages
(``scenario(pkg)``) and their outputs and counters must be identical.  The
hedging case runs on the pool's injected ``clock=``: the hedge must win
before the straggler's delay has passed on that clock, so no test sleeps
past a deadline.  A seeded chaos run (error, straggle and corrupt rates,
one replica death) over three replicas resolves every request, bit-exact
or counted shed.
"""

import time

import jax
import numpy as np
import pytest
import torch

from repro_torch.build import build as tbuild
from repro_torch.serving import FaultEvent, FaultPlan, FaultPolicy
from repro_torch.serving.health import QUARANTINED
from test_torch_serving import JAX, TORCH, _mlp, assert_same, both, samples, stream


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(pkg, policy, faults=None, *, n_replicas=2, buckets=(1, 4, 8), mode="standard",
           **kw):
    """Engine + batcher over ``n_replicas`` LOGICAL replicas on one device
    (the chaos substrate -- fault schedules are per logical replica).
    ``policy`` and ``faults`` are the port's; the JAX arm gets its own
    from their JSON."""
    S = pkg.serving
    engine = pkg.Engine(_mlp(pkg, mode, bn=False))
    if pkg is JAX:
        d = jax.local_devices()[0]
        policy = S.FaultPolicy(**{f: getattr(policy, f) for f in policy.__dataclass_fields__})
        faults = None if faults is None else S.FaultPlan.from_json(faults.to_json())
    else:
        d = torch.device("cpu")
    pool = S.ReplicaPool(engine, devices=[d] * n_replicas, faults=faults, policy=policy,
                         clock=kw.get("clock", time.perf_counter))
    batcher = S.ContinuousBatcher(engine, batch_buckets=buckets, pool=pool,
                                  fault_policy=policy, **kw)
    return engine, batcher


def _outputs(batcher, rids):
    return [batcher.results[r].out for r in rids]


COUNTERS = ("dispatch_failures", "retries", "shed", "completed", "timeouts",
            "corrupt_batches", "quarantines", "hedges", "hedge_wins")


def _counters(batcher):
    return {k: batcher.metrics.counters[k] for k in COUNTERS}


# ------------------------------------------------------------ no rid dropped
def test_injected_dispatch_failure_retries_to_completion():
    plan = FaultPlan(seed=0, events=[FaultEvent("error", replica=0, at_dispatch=0)])
    xs = samples(8)

    def scenario(pkg):
        engine, batcher = _setup(pkg, FaultPolicy(max_retries=2), plan)
        rids = batcher.submit_batch(xs)
        batcher.drain(timeout=60)
        got = np.stack(_outputs(batcher, rids))
        assert_same(got, pkg.run(engine, xs))
        return got, _counters(batcher)

    _, c = both(scenario)
    assert c["dispatch_failures"] == 1 and c["retries"] == 8
    assert c["completed"] == 8 and c["shed"] == 0


def test_real_dispatch_exception_does_not_lose_the_batch():
    xs = samples(4)

    def scenario(pkg):
        engine, batcher = _setup(pkg, FaultPolicy(max_retries=2), n_replicas=1)
        real, tripped = engine.dispatch, {"n": 0}

        def flaky(x, params=None):
            if tripped["n"] == 0:
                tripped["n"] += 1
                raise RuntimeError("transient device error")
            return real(x, params=params)

        engine.dispatch = flaky
        rids = batcher.submit_batch(xs)
        batcher.drain(timeout=60)
        got = np.stack(_outputs(batcher, rids))
        assert_same(got, pkg.run(engine, xs))
        return got, batcher.metrics.counters["dispatch_failures"]

    assert both(scenario)[1] == 1


@pytest.mark.parametrize("policy", ["enabled", "disabled"])
def test_failed_dispatches_resolve_as_shed_never_dropped(policy):
    pol = FaultPolicy(max_retries=1) if policy == "enabled" else FaultPolicy.disabled()
    plan = FaultPlan(seed=1 if policy == "enabled" else 2, rates={"error": 1.0})

    def scenario(pkg):
        _, batcher = _setup(pkg, pol, plan)
        rids = batcher.submit_batch(samples(8))
        batcher.drain(timeout=60)
        assert sorted(batcher.results) == rids
        assert all(batcher.results[r].shed for r in rids)
        return _counters(batcher), batcher.metrics.availability()

    c, availability = both(scenario)
    assert c["completed"] == 0 and availability == 0.0
    assert c["retries"] == (8 if policy == "enabled" else 0)


# ---------------------------------------------------- harvest/drain timeouts
def test_harvest_timeout_names_the_hung_replica():
    plan = FaultPlan(seed=0, events=[FaultEvent("hang", replica=0, at_dispatch=0)])
    _, batcher = _setup(TORCH, FaultPolicy(dispatch_timeout_s=None), plan, n_replicas=1)
    batcher.submit_batch(samples(4))
    batcher.flush_all()
    with pytest.raises(TimeoutError, match=r"replica\(s\) \[0\]"):
        batcher.harvest(block=True, timeout=0.05)


def test_drain_timeout_bounds_a_hung_replica():
    plan = FaultPlan(seed=0, events=[FaultEvent("hang", replica=0, at_dispatch=0)])
    _, batcher = _setup(TORCH, FaultPolicy(dispatch_timeout_s=None), plan, n_replicas=1)
    batcher.submit_batch(samples(4))
    with pytest.raises(TimeoutError):
        batcher.drain(timeout=0.05)


def test_dispatch_timeout_quarantines_and_redispatches():
    plan = FaultPlan(seed=0, events=[FaultEvent("hang", replica=0, at_dispatch=0)])
    xs = samples(8)

    def scenario(pkg):
        engine, batcher = _setup(
            pkg, FaultPolicy(dispatch_timeout_s=0.05, probe_backoff_s=100.0), plan)
        rids = batcher.submit_batch(xs)
        batcher.drain(timeout=60)
        got = np.stack(_outputs(batcher, rids))
        assert_same(got, pkg.run(engine, xs))
        assert batcher.pool.replicas[0].health.state == QUARANTINED
        return got, _counters(batcher)

    c = both(scenario)[1]
    assert c["timeouts"] == 1 and c["quarantines"] >= 1


# ----------------------------------------------------------------- hedging
class Clock:
    """An injected clock that moves only when the test moves it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_hedged_dispatch_first_bit_exact_result_wins_on_an_injected_clock():
    """The straggling primary (0.5 s on the pool's clock) is hedged after
    0.02 s; the hedge resolves while the clock still reads 0.03 s."""
    plan = FaultPlan(seed=0, events=[
        FaultEvent("straggle", replica=0, at_dispatch=0, delay_s=0.5)])
    xs = samples(8)

    def scenario(pkg):
        clock = Clock()
        engine, batcher = _setup(
            pkg, FaultPolicy(hedging=True, hedge_after_s=0.02, dispatch_timeout_s=None),
            plan, clock=clock)
        rids = batcher.submit_batch(xs)
        batcher.flush_all()
        clock.t = 0.03
        t_end = time.perf_counter() + 60
        while batcher.outstanding and time.perf_counter() < t_end:
            batcher.harvest(now=clock.t)
        assert clock.t < 0.5 and batcher.outstanding == 0
        got = np.stack(_outputs(batcher, rids))
        assert_same(got, pkg.run(engine, xs))
        return got, _counters(batcher), batcher.results[rids[0]].t_done

    _, c, t_done = both(scenario)
    assert c["hedges"] == 1 and c["hedge_wins"] == 1 and t_done == 0.03


# --------------------------------------------------------- integrity guard
@pytest.mark.parametrize("mode", ["standard", "binary", "xnor"])
def test_corrupted_batch_quarantines_and_reexecutes_bit_exact(mode):
    plan = FaultPlan(seed=0, events=[FaultEvent("corrupt", replica=0, at_dispatch=0)])
    xs = samples(8, mode)

    def scenario(pkg):
        engine, batcher = _setup(pkg, FaultPolicy(probe_backoff_s=100.0), plan, mode=mode)
        rids = batcher.submit_batch(xs)
        batcher.drain(timeout=60)
        got = np.stack(_outputs(batcher, rids))
        assert_same(got, pkg.run(engine, xs))
        reason = batcher.pool.replicas[0].health.quarantine_reason
        return got, _counters(batcher), reason

    _, c, reason = both(scenario)
    assert c["corrupt_batches"] == 1 and c["quarantines"] == 1
    assert reason.startswith("integrity")


def test_disabled_policy_delivers_the_corruption_baseline():
    plan = FaultPlan(seed=0, events=[FaultEvent("corrupt", replica=0, at_dispatch=0)])
    xs = samples(4)

    def scenario(pkg):
        engine, batcher = _setup(pkg, FaultPolicy.disabled(), plan, n_replicas=1)
        rids = batcher.submit_batch(xs)
        batcher.drain(timeout=60)
        got = np.stack(_outputs(batcher, rids))
        assert not np.array_equal(got, pkg.run(engine, xs))  # corrupted, delivered
        return got

    both(scenario)


# ------------------------------------------------------------ replica death
def test_replica_death_fails_over_and_completes():
    plan = FaultPlan(seed=0, events=[FaultEvent("die", replica=0, at_dispatch=0)])
    xs = samples(12)

    def scenario(pkg):
        engine, batcher = _setup(pkg, FaultPolicy(max_retries=3, probe_backoff_s=100.0),
                                 plan)
        rids = batcher.submit_batch(xs)
        batcher.drain(timeout=60)
        got = np.stack(_outputs(batcher, rids))
        assert_same(got, pkg.run(engine, xs))
        assert batcher.pool.replicas[0].health.dead
        return got, _counters(batcher)

    both(scenario)


# ------------------------------------------------------------ canary probes
def test_canary_probe_recovers_a_transiently_failing_replica():
    plan = FaultPlan(seed=0, events=[
        FaultEvent("error", replica=0, at_dispatch=k) for k in range(3)])
    engine, batcher = _setup(TORCH, FaultPolicy(max_retries=2, probe_backoff_s=0.01),
                             plan, n_replicas=1)
    rid = batcher.submit(samples(1)[0])
    batcher.drain(timeout=60)
    assert batcher.results[rid].shed  # all three attempts hit the fault
    pool = batcher.pool
    t_end = time.perf_counter() + 60
    while not pool.healthy_count and time.perf_counter() < t_end:
        pool.maintain(now=time.perf_counter() + 1.0)  # the backoff has passed
    assert pool.healthy_count == 1 and pool.recoveries == 1 and pool.probes == 1
    assert pool.replicas[0].health.recoveries == 1
    x = samples(2, seed=9)
    rid2 = batcher.submit(x[0])
    batcher.drain(timeout=60)
    assert_same(batcher.results[rid2].out, TORCH.run(engine, x[:1])[0])


def test_deadline_aware_retry_sheds_instead_of_retrying_past_slo():
    plan = FaultPlan(seed=0, events=[FaultEvent("error", replica=0, at_dispatch=0)])

    def scenario(pkg):
        _, batcher = _setup(pkg, FaultPolicy(max_retries=5), plan, n_replicas=1)
        rid = batcher.submit(samples(1)[0], deadline=1.0, now=0.0)
        batcher.poll(now=2.0)  # past the deadline: the launch fails, no retry
        assert batcher.results[rid].shed
        return _counters(batcher)

    c = both(scenario)
    assert c["retries"] == 0 and c["shed"] == 1


# ----------------------------------------------------------------- brownout
def test_brownout_sheds_best_effort_and_shrinks_buckets():
    x = samples(1, seed=7)

    def scenario(pkg):
        S = pkg.serving
        policy = FaultPolicy(probe_backoff_s=100.0, brownout_cooldown_s=100.0)
        engine, batcher = _setup(pkg, policy, buckets=(1, 4, 8))
        be = batcher.submit_batch(samples(2), tier=S.BEST_EFFORT)
        for r in batcher.pool.replicas:
            batcher.pool.quarantine(r, "test")
        batcher.poll()  # healthy_frac 0 -> severe brownout
        assert batcher.metrics.brownout_level == 2 and batcher.active_buckets == (1, 4)
        assert all(batcher.results[r].shed for r in be)
        queued_shed = batcher.metrics.counters["brownout_shed"]
        door = batcher.submit(samples(1)[0], tier=S.BEST_EFFORT)
        assert batcher.results[door].shed
        gold = batcher.submit(x[0])
        assert batcher.queue.depth == 1
        batcher.drain(timeout=60)  # full quarantine: fallback dispatch serves gold
        assert_same(batcher.results[gold].out, pkg.run(engine, x)[0])
        return batcher.results[gold].out, queued_shed, batcher.metrics.counters["brownout_shed"]

    assert both(scenario)[1:] == (2, 3)


# --------------------------------------------------- zero-overhead-healthy
@pytest.mark.parametrize("mode", ["standard", "binary", "xnor"])
def test_no_faults_means_no_fault_side_effects(mode):
    xs = samples(13, mode)

    def scenario(pkg):
        engine, batcher = _setup(pkg, FaultPolicy(hedging=True), mode=mode)
        rids = batcher.submit_batch(xs)
        batcher.drain(timeout=60)
        got = np.stack(_outputs(batcher, rids))
        assert_same(got, pkg.run(engine, xs))
        c = batcher.metrics.counters
        for key in ("dispatch_failures", "retries", "hedges", "hedge_wins",
                    "timeouts", "corrupt_batches", "quarantines", "probes",
                    "brownout_shed", "shed", "rejected"):
            assert c[key] == 0, key
        assert batcher.metrics.availability() == 1.0
        snap = batcher.pool.health_snapshot()
        assert snap["healthy"] == snap["total"] == 2
        return got

    both(scenario)


def test_pick_skips_quarantined_replicas():
    def scenario(pkg):
        _, batcher = _setup(pkg, FaultPolicy(probe_backoff_s=100.0))
        pool = batcher.pool
        pool.quarantine(pool.replicas[0], "test")
        rids = batcher.submit_batch(samples(8))
        batcher.drain(timeout=60)
        assert all(not batcher.results[r].shed for r in rids)
        return pool.load()

    load = both(scenario)
    assert load[0] == 0 and load[1] > 0


def test_accelerator_serve_plumbs_fault_policy():
    rng = np.random.default_rng(0)
    raw = [TORCH.ir.Node("input", "in", {"shape": (24,), "bits": 2}),
           TORCH.ir.Node("linear", "fc0", {},
                         {"w": torch.from_numpy(rng.normal(0, 0.5, (8, 24)).astype(np.float32))})]
    acc = tbuild(raw, target="engine", verify="off", tune="off", device="cpu")
    b = acc.serve(warmup=False, fault_policy=FaultPolicy.disabled())
    assert not b.fault_policy.enabled and not b.pool.policy.enabled
    b2 = acc.serve(warmup=False)
    assert b2.fault_policy.enabled  # hardened by default


# ------------------------------------------------------------------- chaos
def test_seeded_chaos_run_resolves_every_request():
    """Three replicas, background error / straggle / corrupt rates, one
    replica death (and one error and one corruption at fixed dispatches,
    whatever the rates draw): every rid resolves -- bit-exact or counted shed -- and
    no corrupted row is delivered."""
    plan = FaultPlan(seed=5, rates={"error": 0.1, "straggle": 0.1, "corrupt": 0.1},
                     events=[FaultEvent("die", replica=2, at_dispatch=3),
                             FaultEvent("corrupt", replica=1, at_dispatch=1),
                             FaultEvent("error", replica=0, at_dispatch=2)],
                     straggle_delay_s=0.005)
    xs = samples(256)
    engine, batcher = _setup(TORCH, FaultPolicy(max_retries=3, probe_backoff_s=0.01),
                             plan, n_replicas=3, buckets=(1, 4, 8), queue_capacity=128)
    want = TORCH.run(engine, xs)
    rids = stream(batcher, xs, (1, 17, 32, 5, 64, 1, 100, 36))
    batcher.drain(timeout=120)
    assert sorted(batcher.results) == rids
    shed = [i for i, r in enumerate(rids) if batcher.results[r].shed]
    ok = [i for i in range(len(rids)) if i not in shed]
    assert_same(np.stack([batcher.results[rids[i]].out for i in ok]), want[ok])
    c = batcher.metrics.counters
    assert c["completed"] + c["shed"] == len(rids) and c["shed"] == len(shed)
    assert c["dispatch_failures"] > 0 and c["corrupt_batches"] > 0
    assert batcher.pool.replicas[2].health.dead
