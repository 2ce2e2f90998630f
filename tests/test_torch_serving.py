"""The port's serving (``repro_torch.serving``) against the JAX package's, on
the CPU.

Mirrors ``tests/test_serving.py`` and ``tests/test_queue_property.py``:
bounded admission (validation, backpressure, shed), the continuous batcher
(bit-exactness, bucket accounting, the SLO-aware flush policy on an
injected clock), the replica pool, metrics snapshots, the
cycle-time calibration behind ``dataflow.interval_seconds``, and the
serving part of ``core/autotune`` (keys, cache, ``synth_input``).  Each
scenario runs through both packages on the same numpy-seeded inputs and
graph (``scenario(pkg)``), and the two must give identical answers --
``np.array_equal`` outputs, dtypes too -- in the standard, binary and
xnor datapaths.  The port runs on CPU tensors (the kernels' plain
versions).  The full-width NID standard build is served on the CPU against
its golden digest.  Latencies are timings and are never compared across
packages; no test sleeps past a deadline to pass.
"""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.core import autotune as jautotune, dataflow as jdf, ir as jir, lowering as jlow
from repro.core.engine import FusedEngine as JEngine
from repro_torch.build import BuildError, build as tbuild
from repro_torch.configs import golden as golden_mod, nid_mlp as tnid
from repro_torch.core import autotune as tautotune, dataflow as tdf, ir as tir
from repro_torch.core import lowering as tlow
from repro_torch.core.engine import FusedEngine
from repro_torch.data import nid
from repro_torch.kernels import ops
from repro_torch.telemetry import Tracer
from test_serving import _mlp_graph as _jax_serving_graph, _samples  # tests/ is on sys.path

# mode -> (activation bits, weight bits): the three Fig. 4 datapaths
MODES = {"standard": (2, 4), "binary": (2, 2), "xnor": (1, 1)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(pkg, mode="standard", dims=(24, 16, 8), seed=3, bn=True):
    """``tests/test_serving._mlp_graph`` (``bn=False``:
    ``tests/test_serving_faults._mlp_graph``) in either package and any
    datapath: the same numpy draws in the same order."""
    bits, wbits = MODES[mode]
    Node = pkg.ir.Node
    rng = np.random.default_rng(seed)
    g = [Node("input", "in", {"shape": (dims[0],), "bits": bits})]
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        w = rng.normal(0, 0.5, (n, k)).astype(np.float32)
        g.append(Node("linear", f"fc{i}", {}, {"w": pkg.arr(w)}))
        if i < len(dims) - 2:
            if bn:
                g.append(Node("batchnorm", f"bn{i}", {}, {
                    "gamma": pkg.arr(rng.uniform(0.5, 1.5, n).astype(np.float32)),
                    "beta": pkg.arr(rng.uniform(-0.5, 0.5, n).astype(np.float32)),
                    "mean": pkg.arr(rng.normal(0, 1, n).astype(np.float32)),
                    "var": pkg.arr(rng.uniform(0.5, 2, n).astype(np.float32)),
                }))
            g.append(Node("quant_act", f"act{i}", {"bits": bits, "act_scale": 1.0}))
    return pkg.lowering.finalize(pkg.lowering.lower_to_mvu(
        g, mode=mode, weight_bits=wbits, act_bits=bits))


def _jax_run(engine, xs):
    return np.asarray(engine(jnp.asarray(xs)))


def _torch_run(engine, xs):
    return engine(torch.from_numpy(np.asarray(xs))).numpy()


# each package's serving, engine, IR and lowering, its array constructor and
# how its engine's output reaches numpy
JAX = types.SimpleNamespace(serving=jserving, Engine=JEngine, ir=jir, lowering=jlow,
                            arr=jnp.asarray, run=_jax_run)
TORCH = types.SimpleNamespace(serving=tserving, Engine=FusedEngine, ir=tir, lowering=tlow,
                              arr=torch.from_numpy, run=_torch_run)


def engine_for(pkg, mode="standard", **kw):
    return pkg.Engine(_mlp(pkg, mode, bn=kw.pop("bn", True)), **kw)


def samples(n, mode="standard", seed=0):
    return _samples(n, bits=MODES[mode][0], seed=seed)


def assert_same(got, want):
    """Equal structures; arrays by dtype, shape and value (NaN where the
    other has NaN: a corrupted float row)."""
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
        assert np.array_equal(got, want, equal_nan=got.dtype.kind == "f")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    else:
        assert got == want


def both(scenario):
    """``scenario(pkg)`` through both packages: identical results; returns
    the port's."""
    want, got = scenario(JAX), scenario(TORCH)
    assert_same(got, want)
    return got


def served(batcher, rids):
    return np.stack([batcher.results[r].out for r in rids])


def test_graph_helper_is_the_reference_serving_graph():
    xs = samples(9)
    want = _jax_run(JEngine(_jax_serving_graph()), xs)
    assert_same(_jax_run(engine_for(JAX), xs), want)
    assert_same(_torch_run(engine_for(TORCH), xs), want)


# ---------------------------------------------------------------- admission
def test_input_spec_validates_shape_and_dtype_at_admission():
    def scenario(pkg):
        S = pkg.serving
        spec = S.InputSpec.from_graph(engine_for(pkg).graph)
        assert spec.shape == (24,) and spec.bits == 2
        q = S.AdmissionQueue(spec)
        with pytest.raises(ValueError, match="input spec"):
            q.admit(np.zeros(25, np.int32))
        with pytest.raises(ValueError, match="integer"):
            q.admit(np.zeros(24, np.float32))
        with pytest.raises(ValueError, match="input spec"):
            q.admit_batch(np.zeros((3, 23), np.int32))
        assert q.depth == 0
        q.admit(np.zeros(24, np.int32))
        q.admit(np.zeros(24, np.int64))
        q.admit_batch(np.zeros((2, 24), np.int8))
        entries, xs = q.pop(4)
        return [e.rid for e in entries], xs

    _, xs = both(scenario)
    assert xs.dtype == np.int32


def test_queue_reject_policy_backpressure():
    def scenario(pkg):
        S = pkg.serving
        q = S.AdmissionQueue(S.InputSpec((4,), 2), capacity=4)
        q.admit_batch(np.zeros((4, 4), np.int32))
        with pytest.raises(S.QueueFull, match="full"):
            q.admit(np.zeros(4, np.int32))
        with pytest.raises(ValueError, match="capacity"):
            q.admit_batch(np.zeros((9, 4), np.int32))
        return q.depth

    assert both(scenario) == 4


def test_queue_shed_policy_drops_oldest():
    def scenario(pkg):
        S = pkg.serving
        q = S.AdmissionQueue(S.InputSpec((4,), 2), capacity=4, policy="shed")
        first = q.admit_batch(np.arange(16, dtype=np.int32).reshape(4, 4))
        extra = q.admit_batch(np.zeros((2, 4), np.int32))
        shed = [e.rid for e in q.drain_shed()]
        entries, xs = q.pop(4)
        return first, extra, shed, [e.rid for e in entries], xs

    first, extra, shed, popped, xs = both(scenario)
    assert shed == first[:2] and popped == first[2:] + extra
    np.testing.assert_array_equal(xs[:2], np.arange(16).reshape(4, 4)[2:])


def test_queue_batch_enqueue_is_one_block_without_copies():
    q = tserving.AdmissionQueue(tserving.InputSpec((4,), 2), capacity=64)
    xs = _samples(6, k=4)
    assert q.admit_batch(xs) == list(range(6))
    assert len(q._blocks) == 1 and np.shares_memory(q._blocks[0].xs, xs)
    entries, head = q.pop(4)
    assert [e.rid for e in entries] == [0, 1, 2, 3] and np.shares_memory(head, xs)
    assert [e.rid for e in q.pop(10)[0]] == [4, 5]


def test_queue_deadlines_and_fifo_slack():
    def scenario(pkg):
        S = pkg.serving
        q = S.AdmissionQueue(S.InputSpec((4,), 2), default_slo_s=0.5)
        q.admit(np.zeros(4, np.int32), now=1.0)
        q.admit(np.zeros(4, np.int32), deadline=1.2, now=1.1)
        out = [(q.oldest_deadline(), q.min_deadline())]
        q.pop(1)
        out.append((q.oldest_deadline(), q.min_deadline()))
        q.pop(1)
        out.append((q.oldest_deadline(), q.min_deadline()))
        return out

    assert both(scenario) == [(1.5, 1.2), (1.2, 1.2), (math.inf, math.inf)]


OPS = ("admit", "admit_batch", "pop", "shed_tier", "drain_shed")


def _queue_trace(pkg, policy, capacity, trace):
    """``tests/test_queue_property._run_trace`` in either package; returns
    the ledgers (admitted, popped, shed, pending) after checking the
    exactly-once invariant."""
    S = pkg.serving
    q = S.AdmissionQueue(S.InputSpec((4,), 2), capacity=capacity, policy=policy)
    admitted, popped, shed = [], [], []
    for op_idx, arg in trace:
        op = OPS[op_idx % len(OPS)]
        if op == "admit":
            try:
                admitted.append(q.admit(np.full(4, arg % 4, np.int32),
                                        tier="best_effort" if arg % 3 == 0 else "gold"))
            except S.QueueFull:
                pass
        elif op == "admit_batch":
            try:
                admitted.extend(q.admit_batch(np.zeros((1 + arg % 5, 4), np.int32)))
            except (S.QueueFull, ValueError):
                pass
        elif op == "pop":
            entries, xs = q.pop(1 + arg % 7)
            assert len(entries) == len(xs)
            popped.extend(e.rid for e in entries)
        elif op == "shed_tier":
            q.shed_tier("best_effort")
        else:
            shed.extend(e.rid for e in q.drain_shed())
        assert q.depth <= q.capacity
    shed += [e.rid for e in q.drain_shed()]
    pending = q.pending_rids()
    everything = popped + shed + pending
    assert sorted(everything) == sorted(set(everything)), "rid seen twice"
    assert sorted(everything) == sorted(admitted), "rid lost or invented"
    assert q.depth == len(pending) and 0 <= q.depth <= q.capacity
    return admitted, popped, shed, pending


@pytest.mark.parametrize("policy", ["reject", "shed"])
def test_queue_exactly_once_accounting_equals_jax(policy):
    rng = np.random.default_rng(1234 if policy == "reject" else 4321)
    for _ in range(100):
        capacity = int(rng.integers(1, 12))
        trace = [(int(rng.integers(0, 64)), int(rng.integers(0, 64)))
                 for _ in range(int(rng.integers(1, 60)))]
        both(lambda pkg: _queue_trace(pkg, policy, capacity, trace))


def test_queue_exactly_once_accounting_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=100, deadline=None, database=None)
    @given(policy=st.sampled_from(["reject", "shed"]),
           capacity=st.integers(min_value=1, max_value=12),
           trace=st.lists(st.tuples(st.integers(0, 63), st.integers(0, 63)),
                          min_size=1, max_size=60))
    def prop(policy, capacity, trace):
        both(lambda pkg: _queue_trace(pkg, policy, capacity, trace))

    prop()


# ------------------------------------------------------------------ batcher
@pytest.mark.parametrize("mode", list(MODES))
def test_batcher_bit_exact_with_direct_engine_and_jax(mode):
    xs = samples(13, mode)

    def scenario(pkg):
        engine = engine_for(pkg, mode)
        batcher = pkg.serving.ContinuousBatcher(engine, batch_buckets=(1, 4, 8))
        rids = [batcher.submit(xs[i]) for i in range(5)]
        rids += batcher.submit_batch(xs[5:])
        batcher.drain()
        got = served(batcher, rids)
        assert_same(got, pkg.run(engine, xs))
        assert batcher.outstanding == 0
        return got, {k: batcher.metrics.counters[k] for k in
                     ("requests", "completed", "flushes", "padded_samples",
                      "dispatched_samples", "shed")}

    both(scenario)


@pytest.mark.parametrize("mode", list(MODES))
def test_batcher_bucket_accounting_matches_jax(mode):
    def scenario(pkg):
        batcher = pkg.serving.ContinuousBatcher(engine_for(pkg, mode),
                                                batch_buckets=(1, 4, 8))
        batcher.submit_batch(samples(11, mode))
        batcher.drain()
        with pytest.raises(ValueError, match="largest bucket"):
            batcher.bucket_for(9)
        return {k: batcher.metrics.counters[k] for k in
                ("flushes", "padded_samples", "dispatched_samples", "completed")}

    assert both(scenario) == {"flushes": 2, "padded_samples": 1,
                              "dispatched_samples": 12, "completed": 11}


def test_batcher_resolves_shed_requests_so_waiters_terminate():
    xs = samples(6)

    def scenario(pkg):
        engine = engine_for(pkg)
        batcher = pkg.serving.ContinuousBatcher(engine, batch_buckets=(1, 4),
                                                queue_capacity=4, policy="shed")
        victims = [batcher.submit(xs[i]) for i in range(4)]
        survivors = batcher.submit_batch(xs[4:])
        r = batcher.pop_result(victims[0])
        assert r is not None and r.shed and r.out is None
        batcher.drain()
        got = served(batcher, victims[2:] + survivors)
        assert_same(got, pkg.run(engine, xs)[2:])
        return batcher.shed, batcher.metrics.counters["shed"], got

    shed, n_shed, _ = both(scenario)
    assert shed == [0, 1] and n_shed == 2


def test_slo_slack_triggers_flush_on_an_injected_clock():
    def scenario(pkg):
        engine = engine_for(pkg)
        batcher = pkg.serving.ContinuousBatcher(
            engine, batch_buckets=(1, 4), greedy_when_idle=False,
            interval_s=0.010, safety=1.0)
        assert batcher.budgets[1] == pytest.approx(0.010 * engine.plan(1).n_micro)
        x = samples(1)[0]
        batcher.submit(x, deadline=1.0, now=0.0)
        batcher.poll(now=0.5)  # slack 0.5 >> budget: keep batching
        flushes = [batcher.metrics.counters["flushes"]]
        batcher.poll(now=0.995)  # slack 5 ms <= the 10 ms budget: leave now
        flushes.append(batcher.metrics.counters["flushes"])
        batcher.drain()
        assert_same(batcher.results[0].out, pkg.run(engine, x[None])[0])
        return flushes, batcher.results[0].out

    assert both(scenario)[0] == [0, 1]


def test_urgent_later_arrival_triggers_deadline_flush():
    def scenario(pkg):
        batcher = pkg.serving.ContinuousBatcher(
            engine_for(pkg), batch_buckets=(1, 4), greedy_when_idle=False,
            interval_s=0.010, safety=1.0, slo_s=None)
        xs = samples(2)
        batcher.submit(xs[0], now=0.0)
        batcher.submit(xs[1], deadline=1.0, now=0.1)
        batcher.poll(now=0.5)
        out = [batcher.metrics.counters["flushes"]]
        batcher.poll(now=0.995)
        return out + [batcher.metrics.counters["flushes"], batcher.queue.depth]

    assert both(scenario) == [0, 1, 0]


def test_result_store_is_bounded():
    def scenario(pkg):
        batcher = pkg.serving.ContinuousBatcher(engine_for(pkg), batch_buckets=(1, 4),
                                                result_capacity=6)
        rids = batcher.submit_batch(samples(10))
        batcher.drain()
        return len(batcher.results), [r for r in rids if r in batcher.results]

    assert both(scenario) == (6, list(range(4, 10)))


def test_full_bucket_flushes_even_with_slack():
    def scenario(pkg):
        batcher = pkg.serving.ContinuousBatcher(
            engine_for(pkg), batch_buckets=(1, 4), greedy_when_idle=False,
            interval_s=10.0, slo_s=None)
        batcher.submit_batch(samples(4), now=0.0)
        batcher.poll(now=0.0)
        return batcher.metrics.counters["flushes"]

    assert both(scenario) == 1


def test_greedy_idle_flush_ships_partial_buckets():
    def scenario(pkg):
        batcher = pkg.serving.ContinuousBatcher(engine_for(pkg), batch_buckets=(1, 8),
                                                interval_s=10.0)
        batcher.submit(samples(1)[0])
        batcher.poll()
        return batcher.metrics.counters["flushes"]

    assert both(scenario) == 1


def test_traced_serving_records_the_same_lifecycle_as_jax():
    """A Tracer and a DriftMonitor on the batcher: the same span, instant
    and async names as the JAX package's, one request interval per rid,
    outputs equal to the untraced run's."""
    xs = samples(13)

    def scenario(pkg):
        from importlib import import_module

        tel = import_module(f"{'repro' if pkg is JAX else 'repro_torch'}.telemetry")
        engine = engine_for(pkg)
        tr = tel.Tracer()
        drift = tel.DriftMonitor()
        batcher = pkg.serving.ContinuousBatcher(engine, batch_buckets=(1, 4, 8),
                                                tracer=tr, drift=drift)
        rids = batcher.submit_batch(xs[:9]) + [batcher.submit(x) for x in xs[9:]]
        batcher.drain()
        got = served(batcher, rids)
        assert_same(got, pkg.run(engine, xs))
        names = sorted({(e["ph"], e["name"]) for e in tr.events()})
        begins = sorted(e["id"] for e in tr.events() if e["ph"] == "b")
        return got, names, begins, sorted(drift.status()["keys"])

    got, names, begins, keys = both(scenario)
    assert ("X", "engine.dispatch") in names and ("X", "resolve") in names
    assert begins == list(range(13)) and keys == ["replica:0"]


# ------------------------------------------------- schedule -> seconds bridge
def test_calibrated_cycle_time_feeds_interval_seconds():
    engine = engine_for(TORCH)
    cache = tautotune.ScheduleCache()
    entry = tserving.calibrate_cycle_time(engine, batch=8, reps=1, cache=cache)
    assert entry["s_per_cycle"] > 0 and entry["batch"] == 8
    assert entry["n_micro"] == engine.plan(8).n_micro
    # keyed by the engine's device (a CPU engine: cycletime|cpu)
    assert cache.get("cycletime|cpu") == entry
    assert cache.get(tautotune.cycle_time_key(torch.device("cpu"))) == entry
    s = tdf.interval_seconds(engine.schedule, cache=cache, device="cpu")
    assert s == pytest.approx(engine.schedule.steady_state_interval * entry["s_per_cycle"])
    # no measurement in the cache: the nominal clock converts the cycles, as JAX's
    js = jdf.interval_seconds(JEngine(_jax_serving_graph()).schedule,
                              cache=jautotune.ScheduleCache())
    assert tdf.interval_seconds(engine.schedule, cache=tautotune.ScheduleCache()) == js
    assert js == pytest.approx(
        engine.schedule.steady_state_interval / tdf.DEFAULT_CLOCK_HZ)
    # another device's measurement is not this device's
    other = tautotune.ScheduleCache({"cycletime|nvidia-h100-80gb-hbm3": entry})
    assert tdf.interval_seconds(engine.schedule, cache=other, device=torch.device("cpu")) == js


def test_cycle_time_key_and_synth_input_equal_jax():
    assert tautotune.cycle_time_key("cpu") == jautotune.cycle_time_key("cpu") == "cycletime|cpu"
    assert tautotune.cycle_time_key(torch.device("cpu")) == "cycletime|cpu"
    jg, tg = _jax_serving_graph(), _mlp(TORCH)
    for batch, seed in ((1, 0), (7, 0), (128, 3)):
        want = np.asarray(jautotune.synth_input(jg, batch, seed=seed))
        got = tautotune.synth_input(tg, batch, seed=seed)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert_same(got.numpy(), want)
    assert tautotune.synth_input(tg, 2, device="meta").device.type == "meta"
    with pytest.raises(ValueError, match="exactly one input"):
        tautotune.synth_input(tir.Graph(), 2)


def test_device_kind_normalises_the_card_name(monkeypatch):
    assert tautotune.device_kind(torch.device("cpu")) == "cpu"
    assert tautotune.device_kind("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tautotune.device_kind(torch.device("cuda", 0)) == "nvidia-h100-80gb-hbm3"
    with pytest.raises(ValueError, match="meta"):
        tautotune.device_kind("meta")


def test_device_kind_without_a_device_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tautotune.device_kind()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tautotune.cycle_time_key()


def test_schedule_cache_round_trip_and_default_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "sub" / "cache.json")
    cache = tautotune.ScheduleCache({"cycletime|cpu": {"s_per_cycle": 2e-9}})
    assert cache.save(path) == path and cache.path == path
    back = tautotune.ScheduleCache.load(path)
    assert back.entries == cache.entries and "cycletime|cpu" in back and len(back) == 1
    # the file format is the JAX package's
    assert jautotune.ScheduleCache.load(path).entries == cache.entries
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace('"version": 1', '"version": 0'))
    with pytest.raises(ValueError, match="version"):
        tautotune.ScheduleCache.load(path)
    with pytest.raises(ValueError, match="no cache path"):
        tautotune.ScheduleCache().save()
    # default_cache: the user file only, no committed schedules
    monkeypatch.setenv(tautotune.CACHE_PATH_ENV, str(tmp_path / "absent.json"))
    assert len(tautotune.default_cache()) == 0
    cache.save(str(tmp_path / "user.json"))
    monkeypatch.setenv(tautotune.CACHE_PATH_ENV, str(tmp_path / "user.json"))
    user = tautotune.default_cache()
    assert user.entries == cache.entries and user.path == str(tmp_path / "user.json")
    engine = engine_for(TORCH)
    assert tdf.interval_seconds(engine.schedule, device="cpu") == pytest.approx(
        engine.schedule.steady_state_interval * 2e-9)


# --------------------------------------------------------------------- pool
@pytest.mark.parametrize("mode", list(MODES))
def test_pool_single_device_dispatch_resolves_bit_exact(mode):
    xs = samples(8, mode)

    def scenario(pkg):
        engine = engine_for(pkg, mode)
        pool = pkg.serving.ReplicaPool(engine)
        q = pkg.serving.AdmissionQueue(pkg.serving.InputSpec.from_graph(engine.graph))
        q.admit_batch(xs)
        entries, batch = q.pop(8)
        pending = pool.dispatch(batch, entries)
        assert pool.total_inflight == 1 and not pool.idle
        ys = pending.resolve()
        assert pool.idle
        assert_same(ys, pkg.run(engine, xs))
        return ys, pool.load(), pending.plan.n_micro

    both(scenario)


def test_pool_follows_the_engine_device_and_copies_params_per_device():
    engine = engine_for(TORCH)
    pool = tserving.ReplicaPool(engine)
    assert [r.device for r in pool.replicas] == [torch.device("cpu")]
    # a replica on the engine's device shares the engine's tensors
    assert pool.replicas[0].params[1].weights is engine.params[1].weights
    pool = tserving.ReplicaPool(engine, devices=["cpu", "meta"])
    w = pool.replicas[1].params[1].weights
    assert w.device.type == "meta" and w.shape == engine.params[1].weights.shape
    # a CPU tensor on the meta replica: the launch raises, and that is a
    # replica failure, recorded -- not a rerun on a kernel's plain version
    launches = ops.launch_counts()
    with pytest.raises(tserving.DispatchError, match="replica 1") as exc:
        pool.dispatch(samples(2), [], n_valid=2, exclude=(0,))
    assert exc.value.replica == 1 and ops.launch_counts() == launches
    assert pool.replicas[1].health.consecutive_failures == 1
    assert pool.replicas[1].health.state == "suspect"


def test_engine_dispatch_runs_a_replicas_params():
    engine = engine_for(TORCH)
    xs = torch.from_numpy(samples(5))
    want = engine(xs)
    out, plan = engine.dispatch(xs, params=engine.params_on("cpu"))
    assert torch.equal(out, want) and plan == engine.plan(5)
    mixed = list(engine.params_on("cpu"))
    mixed[1] = mixed[1].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        engine.dispatch(xs, params=mixed)


def test_pool_warmup_runs_every_bucket_and_primes_the_canary():
    engine = engine_for(TORCH)
    pool = tserving.ReplicaPool(engine, devices=["cpu"] * 2)
    batches, real = [], engine.dispatch

    def counting(x, **kw):
        batches.append(int(x.shape[0]))
        return real(x, **kw)

    engine.dispatch = counting
    pool.warmup((8, 1, 4, 4))
    # each bucket once on each replica, then the canary (``engine(x)``)
    assert batches == [1, 1, 4, 4, 8, 8, 1]
    x, want = pool._canary
    assert_same(want, _jax_run(JEngine(_jax_serving_graph()), x))
    assert pool.output_dtype == want.dtype == np.float32


# ------------------------------------------------------------------ metrics
def test_metrics_snapshot_percentiles_and_padding_equal_jax():
    def scenario(pkg):
        m = pkg.serving.ServingMetrics(clock=lambda: 10.0)
        for ms in range(1, 101):
            m.observe_latency(ms / 1e3, now=ms / 10.0)
        m.count("padded_samples", 25)
        m.count("dispatched_samples", 100)
        return m.snapshot(), m.prometheus()

    snap, _ = both(scenario)
    assert snap["completed"] == 100
    assert snap["p50_ms"] == pytest.approx(50.5, rel=0.05)
    assert snap["p99_ms"] == pytest.approx(99.01, rel=0.05)
    assert snap["padding_overhead"] == pytest.approx(0.25)
    assert snap["samples_per_s"] == pytest.approx(100 / 9.9)


# ------------------------------------------------------- the NID at full width
def _nid_bursts(n, seed=0):
    """Burst sizes 1-128 (single flows included) summing to ``n``."""
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < n:
        sizes.append(min(int(rng.integers(1, 129)), n - sum(sizes)))
    return sizes


def stream(batcher, xs, sizes) -> list[int]:
    """Submit ``xs`` as bursts of ``sizes`` (a single flow through
    ``submit``), polling after each; a burst waits, polling, until the
    queue has room for it.  Returns the rids in request order."""
    rids, at = [], 0
    for size in sizes:
        assert size <= batcher.queue.capacity
        while batcher.queue.depth + size > batcher.queue.capacity:
            batcher.poll()
        burst = xs[at:at + size]
        rids += [batcher.submit(burst[0])] if size == 1 else batcher.submit_batch(burst)
        at += size
        batcher.poll()
    return rids


def test_nid_standard_served_on_the_cpu_equals_the_golden_digest():
    gd = tnid.load_golden()["standard"]
    acc = tbuild(tnid.build_graph(gd["seed"]), target="serving", tune="off",
                 folding=tnid.foldings(), device="cpu", **gd["build"])
    assert acc.report.cycle_time_source == "measured"
    assert acc.report.measured_interval_s == pytest.approx(
        acc.schedule.steady_state_interval * acc.calibration["s_per_cycle"])
    assert list(acc.cache.entries) == ["cycletime|cpu"]
    x = nid.make_dataset(gd["batch"], seed=gd["data_seed"])[0]
    batcher = acc.serve(batch_buckets=(1, 8, 32, 128), slo_s=0.05)
    rids = stream(batcher, x, _nid_bursts(len(x)))
    batcher.drain(timeout=600)
    y = served(batcher, rids)
    assert_same(y, acc(torch.from_numpy(x)).numpy())
    assert golden_mod.digest_like(gd, y, acc.graph) == gd
    snap = batcher.metrics.snapshot()
    assert snap["completed"] == len(x) and snap["shed"] == 0
    assert snap["dispatched_samples"] - snap["padded_samples"] == len(x)


@pytest.mark.parametrize("target", ["engine", "serving"])
def test_drift_monitor_needs_a_calibrated_build(target):
    acc = tbuild(_mlp(TORCH), target=target, device="cpu", calibrate_batch=4,
                 calibrate_reps=1)
    if target == "engine":
        assert acc.calibration is None and acc.cache is None
        with pytest.raises(BuildError, match="calibrated cycle time"):
            acc.drift_monitor()
        return
    assert acc.report.step_names[-1] == "calibrate"
    assert acc.calibration["batch"] == 4
    drift = acc.drift_monitor()
    stages = {st.name for st in acc.schedule.stages}
    assert set(drift.predictions) == stages
    for st in acc.schedule.stages:
        assert drift.predictions[st.name] == pytest.approx(
            st.cycles * acc.calibration["s_per_cycle"])


def test_accelerator_serve_uses_the_calibrated_budgets():
    acc = tbuild(_mlp(TORCH), target="serving", device="cpu", calibrate_batch=4)
    b = acc.serve(warmup=False, batch_buckets=(1, 4))
    assert b.interval_s == pytest.approx(acc.report.measured_interval_s)
    assert b.budgets[4] == pytest.approx(acc.plan(4).n_micro * b.interval_s * 2.0)
    # an explicit cache wins over the build's
    b2 = acc.serve(warmup=False, cache=tautotune.ScheduleCache())
    assert b2.interval_s == pytest.approx(acc.report.predicted_interval_s)
    y, plan = acc.dispatch(torch.from_numpy(samples(3)), params=acc.engine.params)
    assert torch.equal(y, acc(torch.from_numpy(samples(3)))) and plan == acc.plan(3)
    tr = Tracer()
    b3 = acc.serve(batch_buckets=(1, 4), tracer=tr, drift=acc.drift_monitor())
    rid = b3.submit(samples(1)[0])
    b3.drain()
    assert_same(b3.results[rid].out, _torch_run(acc.engine, samples(1))[0])
    assert {"dispatch", "resolve", "engine.dispatch"} <= {s["name"] for s in tr.spans()}
