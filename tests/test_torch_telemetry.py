"""The port's telemetry against the JAX package's, on the CPU.

Mirrors the non-serving, non-pipeline tests of ``tests/test_telemetry.py``.
``repro_torch.telemetry`` is a copy of ``repro.telemetry`` (pure Python),
so every tracer, histogram, rate, Prometheus and drift scenario runs
through both packages on identical inputs (a deterministic clock where
times matter) and must give identical outputs, besides the reference's own
assertions.  The engine and build instrumentation run on the port
(``device="cpu"``, the kernels' plain versions): ``profile`` is bit-exact
with ``acc(x)`` and with the JAX engine, its node spans nest, traced
dispatch equals untraced, and the build embeds its step spans in the
report.  The calibration helpers equal the reference's.  Span durations
are timings and are never compared across packages.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.telemetry as jtel
import repro_torch.telemetry as ttel
from repro.build import BuildConfig as JBuildConfig, build as jbuild
from repro.core import dataflow as jdf, resource_model as jrm
from repro.core.engine import FusedEngine as JEngine
from repro_torch.build import BuildConfig, BuildError, build as tbuild
from repro_torch.configs import residual_mlp as tres
from repro_torch.core import dataflow as tdf, lowering, resource_model as trm
from repro_torch.core.engine import FusedEngine
from repro_torch.core.ir import Graph, Node
from test_serving import _mlp_graph as _jax_mlp_graph, _samples  # tests/ is on sys.path
from test_telemetry import FakeClock, assert_no_overlap_within_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def both(scenario):
    """``scenario(telemetry_module)`` through both packages: the outputs
    must be identical; returns the port's."""
    want, got = scenario(jtel), scenario(ttel)
    assert got == want
    return got


def _mlp_graph(dims=(24, 16, 8), bits=2, seed=3) -> Graph:
    """``tests/test_serving._mlp_graph`` for the port: the same draws."""
    rng = np.random.default_rng(seed)
    g = [Node("input", "in", {"shape": (dims[0],), "bits": bits})]
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        w = rng.normal(0, 0.5, (n, k)).astype(np.float32)
        g.append(Node("linear", f"fc{i}", {}, {"w": torch.from_numpy(w)}))
        if i < len(dims) - 2:
            g.append(Node("batchnorm", f"bn{i}", {}, {
                "gamma": torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)),
                "beta": torch.from_numpy(rng.uniform(-0.5, 0.5, n).astype(np.float32)),
                "mean": torch.from_numpy(rng.normal(0, 1, n).astype(np.float32)),
                "var": torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32)),
            }))
            g.append(Node("quant_act", f"act{i}", {"bits": bits, "act_scale": 1.0}))
    return lowering.finalize(
        lowering.lower_to_mvu(g, mode="standard", weight_bits=4, act_bits=bits))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


# -------------------------------------------------------------------- copy
@pytest.mark.parametrize("module", ["__init__", "trace", "metrics", "drift"])
def test_telemetry_is_the_reference_copy(module):
    """The port's telemetry differs from the reference only in the package
    name of its imports and docstrings."""
    def read(pkg):
        with open(os.path.join(REPO, "src", pkg, "telemetry", f"{module}.py")) as f:
            return f.read()

    want = read("repro").replace("from repro.", "from repro_torch.").replace(
        "``repro.core.", "``repro_torch.core.")
    assert read("repro_torch") == want


# ------------------------------------------------------------------- tracer
def test_spans_nest_and_never_overlap_within_a_thread():
    def scenario(T):
        tr = T.Tracer(clock=FakeClock(step=1.0))
        with tr.span("outer", cat="t"):
            with tr.span("inner1", cat="t"):
                pass
            with tr.span("inner2", cat="t"):
                with tr.span("leaf", cat="t"):
                    pass
        return tr.spans()

    spans = both(scenario)
    assert [s["name"] for s in spans] == ["inner1", "leaf", "inner2", "outer"]
    depths = {s["name"]: s["depth"] for s in spans}
    assert depths == {"outer": 0, "inner1": 1, "inner2": 1, "leaf": 2}
    assert_no_overlap_within_thread(spans)
    outer = next(s for s in spans if s["name"] == "outer")
    for s in spans:
        assert outer["t0"] <= s["t0"] and s["t1"] <= outer["t1"]


def test_tracer_buffer_bounded_and_drop_accounted():
    def scenario(T):
        tr = T.Tracer(capacity=8, clock=FakeClock())
        for i in range(20):
            tr.instant("tick", n=i)
        out = (len(tr), tr.dropped, [ev["args"]["n"] for ev in tr.events()])
        tr.clear()
        return out + (len(tr), tr.dropped)

    assert both(scenario) == (8, 12, list(range(12, 20)), 0, 0)


def test_span_args_mutable_while_open_and_land_in_event():
    def scenario(T):
        tr = T.Tracer(clock=FakeClock())
        with tr.span("dispatch", cat="serving", bucket=8) as sp:
            sp.args["replica"] = 3
        return tr.spans(name="dispatch")[0]

    assert both(scenario)["args"] == {"bucket": 8, "replica": 3}


def test_chrome_export_is_valid_json_with_named_lanes(tmp_path):
    def scenario(T):
        tr = T.Tracer(meta={"run": "test"}, clock=FakeClock())
        with tr.span("work", cat="engine"):
            tr.instant("mark", cat="engine", k=1)
        tr.begin_async("request", 7, cat="request")
        tr.end_async("request", 7, cat="request")
        tr.counter("queue_depth", 3, cat="serving")
        tr.emit_span("micro0", 0.0, 1.0, cat="pipeline", tid="stage0", stage=0)
        path = tr.save(str(tmp_path / f"{T.__name__}.json"))
        with open(path) as f:
            assert json.load(f) == json.loads(json.dumps(tr.to_chrome()))
        return json.loads(json.dumps(tr.to_chrome()))  # strict-JSON round trip

    doc = both(scenario)
    evs = doc["traceEvents"]
    phases = sorted(e["ph"] for e in evs)
    assert phases == sorted(["X", "i", "b", "e", "C", "X", "M"])
    meta = [e for e in evs if e["ph"] == "M"]
    assert meta[0]["args"]["name"] == "stage0"
    lane_tid = meta[0]["tid"]
    assert any(e["ph"] == "X" and e["tid"] == lane_tid for e in evs)
    assert doc["metadata"]["run"] == "test"
    assert {e["id"] for e in evs if e["ph"] in ("b", "e")} == {7}


def test_tracer_summary_aggregates_per_name():
    def scenario(T):
        tr = T.Tracer(clock=FakeClock(step=1.0))
        for _ in range(3):
            with tr.span("step"):
                pass
        return tr.summary()

    s = both(scenario)
    assert s["spans"]["step"]["count"] == 3
    assert s["events"]["X"] == 3
    assert s["dropped"] == 0


# ---------------------------------------------------------------- histogram
def test_log_histogram_percentiles_within_bucket_width():
    vals = np.random.default_rng(0).lognormal(mean=-5.0, sigma=1.0, size=5000)

    def scenario(T):
        h = T.LogHistogram()
        for v in vals:
            h.observe(float(v))
        return [h.percentile(p) for p in (50, 95, 99)], h.count, h.mean(), h.to_json()

    pcts, count, mean, _ = both(scenario)
    for p, got in zip((50, 95, 99), pcts):
        want = float(np.percentile(vals, p, method="inverted_cdf"))
        assert got == pytest.approx(want, rel=0.05)
    assert count == 5000
    assert mean == pytest.approx(float(vals.mean()))


def test_log_histogram_single_sample_exact_and_empty_none():
    def scenario(T):
        h = T.LogHistogram()
        empty = (h.percentile(50), h.mean())
        h.observe(0.123)
        return empty, h.percentile(50), h.percentile(99)

    empty, p50, p99 = both(scenario)
    assert empty == (None, None)
    assert p50 == pytest.approx(0.123) and p99 == pytest.approx(0.123)


def test_log_histogram_merge_and_json_round_trip():
    def scenario(T):
        a, b = T.LogHistogram(), T.LogHistogram()
        for v in (0.001, 0.002, 0.004):
            a.observe(v)
        for v in (0.008, 0.016):
            b.observe(v)
        a.merge(b)
        rt = T.LogHistogram.from_json(json.loads(json.dumps(a.to_json())))
        with pytest.raises(ValueError, match="merge"):
            a.merge(T.LogHistogram(lo=1e-3))
        return (a.count, a.max, rt.buckets == a.buckets, rt.count == a.count,
                rt.percentile(50) == a.percentile(50), a.to_json())

    count, mx, same_buckets, same_count, same_p50, _ = both(scenario)
    assert (count, mx) == (5, 0.016)
    assert same_buckets and same_count and same_p50


def test_log_histogram_underflow_bucket():
    def scenario(T):
        h = T.LogHistogram(lo=1e-3)
        h.observe(1e-9)
        return h.buckets, h.count, h.percentile(50)

    buckets, count, p50 = both(scenario)
    assert buckets == {-1: 1} and count == 1
    assert p50 == pytest.approx(1e-9)


# ------------------------------------------------------------ windowed rate
def test_windowed_rate_slides():
    def scenario(T):
        t = {"now": 0.0}
        rate = T.WindowedRate(10.0, slots=20, clock=lambda: t["now"])
        for i in range(50):
            t["now"] = i * 0.1
            rate.add()
        r = rate.rate()
        t["now"] = 30.0
        return r, rate.rate()

    r, later = both(scenario)
    assert r == pytest.approx(5.0, rel=0.15)
    assert later == 0.0


# --------------------------------------------------------------- prometheus
@pytest.mark.parametrize("prefix", ["t", None])
def test_render_prometheus_exposition(prefix):
    def scenario(T):
        h = T.LogHistogram()
        h.observe(0.002)
        h.observe(0.004)
        kw = {} if prefix is None else {"prefix": prefix}
        return T.render_prometheus(
            counters={"completed": 2}, gauges={"depth": 3, "p99": None},
            histograms={"latency_seconds": h}, **kw)

    text = both(scenario)
    p = prefix or "repro"
    assert f"# TYPE {p}_completed_total counter" in text
    assert f"{p}_completed_total 2" in text
    assert f"{p}_depth 3.0" in text
    assert f"{p}_p99 NaN" in text
    assert f'{p}_latency_seconds_bucket{{le="+Inf"}} 2' in text
    assert f"{p}_latency_seconds_count 2" in text
    cums = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if "_bucket{" in line]
    assert cums == sorted(cums)


# ------------------------------------------------------------ drift monitor
def test_drift_monitor_flags_sustained_high_ratio_only():
    def scenario(T):
        dm = T.DriftMonitor({"stage0": 1.0}, min_samples=2)
        seen = []
        dm.observe("stage0", 1.1)
        seen.append(dm.flagged())
        dm.observe("stage0", 1.2)
        seen.append(dm.flagged())
        for _ in range(6):
            dm.observe("stage0", 10.0)
        seen += [dm.flagged(), dm.flagged_ever()]
        for _ in range(30):
            dm.observe("stage0", 1.0)
        return seen + [dm.flagged(), dm.flagged_ever(), dm.status()]

    seen = both(scenario)
    assert seen[:6] == [[], [], ["stage0"], ["stage0"], [], ["stage0"]]


def test_drift_monitor_censored_semantics():
    def scenario(T):
        dm = T.DriftMonitor({"r": 1.0})
        out = [dm.observe("r", 2.0, censored=True), dm.flagged_ever(),
               dm.observe("r", 10.0, censored=True), dm.flagged_ever(),
               dm.observe("r", 2.0, censored=True)]
        for _ in range(30):
            dm.observe("r", 1.0)
        return out + [dm.flagged(), dm.flagged_ever(), dm.status()]

    first, ever0, hit, ever1, again, live, ever, st = both(scenario)
    assert first is None and ever0 == []
    assert hit == pytest.approx(10.0) and ever1 == ["r"]
    assert again is None and live == [] and ever == ["r"]
    assert st["keys"]["r"]["censored_hits"] == 1
    assert st["keys"]["r"]["censored_dropped"] >= 1
    json.dumps(st)


def test_drift_monitor_unknown_key_discarded():
    def scenario(T):
        dm = T.DriftMonitor()
        return (dm.observe("nobody", 1.0), dm.observe("x", 5.0, predicted_s=1.0),
                dm.flagged_ever(), T.DEFAULT_BAND)

    nobody, x, ever, band = both(scenario)
    assert nobody is None and x == pytest.approx(5.0) and ever == ["x"]
    assert band[0] < 1.0 < band[1]


def test_drift_monitor_from_schedule_equals_jax():
    jsched = jdf.schedule(_jax_mlp_graph())
    tsched = tdf.schedule(_mlp_graph())
    jdm = jtel.DriftMonitor.from_schedule(jsched, 1e-8)
    tdm = ttel.DriftMonitor.from_schedule(tsched, 1e-8)
    assert tdm.predictions and tdm.predictions == jdm.predictions
    for s in tsched.stages:
        assert tdm.predictions[s.name] == pytest.approx(s.cycles * 1e-8)


# ------------------------------------------------------------- calibration
CYCLES = [12, 48, 3, 600, 64]
SECONDS = [1.3e-6, 5.1e-6, 2.0e-7, 6.2e-5, 7.7e-6]


@pytest.mark.parametrize("s_per_cycle", [None, 1e-7])
def test_calibration_helpers_equal_jax(s_per_cycle):
    assert trm.fit_cycle_time(CYCLES, SECONDS) == jrm.fit_cycle_time(CYCLES, SECONDS)
    errs = trm.cycle_model_errors(CYCLES, SECONDS, s_per_cycle)
    assert errs == jrm.cycle_model_errors(CYCLES, SECONDS, s_per_cycle)
    assert trm.error_summary(errs) == jrm.error_summary(errs)
    assert trm.error_summary([]) == jrm.error_summary([]) == {"n": 0}


@pytest.mark.parametrize("cycles,seconds,match", [
    ([], [], "non-empty"), ([1, 2], [1.0], "non-empty"),
    ([0, 0], [1.0, 2.0], "non-zero"), ([1, 2], [1.0, 0.0], "positive")])
def test_calibration_helpers_raise_like_jax(cycles, seconds, match):
    for rm in (jrm, trm):
        with pytest.raises(ValueError, match=match):
            rm.cycle_model_errors(cycles, seconds)


# ------------------------------------------------- engine instrumentation
@pytest.mark.parametrize("microbatches", [2, None])
def test_engine_profile_bit_exact_and_node_spans_nest(microbatches):
    engine = FusedEngine(_mlp_graph(), microbatches=microbatches)
    x = torch.from_numpy(_samples(6))
    want = engine(x)
    tr = ttel.Tracer()
    drift = ttel.DriftMonitor.from_schedule(engine.schedule, 1e-8)
    got, plan = engine.profile(x, tr, drift=drift)
    assert torch.equal(got, want) and plan == engine.plan(6)
    _same(got, JEngine(_jax_mlp_graph(), microbatches=microbatches)(jnp.asarray(_samples(6))))

    spans = tr.spans()
    assert_no_overlap_within_thread(spans)
    outer = tr.spans(name="engine.profile")[0]
    assert outer["args"] == {"batch": 6, "n_micro": plan.n_micro,
                             "microbatch": plan.microbatch}
    node_spans = tr.spans(cat="node")
    assert len(node_spans) == plan.n_micro * len(engine.graph)
    assert sum(s["dur"] for s in node_spans) <= outer["dur"] + 1e-9
    for s in node_spans:
        assert outer["t0"] <= s["t0"] and s["t1"] <= outer["t1"]
    micro = {s["name"]: s for s in tr.spans(cat="engine") if s["name"].startswith("micro")}
    assert sorted(micro) == [f"micro{m}" for m in range(plan.n_micro)]
    for s in node_spans:
        m = micro[f"micro{s['args']['micro']}"]
        assert m["t0"] <= s["t0"] and s["t1"] <= m["t1"] and s["depth"] == 2
    assert set(drift.status()["keys"]) == {s.name for s in engine.schedule.stages}


def test_engine_profile_span_tree_equals_jax():
    """The same span names, categories, args and nesting as the reference's
    profile of the same graph (durations excluded)."""
    def tree(tr):
        return [(s["name"], s["cat"], s["depth"], s["args"]) for s in tr.spans()]

    x = _samples(7)
    jtr, ttr = jtel.Tracer(), ttel.Tracer()
    jy, jplan = JEngine(_jax_mlp_graph(), microbatches=3).profile(jnp.asarray(x), jtr)
    ty, tplan = FusedEngine(_mlp_graph(), microbatches=3).profile(torch.from_numpy(x), ttr)
    _same(ty, jy)
    assert (tplan.n_micro, tplan.microbatch) == (jplan.n_micro, jplan.microbatch)
    assert tree(ttr) == tree(jtr)


def test_residual_profile_feeds_every_stage_to_drift():
    acc = tbuild(tres.build_graph(), target="engine", folding=tres.foldings(),
                 mode="standard", weight_bits=2, act_bits=2, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 4, (300, 600)).astype(np.int32))
    tr = ttel.Tracer()
    drift = ttel.DriftMonitor.from_schedule(acc.schedule, 1e-8)
    y, plan = acc.profile(x, tr, drift=drift)
    assert torch.equal(y, acc(x)) and plan.n_micro == 3
    assert len(tr.spans(cat="node")) == plan.n_micro * len(acc.engine.graph)
    assert set(drift.status()["keys"]) == {s.name for s in acc.schedule.stages}
    assert {s.name for s in acc.schedule.stages} == {"fc0.mvu", "fc1.mvu", "fc2.mvu"}


def test_engine_dispatch_traced_matches_untraced():
    engine = FusedEngine(_mlp_graph())
    x = torch.from_numpy(_samples(5))
    plain, _ = engine.dispatch(x)
    tr = ttel.Tracer()
    traced, plan = engine.dispatch(x, tracer=tr)
    assert torch.equal(plain, traced)
    sp = tr.spans(name="engine.dispatch")
    assert len(sp) == 1 and sp[0]["cat"] == "engine"
    jtr = jtel.Tracer()
    _, jplan = JEngine(_jax_mlp_graph()).dispatch(jnp.asarray(_samples(5)), tracer=jtr)
    assert sp[0]["args"] == jtr.spans(name="engine.dispatch")[0]["args"] == {
        "batch": 5, "n_micro": plan.n_micro, "microbatch": plan.microbatch,
        "interval_cycles": plan.interval_cycles}


def test_accelerator_dispatch_and_profile_forward_the_tracer():
    acc = tbuild(_mlp_graph(), config=BuildConfig(target="engine", device="cpu"))
    x = torch.from_numpy(_samples(4))
    tr = ttel.Tracer()
    y, plan = acc.dispatch(x, tracer=tr)
    yp, _ = acc.profile(x, tr)
    assert torch.equal(y, acc(x)) and torch.equal(yp, y)
    assert [s["name"] for s in tr.spans(cat="engine") if s["depth"] == 0] == \
        ["engine.dispatch", "engine.profile"]


# --------------------------------------------------------------------- build
def test_build_telemetry_embeds_step_spans_in_report():
    acc = tbuild(_mlp_graph(), config=BuildConfig(target="engine", telemetry=True,
                                                  device="cpu"))
    tele = acc.report.telemetry
    assert tele["spans"]
    assert set(tele["spans"]) == {f"step.{s}" for s in acc.report.step_names}
    assert all(s["cat"] == "build" for s in acc.tracer.spans())
    assert acc.tracer.meta == {"build": "build", "target": "engine"}
    jacc = jbuild(_jax_mlp_graph(), config=JBuildConfig(target="engine", telemetry=True))
    assert {k: v["count"] for k, v in tele["spans"].items()} == \
        {k: v["count"] for k, v in jacc.report.telemetry["spans"].items()}
    json.dumps(acc.report.to_json())
    acc2 = tbuild(_mlp_graph(), config=BuildConfig(target="engine", device="cpu"))
    assert acc2.tracer is None and acc2.report.telemetry == {}


def test_build_step_spans_exclude_the_verification_hook(monkeypatch):
    """A step's span closes before the verification hook runs, as in the
    reference's ``run_pipeline``: each hook starts after its step's span
    ends and before the next step's span starts."""
    import time

    from repro_torch.build import steps

    hook, entered = steps.verify_after, []

    def timed_hook(state, name):
        entered.append(time.perf_counter())  # the tracer's clock
        return hook(state, name)

    monkeypatch.setattr(steps, "verify_after", timed_hook)
    acc = tbuild(_mlp_graph(), config=BuildConfig(target="engine", telemetry=True,
                                                  device="cpu"))
    spans = acc.tracer.spans(cat="build")
    assert [s["name"] for s in spans] == [f"step.{n}" for n in acc.report.step_names]
    assert len(entered) == len(spans)
    for i, (sp, t) in enumerate(zip(spans, entered)):
        assert sp["t1"] <= t
        if i + 1 < len(spans):
            assert t <= spans[i + 1]["t0"]


def test_accelerator_drift_monitor_requires_calibration():
    acc = tbuild(_mlp_graph(), config=BuildConfig(target="engine", device="cpu"))
    with pytest.raises(BuildError, match="calibrated"):
        acc.drift_monitor()
