"""The pure pieces of the port's serving failure model against the JAX
package's, on the CPU.

Mirrors ``tests/test_faults.py`` and ``tests/test_stragglers.py``: the
seeded ``FaultPlan`` (its draws must be the JAX package's, draw for draw,
for the same seed), its JSON round trip, the corruption / integrity pair,
the interval-arithmetic output bound (equal to the reference's on the same
graphs in the standard, binary and xnor datapaths, unfused and fused, and
on the full-width NID), the replica health state machine, the brownout
controller and the trailing-median straggler detector.  Each scenario runs
through both packages (``scenario(pkg)``) and must give identical answers.
"""

import types

import numpy as np
import pytest

import repro.distributed.stragglers as jstragglers
import repro.serving.faults as jfaults
import repro.serving.health as jhealth
import repro_torch.distributed.stragglers as tstragglers
import repro_torch.serving.faults as tfaults
import repro_torch.serving.health as thealth
from repro.build import build as jbuild
from repro.configs import nid_mlp as jnid
from repro_torch.build import build as tbuild
from repro_torch.configs import nid_mlp as tnid
from test_torch_serving import JAX, MODES, TORCH, _mlp, assert_same, samples

# the failure model's modules, by package
FJ = types.SimpleNamespace(faults=jfaults, health=jhealth, stragglers=jstragglers, pkg=JAX)
FT = types.SimpleNamespace(faults=tfaults, health=thealth, stragglers=tstragglers, pkg=TORCH)


def both_f(scenario):
    want, got = scenario(FJ), scenario(FT)
    assert_same(got, want)
    return got


def _draws(plan, replicas=3, n=50):
    return [None if d is None else (d.kind, d.replica, d.at_dispatch, d.delay_s)
            for d in (plan.draw(r, k) for r in range(replicas) for k in range(n))]


# ---------------------------------------------------------------- fault plan
@pytest.mark.parametrize("seed,rates", [
    (11, {"error": 0.1, "corrupt": 0.1}),
    (0, {"error": 0.2}),
    (5, {"error": 0.05, "straggle": 0.05, "corrupt": 0.05, "hang": 0.02}),
])
def test_fault_plan_draws_equal_jax(seed, rates):
    def scenario(F):
        plan = F.faults.FaultPlan(seed=seed, rates=rates, straggle_delay_s=0.02)
        draws = _draws(plan)
        assert draws == _draws(plan)  # a replay gives the same schedule
        return draws

    draws = both_f(scenario)
    assert {d[0] for d in draws if d is not None} <= set(rates)


def test_fault_plan_rates_approximate_probabilities():
    def scenario(F):
        plan = F.faults.FaultPlan(seed=0, rates={"error": 0.2})
        return sum(plan.draw(0, k) is not None for k in range(2000))

    assert 0.15 < both_f(scenario) / 2000 < 0.25


def test_fault_plan_explicit_events_override_rates():
    def scenario(F):
        plan = F.faults.FaultPlan(seed=0, rates={"error": 1.0},
                                  events=[F.faults.FaultEvent("hang", replica=1, at_dispatch=3)])
        return plan.draw(1, 3).kind, plan.draw(1, 4).kind

    assert both_f(scenario) == ("hang", "error")


def test_fault_plan_replica_scoping_and_validation():
    def scenario(F):
        plan = F.faults.FaultPlan(seed=0, rates={"error": 1.0}, replicas=(2,))
        with pytest.raises(ValueError, match="kind"):
            F.faults.FaultPlan(rates={"explode": 0.5})
        with pytest.raises(ValueError, match="rate"):
            F.faults.FaultPlan(rates={"error": 1.5})
        with pytest.raises(ValueError, match="kind"):
            F.faults.FaultEvent("explode", 0, 0)
        return plan.draw(0, 0), plan.draw(2, 0).kind

    assert both_f(scenario) == (None, "error")


def test_fault_plan_json_round_trip_across_packages(tmp_path):
    plan = tfaults.FaultPlan(seed=7, rates={"straggle": 0.05}, straggle_delay_s=0.02,
                             events=[tfaults.FaultEvent("die", 2, 9)], replicas=(0, 1))
    path = plan.save(str(tmp_path / "plan.json"))
    back = tfaults.FaultPlan.load(path)
    assert back == plan and _draws(back, n=30) == _draws(plan, n=30)
    # the JAX package reads the same file and draws the same schedule
    jplan = jfaults.FaultPlan.load(path)
    assert jplan.to_json() == plan.to_json()
    assert _draws(jplan, n=30) == _draws(plan, n=30)


def test_corrupt_array_equals_jax_and_is_out_of_place():
    y = np.arange(12, dtype=np.int32).reshape(3, 4)

    def scenario(F):
        a = F.faults.corrupt_array(y, F.faults.FaultPlan(seed=5).corruption_rng(0, 0))
        b = F.faults.corrupt_array(y, F.faults.FaultPlan(seed=5).corruption_rng(0, 0))
        np.testing.assert_array_equal(a, b)
        f = F.faults.corrupt_array(y.astype(np.float32),
                                   F.faults.FaultPlan(seed=5).corruption_rng(0, 1))
        return a, f

    a, f = both_f(scenario)
    np.testing.assert_array_equal(y, np.arange(12).reshape(3, 4))  # no mutation
    assert (a != y).any() and (np.abs(a.astype(np.int64)) >= (1 << 30)).any()
    assert np.isnan(f).any()


# ------------------------------------------------------------ integrity guard
@pytest.mark.parametrize("fused", [False, True], ids=["lowered", "engine"])
@pytest.mark.parametrize("bn", [True, False], ids=["bn", "no_bn"])
@pytest.mark.parametrize("mode", list(MODES))
def test_infer_output_range_equals_jax(mode, bn, fused):
    def scenario(F):
        g = _mlp(F.pkg, mode, bn=bn)
        if fused:
            g = F.pkg.Engine(g).graph
        return F.faults.infer_output_range(g)

    lo, hi = both_f(scenario)
    engine = TORCH.Engine(_mlp(TORCH, mode, bn=bn))
    ys = TORCH.run(engine, samples(64, mode))
    assert lo <= float(ys.min()) and float(ys.max()) <= hi
    assert hi < 2**30 and lo > -(2**30)


@pytest.mark.parametrize("variant", ["standard", "binary_packed"])
def test_infer_output_range_on_the_full_width_nid_equals_jax(variant):
    gd = tnid.load_golden()[variant]
    jacc = jbuild(jnid.build_graph(gd["seed"]), target="engine", tune="off",
                  folding=jnid.foldings(), verify="off", **gd["build"])
    tacc = tbuild(tnid.build_graph(gd["seed"]), target="engine", tune="off",
                  folding=tnid.foldings(), verify="off", device="cpu", **gd["build"])
    want = jfaults.infer_output_range(jacc.engine.graph)
    assert want is not None
    assert tfaults.infer_output_range(tacc.engine.graph) == want


def test_infer_output_range_returns_none_on_unknown_ops():
    def scenario(F):
        Node = F.pkg.ir.Node
        return F.faults.infer_output_range([Node("input", "in", {"shape": (4,), "bits": 2}),
                                            Node("mystery", "m", {}, {})])

    assert both_f(scenario) is None


def test_check_integrity_catches_corruption_but_passes_clean():
    ys = TORCH.run(TORCH.Engine(_mlp(TORCH, bn=False)), samples(8, seed=1))

    def scenario(F):
        bound = F.faults.infer_output_range(_mlp(F.pkg, bn=False))
        check = F.faults.check_integrity
        bad = F.faults.corrupt_array(ys, F.faults.FaultPlan(seed=1).corruption_rng(0, 0))
        iy = np.arange(12, dtype=np.int32).reshape(3, 4)
        ibad = F.faults.corrupt_array(iy, F.faults.FaultPlan(seed=2).corruption_rng(0, 0))
        return [check(ys, dtype=ys.dtype, value_range=bound),
                check(bad, dtype=ys.dtype, value_range=bound),
                check(ys.astype(np.int64), dtype=ys.dtype),
                check(np.full((2, 3), np.nan, np.float32), dtype=np.float32),
                check(ibad, value_range=(0.0, 11.0)),
                check(iy, value_range=(0.0, 11.0))]

    clean, bad, dtype, nan, ibad, iclean = both_f(scenario)
    assert clean is None and iclean is None and bad is not None
    assert "dtype" in dtype and "finite" in nan and "range" in ibad


# ---------------------------------------------------------------- health fsm
def test_health_failure_ladder_and_recovery_by_success():
    def scenario(F):
        H = F.health
        p = H.FaultPolicy(suspect_after=1, quarantine_after=3)
        h = H.ReplicaHealth(p)
        out = [(h.state, h.usable)]
        h.record_failure(0.0, "boom")
        out.append((h.state, h.usable))
        h.record_success(0.01)
        out.append((h.state, h.consecutive_failures))
        for t in (1.0, 2.0, 3.0):
            h.record_failure(t, "boom")
        out.append((h.state, h.usable, h.quarantine_reason, h.next_probe_at))
        return out, h.snapshot()

    out, _ = both_f(scenario)
    assert out[:3] == [("healthy", True), ("suspect", True), ("healthy", 0)]
    assert out[3][:3] == ("quarantined", False, "boom")
    assert out[3][3] == pytest.approx(3.0 + thealth.FaultPolicy().probe_backoff_s)


def test_health_straggles_escalate_to_quarantine_verdict():
    def scenario(F):
        p = F.health.FaultPolicy(straggler_min_samples=4, straggler_factor=3.0,
                                 straggles_to_quarantine=2)
        h = F.health.ReplicaHealth(p)
        verdicts = [h.record_success(0.010) for _ in range(6)]
        verdicts.append(h.record_success(0.100))
        state = h.state
        verdicts.append(h.record_success(0.100))
        return verdicts, state

    verdicts, state = both_f(scenario)
    assert verdicts == [None] * 6 + ["straggle", "quarantine"] and state == "suspect"


def test_health_probe_backoff_caps_and_recovery_resets():
    def scenario(F):
        h = F.health.ReplicaHealth(F.health.FaultPolicy(probe_backoff_s=0.1,
                                                        probe_backoff_cap_s=0.3))
        h.quarantine(0.0, "corrupt output")
        out = [h.due_probe(0.1), h.due_probe(0.05), h.note_probe(False, 0.1), h.next_probe_at,
               h.note_probe(False, 0.3), h.next_probe_at, h.note_probe(True, 0.6)]
        return out + [h.state, h.recoveries, h.quarantine_reason, h.next_probe_at]

    out = both_f(scenario)
    assert out[0] and not out[1] and out[3] == pytest.approx(0.3)
    assert out[5] == pytest.approx(0.6) and out[6]
    assert out[7:] == ["healthy", 1, None, None]


def test_health_policy_hedge_delay():
    def scenario(F):
        P = F.health.FaultPolicy
        return [P.disabled().hedge_delay(1.0),
                P(hedging=True, hedge_after_s=0.2).hedge_delay(1.0),
                P(hedging=True, hedge_factor=4.0).hedge_delay(0.0),
                P(hedging=True, hedge_factor=4.0).hedge_delay(0.05)]

    out = both_f(scenario)
    assert out[:3] == [None, 0.2, None] and out[3] == pytest.approx(0.2)


# ------------------------------------------------------------------ brownout
def test_brownout_levels_and_hysteresis():
    ticks = [(1.0, 0.1, 0.0), (0.5, 0.1, 1.0), (0.25, 0.1, 2.0), (1.0, 0.0, 2.5),
             (1.0, 0.0, 3.6), (1.0, 0.8, 4.0), (1.0, 1.0, 4.1)]

    def scenario(F):
        p = F.health.FaultPolicy(brownout_healthy_frac=0.5, severe_healthy_frac=0.25,
                                 brownout_depth_frac=0.75, brownout_cooldown_s=1.0)
        b = F.health.BrownoutController(p)
        return [(b.update(healthy_frac=h, depth_frac=d, now=t), b.shedding_best_effort,
                 b.shrink_buckets) for h, d, t in ticks]

    levels = [lvl for lvl, _, _ in both_f(scenario)]
    assert levels == [0, 1, 2, 2, 0, 1, 2]


def test_brownout_disabled_policy_stays_level_zero():
    def scenario(F):
        b = F.health.BrownoutController(F.health.FaultPolicy.disabled())
        return b.update(healthy_frac=0.0, depth_frac=1.0, now=0.0)

    assert both_f(scenario) == 0


def test_serving_tiers_equal_jax():
    assert (thealth.GOLD, thealth.BEST_EFFORT, thealth.TIERS) == (
        jhealth.GOLD, jhealth.BEST_EFFORT, jhealth.TIERS)


# ------------------------------------------------------------ stragglers
def test_trailing_stats_validates_args():
    def scenario(F):
        for kw, match in (({"window": 0}, "window"), ({"factor": 1.0}, "factor")):
            with pytest.raises(ValueError, match=match):
                F.stragglers.TrailingStats(**kw)
        return True

    both_f(scenario)


@pytest.mark.parametrize("kw,series", [
    ({"min_samples": 8, "factor": 3.0}, [0.01] * 7 + [1.0]),
    ({"min_samples": 4, "factor": 3.0}, [0.010] * 8 + [0.050, 0.012]),
    ({"window": 4, "min_samples": 2, "factor": 3.0}, [1.0] * 4 + [5.0] * 4),
    ({"min_samples": 4, "factor": 3.0, "window": 32}, [0.010] * 8 + [1.0, 0.050]),
    ({"ewma_alpha": 0.5}, [0.010, 0.030]),
])
def test_trailing_stats_equal_jax(kw, series):
    """The reference's straggler scenarios: the same flags, median,
    threshold, EWMA and window through both packages."""
    def scenario(F):
        s = F.stragglers.TrailingStats(**kw)
        flags = [s.observe(dt) for dt in series]
        return flags, s.stragglers, s.median, s.threshold(), s.ewma, len(s), \
            s.would_flag(0.05), s.would_flag(0.011)

    flags, stragglers, median, *_ = both_f(scenario)
    assert stragglers == sum(flags)


def test_trailing_stats_is_the_reference_copy():
    """The port's copy differs from the reference only in its docstring."""
    def body(mod):
        with open(mod.__file__) as f:
            return f.read().split('"""', 2)[2]

    assert body(tstragglers) == body(jstragglers)
