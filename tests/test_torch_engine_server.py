"""The port's ``EngineServer`` shim (``repro_torch.launch.serve``) against the
JAX package's (``repro.launch.serve``), on the CPU.

Ports the shim tests of ``tests/test_build.py`` and ``tests/test_engine.py``:
each scenario runs the same submit/flush trace through the JAX server over
the JAX engine and the port's server over the port's engine, both built
from the same numpy-drawn graph, and the two must agree -- request ids,
flush groups, ``stats`` (requests, flushes, padded samples) and outputs,
``np.array_equal`` and of one dtype -- and agree with each package's own
manually flushed ``ContinuousBatcher`` and engine.  An oversize backlog
splits into max-bucket chunks, a malformed sample is refused at
``submit``, and the shim warns once a process, pointing at ``build``.
"""

import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.build as jbuild
import repro.launch.serve as jserve
import repro_torch.build as tbuild
import repro_torch.launch.serve as tserve
from repro.core import ir as jir, lowering as jlow
from repro.core.engine import FusedEngine as JEngine
from repro_torch.core import ir as tir, lowering as tlow
from repro_torch.core.engine import FusedEngine as TEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JAX = types.SimpleNamespace(
    name="jax", serve=jserve, ir=jir, lowering=jlow, Engine=JEngine, arr=jnp.asarray,
    build=lambda g, **kw: jbuild.build(g, **kw),
    run=lambda engine, xs: np.asarray(engine(jnp.asarray(xs))))
TORCH = types.SimpleNamespace(
    name="torch", serve=tserve, ir=tir, lowering=tlow, Engine=TEngine,
    arr=torch.from_numpy,
    build=lambda g, **kw: tbuild.build(g, device="cpu", **kw),
    run=lambda engine, xs: engine(torch.from_numpy(xs)).numpy())
PKGS = (JAX, TORCH)


def _mlp_graph(pkg, dims=(24, 16, 8), bits=2, seed=3, *, scale=0.5, signed_gamma=False,
               mean_sd=1.0, rng=None):
    """``tests/test_build._mlp_graph`` (and, with ``signed_gamma`` and
    ``mean_sd=2``, ``tests/test_engine._mlp_graph``) in either package: the
    same numpy draws in the same order."""
    rng = rng if rng is not None else np.random.default_rng(seed)
    Node = pkg.ir.Node
    g = [Node("input", "in", {"shape": (dims[0],), "bits": bits})]
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        w = rng.normal(0, scale, (n, k)).astype(np.float32)
        g.append(Node("linear", f"fc{i}", {}, {"w": pkg.arr(w)}))
        if i < len(dims) - 2:
            lo = -1.5 if signed_gamma else 0.5
            g.append(Node("batchnorm", f"bn{i}", {}, {
                "gamma": pkg.arr(rng.uniform(lo, 1.5, n).astype(np.float32)),
                "beta": pkg.arr(rng.uniform(-0.5, 0.5, n).astype(np.float32)),
                "mean": pkg.arr(rng.normal(0, mean_sd, n).astype(np.float32)),
                "var": pkg.arr(rng.uniform(0.5, 2, n).astype(np.float32)),
            }))
            g.append(Node("quant_act", f"act{i}", {"bits": bits, "act_scale": 1.0}))
    return g


def _finalized_engine(pkg, seed):
    """``tests/test_engine.py``'s engine: the 24-16-8 MLP lowered with 4-bit
    weights and finalized, in a ``FusedEngine`` of its own."""
    rng = np.random.default_rng(seed)
    g = _mlp_graph(pkg, rng=rng, signed_gamma=True, mean_sd=2.0)
    fin = pkg.lowering.finalize(pkg.lowering.lower_to_mvu(
        g, mode="standard", weight_bits=4, act_bits=2))
    return pkg.Engine(fin), rng


def _server(pkg, engine, buckets):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return pkg.serve.EngineServer(engine, batch_buckets=buckets)


def _trace(n=13, k=24, bits=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**bits, (n, k)).astype(np.int32)


def test_engine_server_shim_matches_continuous_batcher_trace():
    """The shim and a manually flushed ContinuousBatcher stay bit-exact on
    the same submit/flush trace in both packages: same per-rid outputs,
    same flush and padding accounting, and the port's equal to JAX's."""
    xs = _trace()

    results = {}
    for pkg in PKGS:
        acc = pkg.build(_mlp_graph(pkg), mode="standard", weight_bits=4, act_bits=2)
        server = _server(pkg, acc.engine, (1, 4, 8))
        batcher = acc.serve(batch_buckets=(1, 4, 8), greedy_when_idle=False, warmup=False)

        def batcher_flush(batcher=batcher):
            batcher.flush_all()
            done = batcher.harvest(block=True)
            return [(rid, batcher.pop_result(rid).out) for rid in done]

        sides = {}
        for side, submit, submit_batch, flush in (
                ("server", server.submit, server.submit_batch,
                 lambda: [(r.rid, r.out) for r in server.flush()]),
                ("batcher", batcher.submit, batcher.submit_batch, batcher_flush)):
            rids = [submit(xs[i]) for i in range(5)]
            rids += submit_batch(xs[5:13])
            first = flush()
            rids += [submit(xs[i]) for i in range(3)]
            second = flush()
            sides[side] = (rids, [sorted(r for r, _ in first), sorted(r for r, _ in second)],
                           dict(first + second))
        want = pkg.run(acc.engine, np.concatenate([xs, xs[:3]]))
        s_rids, s_groups, s_out = sides["server"]
        b_rids, b_groups, b_out = sides["batcher"]
        assert s_rids == b_rids and s_groups == b_groups
        for i, rid in enumerate(s_rids):
            np.testing.assert_array_equal(s_out[rid], want[i])
            np.testing.assert_array_equal(b_out[rid], want[i])
        assert server.stats["flushes"] == batcher.metrics.counters["flushes"]
        assert server.stats["padded_samples"] == batcher.metrics.counters["padded_samples"]
        results[pkg.name] = (s_rids, s_groups, server.stats, s_out)

    j, t = results["jax"], results["torch"]
    assert t[0] == j[0] and t[1] == j[1] and t[2] == j[2]
    for rid in j[0]:
        assert t[3][rid].dtype == j[3][rid].dtype
        np.testing.assert_array_equal(t[3][rid], j[3][rid])


def test_engine_server_warns_once_pointing_at_build():
    acc = tbuild.build(_mlp_graph(TORCH), mode="standard", weight_bits=4, act_bits=2,
                       device="cpu")
    tserve._ENGINE_SERVER_WARNED = False
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tserve.EngineServer(acc.engine, batch_buckets=(1, 4))
        tserve.EngineServer(acc.engine, batch_buckets=(1, 4))
    dep = [x for x in w if issubclass(x.category, DeprecationWarning)
           and "EngineServer" in str(x.message)]
    assert len(dep) == 1  # a single warning per process, not per instance
    assert "repro_torch.build" in str(dep[0].message)
    assert "serving" in str(dep[0].message)
    assert dep[0].filename == __file__  # points at the caller's line


def test_engine_server_refuses_empty_or_nonpositive_buckets():
    acc = tbuild.build(_mlp_graph(TORCH), mode="standard", weight_bits=4, act_bits=2,
                       device="cpu")
    for buckets in ((), (0, 4), (-1,)):
        with pytest.raises(ValueError, match="bucket"):
            tserve.EngineServer(acc.engine, batch_buckets=buckets)


def test_engine_server_coalesces_and_matches_direct():
    stats, outs = {}, {}
    for pkg in PKGS:
        engine, rng = _finalized_engine(pkg, 13)
        server = _server(pkg, engine, (1, 4, 8))
        xs = rng.integers(0, 4, (11, 24)).astype(np.int32)
        rids = [server.submit(x) for x in xs]
        done = {r.rid: r for r in server.flush()}
        assert sorted(done) == rids and not server._pending
        want = pkg.run(engine, xs)
        for i, rid in enumerate(rids):
            np.testing.assert_array_equal(done[rid].out, want[i])
        # 11 requests over (1,4,8) buckets: one 8-chunk + one 4-bucket pad
        assert server.stats["flushes"] == 2
        assert server.stats["padded_samples"] == 1
        stats[pkg.name], outs[pkg.name] = server.stats, np.stack(
            [done[r].out for r in rids])
    assert stats["torch"] == stats["jax"]
    assert outs["torch"].dtype == outs["jax"].dtype
    np.testing.assert_array_equal(outs["torch"], outs["jax"])


def test_engine_server_splits_oversized_submissions():
    """A backlog larger than the biggest bucket splits across max-size
    bucket launches (not a non-existent bigger bucket)."""
    stats, outs = {}, {}
    for pkg in PKGS:
        engine, rng = _finalized_engine(pkg, 17)
        server = _server(pkg, engine, (1, 4, 8))
        with pytest.raises(ValueError):
            server._bucket_for(9)  # no bucket holds 9 samples
        assert server._bucket_for(5) == 8
        xs = rng.integers(0, 4, (19, 24)).astype(np.int32)
        rids = server.submit_batch(xs)
        done = {r.rid: r for r in server.flush()}
        assert sorted(done) == rids and not server._pending
        want = pkg.run(engine, xs)
        for i, rid in enumerate(rids):
            np.testing.assert_array_equal(done[rid].out, want[i])
        # 19 = 8 + 8 + 3 (padded to 4)
        assert server.stats == {"requests": 19, "flushes": 3, "padded_samples": 1}
        stats[pkg.name], outs[pkg.name] = server.stats, np.stack(
            [done[r].out for r in rids])
    assert stats["torch"] == stats["jax"]
    np.testing.assert_array_equal(outs["torch"], outs["jax"])


@pytest.mark.parametrize("bad", ["shape", "rank", "dtype"])
def test_engine_server_rejects_a_malformed_sample_at_submit(bad):
    """A malformed sample fails at ``submit`` in both packages with a
    ValueError that names the same fault, and leaves nothing queued."""
    raised = {}
    for pkg in PKGS:
        engine, _ = _finalized_engine(pkg, 13)
        server = _server(pkg, engine, (1, 4, 8))
        x = {"shape": np.zeros(23, np.int32), "rank": np.zeros((2, 24, 1), np.int32),
             "dtype": np.zeros(24, np.float32)}[bad]
        with pytest.raises(ValueError) as e:
            server.submit(x)
        raised[pkg.name] = str(e.value).split(" does not")[0].split(" is not")[0]
        assert not server._pending and server.flush() == []
        assert server.stats["requests"] == 0
    assert raised["torch"] == raised["jax"]
