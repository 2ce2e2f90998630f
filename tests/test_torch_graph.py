"""The engine's compiled executable: capture once a key, replay after.

On a CUDA device ``FusedEngine`` captures each key's stream as a CUDA graph
(``core/engine.py``, ``_GraphCache``), the counterpart of the JAX engine's
``jax.jit``.  The CPU has no graphs, so these tests let the cache through on
the CPU with a fake capturer that records the stream by running it eagerly
and replays it into the same static output, as a graph does.  They check
the keys, the output buffers, the launch counters, that nothing reruns a
failed capture eagerly, that a CPU engine never captures, that no timed rep
of ``tune_engine`` captures, and that the replayed engine still equals the
JAX package's ``FusedEngine`` bit for bit.  The real capture is checked on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s graph phase).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.build import build as jbuild
from repro.configs import nid_mlp as jnid, residual_mlp as jres
from repro_torch.build import build
from repro_torch.configs import nid_mlp, residual_mlp
from repro_torch.core import autotune, engine as engine_mod
from repro_torch.core.engine import FusedEngine, StageParams, _GraphCache
from repro_torch.core.folding import Folding
from repro_torch.core.ir import Graph
from repro_torch.core.mvu import MVUParams
from repro_torch.kernels import mvu_int as K, ops

KW = dict(mode="standard", weight_bits=2, act_bits=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Capturer:
    """A fake capture for the CPU: records ``fn(x)`` by running it once and
    replays by rewriting that same output tensor in place, as a graph's
    static output is rewritten.  ``calls`` logs each capture's input shape."""

    def __init__(self, fail: str | None = None):
        self.calls = []
        self.replays = 0
        self.fail = fail  # "capture" or "replay": that step raises

    def __call__(self, fn, x, pool, stream):
        assert pool is None and stream is None  # the CPU has no graph pool or stream
        self.calls.append(tuple(x.shape))
        if self.fail == "capture":
            raise RuntimeError("capture failed")
        out = fn(x)

        def replay():
            if self.fail == "replay":
                raise RuntimeError("replay failed")
            self.replays += 1
            out.copy_(fn(x))

        return replay, out


class CpuGraphs(_GraphCache):
    """The graph cache let through on the CPU (only CUDA captures)."""

    @staticmethod
    def applies(device):
        return True


def _nid(**kw):
    return build(nid_mlp.build_graph(0), target="engine", folding=nid_mlp.foldings(),
                 device="cpu", **{**KW, **kw})


def _x(batch, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 4, (batch, 600)).astype(np.int32))


def _captured(eng, capture=None):
    """``eng`` with a fake-capturing cache; returns the capturer."""
    capture = capture or Capturer()
    eng._graphs = CpuGraphs(capture=capture)
    return capture


def _eager(eng, x):
    return eng._stream(eng.params, x, eng.plan(x.shape[0]).n_micro)


# ------------------------------------------------------------------- keys
def test_one_capture_per_key():
    eng = _nid().engine
    cap = _captured(eng)
    x = _x(300)
    assert eng.plan(300).n_micro == 3
    ys = [eng(x) for _ in range(3)]
    assert cap.calls == [(300, 600)] and eng.captured_graphs == 1 and cap.replays == 2
    want = _eager(eng, x)
    for y in ys:
        assert y.dtype == want.dtype and torch.equal(y, want)


@pytest.mark.parametrize("change", ["batch", "n_micro", "params_on_copy", "tuned_tile",
                                    "dtype"])
def test_a_new_key_captures_anew(change, tmp_path, monkeypatch):
    """What a replay bakes in makes a key: a new batch, ``n_micro``, a
    replica's copy of the parameters, the tile of a ``tune="cache"`` build
    and the input's dtype each capture a graph of their own; the old key
    still replays."""
    x = _x(300)
    if change == "tuned_tile":
        monkeypatch.setenv(autotune.CACHE_PATH_ENV, str(tmp_path / "cache.json"))
        cache = autotune.ScheduleCache()
        cache.put(autotune.engine_key(_nid().engine.graph), {"microbatch": 60})
        acc = _nid(tune="cache", cache=cache)
        assert acc.report.tune["engine_tile"] == 60
        eng = acc.engine
    else:
        eng = _nid().engine
    cap = _captured(eng)
    want = _eager(eng, x)
    for _ in range(2):
        assert torch.equal(eng(x), want)
    first = next(iter(eng._graphs._graphs))
    if change == "batch":
        assert torch.equal(eng(x[:7]), want[:7])
    elif change == "n_micro":
        eng._microbatches = 5
        assert torch.equal(eng(x), want)
    elif change == "params_on_copy":
        copy = [MVUParams(*(None if t is None else t.clone() for t in
                            (p.weights, p.thresholds, p.out_scale)))
                if isinstance(p, MVUParams) else p for p in eng.params]
        y, _ = eng.dispatch(x, params=copy)
        assert torch.equal(y, want)
    elif change == "tuned_tile":
        assert first[3] == 5  # 300 rows at the tuned tile of 60
        eng._tile = None  # the heuristic tile, 128
        assert torch.equal(eng(x), want)
    else:
        assert torch.equal(eng(x.to(torch.int16)), want)
    assert eng.captured_graphs == 2 and len(cap.calls) == 2
    keys = list(eng._graphs._graphs)
    assert keys[0] == first and keys[1] != first
    replays = cap.replays
    assert torch.equal(eng(x), want) and cap.replays == replays + 1
    assert eng.captured_graphs == 2


@pytest.mark.parametrize("retile", ["folding", "entry"])
def test_new_tiles_on_the_same_params_capture_anew(retile):
    """A build whose stages launch other tiles on the same parameter
    tensors -- another folding, or a cache entry pinned by ``apply_entry``
    -- is a new engine with a graph cache of its own: its first call
    captures anew although its key equals the old engine's, and neither
    engine ever replays the other's graph."""
    eng = _nid().engine
    cap = Capturer()
    _captured(eng, cap)
    nodes = []
    for n in eng.graph:
        if n.op == "mvu":
            cfg = n.attrs["config"]
            cfg = (dataclasses.replace(cfg, folding=Folding(1, 8)) if retile == "folding"
                   else autotune.apply_entry(cfg, {"backend": "cuda", "block_m": cfg.block_m,
                                                   "block_n": 64, "block_k": 128,
                                                   "rows_per_tile": 64}))
            n = dataclasses.replace(n, attrs={**n.attrs, "config": cfg})
        nodes.append(n)
    other = FusedEngine(Graph(nodes), fuse=False)  # eng.graph is fused already
    _captured(other, cap)
    blocks = [[n.attrs["config"].kernel_blocks() for n in e.graph if n.op == "mvu"]
              for e in (eng, other)]
    assert blocks[0] != blocks[1]  # the stages launch other tiles
    params = eng.params  # both run on the same parameter tensors
    x = _x(300)
    want = _eager(eng, x)
    for _ in range(2):
        assert torch.equal(eng(x), want)
    assert len(cap.calls) == 1 and cap.replays == 1
    for _ in range(2):
        assert torch.equal(other.dispatch(x, params=params)[0], want)
    assert len(cap.calls) == 2 and cap.replays == 2  # its own capture, then its replay
    assert list(other._graphs._graphs) == list(eng._graphs._graphs)  # one key, two caches
    assert other._graphs is not eng._graphs
    assert torch.equal(eng(x), want) and len(cap.calls) == 2 and cap.replays == 3


def test_successive_outputs_do_not_alias():
    """Two replays of one graph return two tensors, each keeping its own
    batch's values after the other replay rewrote the static output."""
    eng = _nid().engine
    cap = _captured(eng)
    xs = [_x(128, seed=s) for s in range(3)]
    eng(xs[0])  # the eager run and the capture
    y1, y2 = eng(xs[1]), eng(xs[2])
    assert cap.replays == 2
    out = eng._graphs._graphs[next(iter(eng._graphs._graphs))].out
    assert y1.data_ptr() != y2.data_ptr()
    assert out.data_ptr() not in (y1.data_ptr(), y2.data_ptr())
    assert torch.equal(y1, _eager(eng, xs[1])) and torch.equal(y2, _eager(eng, xs[2]))
    assert not torch.equal(y1, y2)


@pytest.mark.parametrize("fail", ["capture", "replay"])
def test_a_failed_capture_or_replay_raises(fail):
    """No eager retry: the stream runs once eagerly on a key's first call
    (that call's result), and a capture or replay that fails raises."""
    eng = _nid().engine
    cap = _captured(eng, Capturer(fail=fail))
    runs = []
    stream = eng._stream
    eng._stream = lambda *a: runs.append(1) or stream(*a)
    x = _x(64)
    if fail == "capture":
        with pytest.raises(RuntimeError, match="capture failed"):
            eng(x)
        assert len(runs) == 1 and eng.captured_graphs == 0
        with pytest.raises(RuntimeError, match="capture failed"):
            eng(x)
        assert len(runs) == 2 and len(cap.calls) == 2
    else:
        eng(x)
        assert len(runs) == 2  # the eager run and the recording
        with pytest.raises(RuntimeError, match="replay failed"):
            eng(x)
        with pytest.raises(RuntimeError, match="replay failed"):
            eng.dispatch(x, tracer=None)
        assert len(runs) == 2 and eng.captured_graphs == 1


def test_replays_add_the_captured_launches():
    """The capture's wrapper calls are taken back from the counters and each
    replay adds them again: the counters count what the card ran."""
    ops.reset_launch_counts()

    def stream(x):
        K.LAUNCHES += 3  # three launches of the stream, as mvu_int's wrapper counts
        return x + 1

    def capture(fn, x, pool, stream):
        out = fn(x)
        return (lambda: out.copy_(x + 1)), out

    cache = CpuGraphs(capture=capture)
    x = torch.arange(6, dtype=torch.int32)
    assert torch.equal(cache.run(stream, StageParams(), x, 1), x + 1)
    assert ops.launch_counts()["mvu_int"] == 3  # the eager run; the capture taken back
    for n in range(1, 5):
        assert torch.equal(cache.run(stream, StageParams(), x * n, 1), x * n + 1)
        assert ops.launch_counts() == {k: 3 * (n + 1) if k == "mvu_int" else 0
                                       for k in ops.KERNELS}
    assert cache._graphs[next(iter(cache._graphs))].launches == {"mvu_int": 3}
    ops.reset_launch_counts()


def test_a_cpu_engine_never_captures():
    acc = _nid()
    cap = Capturer()
    acc.engine._graphs = _GraphCache(capture=cap)
    x = _x(200)
    for _ in range(3):
        assert torch.equal(acc(x), acc.interpret(x))
    acc.engine.dispatch(x, params=acc.engine.params_on("cpu"))
    assert cap.calls == [] and acc.engine.captured_graphs == 0
    assert not _GraphCache.applies(torch.device("cpu"))
    assert _GraphCache.applies(torch.device("cuda", 0))
    assert build(residual_mlp.build_graph(0), folding=residual_mlp.foldings(),
                 device="cpu", **KW).engine.captured_graphs == 0


def test_the_engine_params_are_read_once():
    """The engine's parameters are one :class:`StageParams`, built on first
    use and again after a move; its device and tensor addresses (the
    graph key's part) are read once, and a tuple's stages cannot be
    swapped under them.  A plain sequence is read on every dispatch."""
    eng = _nid().engine
    p = eng.params
    assert isinstance(p, StageParams) and eng.params is p and eng.params_on("cpu") is p
    assert p.device == torch.device("cpu")
    assert p.addresses == tuple(t.data_ptr() for s in p for t in engine_mod._tensors(s))
    assert _GraphCache.key(p, _x(3), 1) == (torch.device("cpu"), (3, 600), torch.int32, 1,
                                            p.addresses)
    with pytest.raises(TypeError):
        p[0] = None
    x = _x(40)
    y, _ = eng.dispatch(x, params=list(p))
    assert torch.equal(y, eng(x))
    eng.to("cpu")  # any move rebuilds them
    assert eng.params is not p and eng.params.addresses == p.addresses
    eng.to("meta")
    assert eng.params.device.type == "meta" and eng.params.addresses != p.addresses


def test_no_timed_rep_of_tune_engine_captures(monkeypatch, tmp_path):
    """Each tile candidate captures on its first call, before the paired
    timer runs: no timer call, warm-up or timed rep, captures.  The timer
    runs the real paired timer, so its warm-ups and reps replay, but
    returns a fixed speedup for each tile, so the winner does not depend
    on the host's noise."""
    monkeypatch.setenv(autotune.CACHE_PATH_ENV, str(tmp_path / "cache.json"))
    cap = Capturer()
    monkeypatch.setattr(engine_mod, "capture_cuda_graph", cap)
    monkeypatch.setattr(_GraphCache, "applies", staticmethod(lambda device: True))
    acc = _nid()
    timed, raced = [], []
    speedup = {256: 1.0, 512: 2.0, 1024: 1.5}  # 1024 within the 10% margin of 512

    def timer(fa, fb, *args, **kw):
        before = len(cap.calls)
        ta, tb, _ = autotune.paired_times(fa, fb, *args, **kw)
        timed.append(len(cap.calls) - before)
        raced.append(fb._tile)
        return ta, tb, speedup[fb._tile]

    cache = autotune.ScheduleCache()
    built = len(cap.calls)  # the build's verification ran its engine too
    replays = cap.replays
    entry = autotune.tune_engine(acc.graph, 512, cache=cache, timer=timer, reps=2)
    # the heuristic tile 128 against 256, 512 and 1024: one capture an
    # engine, each on the engine's first call, none inside the timer
    assert raced == [256, 512, 1024]
    assert timed == [0, 0, 0] and len(cap.calls) - built == 4 and cap.replays > replays
    assert (entry["microbatch"], entry["speedup"]) == (512, 2.0)


# -------------------------------------------------- against the JAX engine
@pytest.mark.parametrize("config", ["nid", "residual"])
def test_replayed_engine_equals_jax(config):
    jcfg, tcfg = (jnid, nid_mlp) if config == "nid" else (jres, residual_mlp)
    jacc = jbuild(jcfg.build_graph(0), target="engine", folding=jcfg.foldings(), **KW)
    tacc = build(tcfg.build_graph(0), target="engine", folding=tcfg.foldings(),
                 device="cpu", **KW)
    cap = _captured(tacc.engine)
    for batch, seed in ((260, 0), (260, 1), (260, 2), (9, 3), (9, 4)):
        x = np.random.default_rng(seed).integers(0, 4, (batch, 600)).astype(np.int32)
        y = tacc(torch.from_numpy(x)).numpy()
        want = np.asarray(jacc(jnp.asarray(x)))
        assert y.dtype == want.dtype and np.array_equal(y, want)
    assert tacc.plan(260).n_micro == 3 and len(cap.calls) == 2 and cap.replays == 3
