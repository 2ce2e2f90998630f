"""The port's autotuner (``repro_torch.core.autotune``) against the JAX
package's, on the CPU.

Ports ``tests/test_autotune.py`` test by test where the port has a
counterpart: candidate enumeration and pruning (on the launch plan's shared
memory, the card's counterpart of VMEM), the cache, ``tune_graph``'s purity
and lookup, the engine's tune modes, ``tune_engine``, explicit schedules and
the keys.  Then parity with the JAX package, exact equality throughout: the
same cache keys for the NID, CNV QUICK and residual graphs; the same
``StreamPlan``, ``acc(x)`` and tune accounting from the same hand-written
cache entries in a ``tune="cache"`` build; and a CPU build's entries scoped
``cpu|...``, so they never apply on the card.  The port's candidates run the
kernels' plain versions here (CPU tensors); caches are written only under
``tmp_path``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.build import build as jbuild
from repro.configs import cnv_bnn as jcnv, nid_mlp as jnid, residual_mlp as jres
from repro.core import autotune as jat, lowering as jlow
from repro.core.ir import Node as JNode
from repro_torch.build import build as tbuild
from repro_torch.configs import cnv_bnn as tcnv, nid_mlp as tnid, residual_mlp as tres
from repro_torch.core import autotune, dataflow, lowering
from repro_torch.core.engine import FusedEngine
from repro_torch.core.folding import Folding
from repro_torch.core.ir import Graph, Node
from repro_torch.core.mvu import KernelBlocks, MVUConfig
from repro_torch.data import nid
from repro_torch.kernels import swu_mvu
from repro_torch.kernels._cuda import SMEM_BYTES

CARD = "nvidia-h100-80gb-hbm3"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_user_cache(tmp_path, monkeypatch):
    """``default_cache()`` reads a file under ``tmp_path`` only."""
    monkeypatch.setenv(autotune.CACHE_PATH_ENV, str(tmp_path / "cache.json"))


def _mlp_graph(rng, dims, bits=2) -> Graph:
    g = Graph([Node("input", "in", {"shape": (dims[0],), "bits": bits})])
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        w = rng.normal(0, 0.5, (n, k)).astype(np.float32)
        g.append(Node("linear", f"fc{i}", {}, {"w": torch.from_numpy(w)}))
        if i < len(dims) - 2:
            g.append(Node("quant_act", f"act{i}", {"bits": bits, "act_scale": 1.0}))
    return g


def _finalized(rng, dims, mode="standard", bits=2, weight_bits=4) -> Graph:
    g = _mlp_graph(rng, dims, bits)
    return lowering.finalize(
        lowering.lower_to_mvu(g, mode=mode, weight_bits=weight_bits, act_bits=bits))


def _no_timer(*a, **kw):
    raise AssertionError("timer must not run in cache mode")


def _x(rng, batch, k, bits=2):
    return torch.as_tensor(rng.integers(0, 2**bits, (batch, k)), dtype=torch.int32)


# ------------------------------------------------------------ candidates
@pytest.mark.parametrize("mode,weight_bits,twin", [
    ("standard", 4, False), ("standard", 2, True), ("binary", 1, True), ("xnor", 1, False)])
def test_candidates_pruned_and_ordered(mode, weight_bits, twin):
    """On the card a node's candidates are the JAX package's tile
    candidates mapped onto the compiled tiles they launch, in both storage
    forms of a packable dense node that is not xnor: unique by launched
    tile, pinned there, in cycle-model order, then the default 32 tile and
    last the node's own schedule (its folding's tile)."""
    cfg = MVUConfig(in_features=96, out_features=24, mode=mode, weight_bits=weight_bits)
    cands = autotune.enumerate_candidates(cfg)
    own = cands[-1]
    assert own.blocks == KernelBlocks.from_blocks({**cfg.kernel_blocks(),
                                                   "block_m": cfg.block_m})
    assert own.packed == (mode == "xnor")  # the xnor kernel is the packed datapath
    assert own.predicted_cycles == cfg.resolved_folding().cycles(24, 96, 1)
    tiles = [(c.packed, autotune.launched_tile(cfg, c.blocks, c.packed)[0]) for c in cands]
    assert len(set(tiles)) == len(tiles)  # nothing is timed against itself
    assert own.smem_bytes == autotune.launched_tile(cfg, own.blocks, own.packed)[1] > 0
    default = (own.packed, ("tiled", 32, 32, 32))
    assert default in tiles
    assert {c.packed for c in cands} == ({False, True} if twin else {own.packed})
    if twin:  # the packed datapath at the node's own tile, as before tiles were raced
        assert cands[-2].packed and cands[-2].blocks == own.blocks
    # every candidate runs the hand kernels at the node's own burst; the
    # challengers are pinned on the tile they launch, in cycle-model order
    assert {c.backend for c in cands} == {"cuda"}
    assert {c.blocks.block_m for c in cands} == {cfg.block_m}
    rest = [c for c, t in zip(cands[:-1], tiles) if t != default and c.blocks != own.blocks]
    assert [c.predicted_cycles for c in rest] == sorted(c.predicted_cycles for c in rest)
    for c, (_, (_, tm, tn, tk)) in zip(rest, [t for c, t in zip(cands, tiles) if c in rest]):
        kw = c.blocks.as_kwargs(mode, c.packed)
        assert (kw["rows_per_tile"], kw["block_n"], kw.get("block_k", kw.get("block_kw"))) == (
            tm, tn, tk)
    kstep = {"standard": 128, "binary": 128, "xnor": 32}[mode]  # SIMD 96 rounded up
    assert tiles[-1] == (own.packed, ("tiled", 32, 32, kstep))


def test_candidates_smem_pruning_rejects_over_budget():
    """Pruning reads each candidate's launch plan's shared memory; the
    node's own schedule and the default tile are never pruned, and
    ``max_measure`` caps the challengers."""
    cfg = MVUConfig(in_features=2048, out_features=512, weight_bits=2)
    loose = autotune.enumerate_candidates(cfg, smem_bytes=1 << 30, max_measure=100)
    fixed = loose[-3:]  # the default tile, the packed twin, the node's own
    assert [(c.blocks.block_n, c.packed) for c in fixed] == [(32, False), (64, True),
                                                             (64, False)]
    budget = sorted(c.smem_bytes for c in loose[:-3])[len(loose) // 2]
    tight = autotune.enumerate_candidates(cfg, smem_bytes=budget, max_measure=100)
    assert all(c.smem_bytes <= budget for c in tight if c not in (fixed[0], fixed[2]))
    assert 3 < len(tight) < len(loose)
    assert fixed[0] in tight and tight[-1] == fixed[2]
    assert max(c.smem_bytes for c in loose) <= SMEM_BYTES
    assert autotune.enumerate_candidates(cfg, max_measure=0) == fixed
    assert len(autotune.enumerate_candidates(cfg, max_measure=3)) <= 6
    # at 10,000 bytes the twin goes too; the default and the incumbent stay
    assert autotune.enumerate_candidates(cfg, smem_bytes=10000) == [fixed[0], fixed[2]]


@pytest.mark.parametrize("n,k,mode,packed", [
    (64, 600, "standard", False), (64, 600, "standard", True), (1, 64, "binary", True),
    (64, 64, "xnor", False), (24, 96, "binary", False), (512, 2304, "standard", True)])
def test_block_candidates_equal_jax(n, k, mode, packed):
    from repro.core.folding import block_candidates as jblock_candidates

    from repro_torch.core.folding import block_candidates

    assert block_candidates(n, k, mode, packed=packed) == jblock_candidates(
        n, k, mode, packed=packed)


def test_conv_candidates_use_conv_launch_plan():
    """A conv node's candidates race its compiled pixel x channel tiles
    (rows_per_tile from the JAX search's block_m, block_n over N's
    divisors), one storage form, each with its conv launch plan's shared
    memory; the default tile and the node's own come last."""
    cfg = MVUConfig(in_features=27, out_features=8, mode="xnor")
    conv = {"kernel": 3, "stride": 1, "pad": 0}
    cands = autotune.enumerate_candidates(cfg, n_pixels=36, in_shape=(8, 8, 3), conv=conv,
                                          smem_bytes=1 << 30)
    plans = [swu_mvu.conv_launch_plan(1, 8, 8, 3, 8, 3, block_n=c.blocks.block_n,
                                      rows_per_tile=c.blocks.rows_per_tile) for c in cands]
    assert [c.smem_bytes for c in cands] == [p.smem_bytes for p in plans]
    assert len({(p.tile_m, p.tile_n) for p in plans}) == len(plans)
    # 6 x 6 output pixels: block_n 8 -> 32 channels, 128 -> 64; the untuned 32
    # pixels, or rows of 36 pixels -> 64 where 64-pixel tiles exist (64 channels)
    assert {(p.tile_m, p.tile_n) for p in plans} == {(32, 32), (32, 64), (64, 64)}
    assert (plans[-1].tile_m, plans[-1].tile_n) == (32, 32)  # own: PE 8 -> 32, 32 pixels
    assert {c.backend for c in cands} == {"cuda"} and {c.packed for c in cands} == {True}
    assert all(c.blocks.block_m == cfg.block_m for c in cands)
    assert cands[-1].predicted_cycles == cfg.resolved_folding().cycles(8, 27, 36)


# ----------------------------------------------------------------- cache
def test_cache_roundtrip(tmp_path):
    cache = autotune.ScheduleCache()
    key = "cpu|mvu|standard|n8|k16|thresh|px1"
    cache.put(key, {"backend": "cuda", "block_m": 32, "block_n": 8,
                    "block_k": 16, "block_kw": 8})
    path = str(tmp_path / "cache.json")
    cache.save(path)
    back = autotune.ScheduleCache.load(path)
    assert back.get(key) == cache.get(key)
    assert key in back and len(back) == 1
    assert jat.ScheduleCache.load(path).entries == back.entries  # one file format


def test_cache_version_mismatch_raises(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text('{"version": 99, "entries": {}}')
    with pytest.raises(ValueError):
        autotune.ScheduleCache.load(str(path))


def test_default_cache_merges_no_committed_schedules():
    """The JAX package's committed schedules were measured on its CPU host;
    the port's default cache holds none of them."""
    jcache = jat.default_cache()
    assert set(jnid.TUNED_SCHEDULES) | set(jcnv.TUNED_SCHEDULES) <= set(jcache.entries)
    assert len(autotune.default_cache()) == 0


# ------------------------------------------------------------ tune_graph
def test_tune_graph_cache_mode_is_pure_lookup():
    rng = np.random.default_rng(0)
    fin = _finalized(rng, [16, 8])
    key = autotune.node_key(fin[1].attrs["config"], epilogue="scale", device="cpu")
    cache = autotune.ScheduleCache({key: {
        "backend": "pallas", "block_m": 64, "block_n": 8, "block_k": 16, "block_kw": 8}})
    tuned = autotune.tune_graph(fin, cache=cache, mode="cache", timer=_no_timer)
    cfg = tuned[1].attrs["config"]
    assert cfg.backend == "cuda"  # the JAX package's name maps to the port's
    assert cfg.blocks == KernelBlocks(block_m=64, block_n=8, block_k=16, block_kw=8)
    assert cfg.block_m == 64
    # purity: the input graph keeps its heuristic config
    assert fin[1].attrs["config"].blocks is None
    assert fin[1].attrs["config"].block_m == 128
    # the lowering pass is the same lookup
    assert lowering.apply_schedules(fin, cache=cache)[1].attrs["config"] == cfg


def test_tune_graph_cache_miss_keeps_heuristic():
    rng = np.random.default_rng(1)
    fin = _finalized(rng, [16, 8])
    tuned = autotune.tune_graph(fin, cache=autotune.ScheduleCache(), mode="cache",
                                timer=_no_timer)
    assert tuned[1].attrs["config"].blocks is None


@pytest.mark.parametrize("winner", ["own", "packed"])
def test_tune_graph_auto_fills_cache_and_stays_bit_exact(winner):
    """A stubbed timer decides the race: the node's own schedule, or the
    packed datapath (2-bit weights pack); the keys are the JAX package's."""
    rng = np.random.default_rng(2)
    fin = _finalized(rng, [24, 12, 8], weight_bits=2)
    calls = []

    def timer(fa, fb, *args, **kw):
        calls.append((kw["reps"], kw["clock"]))
        return (1.0, 0.5, 2.0) if winner == "packed" else (1.0, 1.0, 1.0)

    cache = autotune.ScheduleCache()
    tuned = autotune.tune_graph(fin, cache=cache, mode="auto", timer=timer,
                                sample_m=32, reps=1, max_measure=2)
    assert len(cache) == 2 and calls == [(1, "device")] * 2  # one entry and one race per node
    assert all(e["measured_candidates"] == 1 and e["backend"] == "cuda"
               for e in cache.entries.values())
    assert all(bool(e.get("packed")) == (winner == "packed") for e in cache.entries.values())
    x = _x(rng, 9, 24)
    np.testing.assert_array_equal(dataflow.execute(tuned, x).numpy(),
                                  dataflow.execute(fin, x).numpy())
    jfin = jlow.finalize(jlow.lower_to_mvu(
        _jax_mlp(np.random.default_rng(2), [24, 12, 8]), weight_bits=2, act_bits=2))
    assert sorted(cache.entries) == sorted(jat.graph_node_keys(jfin))


@pytest.mark.parametrize("backend", ["xla", "torch"])
def test_plain_reference_entry_raises_off_the_cpu(backend):
    """A cache entry naming the plain reference (the JAX package's ``xla``
    or the port's ``torch``) applies on the CPU, and raises for a node
    whose parameters lie off it, through ``tune_graph`` too: a cache never
    moves a card's node off the hand kernels unseen."""
    rng = np.random.default_rng(3)
    fin = _finalized(rng, [16, 8])
    cfg = fin[1].attrs["config"]
    entry = {"backend": backend, "block_m": 64, "block_n": 8, "block_k": 16, "block_kw": 8}
    assert autotune.apply_entry(cfg, entry, device=torch.device("cpu")).backend == "torch"
    assert autotune.apply_entry(cfg, {**entry, "backend": "pallas"},
                                device=torch.device("cuda")).backend == "cuda"
    with pytest.raises(ValueError, match="plain reference"):
        autotune.apply_entry(cfg, entry, device=torch.device("cuda"))
    key = autotune.graph_node_keys(fin, device=CARD)[0]
    off_cpu = dataflow.graph_to(fin, "meta")
    with pytest.raises(ValueError, match="plain reference"):
        autotune.tune_graph(off_cpu, cache=autotune.ScheduleCache({key: entry}),
                            mode="cache", device=CARD)


def test_node_race_times_the_card_clock():
    """tune_node asks the timer for the card's clock; paired_times takes
    the wall clock on CPU tensors and refuses an unknown clock."""
    rng = np.random.default_rng(2)
    fin = _finalized(rng, [24, 12], weight_bits=2)
    clocks = []
    autotune.tune_node(fin[1], sample_m=8, reps=1,
                       timer=lambda fa, fb, *a, **kw: clocks.append(kw["clock"]) or (1., 1., 1.))
    assert clocks and set(clocks) == {"device"}  # each raced tile on the card's clock
    x = torch.ones(4, 4)
    t_a, t_b, speedup = autotune.paired_times(torch.neg, torch.abs, x, reps=2, clock="device")
    assert t_a > 0 and t_b > 0 and speedup > 0
    with pytest.raises(ValueError, match="clock"):
        autotune.paired_times(torch.neg, torch.abs, x, clock="host")


def test_tune_graph_rejects_unknown_mode():
    rng = np.random.default_rng(3)
    fin = _finalized(rng, [16, 8])
    with pytest.raises(ValueError):
        autotune.tune_graph(fin, cache=autotune.ScheduleCache(), mode="always")


# ---------------------------------------------------------------- engine
def test_engine_cache_mode_zero_measurement(monkeypatch):
    """tune="cache" is a pure cache lookup: constructing the engine never
    invokes the timer, even on a fully populated cache."""
    monkeypatch.setattr(autotune, "paired_timer", _no_timer)
    rng = np.random.default_rng(4)
    fin = _finalized(rng, [24, 12, 8], weight_bits=2)  # 2-bit: the packed race runs
    cache = autotune.ScheduleCache()
    for node in lowering.fuse_epilogues(fin):
        if node.op != "mvu":
            continue
        key = autotune.node_key(node.attrs["config"], device="cpu",
                                epilogue=autotune.epilogue_form(node.params["mvu"]))
        cache.put(key, {"backend": "cuda", "block_m": 32, "block_n": 16,
                        "block_k": 32, "block_kw": 8})
    engine = FusedEngine(fin, tune="cache", cache=cache)
    cfgs = [n.attrs["config"] for n in engine.graph if n.op == "mvu"]
    assert all(c.backend == "cuda" and c.blocks is not None for c in cfgs)
    # ... and tune="auto" on a cache miss WOULD measure (the stub trips)
    with pytest.raises(AssertionError, match="timer must not run"):
        FusedEngine(fin, tune="auto", cache=autotune.ScheduleCache())


def test_engine_tuned_bit_exact_with_heuristic():
    rng = np.random.default_rng(5)
    fin = _finalized(rng, [32, 16, 8], weight_bits=2)
    cache = autotune.ScheduleCache()
    FusedEngine(fin, tune="auto", cache=cache,  # fill by measuring once
                tune_kwargs={"sample_m": 32, "reps": 1, "max_measure": 3})
    assert len(cache) == 2
    x = _x(rng, 21, 32)
    want = FusedEngine(fin)(x)
    got = FusedEngine(fin, tune="cache", cache=cache)(x)
    assert torch.equal(got, want)


def test_engine_rejects_unknown_tune_mode():
    rng = np.random.default_rng(6)
    fin = _finalized(rng, [16, 8])
    with pytest.raises(ValueError):
        FusedEngine(fin, tune="yes")


def test_engine_microbatch_entry_overrides_plan():
    rng = np.random.default_rng(7)
    fin = _finalized(rng, [16, 8])
    engine = FusedEngine(fin)
    key = autotune.engine_key(engine.graph)
    assert key.startswith("engine|cpu|")  # the scope of the graph's device
    cache = autotune.ScheduleCache({key: {"microbatch": 4, "batch": 64}})
    tuned = FusedEngine(fin, tune="cache", cache=cache)
    assert tuned._tile == 4
    assert tuned.plan(64).n_micro == 16
    assert FusedEngine(fin, tune="cache", cache=cache, microbatches=2).plan(64).n_micro == 2
    x = _x(rng, 13, 16)
    assert torch.equal(tuned(x), engine(x))


def test_tune_engine_records_entry():
    rng = np.random.default_rng(8)
    fin = _finalized(rng, [16, 8])
    cache = autotune.ScheduleCache()
    calls = []

    def fake_timer(fa, fb, *args, **kw):
        calls.append(fb._tile)
        return (1.0, 0.5, 2.0)  # the candidate "wins" by 2x

    entry = autotune.tune_engine(fin, 32, cache=cache, timer=fake_timer)
    assert calls == [64, 128, 256]  # 2h, 4h, 8h beside h = the whole batch of 32
    key = autotune.engine_key(FusedEngine(fin).graph)
    assert cache.get(key) == entry
    assert entry["microbatch"] >= 1 and entry["speedup"] == 2.0


def test_tune_engine_baseline_ignores_prior_engine_entry():
    """Re-tuning baselines against the heuristic plan, not the previous
    engine entry."""
    rng = np.random.default_rng(10)
    fin = _finalized(rng, [16, 8])
    heur_tile = FusedEngine(fin).plan(32).microbatch
    key = autotune.engine_key(FusedEngine(fin).graph)
    cache = autotune.ScheduleCache({key: {"microbatch": 999, "batch": 32, "speedup": 9.9}})

    def never_wins(fa, fb, *args, **kw):
        assert fa._tile is None  # the baseline runs the heuristic plan
        return (1.0, 1.0, 1.0)

    entry = autotune.tune_engine(fin, 32, cache=cache, timer=never_wins)
    assert entry["microbatch"] == heur_tile  # not 999 or a 999-multiple
    assert entry["speedup"] == 1.0


# ------------------------------------------- config-time schedule legality
def test_illegal_explicit_folding_fails_at_config_time():
    """An MVUConfig with a non-divisor PE/SIMD folding fails when the folding
    is resolved, not later."""
    bad_pe = MVUConfig(in_features=64, out_features=64, folding=Folding(3, 2))
    with pytest.raises(ValueError, match="PE=3"):
        bad_pe.resolved_folding()
    with pytest.raises(ValueError):
        bad_pe.kernel_blocks()
    bad_simd = MVUConfig(in_features=600, out_features=64, folding=Folding(64, 7))
    with pytest.raises(ValueError, match="SIMD=7"):
        bad_simd.kernel_blocks()
    # legal foldings (the paper's Table 6 choices) still resolve, and pick
    # the kernel's tile: PE 64 -> 64 columns, SIMD 50 -> a 64-synapse step
    ok = MVUConfig(in_features=600, out_features=64, folding=Folding(64, 50))
    assert ok.resolved_folding() == Folding(64, 50)
    assert ok.kernel_blocks() == {"block_m": 128, "block_n": 64, "block_k": 64}


def test_explicit_blocks_override_folding_derivation():
    cfg = MVUConfig(in_features=64, out_features=32,
                    blocks=KernelBlocks(block_m=64, block_n=16, block_k=32))
    assert cfg.kernel_blocks() == {"block_m": 64, "block_n": 16, "block_k": 32}
    xcfg = MVUConfig(in_features=64, out_features=32, mode="xnor",
                     blocks=KernelBlocks(block_m=64, block_n=16, block_kw=2))
    assert xcfg.kernel_blocks() == {"block_m": 64, "block_n": 16, "block_kw": 2}


# ------------------------------------------------------------------ keys
def test_node_key_fields():
    cfg = MVUConfig(in_features=600, out_features=64, mode="standard")
    key = autotune.node_key(cfg, epilogue="thresh", n_pixels=3, device="cpu")
    assert key == "cpu|mvu|standard|n64|k600|thresh|px3"
    assert autotune.node_key(cfg, device=torch.device("cpu")) == autotune.node_key(
        cfg, device="cpu")
    packed = MVUConfig(in_features=600, out_features=64, weight_bits=2, packed=True)
    assert autotune.node_key(packed, device="cpu").endswith("|px1|packed")


def test_node_key_separates_conv_geometry():
    cfg = MVUConfig(in_features=36, out_features=8)
    a = Node("conv_mvu", "a", {"kernel": 3, "stride": 1, "pad": 0, "config": cfg})
    b = Node("conv_mvu", "b", {"kernel": 3, "stride": 2, "pad": 1, "config": cfg})
    ka = autotune.node_key(cfg, device="cpu", op=autotune.op_tag(a, (14, 14, 4)))
    kb = autotune.node_key(cfg, device="cpu", op=autotune.op_tag(b, (28, 28, 4)))
    assert ka != kb
    assert "conv3s1p0@14x14x4" in ka and "conv3s2p1@28x28x4" in kb
    assert autotune.op_tag(Node("mvu", "d", {"config": cfg})) == "mvu"


def test_engine_key_stable_and_device_scoped():
    rng = np.random.default_rng(9)
    fin = _finalized(rng, [16, 8])
    k1 = autotune.engine_key(fin, device="cpu")
    k2 = autotune.engine_key(fin)  # the scope of the graph's device
    k3 = autotune.engine_key(fin, device="tpu-v5e")
    assert k1 == k2 and k1 != k3
    assert k1.startswith("engine|cpu|")
    assert autotune.engine_key(fin, device=CARD).split("|")[2] == k1.split("|")[2]


# ------------------------------------------------------ parity with JAX
def _jax_mlp(rng, dims, bits=2):
    g = [JNode("input", "in", {"shape": (dims[0],), "bits": bits})]
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        w = rng.normal(0, 0.5, (n, k)).astype(np.float32)
        g.append(JNode("linear", f"fc{i}", {}, {"w": jnp.asarray(w)}))
        if i < len(dims) - 2:
            g.append(JNode("quant_act", f"act{i}", {"bits": bits, "act_scale": 1.0}))
    return g


def _cnv_pair(mode="standard"):
    wb, ab = {"standard": (2, 2), "binary": (1, 2), "xnor": (1, 1)}[mode]
    return (jcnv.build_graph(dataclasses.replace(jcnv.QUICK, weight_bits=wb, act_bits=ab),
                             seed=0),
            tcnv.build_graph(dataclasses.replace(tcnv.QUICK, weight_bits=wb, act_bits=ab),
                             seed=0),
            {"mode": mode, "weight_bits": wb, "act_bits": ab})


GRAPHS = {
    "nid": lambda: (jnid.build_graph(0), tnid.build_graph(0),
                    {"mode": "standard", "weight_bits": 2, "act_bits": 2,
                     "folding": "nid"}),
    "nid_xnor": lambda: (jnid.build_graph(0), tnid.build_graph(0),
                         {"mode": "xnor", "weight_bits": 1, "act_bits": 1,
                          "folding": "nid"}),
    "cnv_quick": _cnv_pair,
    "cnv_quick_binary": lambda: _cnv_pair("binary"),
    "residual": lambda: (jres.build_graph(0), tres.build_graph(0),
                         {"mode": "standard", "weight_bits": 2, "act_bits": 2,
                          "folding": "residual"}),
}


def _builds(name, **kw):
    jg, tg, bkw = GRAPHS[name]()
    bkw = dict(bkw)
    fold = bkw.pop("folding", None)
    jfold = {"nid": jnid.foldings, "residual": jres.foldings}.get(fold)
    tfold = {"nid": tnid.foldings, "residual": tres.foldings}.get(fold)
    jx = {} if jfold is None else {"folding": jfold()}
    tx = {} if tfold is None else {"folding": tfold()}
    jacc = jbuild(jg, target="engine", **bkw, **jx, **{k: v for k, v in kw.items()
                                                     if k != "tcache"})
    targs = {k: v for k, v in kw.items() if k not in ("cache", "tcache")}
    if "tcache" in kw:
        targs["cache"] = kw["tcache"]
    tacc = tbuild(tg, target="engine", device="cpu", **bkw, **tx, **targs)
    return jacc, tacc


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def untuned(request):
    return request.param, _builds(request.param)


def test_keys_equal_jax(untuned):
    """node_key, graph_node_keys and engine_key are the JAX package's
    strings at device="cpu" (and the graph's own scope is "cpu")."""
    _, (jacc, tacc) = untuned
    jkeys = jat.graph_node_keys(jacc.graph, device="cpu")
    assert autotune.graph_node_keys(tacc.graph, device="cpu") == jkeys
    assert autotune.graph_node_keys(tacc.graph) == jkeys
    assert len(jkeys) == sum(n.op in ("mvu", "conv_mvu") for n in tacc.graph)
    assert autotune.engine_key(tacc.engine.graph, device="cpu") == jat.engine_key(
        jacc.engine.graph, device="cpu")
    assert autotune.engine_key(tacc.engine.graph) == jat.engine_key(jacc.engine.graph)
    for tn, jn in zip(tacc.graph, jacc.graph):
        if tn.op in ("mvu", "conv_mvu"):
            assert autotune.epilogue_form(tn.params["mvu"]) == jat.epilogue_form(
                jn.params["mvu"])


def _entries(name, tacc, with_engine):
    """Hand-written entries for every node key of an untuned build: the
    JAX package's backend names, schedules with other bursts, the packed
    datapath on every other packable node; and an engine entry for the
    engine graph that those entries give."""
    entries = {}
    keys = autotune.graph_node_keys(tacc.graph, device="cpu")
    nodes = [n for n in tacc.graph if n.op in ("mvu", "conv_mvu")]
    for i, (key, node) in enumerate(zip(keys, nodes)):
        cfg = node.attrs["config"]
        e = {"backend": "pallas", "block_m": (64, 32, 256)[i % 3], "block_n": 16,
             "block_k": 32, "block_kw": 4, "speedup": 1.5, "measured_candidates": 2}
        if node.op == "mvu" and autotune.packable(cfg) and i % 2 == 0:
            e["packed"] = True
        entries[key] = e
    if with_engine:
        eng = FusedEngine(tacc.graph, tune="cache",
                          cache=autotune.ScheduleCache(entries))
        entries[autotune.engine_key(eng.graph)] = {"microbatch": 3, "batch": 4096,
                                                   "speedup": 1.2}
    return entries


@pytest.mark.parametrize("with_engine", [False, True], ids=["nodes", "engine"])
def test_cache_build_equals_jax(untuned, with_engine):
    """The same hand-written entries, a JAX build and a port build both with
    tune="cache": the same plans, outputs, node reports and accounting."""
    name, (_, tacc0) = untuned
    entries = _entries(name, tacc0, with_engine)
    jacc, tacc = _builds(name, tune="cache", cache=jat.ScheduleCache(entries),
                         tcache=autotune.ScheduleCache(entries))
    for b in (1, 127, 4096):
        assert dataclasses.astuple(tacc.plan(b)) == dataclasses.astuple(jacc.plan(b))
    assert tacc.report.tune == jacc.report.tune
    assert tacc.report.tune["cache_hits"] == len(autotune.graph_node_keys(tacc0.graph))
    assert (tacc.report.tune["engine_tile"] == 3) == with_engine
    keys = ("name", "packed", "tuned", "weight_bytes")
    assert ([[getattr(n, k) for k in keys] for n in tacc.report.nodes]
            == [[getattr(n, k) for k in keys] for n in jacc.report.nodes])
    assert any(n.packed for n in tacc.report.nodes)
    head = next(n for n in jacc.graph if n.op == "input")
    rng = np.random.default_rng(11)
    x = rng.integers(0, 2**head.attrs["bits"], (127, *head.attrs["shape"])).astype(np.int32)
    got = tacc(torch.from_numpy(x)).numpy()
    want = np.asarray(jacc(x))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tacc.interpret(torch.from_numpy(x)).numpy(), want)


def test_auto_build_and_its_cache_rebuild_on_the_cpu(monkeypatch):
    """The acceptance path on the CPU: a tune="auto" NID build fills the
    cache with cpu-scoped entries and stays bit-exact; tune_engine records
    the tile; a tune="cache" rebuild measures nothing and equals both."""
    kw = dict(target="engine", mode="standard", weight_bits=2, act_bits=2,
              folding=tnid.foldings(), device="cpu")
    cache = autotune.ScheduleCache()
    acc = tbuild(tnid.build_graph(0), tune="auto", cache=cache,
                 tune_kwargs={"reps": 1, "sample_m": 64}, **kw)
    assert acc.report.tune == {"mode": "auto", "cache_hits": 0, "cache_misses": 4,
                               "cache_entries": 3, "engine_tile": None}
    assert all(k.startswith("cpu|mvu|standard|") for k in cache.entries)
    # each node raced its compiled tiles (and the packed twin) against its own
    assert all(e["measured_candidates"] >= 2 for e in cache.entries.values())
    assert all(n.tuned for n in acc.report.nodes)
    entry = autotune.tune_engine(acc.graph, 512, cache=cache, reps=1,
                                 node_kwargs={"reps": 1})
    monkeypatch.setattr(autotune, "paired_timer", _no_timer)
    again = tbuild(tnid.build_graph(0), tune="cache", cache=cache, **kw)
    # the nodes were raced again at the rows a launch gets under the tile,
    # and the entry is keyed on the graph their entries give
    mb = again.plan(512).microbatch
    assert all(e["sample_m"] == mb for k, e in cache.entries.items() if "|mvu|" in k)
    assert cache.get(autotune.engine_key(again.engine.graph)) == entry
    assert again.report.tune == {"mode": "cache", "cache_hits": 4, "cache_misses": 0,
                                 "cache_entries": 4, "engine_tile": entry["microbatch"]}
    plain = tbuild(tnid.build_graph(0), **kw)
    x = torch.from_numpy(nid.make_dataset(512, seed=1)[0])
    y = again(x)
    assert torch.equal(y, plain(x)) and torch.equal(acc(x), y)
    assert again.plan(512).microbatch == min(512, entry["microbatch"])


@pytest.mark.parametrize("packed_wins", [True, False])
@pytest.mark.parametrize("pack", ["auto", "never", "always"])
def test_tune_engine_races_the_nodes_under_the_builds_pack_policy(pack, packed_wins,
                                                                  monkeypatch):
    """tune_engine races each node again under the build's pack policy --
    on a timer stub where the packed datapath always wins, or always
    loses -- and keys the tile under the graph a ``tune="cache"`` rebuild
    with that policy has: the rebuild finds it, packs what the policy and
    the entries say, and equals the untuned build."""
    kw = dict(target="engine", mode="standard", weight_bits=2, act_bits=2,
              folding=tnid.foldings(), device="cpu", pack=pack)
    node_fn = autotune._node_fn

    def tagged(cfg, params, cand, conv):
        fn = node_fn(cfg, params, cand, conv)
        fn.packed = cand.packed
        return fn

    monkeypatch.setattr(autotune, "_node_fn", tagged)
    monkeypatch.setattr(autotune, "paired_timer",
                        lambda fa, fb, *a, **k: (1.0, 1.0, 2.0 if fb.packed == packed_wins
                                                 else 0.5))
    cache = autotune.ScheduleCache()
    acc = tbuild(tnid.build_graph(0), tune="auto", cache=cache,
                 tune_kwargs={"reps": 1, "sample_m": 16}, **kw)
    entry = autotune.tune_engine(acc.graph, 64, cache=cache, pack=pack,
                                 timer=lambda *a, **k: (1.0, 1.0, 1.0), node_kwargs={"reps": 1})
    nodes = [e for k, e in cache.entries.items() if "|mvu|" in k]
    assert len(nodes) == 3 and all(e["sample_m"] == 64 for e in nodes)
    packed = pack == "always" or (pack == "auto" and packed_wins)
    assert all(bool(e.get("packed")) == packed for e in nodes)
    monkeypatch.setattr(autotune, "paired_timer", _no_timer)
    again = tbuild(tnid.build_graph(0), tune="cache", cache=cache, **kw)
    assert again.report.tune["engine_tile"] == entry["microbatch"]
    assert [n.attrs["config"].packed for n in again.graph if n.op == "mvu"] == \
        [packed] * 4
    x = torch.from_numpy(nid.make_dataset(64, seed=1)[0])
    assert torch.equal(again(x), tbuild(tnid.build_graph(0), **kw)(x))
    with pytest.raises(ValueError, match="pack"):
        autotune.tune_engine(acc.graph, 64, cache=cache, pack="sometimes")


def test_cpu_entries_never_apply_on_the_card():
    """A CPU build keys its entries cpu|...; looked up under the card's
    scope they all miss, and the card's engine entry does not move a CPU
    engine's tile."""
    kw = dict(target="engine", mode="standard", weight_bits=2, act_bits=2,
              folding=tnid.foldings(), device="cpu")
    cache = autotune.ScheduleCache()
    acc = tbuild(tnid.build_graph(0), tune="auto", cache=cache,
                 tune_kwargs={"reps": 1, "sample_m": 16},
                 **kw)
    card = tbuild(tnid.build_graph(0), tune="cache", cache=cache,
                  tune_kwargs={"device": CARD}, **kw)
    assert card.report.tune["cache_hits"] == 0 and card.report.tune["cache_misses"] == 4
    assert not any(n.tuned for n in card.report.nodes)
    digest = autotune.engine_key(acc.engine.graph).split("|")[2]
    cache.put(f"engine|{CARD}|{digest}", {"microbatch": 7, "batch": 64})
    assert FusedEngine(acc.graph, tune="cache", cache=cache)._tile is None
    assert FusedEngine(acc.graph, tune="cache", cache=cache,
                       tune_kwargs={"device": CARD})._tile == 7


def test_pack_never_keeps_the_tuner_off_the_packed_datapath():
    rng = np.random.default_rng(12)
    fin = _finalized(rng, [24, 12, 8], weight_bits=2)
    cache = autotune.ScheduleCache()
    calls = []
    tuned = autotune.tune_graph(fin, cache=cache, mode="auto", allow_packed=False,
                                timer=lambda *a, **k: calls.append(1) or (1.0, 0.5, 2.0),
                                sample_m=16, reps=1)
    # the unpacked tiles are raced; no packed candidate is, nor pinned
    assert len(calls) == sum(e["measured_candidates"] for e in cache.entries.values()) > 0
    assert not any(e.get("packed") for e in cache.entries.values())
    assert not any(n.attrs["config"].packed for n in tuned if n.op == "mvu")
    packed = {k: {**v, "packed": True} for k, v in cache.entries.items()}
    again = autotune.tune_graph(fin, cache=autotune.ScheduleCache(packed), mode="cache",
                                allow_packed=False)
    assert all(n.attrs["config"].blocks is None for n in again if n.op == "mvu")
