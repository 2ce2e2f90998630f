"""Per-layer kernel tiles on the CPU: the folding picks the tile, as
``to_tpu_blocks`` picks the Pallas blocks, and the autotuner races the tiles.

* ``core/folding.py::to_gpu_blocks`` against the JAX package's
  ``to_tpu_blocks`` for every layer's folding in the NID, the FULL CNV
  (rate-balanced) and the residual MLP, and for the PE and SIMD sweeps of
  the paper's configurations 5 and 6, in every datapath: the same keys and
  burst, ``block_n`` the smallest compiled ``tile_n`` at least PE and
  ``block_k`` the smallest compiled K step at least SIMD, each at least
  the TPU's block.
* The launch plans on every compiled tile (a hypothesis property over
  shapes up to the CNV's widths): the K slices partition [0, K) once, the
  shared memory fits the H100's, the grid covers M x N.
* Two foldings of one layer launch two tiles; a tuned entry's tile is what
  ``tune="cache"`` launches, read from the plan.

The kernels themselves run on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s tiles phase); on the CPU every wrapper takes its plain
version, which has no tile.
"""

import numpy as np
import pytest
import torch

from repro.configs import paper_sweeps
from repro.core.folding import to_tpu_blocks
from repro_torch.build import build
from repro_torch.configs import cnv_bnn, nid_mlp, residual_mlp
from repro_torch.core import autotune, ir, lowering
from repro_torch.core.folding import Folding, to_gpu_blocks
from repro_torch.core.mvu import KernelBlocks, MVUConfig
from repro_torch.kernels import dense_mvu, swu_mvu
from repro_torch.kernels._cuda import SMEM_BYTES

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

DATAPATHS = [("xnor", False), ("binary", False), ("binary", True), ("standard", False),
             ("standard", True)]


def _cnv_full_foldings() -> list[Folding]:
    """The FULL CNV's rate-balanced foldings, as ``build(folding="balance")``
    gives them: (16, 27), (64, 96), (32, 96), (32, 128), (8, 96), (2, 96),
    (1, 64), (1, 128), (1, 2)."""
    g = lowering.lower_to_mvu(cnv_bnn.build_graph(cnv_bnn.FULL), mode="standard",
                              weight_bits=1, act_bits=1)
    g = lowering.apply_folding(lowering.finalize(g))
    return [n.attrs["config"].folding for n in g if n.op in ("mvu", "conv_mvu")]


def _sweep_foldings(cfg_id: int) -> list[Folding]:
    return [Folding(row["pe"], row["simd"]) for row, _ in paper_sweeps.expand(cfg_id)]


FOLDINGS = {
    "nid": nid_mlp.foldings(),
    "residual": residual_mlp.foldings(),
    "sweep5": _sweep_foldings(5),
    "sweep6": _sweep_foldings(6),
}


def _check_blocks(fold: Folding, mode: str, packed: bool):
    want = to_tpu_blocks(fold, mode, 64, packed=packed)
    got = to_gpu_blocks(fold, mode, 64, packed=packed)
    assert set(got) == set(want) and got["block_m"] == want["block_m"] == 64
    assert got["block_n"] == min(t for t in dense_mvu.TILE_NS if t >= fold.pe)
    assert got["block_n"] >= max(fold.pe, want["block_n"])
    if "block_k" in want:  # int8 rows and 2-bit lanes: the K step follows SIMD
        assert got["block_k"] == min(t for t in dense_mvu.KSTEPS if t >= fold.simd)
        assert got["block_k"] >= max(fold.simd, want["block_k"])
    else:  # the word datapaths step K by one word a column (32 words a row)
        assert got["block_kw"] == 32 >= want["block_kw"]


@pytest.mark.parametrize("mode,packed", DATAPATHS)
@pytest.mark.parametrize("config", sorted(FOLDINGS))
def test_to_gpu_blocks_follows_the_folding_like_to_tpu_blocks(config, mode, packed):
    for fold in FOLDINGS[config]:
        _check_blocks(fold, mode, packed)


@pytest.mark.parametrize("mode,packed", DATAPATHS)
def test_to_gpu_blocks_on_the_full_cnv(mode, packed):
    folds = _cnv_full_foldings()
    assert len(folds) == 9 and max(f.pe for f in folds) == 64
    assert max(f.simd for f in folds) == 128
    for fold in folds:
        _check_blocks(fold, mode, packed)


def test_the_folding_sets_the_layer_tile():
    """``MVUConfig.kernel_blocks`` follows the folding untuned, as the JAX
    package's does: NID fc0 (PE 64, SIMD 50) gets 64 columns and a 64-
    synapse step, fc1-fc3 the default 32 tile; a pinned entry wins."""
    cfgs = [MVUConfig(in_features=k, out_features=n, folding=Folding(pe, simd), block_m=128)
            for k, n, pe, simd in nid_mlp.LAYERS]
    assert [(b["block_n"], b["block_k"]) for b in (c.kernel_blocks() for c in cfgs)] == [
        (64, 64), (32, 32), (32, 32), (32, 32)]
    plans = [dense_mvu.dense_launch_plan(128, c.out_features, c.in_features, "int8",
                                         **_tile(c)) for c in cfgs]
    assert [(p.tile_m, p.tile_n, p.kstep) for p in plans] == [
        (32, 64, 64), (32, 32, 32), (32, 32, 32), (32, 32, 32)]
    pinned = autotune.apply_entry(cfgs[0], {"backend": "cuda", "block_m": 128, "block_n": 32,
                                            "block_k": 128, "rows_per_tile": 64})
    assert pinned.kernel_blocks() == {"block_m": 128, "block_n": 32, "block_k": 128,
                                      "rows_per_tile": 64}


def _tile(cfg: MVUConfig) -> dict:
    b = cfg.kernel_blocks()
    return {"block_n": b["block_n"], "block_k": b.get("block_k", b.get("block_kw")),
            "rows_per_tile": b.get("rows_per_tile")}


@pytest.mark.parametrize("op", ["dense", "conv"])
def test_two_foldings_of_one_layer_launch_two_tiles(op):
    """One layer, two foldings: two compiled tiles, read from the plan."""
    a = MVUConfig(in_features=576, out_features=64, folding=Folding(16, 32))
    b = MVUConfig(in_features=576, out_features=64, folding=Folding(64, 96))
    if op == "dense":
        pa, pb = (dense_mvu.dense_launch_plan(128, 64, 576, "int8", **_tile(c)) for c in (a, b))
        assert (pa.tile_n, pa.kstep, pb.tile_n, pb.kstep) == (32, 32, 64, 128)
    else:
        pa, pb = (swu_mvu.conv_launch_plan(1, 30, 30, 64, 64, 3,
                                           block_n=c.kernel_blocks()["block_n"]) for c in (a, b))
        assert (pa.tile_n, pb.tile_n) == (32, 64)
    assert pa.tile != pb.tile


# ------------------------------------------------------------ the plans
def _assert_partition(slices, k):
    assert slices[0][0] == 0 and slices[-1][1] == k
    assert all(lo < hi for lo, hi in slices) or k == 0
    assert all(x[1] == y[0] for x, y in zip(slices, slices[1:]))


@settings(max_examples=60, deadline=None)
@given(tile=st.sampled_from(dense_mvu.DENSE_TILES),
       coding=st.sampled_from(sorted(set(dense_mvu.CODING.values()))),
       m=st.integers(9, 4096), n=st.integers(1, 512), k=st.integers(1, 4608))
def test_dense_plans_on_every_tile(tile, coding, m, n, k):
    tm, tn, tk = tile
    plan = dense_mvu.dense_launch_plan(m, n, k, coding, block_n=tn, block_k=tk, rows_per_tile=tm)
    want_k = tk if tk in dense_mvu.ksteps(coding) else 32  # word codings step by 32
    assert (plan.arrangement, plan.tile_m, plan.tile_n, plan.kstep) == ("tiled", tm, tn, want_k)
    assert dense_mvu.DENSE_TILES[plan.tile] == (tm, tn, want_k)
    assert plan.smem_bytes <= SMEM_BYTES and 1 <= plan.splits <= 8
    assert plan.smem_bytes == dense_mvu.tiled_smem_bytes(coding, tm, tn, want_k)
    assert plan.steps == -(-k // want_k) and plan.splits <= plan.steps
    slices = plan.k_slices(k)
    assert len(slices) == plan.splits
    _assert_partition(slices, k)
    assert all(lo % want_k == 0 for lo, _ in slices)
    grid = (-(-m // plan.tile_m), -(-n // plan.tile_n))
    assert grid[0] * plan.tile_m >= m > (grid[0] - 1) * plan.tile_m
    assert grid[1] * plan.tile_n >= n > (grid[1] - 1) * plan.tile_n


@settings(max_examples=60, deadline=None)
@given(tile=st.sampled_from(swu_mvu.CONV_TILES), b=st.integers(1, 64),
       h=st.integers(3, 34), c=st.sampled_from([3, 16, 64, 128, 256]),
       n=st.integers(1, 256), kd=st.sampled_from([1, 3, 5]), pad=st.integers(0, 1))
def test_conv_plans_on_every_tile(tile, b, h, c, n, kd, pad):
    tm, tn = tile
    if h + 2 * pad < kd:
        return
    ow = h + 2 * pad - kd + 1
    rows = None if tm == 32 else max(1, tm // ow)  # rows_per_tile pins the pixel tile
    plan = swu_mvu.conv_launch_plan(b, h, h, c, n, kd, 1, pad, block_n=tn, rows_per_tile=rows)
    want_m = 32 if rows is None else swu_mvu.conv_tile(ow, block_n=tn, rows_per_tile=rows)[0]
    assert (plan.tile_m, plan.tile_n) == (want_m, tn)
    assert swu_mvu.CONV_TILES[plan.tile] == (plan.tile_m, plan.tile_n)
    assert plan.smem_bytes <= SMEM_BYTES and 1 <= plan.splits <= 8
    assert plan.smem_bytes == swu_mvu.conv_smem_bytes(plan.arrangement, h, h, c, kd, 1, pad,
                                                      plan.tile_m, plan.tile_n)
    k = kd * kd * c
    slices = plan.k_slices(k)
    assert len(slices) == plan.splits
    _assert_partition(slices, k)
    pixels = ow * ow
    assert -(-pixels // plan.tile_m) * plan.tile_m >= pixels


def test_conv_rows_per_tile_rounds_onto_the_pixel_tiles():
    """block_n onto (32, 64); rows_per_tile x OW pixels rounded up onto the
    pixel tiles compiled at that tile_n -- (32, 64, 128) at 64 channels,
    32 at 32 -- the largest beyond; no rows: 32 pixels."""
    assert swu_mvu.conv_tile(28) == (32, 32)
    assert swu_mvu.conv_tile(28, rows_per_tile=1, block_n=8) == (32, 32)
    assert swu_mvu.conv_tile(28, rows_per_tile=4, block_n=32) == (32, 32)
    assert swu_mvu.conv_tile(28, block_n=64) == (32, 64)
    assert swu_mvu.conv_tile(28, rows_per_tile=2, block_n=33) == (64, 64)
    assert swu_mvu.conv_tile(28, rows_per_tile=4, block_n=64) == (128, 64)
    assert swu_mvu.conv_tile(30, rows_per_tile=9, block_n=512) == (128, 64)


def test_dense_tile_shape_rule():
    """Untuned, a dense launch takes 32 rows at every shape; a pinned
    rows_per_tile takes 64 only where 64 rows are compiled (the 32 x 32 x
    32 tile), and block_n / block_k round onto the coding's axes."""
    for m, n in ((128, 64), (4096, 64), (4096, 4096)):
        assert dense_mvu.dense_launch_plan(m, n, 600, "int8", block_n=64).tile_m == 32
    assert dense_mvu.dense_tile("int8", rows_per_tile=64) == (64, 32, 32)
    assert dense_mvu.dense_tile("int8", rows_per_tile=1) == (32, 32, 32)
    assert dense_mvu.dense_tile("int8", block_n=64, rows_per_tile=64) == (32, 64, 32)
    assert dense_mvu.dense_tile("int2", block_k=100, rows_per_tile=64) == (32, 32, 128)
    assert dense_mvu.dense_tile("words", block_n=64, block_k=128) == (32, 64, 32)
    assert dense_mvu.dense_tile("bits", rows_per_tile=64) == (64, 32, 32)


# ------------------------------------------------------------- the search
def test_a_raced_tile_lands_in_the_entry_and_tune_cache_launches_it(monkeypatch):
    """On a timer stub that makes one challenger win, the entry records the
    tile it launched; ``tune="cache"`` pins that entry, and the node's plan
    at its burst is that tile."""
    g = build(nid_mlp.build_graph(0), target="engine", folding=nid_mlp.foldings(),
              mode="standard", weight_bits=4, act_bits=2, device="cpu").graph
    node, ins, _ = next((n, i, o) for n, i, o in ir.io_shapes(g) if n.op == "mvu")
    cfg = node.attrs["config"]
    cands = autotune.enumerate_candidates(cfg)
    target = cands[1]
    timed = []

    def timer(base_fn, fn, x, **kw):
        timed.append(fn)
        return 1.0, 1.0, 3.0 if len(timed) == 2 else 1.0

    entry = autotune.tune_node(node, ins[0] if ins else None, timer=timer, sample_m=16, reps=1)
    assert KernelBlocks.from_blocks(entry) == target.blocks
    tile = autotune.launched_tile(cfg, target.blocks, False)[0]
    cache = autotune.ScheduleCache({autotune.graph_node_keys(g)[0]: entry})
    monkeypatch.setattr(autotune, "paired_timer", lambda *a, **k: pytest.fail("timed"))
    tuned = autotune.tune_graph(g, cache=cache, mode="cache")
    tcfg = next(n for n in tuned if n.op == "mvu").attrs["config"]
    plan = dense_mvu.dense_launch_plan(tcfg.block_m, tcfg.out_features, tcfg.in_features,
                                       "int8", **_tile(tcfg))
    assert (plan.arrangement, plan.tile_m, plan.tile_n, plan.kstep) == tile
    assert tile != autotune.launched_tile(cfg, cands[-1].blocks, False)[0]  # not the node's own


def test_the_cpu_tuned_build_equals_the_untuned_at_every_tile():
    """Whatever tile a CPU race picks, the tuned build's output equals the
    untuned one's (the plain versions take no tile)."""
    kw = dict(target="engine", folding=nid_mlp.foldings(), mode="standard", weight_bits=2,
              act_bits=2, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 4, (40, 600)).astype(np.int32))
    plain = build(nid_mlp.build_graph(0), **kw)
    tuned = build(nid_mlp.build_graph(0), tune="auto", cache=autotune.ScheduleCache(),
                  tune_kwargs={"reps": 1, "sample_m": 16}, **kw)
    assert torch.equal(tuned(x), plain(x))
