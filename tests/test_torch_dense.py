"""The dense MVU core (``csrc/dense_mvu.cuh``) of ``mvu_int``, ``mvu_binary``,
``mvu_binary_packed``, ``mvu_int2_packed`` and ``mvu_xnor``, on the CPU,
with tolerance 0 (``np.array_equal``, dtypes too).

* ``kernels/dense_mvu.py::dense_launch_plan``, the one launch plan of the
  five kernels: within the H100's 232,448 bytes of shared memory a block
  and the portable cluster of 8, its K slices covering [0, K) in rank
  order, a function of the shape and the weight coding alone, and the
  five codings apart only in shared memory.
* ``mvu_int``, ``mvu_binary_packed`` and ``mvu_int2_packed`` on CPU
  tensors (their plain versions) against the JAX Pallas kernels in
  interpret mode at the card checks' sweep: N = 10, M in
  {1, 9, 100, 128, 4096}, K in {27, 64, 600, 2304}, all three epilogues,
  activations in [-300, 300) (the packed kernels' int8 wrap), full int8
  weights for ``mvu_int`` and, for the packed kernels, every pad bit or
  pad lane of the last word or byte set and two words or bytes more a row
  than K needs.  (``mvu_xnor``'s two entries at the same sweep:
  ``tests/test_torch_binarized.py``.)
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import mvu_packed as jmp, ops as jops
from repro_torch.configs import nid_mlp
from repro_torch.kernels import dense_mvu as D, mvu_binary as B, mvu_int as K
from repro_torch.kernels import mvu_packed as P, packing

CODINGS = ("int8", "bitplanes", "int2", "words", "bits")
SWEEP_MS = (1, 9, 100, 128, 4096)
SWEEP_KS = (27, 64, 600, 2304)
EPILOGUES = ("raw", "thresholds", "scale")


# (M, N, K) of every launch on the main paths -- the NID layers at M = 128
# (a microbatch) and 4096, the FULL CNV's dense layers at M = 1 (512-512-10
# after its 1 x 1 x 256 last conv output) -- and the sweep
PLAN_SHAPES = sorted({(m, n, k) for k, n, _, _ in nid_mlp.LAYERS for m in (128, 4096)}
                     | {(1, 512, 256), (1, 512, 512), (1, 10, 512)}
                     | {(m, 10, k) for m in SWEEP_MS for k in SWEEP_KS})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    assert np.array_equal(got, want)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _epilogue(n, span, epilogue, rng):
    if epilogue == "thresholds":
        return np.sort(rng.integers(-span, span, (n, 3)), axis=1).astype(np.int32), None
    if epilogue == "scale":
        return None, rng.uniform(0.01, 2.0, (n,)).astype(np.float32)
    return None, None


# ---------------------------------------------------------------- the plan
@pytest.mark.parametrize("m,n,k", PLAN_SHAPES)
@pytest.mark.parametrize("coding", CODINGS)
def test_dense_launch_plan_fits_and_covers_k(coding, m, n, k):
    """Within 232,448 bytes of shared memory and a cluster of 8, its K
    slices cover [0, K) once in rank order, the same after the cache is
    cleared; gemv at M <= 8, tiles above."""
    plan = D.dense_launch_plan(m, n, k, coding)
    assert plan.arrangement == ("gemv" if m <= 8 else "tiled")
    assert 0 <= plan.smem_bytes <= 232448 and 1 <= plan.splits <= 8
    assert plan.splits <= plan.steps == max(1, -(-k // 32))
    slices = plan.k_slices(k)
    assert len(slices) == plan.splits and slices[0][0] == 0 and slices[-1][1] == k
    assert all(lo < hi for lo, hi in slices)
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    D.dense_launch_plan.cache_clear()
    again = D.dense_launch_plan(m, n, k, coding)
    assert again == plan and again is not plan
    if (m, n, k) == (128, 64, 600):  # NID fc0: 8 tiles of 19 steps, split 8 ways
        assert plan.splits == 8


# a K step's W stage by coding: 32 int8 rows of 48 bytes, a word a column
# (bitplanes, and the xnor bit entry), 8 bytes of 2-bit lanes a column,
# 32 rows of 36 words (xnor words, staged like A)
W_STAGE = {"int8": 1536, "bitplanes": 128, "int2": 256, "words": 4608, "bits": 128}


@pytest.mark.parametrize("m,n,k", PLAN_SHAPES)
def test_codings_differ_only_in_shared_memory(m, n, k):
    """Each coding's tiled plan differs from the int8 rows' by twice the
    difference of their W stages, and in nothing else; every entry point
    on the core has a coding."""
    rows = D.dense_launch_plan(m, n, k, "int8")
    assert B.binary_launch_plan(m, n, k) == rows
    assert set(D.CODING) == {"mvu_int", "mvu_binary", "mvu_binary_packed",
                             "mvu_int2_packed", "mvu_xnor", "mvu_xnor_bits"}
    assert set(D.CODING.values()) == set(CODINGS) == set(D.W_STAGE_BYTES)
    for coding in CODINGS:
        plan = D.dense_launch_plan(m, n, k, coding)
        assert D.W_STAGE_BYTES[coding] == W_STAGE[coding]
        assert plan._replace(smem_bytes=rows.smem_bytes) == rows
        assert rows.smem_bytes - plan.smem_bytes == (
            0 if m <= 8 else 2 * (W_STAGE["int8"] - W_STAGE[coding]))
    assert rows.c_args == (D.ARRANGEMENTS.index(rows.arrangement), rows.tile, rows.tile_m,
                           rows.tile_n, rows.kstep, rows.splits, rows.smem_bytes)
    # the default tile (index 0, 32 x 32, 32 units a step); gemv has none
    assert (rows.tile, rows.kstep) == ((-1, 32) if m <= 8 else (0, 32))


# --------------------------------------------------- the kernels against JAX
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("k", SWEEP_KS)
@pytest.mark.parametrize("m", SWEEP_MS)
def test_mvu_int_matches_jax_pallas_at_the_dense_sweep(m, k, epilogue):
    rng = np.random.default_rng(5000 + 10 * m + k)
    a = rng.integers(-300, 300, (m, k)).astype(np.int32)
    w = rng.integers(-128, 128, (10, k)).astype(np.int8)
    t, s = _epilogue(10, 300 * 128 * k, epilogue, rng)
    want = jops.mvu(_j(a), _j(w), thresholds=_j(t), out_scale=_j(s), backend="pallas")
    launches = K.LAUNCHES
    _same(K.mvu_int(_t(a), _t(w), _t(t), _t(s)), want)
    assert K.LAUNCHES == launches  # a CPU tensor takes the plain version
    _same(K.mvu_int_plain(_t(a), _t(w), _t(t), _t(s)), want)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("k", SWEEP_KS)
@pytest.mark.parametrize("m", SWEEP_MS)
def test_mvu_binary_packed_matches_jax_pallas_at_the_dense_sweep(m, k, epilogue):
    rng = np.random.default_rng(6000 + 10 * m + k)
    a = rng.integers(-300, 300, (m, k)).astype(np.int32)
    w01 = rng.integers(0, 2, (10, k)).astype(np.int8)
    g = torch.Generator().manual_seed(m + k)
    words = packing.pack_bits_pad_set(torch.from_numpy(w01), 2, g).numpy().view(np.uint32)
    nw = -(-k // 32)
    assert words.shape[1] == nw + 2
    t, s = _epilogue(10, 128 * k, epilogue, rng)
    want = jops.mvu(_j(a), _j(words), "binary", k_bits=k, thresholds=_j(t),
                    out_scale=_j(s), packed=True)
    # the pad bits do not count in JAX either: the same as clean words
    clean = jmp.pack_mvu_weights(_j(w01), "binary")
    pad = np.uint32((0xFFFFFFFF << (k % 32)) & 0xFFFFFFFF) if k % 32 else np.uint32(0)
    assert np.array_equal(words[:, nw - 1] & pad, np.full(10, pad))  # every pad bit set
    words_in_k = words[:, :nw].copy()
    words_in_k[:, -1] &= ~pad
    assert np.array_equal(words_in_k, np.asarray(clean))  # JAX's bitplanes below K
    assert np.array_equal(np.asarray(want), np.asarray(
        jops.mvu(_j(a), clean, "binary", k_bits=k, thresholds=_j(t), out_scale=_j(s),
                 packed=True)))
    tw = torch.from_numpy(words.view(np.int32))
    launches = P.BINARY_LAUNCHES
    _same(P.mvu_binary_packed(_t(a), tw, k, _t(t), _t(s)), want)
    assert P.BINARY_LAUNCHES == launches  # a CPU tensor takes the plain version
    _same(P.mvu_binary_packed_plain(_t(a), tw, k, _t(t), _t(s)), want)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("k", SWEEP_KS)
@pytest.mark.parametrize("m", SWEEP_MS)
def test_mvu_int2_packed_matches_jax_pallas_at_the_dense_sweep(m, k, epilogue):
    rng = np.random.default_rng(7000 + 10 * m + k)
    a = rng.integers(-300, 300, (m, k)).astype(np.int32)
    w2 = rng.integers(-2, 2, (10, k)).astype(np.int8)
    g = torch.Generator().manual_seed(m + k)
    lanes = packing.pack_int2_pad_set(torch.from_numpy(w2), 2, g).numpy()
    nb = -(-k // 4)
    assert lanes.shape[1] == nb + 2
    t, s = _epilogue(10, 256 * k, epilogue, rng)
    want = jops.mvu(_j(a), _j(lanes), "standard", k_bits=k, thresholds=_j(t),
                    out_scale=_j(s), packed=True)
    # the pad lanes do not count in JAX either: the same as clean lanes
    clean = np.asarray(jmp.pack_mvu_weights(_j(w2), "standard"))
    pad = (0xFF << (2 * (k % 4))) & 0xFF if k % 4 else 0
    assert np.array_equal(lanes[:, nb - 1] & pad, np.full(10, pad, np.uint8))  # every pad lane set
    lanes_in_k = lanes[:, :nb].copy()
    lanes_in_k[:, -1] &= ~np.uint8(pad)
    assert np.array_equal(lanes_in_k, clean)  # JAX's 2-bit lanes below K
    assert np.array_equal(np.asarray(want), np.asarray(
        jops.mvu(_j(a), _j(clean), "standard", k_bits=k, thresholds=_j(t), out_scale=_j(s),
                 packed=True)))
    tw = torch.from_numpy(lanes)
    launches = P.INT2_LAUNCHES
    _same(P.mvu_int2_packed(_t(a), tw, k, _t(t), _t(s)), want)
    assert P.INT2_LAUNCHES == launches  # a CPU tensor takes the plain version
    _same(P.mvu_int2_packed_plain(_t(a), tw, k, _t(t), _t(s)), want)
