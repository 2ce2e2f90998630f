"""The binarized datapaths (paper Fig. 4a xnor, Fig. 4b binary) against the
JAX package, on the CPU, with tolerance 0 (``np.array_equal``, dtypes too).

* ``kernels/packing.py``: every helper against the JAX package's, packed
  words compared as bit patterns (the port's int32 against JAX's uint32).
* ``mvu_xnor`` and ``mvu_binary``: the wrappers on CPU tensors (the kernels'
  plain versions) against the JAX Pallas kernels in interpret mode, at
  N in {1, 7, 64}, K in {1, 33, 64, 600}, M in {1, 3, 128} and all three
  epilogues; ``backend="torch"`` against the same numbers.
* ``mvu_xnor``'s two entries at the dense core's sweep (N = 10, M in
  {1, 9, 100, 128, 4096}, K in {27, 64, 600, 2304}, all three
  epilogues): the packed one against ``mvu_xnor_pallas``, the bit one
  (multi-bit and negative activations, whose LSB alone counts) against
  JAX ``pack_bits`` followed by ``mvu_xnor_pallas``; the engine's xnor
  stage packs on the CPU and raises on a meta tensor.
* The slice: the NID-MLP built at full width in the xnor and binary
  variants by both packages, ``acc(x)`` and ``acc.interpret(x)`` against
  the JAX engine at B in {1, 3, 257}, and the weight storage carried across.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.build import build as jbuild
from repro.configs import nid_mlp as jnid
from repro.data import nid
from repro.kernels import _common as jcommon, ops as jops, packing as jpacking, ref as jref
from repro_torch import convert
from repro_torch.build import BuildError, build as tbuild
from repro_torch.configs import nid_mlp as tnid
from repro_torch.core import dataflow as tdf
from repro_torch.core.engine import FusedEngine
from repro_torch.core.ir import Node
from repro_torch.core.mvu import MVUConfig, MVULayer, MVUParams
from repro_torch.kernels import (
    _common,
    mvu_binary as B,
    mvu_int,
    mvu_xnor as X,
    ops,
    packing,
    ref,
)

NS = (1, 7, 64)
KS = (1, 33, 64, 600)
MS = (1, 3, 128)
EPILOGUES = ("raw", "thresholds", "scale")
VARIANTS = {"xnor": {"mode": "xnor", "weight_bits": 1, "act_bits": 1},
            "binary": {"mode": "binary", "act_bits": 4}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    """numpy view of a tensor or JAX array; uint32 words as int32 patterns."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    assert np.array_equal(got, want)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _epilogue(n, k, epilogue, rng):
    if epilogue == "thresholds":
        return np.sort(rng.integers(-k - 2, k + 3, (n, 3)), axis=1).astype(np.int32), None
    if epilogue == "scale":
        return None, rng.uniform(0.01, 2.0, (n,)).astype(np.float32)
    return None, None


# ------------------------------------------------------------ packing helpers
@pytest.mark.parametrize("k", [1, 31, 32, 33, 600])
def test_pack_bits_round_trip_equals_jax(k):
    rng = np.random.default_rng(k)
    x = rng.integers(0, 4, (5, k)).astype(np.int32)  # multi-bit: only LSBs pack
    tw, jw = packing.pack_bits(_t(x)), jpacking.pack_bits(_j(x))
    assert tw.dtype == torch.int32 and tuple(tw.shape) == (5, packing.num_words(k))
    _same(tw, jw)
    _same(packing.unpack_bits(tw, k), jpacking.unpack_bits(jw, k))
    _same(packing.unpack_bits(tw, k), x & 1)
    # the high bit of a word: the port's int32 pattern is negative
    ones = packing.pack_bits(torch.ones((1, k), dtype=torch.int32))
    _same(ones, jpacking.pack_bits(jnp.ones((1, k), jnp.int32)))


@pytest.mark.parametrize("k", [1, 31, 32, 33, 600])
def test_pack_int2_round_trip_equals_jax(k):
    rng = np.random.default_rng(k + 1)
    v = rng.integers(-2, 2, (4, k)).astype(np.int32)
    tb, jb = packing.pack_int2(_t(v)), jpacking.pack_int2(_j(v))
    assert tb.dtype == torch.uint8 and tuple(tb.shape) == (4, packing.num_int2_bytes(k))
    _same(tb, jb)
    _same(packing.unpack_int2(tb, k), jpacking.unpack_int2(jb, k))
    _same(packing.unpack_int2(tb, k), v)


def test_popcounts_and_bipolar_helpers_equal_jax():
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2**32, (257,), dtype=np.uint64).astype(np.uint32)
    u[:3] = (0, 2**31, 2**32 - 1)
    words = torch.from_numpy(u.view(np.int32))
    _same(packing.popcount(words), jpacking.popcount(jnp.asarray(u)))
    _same(_common.swar_popcount(words), jcommon.swar_popcount(jnp.asarray(u)))
    s = rng.integers(-3, 4, (40,)).astype(np.int32)
    _same(packing.bipolar_to_bits(_t(s)), jpacking.bipolar_to_bits(_j(s)))
    b = rng.integers(0, 2, (40,)).astype(np.int32)
    _same(packing.bits_to_bipolar(_t(b)), jpacking.bits_to_bipolar(_j(b)))


@pytest.mark.parametrize("k", [0, 1, 31, 32, 33, 600])
def test_size_algebra_equals_jax(k):
    for fn in ("padded_bits", "num_words", "padded_int2", "num_int2_bytes",
               "pad_correction"):
        assert getattr(packing, fn)(k) == getattr(jpacking, fn)(k)
    assert packing.pad_correction(k, packing.padded_bits(k) + 64) == \
        jpacking.pad_correction(k, jpacking.padded_bits(k) + 64)


@pytest.mark.parametrize("call", ["padded_bits", "padded_int2", "pad_correction",
                                  "unpack_bits_negative", "unpack_bits_overflow",
                                  "unpack_int2_negative", "unpack_int2_overflow"])
def test_bad_counts_raise_as_in_jax(call):
    words = np.zeros((2, 1), np.uint32)
    lanes = np.zeros((2, 1), np.uint8)
    calls = {
        "padded_bits": lambda p, w, l: p.padded_bits(-1),
        "padded_int2": lambda p, w, l: p.padded_int2(-1),
        "pad_correction": lambda p, w, l: p.pad_correction(33, 32),
        "unpack_bits_negative": lambda p, w, l: p.unpack_bits(w, -1),
        "unpack_bits_overflow": lambda p, w, l: p.unpack_bits(w, 33),
        "unpack_int2_negative": lambda p, w, l: p.unpack_int2(l, -1),
        "unpack_int2_overflow": lambda p, w, l: p.unpack_int2(l, 5),
    }
    with pytest.raises(ValueError) as jerr:
        calls[call](jpacking, jnp.asarray(words), jnp.asarray(lanes))
    with pytest.raises(ValueError) as terr:
        calls[call](packing, torch.from_numpy(words.view(np.int32)), torch.from_numpy(lanes))
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------------- kernels
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
def test_mvu_xnor_matches_jax_pallas(n, k, m, epilogue):
    rng = np.random.default_rng(1000 * n + 10 * k + m)
    ab = rng.integers(0, 2, (m, k)).astype(np.int32)
    wb = rng.integers(0, 2, (n, k)).astype(np.int32)
    t, s = _epilogue(n, k, epilogue, rng)
    jap, jwp = jpacking.pack_bits(_j(ab)), jpacking.pack_bits(_j(wb))
    want = jops.mvu(jap, jwp, "xnor", k_bits=k, thresholds=_j(t), out_scale=_j(s))
    tap, twp = _t(_np(jap)), _t(_np(jwp))
    launches = X.LAUNCHES
    _same(ops.mvu(tap, twp, "xnor", k_bits=k, thresholds=_t(t), out_scale=_t(s)), want)
    assert X.LAUNCHES == launches  # a CPU tensor takes the plain version
    _same(ops.mvu(tap, twp, "xnor", k_bits=k, thresholds=_t(t), out_scale=_t(s),
                  backend="torch"), want)
    _same(ops.mvu(tap, twp, "xnor", k_bits=k, thresholds=_t(t), out_scale=_t(s),
                  packed=True, backend="torch"), want)


# the dense core's sweep (tests/test_torch_dense.py)
SWEEP_MS = (1, 9, 100, 128, 4096)
SWEEP_KS = (27, 64, 600, 2304)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("k", SWEEP_KS)
@pytest.mark.parametrize("m", SWEEP_MS)
def test_mvu_xnor_matches_jax_pallas_at_the_dense_sweep(m, k, epilogue):
    rng = np.random.default_rng(8000 + 10 * m + k)
    ab = rng.integers(0, 2, (m, k)).astype(np.int32)
    wb = rng.integers(0, 2, (10, k)).astype(np.int32)
    t, s = _epilogue(10, k, epilogue, rng)
    jap, jwp = jpacking.pack_bits(_j(ab)), jpacking.pack_bits(_j(wb))
    want = jops.mvu(jap, jwp, "xnor", k_bits=k, thresholds=_j(t), out_scale=_j(s))
    tap, twp = _t(_np(jap)), _t(_np(jwp))
    launches = X.LAUNCHES
    _same(X.mvu_xnor(tap, twp, k, _t(t), _t(s)), want)
    assert X.LAUNCHES == launches  # a CPU tensor takes the plain version
    _same(X.mvu_xnor_plain(tap, twp, k, _t(t), _t(s)), want)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("k", SWEEP_KS)
@pytest.mark.parametrize("m", SWEEP_MS)
def test_mvu_xnor_bits_matches_jax_pack_then_pallas_at_the_dense_sweep(m, k, epilogue):
    """Activations in [-300, 300): only the LSB of each counts, a negative
    one's too (two's complement), and none leaks into the pad bits."""
    rng = np.random.default_rng(9000 + 10 * m + k)
    a = rng.integers(-300, 300, (m, k)).astype(np.int32)
    wb = rng.integers(0, 2, (10, k)).astype(np.int32)
    t, s = _epilogue(10, k, epilogue, rng)
    jwp = jpacking.pack_bits(_j(wb))
    want = jops.mvu(jpacking.pack_bits(_j(a)), jwp, "xnor", k_bits=k, thresholds=_j(t),
                    out_scale=_j(s))
    twp = _t(_np(jwp))
    launches = X.LAUNCHES
    _same(X.mvu_xnor_bits(_t(a), twp, _t(t), _t(s)), want)
    assert X.LAUNCHES == launches  # a CPU tensor takes the plain version
    _same(X.mvu_xnor_bits_plain(_t(a), twp, _t(t), _t(s)), want)


def _xnor_stage(k=600, n=7):
    cfg = MVUConfig(k, n, mode="xnor", weight_bits=1, act_bits=1)
    g = torch.Generator().manual_seed(k)
    params = MVUParams(packing.pack_bits(torch.randint(0, 2, (n, k), generator=g)),
                       torch.sort(torch.randint(-k, k, (n, 1), generator=g,
                                                dtype=torch.int32), 1).values, None)
    return tdf.node_runner(Node("mvu", "fc0", attrs={"config": cfg},
                                params={"mvu": params}))


def test_xnor_stage_packs_on_the_cpu(monkeypatch):
    """On the CPU the engine's xnor stage packs its input with pack_bits
    and runs the packed plain version; no launch."""
    params, run = _xnor_stage()
    x = torch.randint(-300, 300, (2, 3, 600), generator=torch.Generator().manual_seed(1),
                      dtype=torch.int32)
    calls = []
    pack = packing.pack_bits
    monkeypatch.setattr(packing, "pack_bits", lambda v: calls.append(v.shape) or pack(v))
    launches = X.LAUNCHES
    y = run(params, x)
    assert calls == [(2, 3, 600)] and X.LAUNCHES == launches
    want = X.mvu_xnor_plain(pack(x.reshape(6, 600)), params.weights, 600, params.thresholds)
    _same(y, want.reshape(2, 3, 7))


def test_xnor_stage_raises_on_a_meta_tensor(monkeypatch):
    """Off the CPU the stage takes the bit entry, which launches the kernel
    or raises: no pack_bits, no fallback."""
    params, run = _xnor_stage()
    meta = MVUParams(*(None if v is None else v.to("meta")
                       for v in (params.weights, params.thresholds, params.out_scale)))
    monkeypatch.setattr(packing, "pack_bits", lambda v: pytest.fail("pack_bits was called"))
    launches = X.LAUNCHES
    with pytest.raises(ValueError, match="CUDA or CPU"):
        run(meta, torch.empty((4, 600), dtype=torch.int32, device="meta"))
    assert X.LAUNCHES == launches


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
def test_mvu_binary_matches_jax_pallas(n, k, m, epilogue):
    rng = np.random.default_rng(2000 * n + 10 * k + m)
    a = rng.integers(-8, 16, (m, k)).astype(np.int32)
    w = rng.integers(0, 2, (n, k)).astype(np.int8)
    t, s = _epilogue(n, 16 * k, epilogue, rng)
    want = jops.mvu(_j(a), _j(w), "binary", thresholds=_j(t), out_scale=_j(s))
    launches = B.LAUNCHES
    _same(ops.mvu(_t(a), _t(w), "binary", thresholds=_t(t), out_scale=_t(s)), want)
    assert B.LAUNCHES == launches  # a CPU tensor takes the plain version
    _same(ops.mvu(_t(a), _t(w), "binary", thresholds=_t(t), out_scale=_t(s),
                  backend="torch"), want)


@pytest.mark.parametrize("k", [33, 600])
def test_oracles_equal_jax_oracles(k):
    """The unpacking oracles (``backend="torch"``) against the JAX ref.py
    ones, with wide activations on the binary oracle (not narrowed)."""
    rng = np.random.default_rng(k)
    ab, wb = (rng.integers(0, 2, (9, k)).astype(np.int32) for _ in range(2))
    jap, jwp = jpacking.pack_bits(_j(ab)), jpacking.pack_bits(_j(wb))
    _same(ref.mvu_xnor_ref(_t(_np(jap)), _t(_np(jwp)), k), jref.mvu_xnor_ref(jap, jwp, k))
    a = rng.integers(-2**20, 2**20, (9, k)).astype(np.int32)
    w = rng.integers(0, 2, (5, k)).astype(np.int8)
    _same(ref.mvu_binary_ref(_t(a), _t(w)), jref.mvu_binary_ref(_j(a), _j(w)))
    assert ref.mvu_binary_ref is B.mvu_binary_plain


def test_binary_sum_wraps_like_xla():
    rng = np.random.default_rng(5)
    a = rng.integers(-2**31, 2**31 - 1, (5, 77)).astype(np.int32)
    w = rng.integers(0, 2, (9, 77)).astype(np.int8)
    _same(ops.mvu(_t(a), _t(w), "binary"),
          jops.mvu(_j(a), _j(w), "binary", block_m=8, block_n=8, block_k=32))


@pytest.mark.parametrize("bad", ["uint32_words", "int8_words", "k_too_big", "k_negative",
                                 "words_mismatch", "int32_w_binary", "float_a_binary",
                                 "both_epilogues"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    words = torch.zeros((4, 2), dtype=torch.int32)
    a = torch.zeros((4, 16), dtype=torch.int32)
    w01 = torch.zeros((3, 16), dtype=torch.int8)
    with pytest.raises((TypeError, ValueError)):
        if bad == "uint32_words":
            X.mvu_xnor(words.to(torch.uint32), words, 64)
        elif bad == "int8_words":
            X.mvu_xnor(words, words.to(torch.int8), 64)
        elif bad == "k_too_big":
            X.mvu_xnor(words, words, 65)
        elif bad == "k_negative":
            X.mvu_xnor(words, words, -1)
        elif bad == "words_mismatch":
            X.mvu_xnor(words, torch.zeros((4, 3), dtype=torch.int32), 64)
        elif bad == "int32_w_binary":
            B.mvu_binary(a, w01.int())
        elif bad == "float_a_binary":
            B.mvu_binary(a.float(), w01)
        else:
            B.mvu_binary(a, w01, torch.zeros((3, 1), dtype=torch.int32),
                         torch.ones(3))


@pytest.mark.parametrize("wrapper", ["mvu_xnor", "mvu_binary"])
def test_meta_tensor_raises_instead_of_falling_back(wrapper):
    a = torch.empty((4, 16), dtype=torch.int32, device="meta")
    w = torch.empty((8, 16), dtype=torch.int32 if wrapper == "mvu_xnor" else torch.int8,
                    device="meta")
    mod = X if wrapper == "mvu_xnor" else B
    launches = mod.LAUNCHES
    with pytest.raises(ValueError, match="CUDA or CPU"):
        if wrapper == "mvu_xnor":
            mod.mvu_xnor(a, w, 512)
        else:
            mod.mvu_binary(a, w)
    assert mod.LAUNCHES == launches


# (M, N, K) of every launch of the binary kernel on the main paths: the
# NID layers at M = 128 (a microbatch) and 4096, the CNV's dense layers at
# M = 1 (one image a microbatch)
BINARY_SHAPES = ([(m, n, k) for k, n, _, _ in tnid.LAYERS for m in (128, 4096)]
                 + [(1, 512, 256), (1, 512, 512), (1, 10, 512)])


@pytest.mark.parametrize("m,n,k", BINARY_SHAPES)
def test_binary_launch_plan_fits_and_covers_k(m, n, k):
    """A plan within the H100's 232,448 bytes of shared memory a block and
    the portable cluster of 8, whose K slices cover K exactly once, the
    same on every call; gemv at M <= 8, tiles above."""
    plan = B.binary_launch_plan(m, n, k)
    assert plan.arrangement == ("gemv" if m <= 8 else "tiled")
    assert plan.smem_bytes <= 232448 and 1 <= plan.splits <= 8
    slices = plan.k_slices(k)
    assert len(slices) == plan.splits and slices[0][0] == 0 and slices[-1][1] == k
    assert all(lo < hi for lo, hi in slices)
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    B.binary_launch_plan.cache_clear()
    assert B.binary_launch_plan(m, n, k) == plan
    if (m, k) == (128, 600):  # NID fc0: 8 tiles of 19 steps, split 8 ways
        assert plan.splits == 8


@pytest.mark.parametrize("mode", ["xnor", "binary"])
def test_init_params_on_the_mode_grid(mode):
    layer = MVULayer(MVUConfig(600, 7, mode=mode))
    p = layer.init_params(torch.Generator().manual_seed(0))
    if mode == "xnor":
        assert p.weights.dtype == torch.int32 and tuple(p.weights.shape) == (7, 19)
        x = packing.pack_bits(torch.randint(0, 2, (3, 600), dtype=torch.int32))
    else:
        assert p.weights.dtype == torch.int8 and set(p.weights.unique().tolist()) <= {0, 1}
        x = torch.randint(0, 16, (3, 600), dtype=torch.int32)
    assert tuple(layer(p, x).shape) == (3, 7)


# --------------------------------------------------------------------- slice
@pytest.fixture(scope="module", params=sorted(VARIANTS))
def accs(request):
    kw = dict(target="engine", tune="off", **VARIANTS[request.param])
    jacc = jbuild(jnid.build_graph(0), folding=jnid.foldings(), **kw)
    tacc = tbuild(tnid.build_graph(0), folding=tnid.foldings(), device="cpu", **kw)
    return jacc, tacc


@pytest.mark.parametrize("batch", [1, 3, 257])
def test_engine_equals_interpreter_and_jax(accs, batch):
    jacc, tacc = accs
    x = nid.make_dataset(batch, seed=batch)[0]
    launches = (X.LAUNCHES, B.LAUNCHES, mvu_int.LAUNCHES)
    y = tacc(torch.from_numpy(x))
    assert (X.LAUNCHES, B.LAUNCHES, mvu_int.LAUNCHES) == launches
    want = jacc(x)
    _same(y, want)
    _same(tacc.interpret(torch.from_numpy(x)), want)
    assert y.dtype == torch.float32 and tuple(y.shape) == (batch, 1)


def test_weights_and_report_equal_jax(accs):
    jacc, tacc = accs
    jn = [n for n in jacc.graph if n.op == "mvu"]
    tn = [n for n in tacc.graph if n.op == "mvu"]
    assert [n.name for n in tn] == [n.name for n in jn]
    for a, b in zip(tn, jn):
        for f in ("weights", "thresholds", "out_scale"):
            ta, ja = getattr(a.params["mvu"], f), getattr(b.params["mvu"], f)
            assert (ta is None) == (ja is None)
            if ta is not None:
                _same(ta, ja)
    keys = ("name", "mode", "n", "k", "cycles", "bram_bytes", "packed", "weight_bytes",
            "canonical_weight_bytes")
    assert ([[getattr(n, k) for k in keys] for n in tacc.report.nodes]
            == [[getattr(n, k) for k in keys] for n in jacc.report.nodes])
    assert tacc.report.step_names == jacc.report.step_names


def _plain_nodes(graph):
    out = []
    for n in graph:
        attrs = dict(n.attrs)
        params = {}
        for k, v in n.params.items():
            if k == "mvu":
                params[k] = {f: None if getattr(v, f) is None else np.asarray(getattr(v, f))
                             for f in ("weights", "thresholds", "out_scale")}
            else:
                params[k] = np.asarray(v)
        if "config" in attrs:
            attrs["config"] = dataclasses.asdict(attrs["config"])
        out.append({"op": n.op, "name": n.name, "attrs": attrs, "inputs": n.inputs,
                    "params": params})
    return out


def test_graph_carried_across_keeps_storage_and_output(accs):
    jacc, _ = accs
    fused = convert.graph_from_numpy(_plain_nodes(jacc.graph), device="cpu")
    for jn, tn in zip([n for n in jacc.graph if n.op == "mvu"],
                      [n for n in fused if n.op == "mvu"]):
        _same(tn.params["mvu"].weights, jn.params["mvu"].weights)
    x = nid.make_dataset(257, seed=4)[0]
    want = jacc(x)
    _same(FusedEngine(fused)(torch.from_numpy(x)), want)
    _same(tdf.execute(fused, torch.from_numpy(x)), want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_build_without_device_raises_when_cuda_is_absent(monkeypatch, variant):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BuildError, match="device='cpu'"):
        tbuild(tnid.build_graph(0), **VARIANTS[variant])
