"""The packed-weight datapaths against the JAX package, on the CPU, with
tolerance 0 (``np.array_equal``, dtypes too).

* ``mvu_binary_packed`` (32-bit bitplanes) and ``mvu_int2_packed`` (2-bit
  lanes): the wrappers on CPU tensors (the kernels' plain versions) against
  the JAX Pallas kernels in interpret mode at N in {1, 7, 64}, K in
  {1, 33, 64, 600}, M in {1, 3, 128} and all three epilogues, with
  activations up to 299: the kernels narrow them to int8 by a wrapping
  cast, as the JAX kernels do.  ``backend="torch"`` (the ports of the JAX
  ``*_xla`` references, which do not narrow) against those.
* The storage: ``pack_mvu_weights``, ``packed_weight_bytes``, the resource
  model's footprints and the ``pack_weights`` pass.
* The slice: the NID-MLP built at full width with ``pack="always"`` in
  the binary and 2-bit standard variants by both packages, ``acc(x)`` and
  ``acc.interpret(x)`` against the JAX engine at B in {1, 3, 257}.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.build import build as jbuild
from repro.configs import nid_mlp as jnid
from repro.data import nid
from repro.kernels import mvu_packed as jmp, ops as jops
from repro_torch import convert
from repro_torch.build import BuildError, build as tbuild
from repro_torch.configs import nid_mlp as tnid
from repro_torch.core import dataflow as tdf, lowering
from repro_torch.core.engine import FusedEngine
from repro_torch.core.mvu import MVUConfig, MVULayer, MVUParams
from repro_torch.core.resource_model import weight_resident_bytes
from repro_torch.kernels import mvu_int, mvu_packed as P, mvu_xnor, ops, packing

NS = (1, 7, 64)
KS = (1, 33, 64, 600)
MS = (1, 3, 128)
EPILOGUES = ("raw", "thresholds", "scale")
VARIANTS = {
    "binary_packed": {"mode": "binary", "act_bits": 4, "pack": "always"},
    "standard_packed": {"mode": "standard", "weight_bits": 2, "act_bits": 2,
                        "pack": "always"},
}


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
    return None if x is None else torch.from_numpy(np.array(_np(x)))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _epilogue(n, span, epilogue, rng):
    if epilogue == "thresholds":
        return np.sort(rng.integers(-span, span, (n, 3)), axis=1).astype(np.int32), None
    if epilogue == "scale":
        return None, rng.uniform(0.01, 2.0, (n,)).astype(np.float32)
    return None, None


CODINGS = {  # mode -> (weight values drawn, the wrapper, its launch counter)
    "binary": ((0, 2), "mvu_binary_packed", "BINARY_LAUNCHES"),
    "standard": ((-2, 2), "mvu_int2_packed", "INT2_LAUNCHES"),
}


def _case(mode, n, k, m, epilogue, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-8, 300, (m, k)).astype(np.int32)  # >= 128 wraps in the kernels
    lo, hi = CODINGS[mode][0]
    w = rng.integers(lo, hi, (n, k)).astype(np.int8)
    t, s = _epilogue(n, 128 * k + 8, epilogue, rng)
    return a, jmp.pack_mvu_weights(_j(w), mode), w, t, s


# ------------------------------------------------------------------- kernels
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("mode", sorted(CODINGS))
def test_packed_kernel_matches_jax_pallas(mode, n, k, m, epilogue):
    a, jwp, _, t, s = _case(mode, n, k, m, epilogue, 3000 * n + 10 * k + m)
    want = jops.mvu(_j(a), jwp, mode, k_bits=k, thresholds=_j(t), out_scale=_j(s),
                    packed=True)
    counter = CODINGS[mode][2]
    launches = getattr(P, counter)
    got = ops.mvu(_t(a), _t(jwp), mode, k_bits=k, thresholds=_t(t), out_scale=_t(s),
                  packed=True)
    assert getattr(P, counter) == launches  # a CPU tensor takes the plain version
    _same(got, want)
    # the references, as the JAX package's xla arm, take a as it is (no narrowing)
    want_xla = jops.mvu(_j(a), jwp, mode, k_bits=k, thresholds=_j(t), out_scale=_j(s),
                        packed=True, backend="xla")
    _same(ops.mvu(_t(a), _t(jwp), mode, k_bits=k, thresholds=_t(t), out_scale=_t(s),
                  packed=True, backend="torch"), want_xla)


@pytest.mark.parametrize("mode", sorted(CODINGS))
def test_int8_narrowing_is_the_reference_property(mode):
    """Activations >= 128 wrap on the JAX package's packed Pallas kernels,
    not on its unpacked datapath: the port follows (ROADMAP queue C)."""
    a, jwp, w, _, _ = _case(mode, 7, 33, 3, "raw", 11)
    a[:, 0] = 200  # wraps to -56 on the packed kernels
    packed = jops.mvu(_j(a), jwp, mode, k_bits=33, packed=True)
    unpacked = jops.mvu(_j(a), _j(w), mode)
    assert not np.array_equal(np.asarray(packed), np.asarray(unpacked))
    _same(ops.mvu(_t(a), _t(jwp), mode, k_bits=33, packed=True), packed)
    _same(ops.mvu(_t(a), _t(w), mode), unpacked)
    a8 = ((a + 128) % 256 - 128).astype(np.int32)  # the wrap, written out
    _same(ops.mvu(_t(a), _t(jwp), mode, k_bits=33, packed=True),
          jops.mvu(_j(a8), _j(w), mode))


@pytest.mark.parametrize("mode", ["xnor", "binary", "standard"])
def test_pack_mvu_weights_and_bytes_equal_jax(mode):
    rng = np.random.default_rng(7)
    for n, k in ((64, 600), (64, 64), (1, 64), (7, 33)):
        if mode == "xnor":
            w = jmp.pack_mvu_weights(_j(rng.integers(0, 2, (n, k)).astype(np.int32)), "binary")
        else:
            lo, hi = CODINGS[mode][0]
            w = _j(rng.integers(lo, hi, (n, k)).astype(np.int8))
        _same(P.pack_mvu_weights(_t(w), mode), jmp.pack_mvu_weights(w, mode))
        for wb in (1, 2):
            want = jmp.packed_weight_bytes(n, k, mode, wb)
            assert P.packed_weight_bytes(n, k, mode, wb) == want
            assert weight_resident_bytes(n, k, mode, packed=True) == want
        assert weight_resident_bytes(n, k, mode, packed=False) == (
            n * packing.num_words(k) * 4 if mode == "xnor" else n * k)


def test_pack_mvu_weights_rejects_wide_standard_as_in_jax():
    w = np.random.default_rng(10).integers(-8, 8, (4, 8)).astype(np.int8)
    with pytest.raises(ValueError, match="2-bit") as jerr:
        jmp.pack_mvu_weights(_j(w), "standard")
    with pytest.raises(ValueError, match="2-bit") as terr:
        P.pack_mvu_weights(_t(w), "standard")
    assert str(terr.value) == str(jerr.value)


def test_packed_layer_packs_canonical_storage_on_the_fly():
    rng = np.random.default_rng(12)
    w = torch.from_numpy(rng.integers(0, 2, (7, 40)).astype(np.int8))
    x = torch.from_numpy(rng.integers(0, 16, (5, 40)).astype(np.int32))
    cfg = MVUConfig(40, 7, mode="binary", packed=True)
    got = MVULayer(cfg)(MVUParams(w, None, None), x)
    want = MVULayer(MVUConfig(40, 7, mode="binary"))(MVUParams(w, None, None), x)
    _same(got, want)
    wide = torch.full((7, 40), 5, dtype=torch.int8)
    with pytest.raises(ValueError, match="2-bit"):
        MVULayer(MVUConfig(40, 7, weight_bits=4, packed=True))(MVUParams(wide, None, None), x)


@pytest.mark.parametrize("bad", ["int8_bitplanes", "uint32_bitplanes", "int8_lanes",
                                 "too_few_words", "too_few_bytes", "k_mismatch"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    a = torch.zeros((4, 40), dtype=torch.int32)
    words = torch.zeros((3, 2), dtype=torch.int32)
    lanes = torch.zeros((3, 10), dtype=torch.uint8)
    with pytest.raises((TypeError, ValueError)):
        if bad == "int8_bitplanes":
            P.mvu_binary_packed(a, words.to(torch.int8), 40)
        elif bad == "uint32_bitplanes":
            P.mvu_binary_packed(a, words.to(torch.uint32), 40)
        elif bad == "int8_lanes":
            P.mvu_int2_packed(a, lanes.to(torch.int8), 40)
        elif bad == "too_few_words":
            P.mvu_binary_packed(a, words[:, :1].contiguous(), 40)
        elif bad == "too_few_bytes":
            P.mvu_int2_packed(a, lanes[:, :9].contiguous(), 40)
        else:
            P.mvu_int2_packed(a, lanes, 36)


@pytest.mark.parametrize("mode", sorted(CODINGS))
def test_meta_tensor_raises_instead_of_falling_back(mode):
    a = torch.empty((4, 40), dtype=torch.int32, device="meta")
    dtype, cols = (torch.int32, 2) if mode == "binary" else (torch.uint8, 10)
    w = torch.empty((3, cols), dtype=dtype, device="meta")
    _, name, counter = CODINGS[mode]
    launches = getattr(P, counter)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        getattr(P, name)(a, w, 40)
    assert getattr(P, counter) == launches


def _graph_with_packed_flags(mode):
    g = lowering.finalize(lowering.lower_to_mvu(tnid.build_graph(0), mode=mode,
                                                weight_bits=2, act_bits=2))
    return lowering.pack_weights(g, force=True)


@pytest.mark.parametrize("mode", ["xnor", "binary", "standard"])
def test_pack_weights_pass_is_idempotent_and_typed(mode):
    g = _graph_with_packed_flags(mode)
    nodes = [n for n in g if n.op == "mvu"]
    want = {"xnor": torch.int32, "binary": torch.int32, "standard": torch.uint8}[mode]
    assert all(n.attrs["config"].packed for n in nodes)
    assert all(n.params["mvu"].weights.dtype == want for n in nodes)
    again = lowering.pack_weights(g)
    for a, b in zip(nodes, [n for n in again if n.op == "mvu"]):
        assert torch.equal(a.params["mvu"].weights, b.params["mvu"].weights)
    assert lowering.packable(nodes[0].attrs["config"])
    assert not lowering.packable(MVUConfig(8, 4, weight_bits=4))


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
    counters = (P.BINARY_LAUNCHES, P.INT2_LAUNCHES, mvu_xnor.LAUNCHES, mvu_int.LAUNCHES)
    y = tacc(torch.from_numpy(x))
    assert (P.BINARY_LAUNCHES, P.INT2_LAUNCHES, mvu_xnor.LAUNCHES,
            mvu_int.LAUNCHES) == counters
    want = jacc(x)
    _same(y, want)
    _same(tacc.interpret(torch.from_numpy(x)), want)
    assert y.dtype == torch.float32 and tuple(y.shape) == (batch, 1)


def test_storage_and_report_equal_jax(accs):
    jacc, tacc = accs
    for a, b in zip([n for n in tacc.graph if n.op == "mvu"],
                    [n for n in jacc.graph if n.op == "mvu"]):
        assert a.attrs["config"].packed and b.attrs["config"].packed
        for f in ("weights", "thresholds", "out_scale"):
            ta, ja = getattr(a.params["mvu"], f), getattr(b.params["mvu"], f)
            assert (ta is None) == (ja is None)
            if ta is not None:
                _same(ta, ja)
    keys = ("name", "mode", "packed", "weight_bytes", "canonical_weight_bytes",
            "bram_bytes", "cycles")
    assert ([[getattr(n, k) for k in keys] for n in tacc.report.nodes]
            == [[getattr(n, k) for k in keys] for n in jacc.report.nodes])
    assert [s.verified for s in tacc.report.steps] == [s.verified for s in jacc.report.steps]


def test_graph_carried_across_keeps_storage_and_output(accs):
    """The JAX build's packed graph (uint32 bitplanes or uint8 lanes),
    carried across by ``convert.graph_from_numpy``, runs in the port."""
    jacc, _ = accs
    nodes = []
    for n in jacc.graph:
        attrs = dict(n.attrs)
        if "config" in attrs:
            attrs["config"] = dataclasses.asdict(attrs["config"])
        params = {k: ({f: None if getattr(v, f) is None else np.asarray(getattr(v, f))
                       for f in ("weights", "thresholds", "out_scale")}
                      if k == "mvu" else np.asarray(v)) for k, v in n.params.items()}
        nodes.append({"op": n.op, "name": n.name, "attrs": attrs, "inputs": n.inputs,
                      "params": params})
    fused = convert.graph_from_numpy(nodes, device="cpu")
    for jn, tn in zip([n for n in jacc.graph if n.op == "mvu"],
                      [n for n in fused if n.op == "mvu"]):
        assert tn.attrs["config"].packed
        _same(tn.params["mvu"].weights, jn.params["mvu"].weights)
    x = nid.make_dataset(257, seed=4)[0]
    want = jacc(x)
    _same(FusedEngine(fused)(torch.from_numpy(x)), want)
    _same(tdf.execute(fused, torch.from_numpy(x)), want)


def test_pack_always_skips_wide_standard_weights_as_in_jax():
    """``pack="always"`` packs only packable nodes: 4-bit standard weights
    keep canonical storage in both packages (packing them raises, above)."""
    kw = dict(target="engine", tune="off", mode="standard", weight_bits=4, act_bits=2,
              pack="always")
    jacc = jbuild(jnid.build_graph(0), folding=jnid.foldings(), **kw)
    tacc = tbuild(tnid.build_graph(0), folding=tnid.foldings(), device="cpu", **kw)
    assert [n.packed for n in tacc.report.nodes] == [n.packed for n in jacc.report.nodes] \
        == [False] * 4
    x = nid.make_dataset(64, seed=2)[0]
    _same(tacc(torch.from_numpy(x)), jacc(x))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_build_without_device_raises_when_cuda_is_absent(monkeypatch, variant):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BuildError, match="device='cpu'"):
        tbuild(tnid.build_graph(0), **VARIANTS[variant])
