"""The port's Section 6.5 flow (``repro_torch.launch.nid_qat``) against the
JAX package's ``benchmarks/nid_mlp.py``, on the CPU.

* The streamlined NID graph of the same float weights, built by both
  packages through the flow's steps, is equal node for node (integer
  weights, thresholds, scale), interprets to equal outputs and schedules to
  the paper's interval and latency (12 / 36 cycles, bottleneck fc0).  The
  weights are numpy draws, with the flow's identity batchnorm and with
  seeded batchnorm constants whose gammas take both signs (flipped rows).
* Weights trained by the port's ``train`` streamline like JAX's too.
* The straight-through gradient equals ``jax.grad`` of the reference's
  ``loss_ste`` in float64.
* ``accuracy_check`` on the CPU meets the reference's claims, its engine
  equal to the interpreter; a differing output is refused, never scored.
* The committed golden digests (``configs/nid_qat_golden.json``,
  ``scripts/nid_qat_golden.py``) are reproduced by both packages.

The port runs on CPU tensors (the kernels' plain versions).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dataflow as jdf
from repro.core.resource_model import mvu_resources as jax_mvu_resources
from repro.core.folding import Folding as JFolding
from repro_torch.configs import golden as golden_mod, nid_mlp
from repro_torch.core import dataflow as tdf
from repro_torch.data import nid
from repro_torch.launch import nid_qat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "nid_qat_golden", os.path.join(ROOT, "scripts", "nid_qat_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_build(graph):
    return nid_qat.build_streamlined(graph, device="cpu")


def _mvu_arrays(graph):
    """Per MVU node, its weights / thresholds / out_scale as numpy (None
    where absent), in graph order."""
    out = {}
    for n in graph:
        if n.op == "mvu":
            p = n.params["mvu"]
            out[n.name] = {k: None if v is None else np.asarray(
                v.cpu().numpy() if torch.is_tensor(v) else v)
                for k, v in (("weights", p.weights), ("thresholds", p.thresholds),
                             ("out_scale", p.out_scale))}
    return out


def _assert_same_nodes(jax_graph, port_graph):
    want, got = _mvu_arrays(jax_graph), _mvu_arrays(port_graph)
    assert list(got) == list(want) == ["fc0.mvu", "fc1.mvu", "fc2.mvu", "fc3.mvu"]
    for name in want:
        for key in ("weights", "thresholds", "out_scale"):
            w, g = want[name][key], got[name][key]
            assert (w is None) == (g is None), (name, key)
            if w is not None:
                assert g.dtype == w.dtype and np.array_equal(g, w), (name, key)


def test_seeded_weights_are_the_issue_draws():
    rng = np.random.default_rng(0)
    want = [rng.normal(0, 1, (n, k)) / np.sqrt(k)
            for k, n in zip(nid_qat.DIMS[:-1], nid_qat.DIMS[1:])]
    got = nid_qat.seeded_weights(0)
    assert [w.shape for w in got] == [(64, 600), (64, 64), (64, 64), (1, 64)]
    assert all(g.dtype == np.float32 and np.array_equal(g, w.astype(np.float32))
               for g, w in zip(got, want))
    bn = nid_qat.seeded_bn(1)
    assert all((p["gamma"] < 0).any() and (p["gamma"] > 0).any() for p in bn)


@pytest.mark.parametrize("variant", nid_qat.GOLDEN_VARIANTS)
def test_streamlined_graph_equals_jax(script, variant):
    graph = nid_qat.variant_graph(variant)
    jacc = script.jax_build(graph)
    tacc = _port_build(graph)
    assert tacc.report.step_names == list(nid_qat.BUILD_STEPS)
    _assert_same_nodes(jacc.graph, tacc.graph)
    x, _ = nid.make_dataset(1024, seed=1)
    want = np.asarray(jacc.interpret(jnp.asarray(x)))
    got = tacc.interpret(torch.from_numpy(x))
    assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want)
    assert torch.equal(tacc(torch.from_numpy(x)), got)  # the engine, too
    js, ts = jdf.schedule(jacc.graph), tdf.schedule(tacc.graph)
    assert (ts.steady_state_interval, ts.latency_cycles, ts.bottleneck.name) \
        == (js.steady_state_interval, js.latency_cycles, js.bottleneck.name) \
        == (12, 36, "fc0.mvu")


def test_seeded_bn_flips_rows():
    """The streamline negates a weight row where gamma < 0: the integer rows
    of the two variants differ in sign exactly there (equal to the JAX
    package's rows by ``test_streamlined_graph_equals_jax``)."""
    ident = _port_build(nid_qat.variant_graph("identity_bn"))
    seeded = _port_build(nid_qat.variant_graph("seeded_bn"))
    bn = nid_qat.seeded_bn(1)
    for i in range(3):
        wi = ident.graph[i + 1].params["mvu"].weights.numpy()
        ws = seeded.graph[i + 1].params["mvu"].weights.numpy()
        flip = bn[i]["gamma"] < 0
        assert flip.any()
        assert np.array_equal(ws[flip], -wi[flip]) and np.array_equal(ws[~flip], wi[~flip])


def test_port_trained_weights_streamline_like_jax(script):
    x_train, y_train = nid.make_dataset(1024, seed=0)
    ws = nid_qat.train(x_train, y_train, steps=40, device="cpu")
    assert all(w.dtype == torch.float32 and w.device.type == "cpu" for w in ws)
    graph = nid_qat.qat_graph(ws)
    jacc = script.jax_build(graph)
    tacc = _port_build(graph)
    _assert_same_nodes(jacc.graph, tacc.graph)
    x, _ = nid.make_dataset(1024, seed=1)
    want = np.asarray(jacc.interpret(jnp.asarray(x)))
    got = tacc(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _jax_loss_ste(ws, x, y):
    """``benchmarks/nid_mlp.py::accuracy_check.loss_ste``, copied."""
    h = x.astype(ws[0].dtype)
    for i, w in enumerate(ws):
        h = h @ w.T
        if i < len(ws) - 1:
            hq = jnp.clip(jnp.round(jnp.maximum(h, 0)), 0, 3)
            h = h + jax.lax.stop_gradient(hq - h)
    logit = h[..., 0]
    return jnp.mean(jnp.maximum(logit, 0) - logit * y
                    + jnp.log1p(jnp.exp(-jnp.abs(logit))))


def test_ste_gradient_matches_jax():
    x, y = nid.make_dataset(256, seed=0)
    ws64 = [w.astype(np.float64) for w in nid_qat.seeded_weights(3)]
    with jax.enable_x64(True):
        jws = [jnp.asarray(w) for w in ws64]
        jloss, jgrads = jax.value_and_grad(_jax_loss_ste)(
            jws, jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64))
        jgrads = [np.asarray(g) for g in jgrads]
        jloss = float(jloss)
    tws = [torch.from_numpy(w).requires_grad_() for w in ws64]
    tloss = nid_qat.loss_ste(tws, torch.from_numpy(x), torch.from_numpy(y))
    tgrads = torch.autograd.grad(tloss, tws)
    assert tloss.dtype == torch.float64
    np.testing.assert_allclose(float(tloss.detach()), jloss, rtol=1e-6)
    for g, j in zip(tgrads, jgrads):
        assert g.dtype == torch.float64 and np.abs(j).max() > 0
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-6, atol=0)


def test_accuracy_check_on_cpu():
    out = nid_qat.accuracy_check(device="cpu", steps=120)
    assert set(out) == {"float_acc", "mvu_int_acc", "pipeline_interval_cycles",
                        "pipeline_latency_cycles", "bottleneck"}
    claims = nid_qat.check_claims(nid_qat.layer_rows(), out)
    assert all(claims.values())
    assert out["mvu_int_acc"] >= out["float_acc"] - 0.05 and out["mvu_int_acc"] > 0.95
    assert (out["pipeline_interval_cycles"], out["pipeline_latency_cycles"],
            out["bottleneck"]) == (12, 36, "fc0.mvu")


def test_score_refuses_an_output_unequal_to_the_interpreter():
    run = nid_qat.prepare(n_train=256, n_test=64, steps=2, device="cpu")
    out = run.acc(run.x_test)
    assert nid_qat.score(run, out)["mvu_int_acc"] >= 0.0
    bad = out.clone()
    bad[0, 0] += 1.0
    with pytest.raises(AssertionError, match="not bit-exact"):
        nid_qat.score(run, bad)


def test_claims_raise_when_one_fails():
    rows = nid_qat.layer_rows()
    good = {"float_acc": 1.0, "mvu_int_acc": 0.99}
    assert all(nid_qat.check_claims(rows, good).values())
    with pytest.raises(AssertionError, match="int_acc_tracks_float"):
        nid_qat.check_claims(rows, {"float_acc": 1.0, "mvu_int_acc": 0.9})
    with pytest.raises(AssertionError, match="cycles_match_paper"):
        nid_qat.check_claims([{**rows[0], "exec_cycles_model": 16}, *rows[1:]], good)


def test_layer_rows_reproduce_table7_and_the_jax_depths():
    rows = nid_qat.layer_rows()
    assert [r["exec_cycles_model"] for r in rows] == [17, 13, 13, 13]
    assert [r["exec_cycles_paper_rtl"] for r in rows] == [17, 13, 13, 13]
    for r, (k, n, pe, simd) in zip(rows, nid_mlp.LAYERS):
        j = jax_mvu_resources(n, k, JFolding(pe, simd), mode="standard",
                              weight_bits=nid_mlp.WEIGHT_BITS,
                              act_bits=nid_mlp.INPUT_BITS, n_pixels=1, n_thresh=3)
        assert (r["wmem_depth"], r["inbuf_depth"]) == (j.weight_mem_depth,
                                                       j.input_buffer_depth)
        assert min(r["rtl_lut_bytes"], r["rtl_ff_bytes"], r["rtl_bram_bytes"]) > 0


def test_flow_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nid_qat.accuracy_check(n_train=8, n_test=8, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nid_qat.train(np.zeros((2, 600)), np.zeros(2))


# ------------------------------------------------------------------ golden
def test_the_golden_file_holds_the_variants():
    golden = nid_qat.load_golden()
    assert sorted(golden) == sorted(nid_qat.GOLDEN_VARIANTS)
    for v, gd in golden.items():
        assert gd["build"] == {"variant": v} and gd["batch"] == 4096
        assert gd["output_shape"] == [4096, 1]


@pytest.mark.parametrize("variant", nid_qat.GOLDEN_VARIANTS)
def test_jax_package_reproduces_the_qat_golden(script, variant):
    assert script.jax_digest(variant) == nid_qat.load_golden()[variant]


@pytest.mark.parametrize("variant", nid_qat.GOLDEN_VARIANTS)
def test_port_reproduces_the_qat_golden(variant):
    gd = nid_qat.load_golden()[variant]
    acc = _port_build(nid_qat.variant_graph(variant))
    x = torch.from_numpy(nid.make_dataset(gd["batch"], seed=gd["data_seed"])[0])
    y = acc(x)
    assert torch.equal(y, acc.interpret(x))
    assert golden_mod.digest_like(gd, y.numpy(), acc.graph) == gd
