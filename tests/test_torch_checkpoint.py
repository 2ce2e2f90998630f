"""The port's checkpoints and fault tolerance (``checkpoint/ckpt.py``,
``distributed/fault_tolerance.py``) against the JAX package, on the CPU.

The contract, fixed before the port was written:

* the file layout is the reference's: ``step_<N:08d>/arrays.npz`` and
  ``manifest.json``, keys the leaves' paths as the reference's
  ``_flatten`` joins them, written to ``.tmp`` and renamed;
* a port save restores in the JAX package equal, and a JAX save restores
  in the port equal (float32 and int32 leaves, the AdamW state's layout);
* a bfloat16 leaf round-trips in the port bit for bit (NaN, inf and -0
  included), and the port reads the JAX package's bfloat16 leaf (stored
  as ``V2``) bit for bit, where the JAX package's own restore raises;
* a missing key and a shape mismatch raise the reference's errors, with
  its messages;
* the ported ``test_checkpoint_manager_and_watchdog`` and
  ``test_atomic_save_never_leaves_partial``; the manager's retention,
  sync and async, equal to the reference's; the watchdog's straggler
  count equal to the reference's on the same step times.

Every test writes only under ``tmp_path``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JC
from repro.distributed import fault_tolerance as JF
from repro.optim import adamw as JA
from repro_torch.checkpoint import ckpt as TC
from repro_torch.configs import lm_golden as G
from repro_torch.convert import lm_numpy_params, lm_params_from_numpy, opt_state_from_numpy
from repro_torch.distributed import fault_tolerance as TF
from repro_torch.optim import adamw as TA
from repro_torch.tree import flat_leaves, tree_map


def _train_tree(seed=0):
    """A {"params", "opt"} tree of the reduced Yi-9B as numpy: float32
    params, an AdamW state some steps in (int32 step)."""
    params = lm_numpy_params(G.golden_config(), seed)
    rng = np.random.default_rng(seed + 1)
    moment = lambda: jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                  params)
    return {"params": params, "opt": {"mu": moment(), "nu": moment(),
                                      "step": np.array(7, np.int32)}}


def _port(tree):
    return {"params": lm_params_from_numpy(tree["params"]),
            "opt": opt_state_from_numpy(tree["opt"])}


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bit patterns (so NaN, inf and -0 compare exactly)."""
    view = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
            torch.float32: torch.int32, torch.float64: torch.int64}.get(t.dtype)
    return (t.view(view) if view is not None else t).numpy()


def _equal_trees(want: dict, got: dict):
    want, got = flat_leaves(want), flat_leaves(got)
    assert want.keys() == got.keys()
    for path, w in want.items():
        g = got[path]
        if isinstance(g, torch.Tensor):
            g = g.numpy()
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), path


def test_key_names_equal_jax_flatten():
    tree = _train_tree()
    want, _ = JC._flatten(jax.tree.map(jnp.asarray, tree))
    got = TC._flatten(_port(tree))
    assert sorted(got) == sorted(want)
    assert "opt/mu/layers/attn/wq/w" in got and "opt/step" in got
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_layout_and_manifest_equal_jax(tmp_path):
    tree = _train_tree()
    TC.save(str(tmp_path / "port"), 12, _port(tree), extra={"note": "x"})
    JC.save(str(tmp_path / "jax"), 12, jax.tree.map(jnp.asarray, tree), extra={"note": "x"})
    for d in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / d)) == ["step_00000012"]
        assert sorted(os.listdir(tmp_path / d / "step_00000012")) == ["arrays.npz",
                                                                     "manifest.json"]
    read = lambda d: json.load(open(tmp_path / d / "step_00000012" / "manifest.json"))
    port, ref = read("port"), read("jax")
    assert port.keys() == ref.keys() and port["time"] > 0
    assert {k: v for k, v in port.items() if k != "time"} == {
        k: v for k, v in ref.items() if k != "time"}


def test_port_save_restores_in_jax_equal(tmp_path):
    tree = _train_tree(1)
    TC.save(str(tmp_path), 3, _port(tree))
    like = jax.eval_shape(lambda: jax.tree.map(jnp.asarray, tree))
    _equal_trees(tree, JC.restore(str(tmp_path), 3, like))


def test_jax_save_restores_in_port_equal(tmp_path):
    tree = _train_tree(2)
    JC.save(str(tmp_path), 3, jax.tree.map(jnp.asarray, tree))
    like = _port(_train_tree(9))  # other values, the same shapes and dtypes
    got = TC.restore(str(tmp_path), 3, like)
    _equal_trees(tree, got)
    assert list(got) == list(like) and list(got["params"]) == list(like["params"])


def _bf16_edge_values() -> torch.Tensor:
    bits = np.array([0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC0, 0x3F80, 0x0001, 0xC2F7, 0x7F7F],
                    np.uint16)
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16).reshape(3, 3)


def test_bfloat16_round_trip_in_the_port_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)).to(
        torch.bfloat16), "edge": _bf16_edge_values(), "s": torch.tensor(3, dtype=torch.int32),
        "f": {"x": torch.ones(2, 2)}}
    TC.save(str(tmp_path), 1, tree)
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
        assert z["w"].dtype == np.dtype("V2") and z["f/x"].dtype == np.float32
    got = TC.restore(str(tmp_path), 1, tree)
    for k in ("w", "edge", "s"):
        assert got[k].dtype == tree[k].dtype and np.array_equal(_bits(got[k]), _bits(tree[k]))
    assert torch.equal(got["f"]["x"], tree["f"]["x"])


def test_port_reads_a_jax_bfloat16_leaf_bit_for_bit_where_jax_cannot(tmp_path):
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.standard_normal((4, 6)).astype(np.float32)).astype(jnp.bfloat16)
    edge = jnp.asarray(np.asarray(_bits(_bf16_edge_values())).view(np.uint16).view(
        a.dtype)).reshape(3, 3)
    tree = {"a": a, "b": {"c": jnp.arange(5, dtype=jnp.float32)},
            "edge": edge, "step": jnp.asarray(4, jnp.int32)}
    JC.save(str(tmp_path), 2, tree)
    with np.load(tmp_path / "step_00000002" / "arrays.npz") as z:
        assert z["a"].dtype == np.dtype("V2")
    # the reference fault: its own restore cannot cast the V2 leaf
    with pytest.raises(ValueError, match="No cast function available"):
        JC.restore(str(tmp_path), 2, jax.eval_shape(lambda: tree))
    like = {"a": torch.empty(4, 6, dtype=torch.bfloat16, device="meta"),
            "b": {"c": torch.empty(5, device="meta")},
            "edge": torch.empty(3, 3, dtype=torch.bfloat16, device="meta"),
            "step": torch.empty((), dtype=torch.int32, device="meta")}
    got = TC.restore(str(tmp_path), 2, like, device="cpu")
    for k in ("a", "edge"):
        assert got[k].dtype == torch.bfloat16
        assert np.array_equal(_bits(got[k]), np.asarray(tree[k]).view(np.int16))
    assert np.array_equal(got["b"]["c"].numpy(), np.arange(5, dtype=np.float32))
    assert got["step"].dtype == torch.int32 and got["step"].item() == 4


def test_restore_casts_to_the_like_dtype_as_jax(tmp_path):
    tree = {"x": np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)}
    TC.save(str(tmp_path), 1, {"x": torch.from_numpy(tree["x"])})
    want = JC.restore(str(tmp_path), 1, {"x": jax.ShapeDtypeStruct((3, 4), jnp.bfloat16)})
    got = TC.restore(str(tmp_path), 1, {"x": torch.empty(3, 4, dtype=torch.bfloat16)})
    assert np.array_equal(_bits(got["x"]), np.asarray(want["x"]).view(np.int16))


def _errors(fn):
    try:
        fn()
    except (KeyError, ValueError) as e:
        return type(e), str(e)
    raise AssertionError("no error")


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_missing_key_and_shape_errors_equal_jax(tmp_path, fault):
    tree = _train_tree(3)
    JC.save(str(tmp_path), 5, jax.tree.map(jnp.asarray, tree))
    bad = jax.tree.map(lambda a: a, tree)
    if fault == "missing":
        bad["opt"]["mu"]["extra"] = np.zeros(2, np.float32)
    else:
        bad["params"]["layers"]["attn"]["wk"]["w"] = np.zeros((2, 64, 31), np.float32)
    want = _errors(lambda: JC.restore(str(tmp_path), 5, jax.eval_shape(
        lambda: jax.tree.map(jnp.asarray, bad))))
    got = _errors(lambda: TC.restore(str(tmp_path), 5, _port(bad)))
    assert got == want
    assert want[0] is (KeyError if fault == "missing" else ValueError)


def test_restore_moves_onto_the_device(tmp_path):
    tree = _port(_train_tree(4))
    TC.save(str(tmp_path), 1, tree)
    got = TC.restore(str(tmp_path), 1, tree, device=torch.device("cpu"))
    assert all(t.device.type == "cpu" for t in flat_leaves(got).values())
    _equal_trees({k: {p: v.numpy() for p, v in flat_leaves(t).items()} for k, t in tree.items()},
                 {k: flat_leaves(t) for k, t in got.items()})


def test_restore_defaults_to_each_like_leafs_device(tmp_path):
    """Without ``device``, a leaf goes where its ``like`` leaf lies, and a
    meta leaf (no data, so no device of its own) onto the card: on a host
    without one that raises, as the port's other entry points do."""
    tree = {"w": torch.arange(6, dtype=torch.bfloat16), "s": {"n": torch.tensor(3)}}
    TC.save(str(tmp_path), 1, tree)
    mgr = TF.CheckpointManager(str(tmp_path))
    for got in (TC.restore(str(tmp_path), 1, tree), mgr.resume_latest(tree)[1]):
        have, want = flat_leaves(got), flat_leaves(tree)
        assert have.keys() == want.keys()
        for path, w in want.items():
            assert have[path].device.type == "cpu" and have[path].dtype == w.dtype
            assert torch.equal(have[path], w), path
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)
    if torch.cuda.is_available():
        got = TC.restore(str(tmp_path), 1, meta)
        assert all(t.is_cuda for t in flat_leaves(got).values())
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            TC.restore(str(tmp_path), 1, meta)
        with pytest.raises((AssertionError, RuntimeError)):
            mgr.resume_latest(meta)


def test_save_async_snapshots_before_it_returns(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    thread = TC.save_async(str(tmp_path), 1, tree)
    tree["w"].add_(100.0)  # the caller goes on training in place
    thread.join(30)
    assert not thread.is_alive()
    got = TC.restore(str(tmp_path), 1, tree)
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32))


def test_available_latest_and_prune_equal_jax(tmp_path):
    for d, mod, tree in (("port", TC, {"w": torch.zeros(2)}), ("jax", JC, {"w": jnp.zeros(2)})):
        for s in (3, 1, 10, 7):
            mod.save(str(tmp_path / d), s, tree)
        os.makedirs(tmp_path / d / "step_00000011")  # no manifest: not a checkpoint
        mod.prune(str(tmp_path / d), 2)
    for fn in ("available_steps", "latest_step"):
        assert getattr(TC, fn)(str(tmp_path / "port")) == getattr(JC, fn)(str(tmp_path / "jax"))
    assert TC.available_steps(str(tmp_path / "port")) == [7, 10]
    assert TC.available_steps(str(tmp_path / "none")) == [] and TC.latest_step(
        str(tmp_path / "none")) is None


def test_checkpoint_manager_and_watchdog(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32)}}
    d = str(tmp_path)
    mgr = TF.CheckpointManager(d, every=2, keep=2, use_async=True)
    for step in range(1, 7):
        mgr.maybe_save(step, tree)
    mgr.wait()
    assert TC.available_steps(d) == [4, 6]  # keep=2
    step, restored = mgr.resume_latest({k: v for k, v in tree.items()})
    assert step == 6
    np.testing.assert_array_equal(restored["a"].numpy(), tree["a"].numpy())

    wd = TF.StepWatchdog(straggler_factor=50.0)
    for _ in range(10):
        with wd:
            pass
    assert wd.stragglers == 0 and wd.median >= 0


def test_atomic_save_never_leaves_partial(tmp_path):
    d = str(tmp_path)
    TC.save(d, 1, {"w": torch.zeros((8, 8))})
    # a .tmp dir from a crashed save must not be listed
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    assert TC.available_steps(d) == [1]


@pytest.mark.parametrize("use_async", [True, False])
@pytest.mark.parametrize("every,keep", [(1, 1), (2, 3), (3, 2)])
def test_manager_retention_equals_jax(tmp_path, every, keep, use_async):
    port = TF.CheckpointManager(str(tmp_path / "port"), every=every, keep=keep,
                                use_async=use_async)
    ref = JF.CheckpointManager(str(tmp_path / "jax"), every=every, keep=keep,
                               use_async=use_async)
    saved = []
    for step in range(1, 10):
        saved.append((port.maybe_save(step, {"s": torch.tensor(step)}),
                      ref.maybe_save(step, {"s": jnp.asarray(step)})))
        port.wait()
        ref.wait()
        assert TC.available_steps(str(tmp_path / "port")) == JC.available_steps(
            str(tmp_path / "jax")), step
    assert all(a == b for a, b in saved)
    step, tree = port.resume_latest({"s": torch.tensor(0)})
    assert (step, tree["s"].item()) == (9 - 9 % every, 9 - 9 % every)
    assert TF.CheckpointManager(str(tmp_path / "empty")).resume_latest({}) == (0, None)


def test_watchdog_flags_the_reference_stragglers(monkeypatch):
    """Both watchdogs fed the same step times (their clocks stubbed) count
    the same stragglers and agree on the median."""
    durations = [0.1] * 9 + [0.5, 0.1, 0.31, 0.1, 2.0] + [0.1] * 30 + [0.35]
    counts = {}
    for name, mod in (("port", TF), ("jax", JF)):
        clock = iter(np.cumsum([0.0] + [x for d in durations for x in (d, 0.01)]).tolist())
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        wd = mod.StepWatchdog(window=16, straggler_factor=3.0)
        for _ in durations:
            with wd:
                pass
        counts[name] = (wd.stragglers, wd.median, list(wd.times), wd.factor)
    assert counts["port"] == counts["jax"] and counts["port"][0] == 4
