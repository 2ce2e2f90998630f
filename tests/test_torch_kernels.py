"""The port's MVU kernel module against the JAX package, on the CPU.

``repro_torch.kernels.ops.mvu`` on CPU tensors takes the kernel's plain
version (``mvu_int_plain``); it is held for exact equality (values and
dtype) to the JAX ``ops.mvu(backend="pallas")`` run in interpret mode and
to the JAX oracle ``ref.mvu_int_ref``, on the same numpy inputs.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import _common, dense_mvu, mvu_int as K, ops, ref

MS = (1, 3, 128, 300)
NKS = ((1, 8), (1, 64), (16, 32), (64, 64), (64, 600))
WEIGHTS = {"int2": (-1, 2), "int8": (-128, 128)}
EPILOGUES = ("raw", "thresholds", "scale")


def _inputs(m, n, k, wkind, epilogue, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, (m, k)).astype(np.int32)
    lo, hi = WEIGHTS[wkind]
    w = rng.integers(lo, hi, (n, k)).astype(np.int8)
    t = s = None
    if epilogue == "thresholds":
        span = 3 * max(abs(lo), hi) * k
        t = np.sort(rng.integers(-span, span, (n, 3)), axis=1).astype(np.int32)
    elif epilogue == "scale":
        s = rng.uniform(0.01, 2.0, (n,)).astype(np.float32)
    return a, w, t, s


def _jax(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.from_numpy(x)


def _port(a, w, t, s, **kw):
    out = ops.mvu(_torch(a), _torch(w), thresholds=_torch(t), out_scale=_torch(s), **kw)
    return out.numpy()


def _assert_same(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("wkind", sorted(WEIGHTS))
@pytest.mark.parametrize("n,k", NKS)
@pytest.mark.parametrize("m", MS)
def test_mvu_matches_jax_pallas_and_oracle(m, n, k, wkind, epilogue):
    a, w, t, s = _inputs(m, n, k, wkind, epilogue, seed=m * 7 + k)
    want_pl = jops.mvu(_jax(a), _jax(w), thresholds=_jax(t), out_scale=_jax(s),
                       backend="pallas")
    want_ref = jref.mvu_int_ref(_jax(a), _jax(w), _jax(t), _jax(s))
    launches = K.LAUNCHES
    got = _port(a, w, t, s)
    assert K.LAUNCHES == launches  # a CPU tensor takes the plain version
    _assert_same(got, want_pl)
    _assert_same(got, want_ref)
    _assert_same(_port(a, w, t, s, backend="torch"), want_ref)


def test_both_epilogues_raise():
    a, w, t, _ = _inputs(4, 8, 16, "int2", "thresholds")
    s = np.ones(8, np.float32)
    with pytest.raises(ValueError, match="mutually exclusive"):
        jops.mvu(_jax(a), _jax(w), thresholds=_jax(t), out_scale=_jax(s))
    with pytest.raises(ValueError, match="mutually exclusive"):
        _port(a, w, t, s)
    with pytest.raises(ValueError, match="mutually exclusive"):
        K.mvu_int_plain(_torch(a), _torch(w), _torch(t), _torch(s))


def test_accumulator_width_no_overflow():
    """int8 x int8 over K=8192 stays within int32 (FINN wide-accumulator claim)."""
    a = np.full((8, 8192), 7, np.int8)
    w = np.full((8, 8192), 7, np.int8)
    want = jops.mvu(_jax(a), _jax(w), "standard", block_m=8, block_n=8, block_k=256)
    got = _port(a, w, None, None)
    assert int(got[0, 0]) == 49 * 8192
    _assert_same(got, want)


def test_int32_sum_wraps_like_xla():
    rng = np.random.default_rng(5)
    a = rng.integers(-2**31, 2**31 - 1, (5, 77)).astype(np.int32)
    w = rng.integers(-128, 128, (9, 77)).astype(np.int8)
    _assert_same(_port(a, w, None, None), jref.mvu_int_ref(_jax(a), _jax(w)))


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.int16])
def test_narrow_activations_are_widened(dtype):
    a, w, t, _ = _inputs(6, 16, 32, "int8", "thresholds", seed=3)
    got = ops.mvu(torch.from_numpy(a).to(dtype), torch.from_numpy(w),
                  thresholds=torch.from_numpy(t))
    _assert_same(got.numpy(), _port(a, w, t, None))


@pytest.mark.parametrize("bad", ["float_a", "int64_a", "int32_w", "thr_dtype",
                                 "scale_shape", "k_mismatch", "non_contiguous",
                                 "blocks"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a, w, _, s = _inputs(4, 8, 16, "int2", "scale")
    a, w, s = torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(s)
    kw = {"out_scale": s}
    if bad == "float_a":
        a = a.float()
    elif bad == "int64_a":
        a = a.long()
    elif bad == "int32_w":
        w = w.int()
    elif bad == "thr_dtype":
        kw = {"thresholds": torch.zeros(8, 3, dtype=torch.int64)}
    elif bad == "scale_shape":
        kw = {"out_scale": torch.ones(8, 1)}
    elif bad == "k_mismatch":
        a = a[:, :15].contiguous()
    elif bad == "non_contiguous":
        a = torch.cat([a, a], 1)[:, ::2]
    elif bad == "blocks":
        kw["block_m"] = 64
    with pytest.raises((TypeError, ValueError)):
        K.mvu_int(a, w, **kw)


def test_epilogue_value_and_pad_to():
    acc = torch.tensor([[-5, 0, 5]], dtype=torch.int32).T  # (3, 1)
    t = torch.tensor([[-2, 1, 4]], dtype=torch.int32)
    assert _common.epilogue_value(acc, t, None)[:, 0].tolist() == [0, 1, 3]
    assert torch.equal(_common.epilogue_value(acc, None, None), acc)
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert tuple(_common.pad_to(x, 0, 4).shape) == (4, 3)
    assert tuple(_common.pad_to(x, 1, 4, value=-1).shape) == (2, 4)
    assert _common.pad_to(x, 1, 4, value=-1)[:, 3].tolist() == [-1, -1]
    assert _common.pad_to(x, 0, 2) is x


def test_oracle_matches_plain_on_random_int8(monkeypatch):
    """The plain version is the port's oracle; chunked over M (here 3 rows
    a chunk) it still equals the JAX oracle."""
    assert ref.mvu_int_ref is K.mvu_int_plain
    a, w, t, _ = _inputs(40, 50, 160, "int8", "thresholds", seed=9)
    monkeypatch.setattr(_common, "PLAIN_CHUNK_BYTES", 3 * 8 * 50 * 160)
    got = K.mvu_int_plain(*[_torch(v) for v in (a, w, t)])
    _assert_same(got.numpy(), jref.mvu_int_ref(_jax(a), _jax(w), _jax(t)))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_ops_mvu_ignores_tile_kwargs(backend, monkeypatch):
    """JAX's tile kwargs change no number (integer sums do not depend on the
    order, and the plain versions take no tile), but on the hand-kernel
    backend they reach the kernel's wrapper, which launches the compiled
    tile they round up to; ``block_m``, the burst, does not."""
    a, w, t, _ = _inputs(40, 16, 64, "int2", "thresholds", seed=4)
    got = _port(a, w, t, None, backend=backend, block_m=8, block_n=8, block_k=256)
    _assert_same(got, _port(a, w, t, None, backend=backend))
    seen = []
    real = K.mvu_int
    monkeypatch.setattr(K, "mvu_int", lambda *args, **kw: seen.append(kw) or real(*args, **kw))
    _assert_same(_port(a, w, t, None, backend=backend, block_m=8, block_n=48, block_k=40,
                       rows_per_tile=64), got)
    if backend == "torch":
        assert seen == []  # the oracle takes no tile
        return
    assert seen == [{"block_n": 48, "block_k": 40, "rows_per_tile": 64}]
    plan = dense_mvu.dense_launch_plan(40, 16, 64, "int8", **seen[0])
    assert (plan.tile_m, plan.tile_n, plan.kstep) == (32, 64, 64)  # 64 rows: 32 x 32 x 32 only


def test_layer_fn_is_mvu_on_a_params_dict():
    a, w, t, _ = _inputs(5, 16, 64, "int2", "thresholds", seed=2)
    fn = ops.mvu_layer_fn("standard")
    got = fn({"w": torch.from_numpy(w), "t": torch.from_numpy(t)}, torch.from_numpy(a))
    _assert_same(got.numpy(), _port(a, w, t, None))
