"""The port's threshold folding and weight quantizer against the JAX package.

Same numpy inputs through both; the integer thresholds, flip masks and
integer weights must be equal, and so must the float32 intermediates the
integers come from (the port keeps the JAX op order).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import quantize as jq, thresholds as jth
from repro_torch.core import quantize as tq, thresholds as tth


def _bn(c, seed, gamma_special):
    rng = np.random.default_rng(seed)
    gamma = rng.uniform(0.3, 2.0, c).astype(np.float32)
    if gamma_special == "negative":
        gamma[::2] *= -1
    elif gamma_special == "zero":
        gamma[1::3] = 0.0
        gamma[::4] *= -1
    beta = rng.uniform(-1, 1, c).astype(np.float32)
    mean = rng.normal(0, 3, c).astype(np.float32)
    var = rng.uniform(0.1, 4, c).astype(np.float32)
    return gamma, beta, mean, var


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gamma_special", ["positive", "negative", "zero"])
@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("act_scale", [1.0, 0.37])
def test_bn_quant_thresholds_equal_jax(gamma_special, bits, act_scale):
    bn = _bn(24, bits * 13 + len(gamma_special), gamma_special)
    jt, jflip = jth.bn_quant_thresholds(*(jnp.asarray(v) for v in bn), bits=bits,
                                        act_scale=act_scale)
    tt, tflip = tth.bn_quant_thresholds(*(torch.from_numpy(v) for v in bn), bits=bits,
                                        act_scale=act_scale)
    _eq(tt, jt)
    _eq(tflip, jflip)
    _eq(tth.integerize_thresholds(tt), jth.integerize_thresholds(jt))
    # the fused-epilogue form: thresholds over a per-row dequant scale
    scale = np.random.default_rng(bits).uniform(0.01, 0.5, 24).astype(np.float32)
    _eq(tth.integerize_thresholds(tt / torch.from_numpy(scale)[:, None]),
        jth.integerize_thresholds(jt / jnp.asarray(scale)[:, None]))


def test_apply_thresholds_and_signs_equal_jax():
    rng = np.random.default_rng(4)
    acc = rng.integers(-60, 60, (33, 8)).astype(np.int32)
    t = np.sort(rng.integers(-50, 50, (8, 3)), axis=1).astype(np.int32)
    _eq(tth.apply_thresholds(torch.from_numpy(acc), torch.from_numpy(t)),
        jth.apply_thresholds(jnp.asarray(acc), jnp.asarray(t)))
    w = rng.integers(-1, 2, (8, 5)).astype(np.int32)
    flip = rng.integers(0, 2, 8).astype(bool)
    _eq(tth.streamline_signs(torch.from_numpy(w), torch.from_numpy(flip)),
        jth.streamline_signs(jnp.asarray(w), jnp.asarray(flip)))


@pytest.mark.parametrize("bits", [1, 2, 8])
@pytest.mark.parametrize("axis", [0, None])
def test_quantize_weights_equal_jax(bits, axis):
    rng = np.random.default_rng(bits)
    w = (rng.normal(0, 1, (64, 600)) / np.sqrt(600)).astype(np.float32)
    w[3, 7] = 0.0
    jqt = jq.quantize_weights(jnp.asarray(w), bits, axis=axis)
    tqt = tq.quantize_weights(torch.from_numpy(w), bits, axis=axis)
    _eq(tqt.values, jqt.values)
    # the bipolar scale is a float mean: the port sums an (N, K) weight's rows
    # in XLA:CPU's order; a tensor-wide mean (axis=None) is not matched yet
    if bits > 1 or axis == 0:
        _eq(tqt.scale, jqt.scale)
    assert (tqt.bits, tqt.signed) == (jqt.bits, jqt.signed)


@pytest.mark.parametrize("k", [1, 3, 31, 32, 33, 64, 600, 1100])
@pytest.mark.parametrize("n", [1, 64])
def test_one_bit_scale_equals_jax_mean(n, k):
    """``jnp.mean`` on the CPU sums in windows of 32 and multiplies by
    float32(1/K); ``torch.mean`` would differ in the last bit already at
    K = 3 (ROADMAP queue C)."""
    w = (np.random.default_rng(4 if k == 3 else k).normal(0, 1, (n, k))
         / np.sqrt(k)).astype(np.float32)
    _eq(tq.quantize_weights(torch.from_numpy(w), 1).scale,
        jq.quantize_weights(jnp.asarray(w), 1).scale)


@pytest.mark.parametrize("k", [27, 576, 1152, 2304])
def test_one_bit_scale_equals_jax_mean_at_conv_widths(k):
    """CNV's conv weights reach the 1-bit scale as (N, Kd^2*C) rows after
    ``pack_conv_weights``: K = 27 (3x3x3) to 2304 (3x3x256), drawn as the
    CNV config draws them."""
    rng = np.random.default_rng(k)
    w = rng.normal(0, 0.5, (3, 3, k // 9, 64)).astype(np.float32)
    rows = np.ascontiguousarray(w.transpose(3, 0, 1, 2).reshape(64, k))
    _eq(tq.quantize_weights(torch.from_numpy(rows), 1).scale,
        jq.quantize_weights(jnp.asarray(rows), 1).scale)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("signed", [True, False])
def test_int_bounds_equal_jax(bits, signed):
    assert tq.int_bounds(bits, signed) == jq.int_bounds(bits, signed)


def test_integerize_saturates_like_xla():
    t = np.array([[np.inf, -np.inf, np.nan, 1.6e12, -1.6e12, 2.5, -2.5,
                   2.0**31, -2.0**31]], np.float32)
    _eq(tth.integerize_thresholds(torch.from_numpy(t)),
        jth.integerize_thresholds(jnp.asarray(t)))
