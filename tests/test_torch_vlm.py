"""The port's VLM modules (``models/layers.py::apply_mrope``,
``models/vlm.py``, the M-RoPE arm of ``models/attention.py``) against the
JAX package, on the CPU.

The contract, fixed before the port was written:

* ``apply_mrope`` within float32 rtol = atol = 1e-5 of the reference's
  (``test_apply_rope_equal_jax``'s bound) at (hd 32, sections (4, 6, 6))
  and (hd 128, (16, 24, 24)), on ``mrope_positions`` ids behind a
  40-patch prefix and on random distinct (3, B, S) ids; in bfloat16 the
  same bound on the float32 values before the final cast, and every
  bfloat16 result within one bfloat16 ulp of the reference's;
  ``sum(sections) == hd // 2`` asserted as the reference asserts it; text
  ids (all three equal) give ``apply_rope``'s values;
* ``mrope_positions`` equal to the reference's (``np.array_equal``, int32)
  with no prefix, a prefix shorter than the grid, 40 and 256 patches, and
  prefixes the grid width does not divide; the text starts at the grid's
  largest id plus one (16 behind 256 patches), and no id is read back from
  the device; ``patch_embed_stub`` zeros of the reference's shape and
  dtype;
* ``attention``, ``attention_prefill`` and ``attention_decode`` under
  M-RoPE within 1e-5 of the reference's, with (3, B, S) ids and with the
  2-D fallback, on a float and an int8 KV cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
import repro.models.layers as JL
import repro.models.vlm as JV
from repro.configs import get_reduced as jax_reduced
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import vlm as TV

ARCH = "qwen2-vl-7b"
ATOL = 1e-5
# (head_dim, sections): the reduced Qwen2-VL's and the full config's
HEADS = {"reduced": (32, (4, 6, 6)), "full": (128, (16, 24, 24))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.to(torch.float32) if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def _ids(kind: str, b: int, s: int) -> np.ndarray:
    """(3, B, S) int32 ids: the text behind a 40-patch prefix (its last S
    ids over P + S tokens), or random distinct ids."""
    if kind == "prefix":
        return np.array(JV.mrope_positions(b, 40, s - 40))
    return np.random.default_rng(5).permutation(3 * b * s * 4)[:3 * b * s].reshape(
        3, b, s).astype(np.int32)


# ------------------------------------------------------------ apply_mrope
@pytest.mark.parametrize("ids", ["prefix", "random"])
@pytest.mark.parametrize("head", sorted(HEADS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_equal_jax(dtype, head, ids):
    hd, sections = HEADS[head]
    x = np.random.default_rng(7).normal(size=(2, 48, 4, hd)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(_np(jx).copy()).to(getattr(torch, dtype))
    pos = _ids(ids, 2, 48)
    assert len({tuple(p) for p in pos.reshape(3, -1).T}) > 1 and not np.array_equal(pos[1],
                                                                                      pos[2])
    want = JL.apply_mrope(jx, jnp.asarray(pos), 1e6, sections)
    got = TL.apply_mrope(tx, torch.from_numpy(pos), 1e6, sections)
    assert got.dtype == tx.dtype and tuple(got.shape) == x.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL, atol=ATOL)
        return
    # bfloat16: the float32 values before the cast, then the cast itself
    jwide = JL.apply_mrope(jx.astype(jnp.float32), jnp.asarray(pos), 1e6, sections)
    twide = TL.apply_mrope(tx.to(torch.float32), torch.from_numpy(pos), 1e6, sections)
    np.testing.assert_allclose(twide.numpy(), np.asarray(jwide), rtol=ATOL, atol=ATOL)
    ulp = np.spacing(np.abs(_np(want)).astype(np.float32)) * 2 ** 16  # a bf16 ulp
    assert (np.abs(_np(got) - _np(want)) <= ulp).all()


def test_mrope_text_degenerates_to_rope():
    """The port's twin of the reference's test: identical t/h/w ids give
    ``apply_rope``'s values (within the reference's rtol 1e-4, atol 1e-5;
    the port's two are equal bit for bit, one frequency table)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 6, 4, 32)).astype(
        np.float32))
    pos = torch.arange(6, dtype=torch.int32)[None].expand(2, 6)
    a = TL.apply_rope(x, pos, theta=1e6)
    b = TL.apply_mrope(x, pos[None].expand(3, 2, 6), theta=1e6, sections=(6, 5, 5))
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-5)
    assert torch.equal(a, b)


def test_apply_mrope_asserts_the_sections_cover_half_the_head():
    x = torch.zeros((1, 2, 1, 32))
    pos = torch.zeros((3, 1, 2), dtype=torch.int32)
    with pytest.raises(AssertionError):
        TL.apply_mrope(x, pos, sections=(4, 6, 5))
    with pytest.raises(AssertionError):
        JL.apply_mrope(jnp.zeros((1, 2, 1, 32)), jnp.zeros((3, 1, 2), jnp.int32),
                       sections=(4, 6, 5))


# ------------------------------------------------------------ vlm.py
@pytest.mark.parametrize("batch,prefix,seq,grid_w", [
    (2, 0, 7, 16), (2, 5, 7, 16), (2, 40, 12, 16), (1, 256, 8, 16), (3, 37, 5, 16),
    (2, 10, 3, 4), (1, 16, 1, 16), (1, 1, 0, 16)])
def test_mrope_positions_equal_jax(batch, prefix, seq, grid_w):
    want = np.asarray(JV.mrope_positions(batch, prefix, seq, grid_w))
    got = TV.mrope_positions(batch, prefix, seq, grid_w)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (3, batch,
                                                                              prefix + seq)
    assert np.array_equal(got.numpy(), want)


def test_the_text_starts_after_the_grid_not_at_the_prefix_length():
    """Behind 256 patches (a 16 x 16 grid) the first text token's ids are
    (16, 16, 16) at index 256; behind 40 (h 0..2, w 0..15) they are 16;
    with no prefix 0; the last patch of the 256 sits at (0, 15, 15)."""
    pos = TV.mrope_positions(1, 256, 3)[:, 0]
    assert pos[:, 256].tolist() == [16, 16, 16] and pos[:, 255].tolist() == [0, 15, 15]
    assert pos[:, 258].tolist() == [18, 18, 18]
    p40 = TV.mrope_positions(2, 40, 2)[:, 1]
    assert p40[1, :40].max() == 2 and p40[2, :40].max() == 15
    assert p40[:, 40].tolist() == [16, 16, 16]
    assert TV.mrope_positions(1, 0, 3)[:, 0, 0].tolist() == [0, 0, 0]


def test_mrope_positions_read_nothing_back_from_the_device():
    """The text base comes from P and the grid width on the host: on the
    meta device (no values at all) the ids still build, of the shape and
    dtype the card would get."""
    pos = TV.mrope_positions(4, 256, 128, device="meta")
    assert pos.device.type == "meta" and pos.dtype == torch.int32
    assert tuple(pos.shape) == (3, 4, 384)


@pytest.mark.parametrize("dtype", [None, "float32"])
def test_patch_embed_stub_is_the_reference_zeros(dtype):
    kw = {} if dtype is None else {"dtype": jnp.dtype(dtype)}
    want = JV.patch_embed_stub(2, 40, 64, **kw)
    got = TV.patch_embed_stub(2, 40, 64, **({} if dtype is None else
                                             {"dtype": getattr(torch, dtype)}))
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    assert tuple(got.shape) == want.shape and not got.any()


# ------------------------------------------------------------ attention
def _cfg(**kw):
    kw = dict(dtype="float32", remat=False, **kw)
    return jax_reduced(ARCH).replace(**kw), get_reduced(ARCH).replace(**kw)


def _attn(tcfg, seed=11):
    one = jax.tree.map(lambda a: a[0], lm_numpy_params(tcfg, seed)["layers"]["attn"])
    return jax.tree.map(jnp.asarray, one), lm_params_from_numpy(one)


@pytest.mark.parametrize("ids", ["3d", "2d"])
def test_attention_mrope_equal_jax(ids):
    """The training forward's attention: (3, B, S) ids behind a prefix, or
    (B, S) ids, which ``_qkv`` broadcasts to all three sections."""
    jcfg, tcfg = _cfg()
    assert tcfg.mrope and tcfg.mrope_sections == (4, 6, 6)
    jp, tp = _attn(tcfg)
    x = np.random.default_rng(12).normal(size=(2, 48, tcfg.d_model)).astype(np.float32)
    pos = _ids("prefix", 2, 48) if ids == "3d" else np.broadcast_to(
        np.arange(48, dtype=np.int32), (2, 48)).copy()
    want = JA.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = TA.attention(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL, atol=ATOL)
    if ids == "2d":  # the broadcast equals passing the three equal rows
        pos3 = torch.from_numpy(pos)[None].expand(3, 2, 48)
        assert torch.equal(TA.attention(tp, tcfg, torch.from_numpy(x), pos3), got)


@pytest.mark.parametrize("ids", ["3d", "2d"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_attention_prefill_and_decode_mrope_equal_jax(kv_quant, ids):
    """A prefill of 44 tokens (three-axis ids behind a prefix, or 2-D ids)
    filling the cache, then three decode steps at (B, 1) positions (the
    reference broadcasts them): each output within 1e-5, and the caches."""
    jcfg, tcfg = _cfg(kv_quant=kv_quant)
    jp, tp = _attn(tcfg, 13)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(2, 44, tcfg.d_model)).astype(np.float32)
    pos = _ids("prefix", 2, 84)[:, :, 40:] if ids == "3d" else np.broadcast_to(
        np.arange(44, dtype=np.int32), (2, 44)).copy()
    jc = JA.init_kv_cache(jcfg, 2, 64, jnp.float32)
    tc = TA.init_kv_cache(tcfg, 2, 64, torch.float32)
    jy, jc = JA.attention_prefill(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), jc)
    ty, _ = TA.attention_prefill(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=ATOL, atol=ATOL)
    for step in range(3):
        xd = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
        pd = np.full((2, 1), 44 + step, np.int32)
        jy, jc = JA.attention_decode(jp, jcfg, jnp.asarray(xd), jnp.asarray(pd), jc)
        ty, _ = TA.attention_decode(tp, tcfg, torch.from_numpy(xd), torch.from_numpy(pd), tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=ATOL, atol=ATOL)
    for name in jc:
        if name in ("k", "v") and kv_quant:  # int8 levels: a float32 ulp may cross one
            assert np.abs(_np(tc[name]).astype(np.int32) - _np(jc[name])).max() <= 1
            assert (_np(tc[name]) == _np(jc[name])).mean() > 0.999
        else:
            np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), rtol=ATOL, atol=ATOL)
