"""The port's fused conv (``kernels/swu_mvu.py``) and SWU against the JAX package.

Same numpy-seeded integer inputs through both packages, exact equality
(``np.array_equal``) on every output:

* ``core/swu.py`` (``out_dim``, ``sliding_window``, ``pack_conv_weights``,
  ``conv_via_swu_mvu``) over the JAX conv tests' (kernel, stride, pad) grid
  on a non-square (2, 9, 13, 3) input;
* ``ops.conv_mvu`` -- the ``cuda`` arm (on the CPU: the kernel's plain
  version ``conv_mvu_plain``) against the JAX package's Pallas kernel in
  interpret mode, the ``torch`` arm against its ``xla`` arm -- in every
  mode over the grid, the three epilogues taking turns, pad > 0 included
  (an xnor pad tap is bipolar -1, not "no contribution");
* the int8 narrowing of the kernel arm (an activation of 200), which the
  oracle arm does not do, in both packages.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import swu as jswu
from repro.kernels import ops as jops, packing as jpacking
from repro_torch.core import swu as tswu
from repro_torch.kernels import ops as tops, packing as tpacking, swu_mvu

GRID = [(kd, st, pd) for kd in (1, 3, 5) for st in (1, 2) for pd in (0, 1, 2)]
MODES = ("standard", "binary", "xnor")
EPILOGUES = ("raw", "thresholds", "scale")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kd,stride,pad", GRID)
def test_swu_helpers_equal_jax(kd, stride, pad):
    rng = np.random.default_rng(kd * 100 + stride * 10 + pad)
    x = rng.integers(-4, 5, (2, 9, 13, 3)).astype(np.int32)
    w = rng.normal(size=(kd, kd, 3, 5)).astype(np.float32)
    assert tswu.out_dim(9, kd, stride, pad) == jswu.out_dim(9, kd, stride, pad)
    assert tswu.out_dim(13, kd, stride, pad) == jswu.out_dim(13, kd, stride, pad)
    _eq(tswu.sliding_window(torch.from_numpy(x), kd, stride, pad),
        jswu.sliding_window(jnp.asarray(x), kd, stride, pad))
    _eq(tswu.pack_conv_weights(torch.from_numpy(w)), jswu.pack_conv_weights(jnp.asarray(w)))
    # integer-valued float32 operands: every partial sum is exact, so both
    # einsums agree whatever their summation order
    wi = rng.integers(-3, 4, (kd, kd, 3, 5)).astype(np.float32)
    _eq(tswu.conv_via_swu_mvu(torch.from_numpy(x).float(), torch.from_numpy(wi), stride, pad),
        jswu.conv_via_swu_mvu(jnp.asarray(x, jnp.float32), jnp.asarray(wi), stride, pad))


def _case(mode: str, kd: int, seed: int, n: int = 6, c: int = 3, hi: int = 8):
    """One conv call's operands as numpy arrays: x (2, 8, 11, C), the
    mode's weight storage (int8 rows, or packed words for xnor; the JAX
    package's uint32 words are the port's int32 patterns), thresholds and
    scale."""
    rng = np.random.default_rng(seed)
    k = kd * kd * c
    x = rng.integers(0, 2 if mode == "xnor" else hi, (2, 8, 11, c)).astype(np.int32)
    if mode == "standard":
        w = rng.integers(-7, 8, (n, k)).astype(np.int8)
    else:
        w = rng.integers(0, 2, (n, k)).astype(np.int8)
    if mode == "xnor":
        w = np.asarray(jpacking.pack_bits(jnp.asarray(w.astype(np.int32))))
    t = np.sort(rng.integers(-8 * k, 8 * k, (n, 3)), axis=1).astype(np.int32)
    s = (rng.random(n) + 0.01).astype(np.float32)
    return x, w, t, s


def _epilogue_kw(epilogue, t, s, as_tensor):
    if epilogue == "thresholds":
        return {"thresholds": as_tensor(t)}
    if epilogue == "scale":
        return {"out_scale": as_tensor(s)}
    return {}


def _port(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _both(x, w, t, s, *, kd, stride, pad, mode, epilogue):
    """{arm: output} of the JAX package's pallas/xla arms and the port's
    cuda/torch arms and plain version, on the same operands."""
    k = kd * kd * x.shape[-1]
    geo = dict(kernel=kd, stride=stride, pad=pad, mode=mode)
    kb = {"k_bits": k} if mode == "xnor" else {}
    jkw = _epilogue_kw(epilogue, t, s, jnp.asarray)
    tkw = _epilogue_kw(epilogue, t, s, torch.from_numpy)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    tx, tw = torch.from_numpy(x), _port(w)
    return {
        "pallas": jops.conv_mvu(jx, jw, backend="pallas", interpret=True, **geo, **kb, **jkw),
        "xla": jops.conv_mvu(jx, jw, backend="xla", **geo, **kb, **jkw),
        "cuda": tops.conv_mvu(tx, tw, backend="cuda", **geo, **kb, **tkw),
        "torch": tops.conv_mvu(tx, tw, backend="torch", **geo, **kb, **tkw),
        "plain": swu_mvu.conv_mvu_plain(tx, tw, **geo, **tkw),
    }


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("i,kd,stride,pad", [(i, *g) for i, g in enumerate(GRID)])
def test_conv_mvu_equals_jax(i, kd, stride, pad, mode):
    """Every mode at every grid point; the epilogue rotates, so each mode
    meets each epilogue at six grid points, pad 1 and 2 among them."""
    epilogue = EPILOGUES[(i + MODES.index(mode)) % 3]
    x, w, t, s = _case(mode, kd, seed=100 * i + MODES.index(mode))
    out = _both(x, w, t, s, kd=kd, stride=stride, pad=pad, mode=mode, epilogue=epilogue)
    # activations < 128: the kernel arm's int8 narrowing changes nothing
    for jarm, tarm in (("pallas", "cuda"), ("pallas", "plain"), ("xla", "torch"),
                       ("xla", "pallas")):
        _eq(out[tarm], out[jarm])
    oh, ow = tswu.out_dim(8, kd, stride, pad), tswu.out_dim(11, kd, stride, pad)
    assert tuple(out["cuda"].shape) == (2, oh * ow, w.shape[0])


@pytest.mark.parametrize("mode", ["standard", "binary"])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_int8_narrowing_is_the_reference_property(mode, epilogue):
    """An activation of 200 counts as -56 on the kernel arm (the JAX Pallas
    kernel casts x to int8, swu_mvu.py:178) and as 200 on the oracle arm
    (ref.conv_mvu_ref keeps int32): each port arm equals its JAX arm, and
    the two arms differ."""
    x, w, t, s = _case(mode, 3, seed=7, hi=4)
    x[0, 3, 4, 1] = 200
    out = _both(x, w, t, s, kd=3, stride=1, pad=1, mode=mode, epilogue=epilogue)
    _eq(out["cuda"], out["pallas"])
    _eq(out["plain"], out["pallas"])
    _eq(out["torch"], out["xla"])
    if epilogue != "thresholds":  # levels may saturate alike
        assert not np.array_equal(np.asarray(out["pallas"]), np.asarray(out["xla"]))


def test_xnor_pad_taps_are_minus_one():
    """All-zero bits against all-one weights: every tap, in the image or in
    the padding, is (-1) x (+1), so every output is -K, corners included."""
    kd, pad, c = 3, 1, 2
    k = kd * kd * c
    x = torch.zeros((1, 4, 5, c), dtype=torch.int32)
    w = tpacking.pack_bits(torch.ones((3, k), dtype=torch.int32))
    out = tops.conv_mvu(x, w, kernel=kd, pad=pad, mode="xnor", k_bits=k)
    assert torch.equal(out, torch.full((1, 20, 3), -k, dtype=torch.int32))


def test_wrapper_checks():
    x = torch.zeros((1, 5, 5, 2), dtype=torch.int32)
    w = torch.zeros((4, 18), dtype=torch.int8)
    assert tuple(swu_mvu.conv_mvu(x, w, kernel=3).shape) == (1, 9, 4)
    with pytest.raises(ValueError, match=r"\(N, 18\)"):
        swu_mvu.conv_mvu(x, w[:, :9], kernel=3)
    with pytest.raises(ValueError, match="does not fit"):
        swu_mvu.conv_mvu(x, torch.zeros((4, 98), dtype=torch.int8), kernel=7)
    with pytest.raises(TypeError, match="int32"):
        swu_mvu.conv_mvu(x, w.int(), kernel=3)
    with pytest.raises(ValueError, match="k_bits"):
        tops.conv_mvu(x, torch.zeros((4, 1), dtype=torch.int32), kernel=3, mode="xnor")
    with pytest.raises(ValueError, match="mutually exclusive"):
        swu_mvu.conv_mvu(x, w, torch.zeros((4, 1), dtype=torch.int32),
                         torch.ones(4), kernel=3)


def test_meta_tensor_raises_instead_of_falling_back():
    x = torch.empty((1, 5, 5, 2), dtype=torch.int32, device="meta")
    w = torch.empty((4, 18), dtype=torch.int8, device="meta")
    launches = swu_mvu.LAUNCHES
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tops.conv_mvu(x, w, kernel=3)
    assert swu_mvu.LAUNCHES == launches


def test_rows_per_tile_and_shared_memory():
    from repro.kernels import swu_mvu as jswu_mvu

    for oh, ow, bm in [(30, 30, 128), (1, 1, 128), (28, 28, 32), (3, 3, 8), (12, 12, 256)]:
        assert swu_mvu.conv_rows_per_tile(oh, ow, bm) == jswu_mvu.conv_rows_per_tile(oh, ow, bm)
    # the line buffer of a 32-pixel tile of conv1 (30x30x64 in, 28x28 out):
    # 32 pixels span 3 output rows, so 5 input rows of 30 pixels at 20 words
    # (64 channels as int8, padded to 4 mod 8 words), after 384 bytes of
    # column sums and decoded taps, 2112 of staged thresholds and the
    # 8 x 32 x 48-byte weight ring
    assert swu_mvu.line_buffer_pitch(64) == 20 and swu_mvu.line_buffer_pitch(3) == 4
    assert swu_mvu.conv_smem_bytes("line", 30, 30, 64, 3) == 384 + 2112 + 12288 + 5 * 30 * 20 * 4
    # conv5 (3x3x256 in, one pixel): the ring and a 3-row line buffer
    assert swu_mvu.conv_smem_bytes("line", 3, 3, 256, 3) == 384 + 2112 + 12288 + 3 * 3 * 68 * 4
    # the gather arrangement: no line buffer, the ring
    assert swu_mvu.conv_smem_bytes("gather", 30, 30, 64, 3) == 384 + 2112 + 12288
    assert swu_mvu.conv_launch_plan(1, 30, 30, 64, 64, 3) == swu_mvu.ConvPlan(
        arrangement="line", tile_m=32, tile_n=32, splits=6, steps=18, smem_bytes=26784)


# (H = W, C, N) of the FULL CNV's six 3x3 conv layers
CNV_CONVS = [(32, 3, 64), (30, 64, 64), (14, 64, 128), (12, 128, 128), (5, 128, 256),
             (3, 256, 256)]


@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("h,c,n", CNV_CONVS)
def test_conv_launch_plan_fits_and_covers_k(h, c, n, b):
    """Every FULL CNV layer at 1 and 32 images: shared memory within the
    H100's 232,448 bytes a block, at most 8 K slices (the portable cluster),
    the slices covering K exactly once, the same plan on every call."""
    k = 9 * c
    plan = swu_mvu.conv_launch_plan(b, h, h, c, n, 3)
    assert plan.smem_bytes <= 232448 and 1 <= plan.splits <= 8
    assert plan.arrangement == "line" and (plan.tile_m, plan.tile_n) == (32, 32)
    assert plan.smem_bytes == swu_mvu.conv_smem_bytes("line", h, h, c, 3)
    slices = plan.k_slices(k)
    assert len(slices) == plan.splits and slices[0][0] == 0 and slices[-1][1] == k
    assert all(lo < hi for lo, hi in slices)
    assert all(a[1] == b_[0] for a, b_ in zip(slices, slices[1:]))
    assert all(lo % swu_mvu.KSTEP == 0 for lo, _ in slices)
    swu_mvu.conv_launch_plan.cache_clear()
    assert swu_mvu.conv_launch_plan(b, h, h, c, n, 3) == plan
    if b == 1 and h <= 30:  # conv1-conv5 at one image: too few tiles, so split K
        assert plan.splits > 1


# (B, H, W, C, N, Kd, stride, pad) of images whose line buffer does not fit
# a block's shared memory: a row of 1,000 pixels at C = 256, a 224-wide
# row at C = 512 (pad 1), and narrow channels (C = 12, C = 3) on rows of
# 3,000 and 5,000 pixels
WIDE_CONVS = [(1, 8, 1000, 256, 64, 3, 1, 0), (2, 6, 224, 512, 40, 3, 1, 1),
              (1, 5, 3000, 12, 16, 3, 2, 1), (1, 4, 5000, 3, 8, 3, 1, 0)]


@pytest.mark.parametrize("b,h,w,c,n,kd,stride,pad", WIDE_CONVS)
def test_conv_launch_plan_gathers_where_the_line_buffer_does_not_fit(b, h, w, c, n, kd, stride,
                                                                     pad):
    """Such an image still gets a plan: the gather arrangement (A read tap
    by tap from the image), with the ring's shared memory only, K slices
    covering K once; and the wrapper runs it (here the plain version)."""
    assert swu_mvu.conv_smem_bytes("line", h, w, c, kd, stride, pad) > 232448
    plan = swu_mvu.conv_launch_plan(b, h, w, c, n, kd, stride, pad)
    assert plan.arrangement == "gather"
    assert plan.smem_bytes == swu_mvu.conv_smem_bytes("gather", h, w, c, kd, stride, pad)
    assert plan.smem_bytes == 384 + 2112 + 12288
    slices = plan.k_slices(kd * kd * c)
    assert slices[0][0] == 0 and slices[-1][1] == kd * kd * c and 1 <= plan.splits <= 8
    if c <= 12:  # a small image of the same geometry through the wrapper's CPU arm
        g = torch.Generator().manual_seed(c)
        x = torch.randint(-8, 300, (b, h, 40, c), generator=g, dtype=torch.int32)
        wt = torch.randint(-2, 2, (n, kd * kd * c), generator=g, dtype=torch.int8)
        got = swu_mvu.conv_mvu(x, wt, kernel=kd, stride=stride, pad=pad)
        want = swu_mvu.conv_mvu_plain(x, wt, kernel=kd, stride=stride, pad=pad)
        assert torch.equal(got, want)
