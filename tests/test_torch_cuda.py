"""The hand kernels and the slice on the card (marked ``cuda``).

Run on a machine with an NVIDIA GPU and nvcc:
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
Elsewhere every test here skips.  No JAX: the card's machine has none.
"""

import numpy as np
import pytest
import torch

import torch_random_dag  # tests/ is on sys.path under pytest
from repro_torch.build import build
from repro_torch.configs import cnv_bnn, golden as golden_mod, nid_mlp, residual_mlp
from repro_torch.core import autotune, dataflow, engine as engine_mod
from repro_torch.core.autotune import ScheduleCache, cycle_time_key, device_kind
from repro_torch.core.engine import FusedEngine
from repro_torch.data import nid
from repro_torch.kernels import dense_mvu, mvu_binary, mvu_int as K, mvu_packed, mvu_xnor
from repro_torch.kernels import ops, packing
from repro_torch.kernels import swu_mvu
from repro_torch.serving import ReplicaPool, calibrate_cycle_time, infer_output_range
from repro_torch.telemetry import DriftMonitor, Tracer

pytestmark = pytest.mark.cuda
VARIANTS = ["standard", "xnor", "binary", "binary_packed", "standard_packed"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(m, n, k, lo, hi, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(0, 4, (m, k), generator=g, dtype=torch.int32)
    w = torch.randint(lo, hi, (n, k), generator=g, dtype=torch.int8)
    t = torch.sort(torch.randint(-300, 300, (n, 3), generator=g, dtype=torch.int32), 1).values
    s = torch.rand(n, generator=g) + 0.01
    return [x.to(device) for x in (a, w, t, s)]


def _epilogue_kw(epilogue, t, s):
    return {"thresholds": t} if epilogue == "thresholds" else \
        {"out_scale": s} if epilogue == "scale" else {}


@pytest.mark.parametrize("epilogue", ["raw", "thresholds", "scale"])
@pytest.mark.parametrize("n,k", [(64, 600), (64, 64), (1, 64), (33, 95)])
@pytest.mark.parametrize("m", [1, 3, 128, 257])
def test_kernel_equals_plain(cuda, m, n, k, epilogue):
    for lo, hi in ((-1, 2), (-128, 128)):
        a, w, t, s = _inputs(m, n, k, lo, hi, cuda, seed=m + k)
        kw = _epilogue_kw(epilogue, t, s)
        launches = K.LAUNCHES
        got = K.mvu_int(a, w, **kw)
        assert K.LAUNCHES == launches + 1 and got.is_cuda
        want = K.mvu_int_plain(a, w, **kw)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["mvu_xnor", "mvu_xnor_bits", "mvu_binary",
                                    "mvu_binary_packed", "mvu_int2_packed"])
@pytest.mark.parametrize("epilogue", ["raw", "thresholds", "scale"])
@pytest.mark.parametrize("n,k", [(64, 600), (64, 64), (1, 64), (33, 95), (7, 1)])
@pytest.mark.parametrize("m", [1, 3, 128, 257])
def test_new_kernels_equal_plain(cuda, kernel, m, n, k, epilogue):
    g = torch.Generator().manual_seed(m * 1000 + k)
    # activations up to 299: the packed kernels narrow them with a wrap
    a = torch.randint(-8, 300, (m, k), generator=g, dtype=torch.int32).to(cuda)
    bits = torch.randint(0, 2, (n, k), generator=g, dtype=torch.int8).to(cuda)
    _, _, t, s = _inputs(1, n, 1, 0, 1, cuda, seed=k)
    kw = _epilogue_kw(epilogue, t, s)
    if kernel == "mvu_xnor":
        fn, plain = mvu_xnor.mvu_xnor, mvu_xnor.mvu_xnor_plain
        args = (packing.pack_bits(a), packing.pack_bits(bits), k)
    elif kernel == "mvu_xnor_bits":
        fn, plain = mvu_xnor.mvu_xnor_bits, mvu_xnor.mvu_xnor_bits_plain
        args = (a, packing.pack_bits(bits))
    elif kernel == "mvu_binary":
        fn, plain = mvu_binary.mvu_binary, mvu_binary.mvu_binary_plain
        args = (a, bits)
    elif kernel == "mvu_binary_packed":
        fn, plain = mvu_packed.mvu_binary_packed, mvu_packed.mvu_binary_packed_plain
        args = (a, packing.pack_bits(bits), k)
    else:
        fn, plain = mvu_packed.mvu_int2_packed, mvu_packed.mvu_int2_packed_plain
        w2 = torch.randint(-2, 2, (n, k), generator=g, dtype=torch.int8).to(cuda)
        args = (a, packing.pack_int2(w2), k)
    launches = ops.launch_counts()[_counter(kernel)]
    got = fn(*args, **kw)
    assert ops.launch_counts()[_counter(kernel)] == launches + 1 and got.is_cuda
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


def _counter(entry):
    """The launch counter (ops.KERNELS) of a wrapper: both of mvu_xnor's
    entries count in mvu_xnor's."""
    return "mvu_xnor" if entry == "mvu_xnor_bits" else entry


def test_kernel_wraps_and_widens(cuda):
    g = torch.Generator().manual_seed(1)
    a = torch.randint(-2**31, 2**31 - 1, (5, 77), generator=g, dtype=torch.int32).to(cuda)
    w = torch.randint(-128, 128, (9, 77), generator=g, dtype=torch.int8).to(cuda)
    assert torch.equal(K.mvu_int(a, w), K.mvu_int_plain(a, w))
    a8 = torch.randint(-128, 128, (5, 77), generator=g, dtype=torch.int8).to(cuda)
    assert torch.equal(K.mvu_int(a8, w), K.mvu_int_plain(a8.int(), w))
    bits = (w > 0).to(torch.int8)
    assert torch.equal(mvu_binary.mvu_binary(a, bits), mvu_binary.mvu_binary_plain(a, bits))


def test_kernel_rejects_non_contiguous_and_mixed_devices(cuda):
    a, w, _, _ = _inputs(8, 4, 32, -1, 2, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.mvu_int(torch.cat([a, a], 1)[:, ::2], w)
    with pytest.raises(ValueError, match="is on cpu"):
        K.mvu_int(a, w.cpu())
    with pytest.raises(ValueError, match="is on cpu"):
        mvu_xnor.mvu_xnor(packing.pack_bits(a), packing.pack_bits(w).cpu(), 32)


@pytest.mark.parametrize("variant", VARIANTS)
def test_nid_engine_on_the_card(cuda, variant):
    golden = nid_mlp.load_golden()[variant]
    kw = golden["build"]
    acc = build(nid_mlp.build_graph(golden["seed"]), folding=nid_mlp.foldings(), **kw)
    x = torch.from_numpy(nid.make_dataset(golden["batch"], seed=golden["data_seed"])[0])
    kernel = ops.kernel_name(kw["mode"], packed=kw.get("pack") == "always")
    ops.reset_launch_counts()
    y = acc(x)
    n_micro = acc.plan(golden["batch"]).n_micro
    assert ops.launch_counts() == {k: 4 * n_micro if k == kernel else 0
                                   for k in ops.KERNELS}
    assert y.is_cuda and torch.equal(y, acc.interpret(x))
    assert golden_mod.digest_like(golden, y.cpu().numpy(), acc.graph) == golden


# (H = W, C, N) of the FULL CNV's six 3x3 conv layers
CNV_CONVS = [(32, 3, 64), (30, 64, 64), (14, 64, 128), (12, 128, 128), (5, 128, 256),
             (3, 256, 256)]


def _conv_operands(mode, b, h, wdim, c, n, kd, device, seed):
    g = torch.Generator().manual_seed(seed)
    k = kd * kd * c
    hi = 2 if mode == "xnor" else 300  # 300: the int8 wrap of the kernel arm
    x = torch.randint(0 if mode == "xnor" else -8, hi, (b, h, wdim, c), generator=g,
                      dtype=torch.int32)
    if mode == "standard":
        w = torch.randint(-2, 2, (n, k), generator=g, dtype=torch.int8)
    else:
        w = torch.randint(0, 2, (n, k), generator=g, dtype=torch.int8)
        if mode == "xnor":
            w = packing.pack_bits(w)
    t = torch.sort(torch.randint(-8 * k, 8 * k, (n, 3), generator=g, dtype=torch.int32),
                   1).values
    s = torch.rand(n, generator=g) + 0.01
    return [v.to(device) for v in (x, w, t, s)]


@pytest.mark.parametrize("epilogue", ["raw", "thresholds", "scale"])
@pytest.mark.parametrize("mode", ["standard", "binary", "xnor"])
@pytest.mark.parametrize("h,c,n", CNV_CONVS)
def test_conv_kernel_equals_plain_at_cnv_shapes(cuda, h, c, n, mode, epilogue):
    for b in (1, 5):
        x, w, t, s = _conv_operands(mode, b, h, h, c, n, 3, cuda, seed=h * 7 + c + b)
        kw = _epilogue_kw(epilogue, t, s)
        launches = swu_mvu.LAUNCHES
        got = swu_mvu.conv_mvu(x, w, kernel=3, mode=mode, **kw)
        assert swu_mvu.LAUNCHES == launches + 1 and got.is_cuda
        want = swu_mvu.conv_mvu_plain(x, w, kernel=3, mode=mode, **kw)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("mode", ["standard", "binary", "xnor"])
@pytest.mark.parametrize("kd,stride,pad", [(1, 1, 0), (3, 2, 1), (5, 1, 2), (5, 2, 2)])
def test_conv_kernel_pads_and_strides(cuda, mode, kd, stride, pad):
    """Non-square images, strides and zero padding (xnor: a pad tap is -1)."""
    x, w, t, _ = _conv_operands(mode, 3, 9, 13, 5, 37, kd, cuda, seed=kd + stride + pad)
    for kw in ({}, {"thresholds": t}):
        got = swu_mvu.conv_mvu(x, w, kernel=kd, stride=stride, pad=pad, mode=mode, **kw)
        want = swu_mvu.conv_mvu_plain(x, w, kernel=kd, stride=stride, pad=pad, mode=mode,
                                      **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["standard", "binary", "xnor"])
@pytest.mark.parametrize("h,c,n", CNV_CONVS)
def test_conv_kernel_plans_at_32_images(cuda, h, c, n, mode):
    """32 images a launch: K split in a cluster (conv4, conv5) or not;
    activations up to 299 wrap."""
    plan = swu_mvu.conv_launch_plan(32, h, h, c, n, 3)
    assert plan.splits >= 1 and plan.arrangement == "line" and plan.tile_m == 32
    x, w, t, _ = _conv_operands(mode, 32, h, h, c, n, 3, cuda, seed=h + c + n)
    got = swu_mvu.conv_mvu(x, w, t, kernel=3, mode=mode)
    want = swu_mvu.conv_mvu_plain(x, w, t, kernel=3, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["standard", "binary", "xnor"])
@pytest.mark.parametrize("h,c,n", CNV_CONVS)
def test_conv_kernel_at_the_tile_race_images(cuda, h, c, n, mode):
    """Every image count the CNV's tile race can choose at 256 (2, 4, 8 and
    the whole batch), all three epilogues."""
    for b in (2, 4, 8, 256):
        x, w, t, s = _conv_operands(mode, b, h, h, c, n, 3, cuda, seed=h * 3 + c + b)
        for kw in ({}, {"thresholds": t}, {"out_scale": s}):
            got = swu_mvu.conv_mvu(x, w, kernel=3, mode=mode, **kw)
            want = swu_mvu.conv_mvu_plain(x, w, kernel=3, mode=mode, **kw)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and torch.equal(got, want)


def _misaligned(t):
    """The same values in a contiguous tensor that starts one element past
    a 16-byte boundary: the kernels' narrow-load paths."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("mode", ["standard", "binary", "xnor"])
@pytest.mark.parametrize("c", [4, 12, 40, 32])
def test_conv_kernel_load_paths(cuda, mode, c):
    """C % 4 == 0 but not % 32 (16-byte rows, per-tap decode), C % 32 == 0
    (a step is one window tap), and both operands misaligned (the 4-byte
    and byte loads), split and whole K, stride 2 and pad 1."""
    for b, stride, pad in ((1, 1, 0), (6, 2, 1)):
        x, w, t, _ = _conv_operands(mode, b, 11, 9, c, 40, 3, cuda, seed=c + b)
        for xx, ww in ((x, w), (_misaligned(x), _misaligned(w))):
            got = swu_mvu.conv_mvu(xx, ww, t, kernel=3, stride=stride, pad=pad, mode=mode)
            want = swu_mvu.conv_mvu_plain(x, w, t, kernel=3, stride=stride, pad=pad,
                                          mode=mode)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


# images whose line buffer does not fit a block (test_torch_conv.WIDE_CONVS)
WIDE_CONVS = [(1, 8, 1000, 256, 64, 3, 1, 0), (2, 6, 224, 512, 40, 3, 1, 1),
              (1, 5, 3000, 12, 16, 3, 2, 1), (1, 4, 5000, 3, 8, 3, 1, 0)]


@pytest.mark.parametrize("mode", ["standard", "binary", "xnor"])
@pytest.mark.parametrize("b,h,w,c,n,kd,stride,pad", WIDE_CONVS)
def test_conv_kernel_gather_equals_plain(cuda, b, h, w, c, n, kd, stride, pad, mode):
    """The gather arrangement (A read tap by tap from the image) equals the
    plain version: aligned and narrow channels, pad taps (xnor: -1), the
    int8 wrap, K split or not, with the threshold and scale epilogues."""
    plan = swu_mvu.conv_launch_plan(b, h, w, c, n, kd, stride, pad)
    assert plan.arrangement == "gather"
    x, wt, t, s = _conv_operands(mode, b, h, w, c, n, kd, cuda, seed=w + c)
    for kw in ({"thresholds": t}, {"out_scale": s}):
        got = swu_mvu.conv_mvu(x, wt, kernel=kd, stride=stride, pad=pad, mode=mode, **kw)
        want = swu_mvu.conv_mvu_plain(x, wt, kernel=kd, stride=stride, pad=pad, mode=mode,
                                      **kw)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)


def _dense_operands(kernel, a, g, n, k):
    """(wrapper, plain, args) of an entry point on the dense core: mvu_int
    takes any int8 weight, mvu_int2_packed 2-bit lanes, the binary and xnor
    kernels {0,1} (bitplanes or words where packed); mvu_xnor packs the
    activations' LSBs first, mvu_xnor_bits takes them as they are."""
    if kernel == "mvu_int":
        w = torch.randint(-128, 128, (n, k), generator=g, dtype=torch.int8).to(a.device)
        return K.mvu_int, K.mvu_int_plain, (a, w)
    if kernel == "mvu_int2_packed":
        w2 = torch.randint(-2, 2, (n, k), generator=g, dtype=torch.int8)
        return (mvu_packed.mvu_int2_packed, mvu_packed.mvu_int2_packed_plain,
                (a, packing.pack_int2(w2).to(a.device), k))
    bits = torch.randint(0, 2, (n, k), generator=g, dtype=torch.int8).to(a.device)
    if kernel == "mvu_binary":
        return mvu_binary.mvu_binary, mvu_binary.mvu_binary_plain, (a, bits)
    if kernel == "mvu_xnor":
        return (mvu_xnor.mvu_xnor, mvu_xnor.mvu_xnor_plain,
                (packing.pack_bits(a), packing.pack_bits(bits), k))
    if kernel == "mvu_xnor_bits":
        return (mvu_xnor.mvu_xnor_bits, mvu_xnor.mvu_xnor_bits_plain,
                (a, packing.pack_bits(bits)))
    return (mvu_packed.mvu_binary_packed, mvu_packed.mvu_binary_packed_plain,
            (a, packing.pack_bits(bits), k))


@pytest.mark.parametrize("kernel", sorted(dense_mvu.CODING))
@pytest.mark.parametrize("epilogue", ["raw", "thresholds", "scale"])
@pytest.mark.parametrize("k", [27, 64, 600, 2304])
@pytest.mark.parametrize("m", [1, 9, 100, 128, 4096])
def test_dense_arrangements_equal_plain(cuda, m, k, epilogue, kernel):
    """Both arrangements of the dense core (gemv at M <= 8, tiles above),
    with and without split K, at a ragged N = 10, for its six entry points;
    activations in [-300, 300) (the packed kernels' int8 wrap; the xnor
    bit entry's LSBs, K not a multiple of 32 among them)."""
    n = 10
    plan = dense_mvu.dense_launch_plan(m, n, k, dense_mvu.CODING[kernel])
    assert plan.arrangement == ("gemv" if m <= 8 else "tiled")
    g = torch.Generator().manual_seed(m + k)
    a = torch.randint(-300, 300, (m, k), generator=g, dtype=torch.int32).to(cuda)
    fn, plain, args = _dense_operands(kernel, a, g, n, k)
    _, _, t, s = _inputs(1, n, 1, 0, 1, cuda, seed=k)
    span = {"mvu_int": 128 * k, "mvu_xnor": 0, "mvu_xnor_bits": 0}.get(kernel, k)
    kw = _epilogue_kw(epilogue, t * span if span else t * k // 300, s)
    launches = ops.launch_counts()[_counter(kernel)]
    got = fn(*args, **kw)
    assert ops.launch_counts()[_counter(kernel)] == launches + 1
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


def _tile_kw(kernel, tile):
    """The tile kwargs that pin a dense entry point's compiled tile."""
    tm, tn, tk = tile
    return ops.tile_kwargs(kernel, block_n=tn, block_k=tk, block_kw=tk, rows_per_tile=tm)


@pytest.mark.parametrize("kernel,tile", [
    (kernel, tile) for kernel in sorted(dense_mvu.CODING)
    for tile in dense_mvu.tiles(dense_mvu.CODING[kernel])])
def test_dense_kernel_equals_plain_at_every_tile(cuda, kernel, tile):
    """Every compiled tile of every entry point on the dense core, read
    back from the plan, at its ragged edges: K not a multiple of the K
    step, N below tile_n and N = 1, M one past a tile; and one output too
    small to fill the card (split K); all three epilogues."""
    tm, tn, tk = tile
    coding = dense_mvu.CODING[kernel]
    unit = 32 if coding == "words" else 1  # packed xnor steps K in words
    for m, n, k_units in ((tm + 1, tn - 3, tk + 5), (tm + 1, 1, 3 * tk - 1),
                          (2 * tm - 1, tn + 1, 600), (4 * tm, 10, 2 * tk + 9)):
        k = k_units * unit
        kw = _tile_kw(kernel, tile)
        plan = dense_mvu.dense_launch_plan(m, n, k_units, coding, block_n=tn, block_k=tk,
                                           rows_per_tile=tm)
        assert (plan.tile_m, plan.tile_n, plan.kstep) == tile
        assert dense_mvu.DENSE_TILES[plan.tile] == tile
        g = torch.Generator().manual_seed(m * 7 + n + k)
        a = torch.randint(-300, 300, (m, k), generator=g, dtype=torch.int32).to(cuda)
        fn, plain, args = _dense_operands(kernel, a, g, n, k)
        _, _, t, s = _inputs(1, n, 1, 0, 1, cuda, seed=k)
        span = {"mvu_int": 128 * k, "mvu_xnor": 0, "mvu_xnor_bits": 0}.get(kernel, k)
        for epilogue in ("raw", "thresholds", "scale"):
            ekw = _epilogue_kw(epilogue, t * span if span else t * k // 300, s)
            launches = ops.launch_counts()[_counter(kernel)]
            got = fn(*args, **ekw, **kw)
            assert ops.launch_counts()[_counter(kernel)] == launches + 1
            want = plain(*args, **ekw)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and torch.equal(got, want), (m, n, k, epilogue)


def _conv_rows(tile_m, ow):
    """The rows_per_tile that pins a tile_m-pixel tile on rows of ow
    pixels (None: the untuned 32)."""
    return None if tile_m == swu_mvu.TILE_M else max(1, tile_m // ow)


@pytest.mark.parametrize("mode", ["standard", "binary", "xnor"])
@pytest.mark.parametrize("tile", swu_mvu.CONV_TILES)
def test_conv_kernel_equals_plain_at_every_tile(cuda, mode, tile):
    """Every compiled pixel x channel tile of conv_mvu, read back from the
    plan: N below tile_n, N = 1 and one past it, a ragged last pixel tile,
    C = 3 (taps decoded a step) and C % 32 == 0, K split or not; the
    threshold and scale epilogues."""
    tm, tn = tile
    for b, h, c, n in ((2, 30, 64, tn - 3), (3, 12, 40, 1), (1, 3, 256, tn + 1),
                       (5, 32, 3, 64)):
        rows = _conv_rows(tm, h - 2)
        plan = swu_mvu.conv_launch_plan(b, h, h, c, n, 3, block_n=tn, rows_per_tile=rows)
        assert (plan.tile_m, plan.tile_n) == tile
        x, w, t, s = _conv_operands(mode, b, h, h, c, n, 3, cuda, seed=h + c + n + tm)
        for kw in ({"thresholds": t}, {"out_scale": s}):
            got = swu_mvu.conv_mvu(x, w, kernel=3, mode=mode, block_n=tn, rows_per_tile=rows,
                                   **kw)
            want = swu_mvu.conv_mvu_plain(x, w, kernel=3, mode=mode, **kw)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and torch.equal(got, want), (b, h, c, n)


@pytest.mark.parametrize("kernel", ["mvu_int", "mvu_binary"])
@pytest.mark.parametrize("m", [1, 5, 128, 300])
def test_dense_wraps_mod_2_32(cuda, m, kernel):
    """int32 activations near 2^30 (and any int8 weight): the sums wrap mod
    2^32 in both arrangements, through the cluster sum too; misaligned
    operands take the narrow loads."""
    g = torch.Generator().manual_seed(m)
    a = torch.randint(2**30 - 2**20, 2**30, (m, 600), generator=g, dtype=torch.int32)
    a[:, ::3] *= -1
    w = torch.randint(-128, 128, (33, 600), generator=g, dtype=torch.int8)
    a, w = a.to(cuda), w.to(cuda)
    fn, plain = ((K.mvu_int, K.mvu_int_plain) if kernel == "mvu_int"
                 else (mvu_binary.mvu_binary, mvu_binary.mvu_binary_plain))
    want = plain(a, w)
    for aa, ww in ((a, w), (_misaligned(a), _misaligned(w))):
        got = fn(aa, ww)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("k", [27, 64, 600])
@pytest.mark.parametrize("m", [1, 9, 128])
def test_binary_packed_ignores_pad_bits(cuda, m, k):
    """Bitplanes whose pad bits in the last word are all 1, two words more
    a row than K needs (Wd > ceil(K/32)), activations up to 299 (the int8
    wrap), both arrangements; misaligned activations take the narrow
    loads."""
    g = torch.Generator().manual_seed(m * 100 + k)
    bits = torch.randint(0, 2, (33, k), generator=g, dtype=torch.int8)
    wp = packing.pack_bits_pad_set(bits, 2, g).to(cuda)
    a = torch.randint(-8, 300, (m, k), generator=g, dtype=torch.int32).to(cuda)
    _, _, t, _ = _inputs(1, 33, 1, 0, 1, cuda, seed=k)
    for kw in ({}, {"thresholds": t * k}):
        want = mvu_packed.mvu_binary_packed_plain(a, wp, k, **kw)
        for aa in (a, _misaligned(a)):
            got = mvu_packed.mvu_binary_packed(aa, wp, k, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.parametrize("k", [27, 64, 600])
@pytest.mark.parametrize("m", [1, 9, 128])
def test_int2_packed_ignores_pad_lanes(cuda, m, k):
    """2-bit rows whose pad lanes in the last byte are all set (0b11), two
    bytes more a row than K needs (Bd > ceil(K/4): 9-, 18- and 152-byte
    rows, so the unaligned and the 8-byte staging), activations up to 299
    (the int8 wrap), both arrangements; misaligned activations and rows
    take the narrow loads."""
    g = torch.Generator().manual_seed(m * 100 + k + 1)
    w2 = torch.randint(-2, 2, (33, k), generator=g, dtype=torch.int8)
    wp = packing.pack_int2_pad_set(w2, 2, g).to(cuda)
    a = torch.randint(-8, 300, (m, k), generator=g, dtype=torch.int32).to(cuda)
    _, _, t, _ = _inputs(1, 33, 1, 0, 1, cuda, seed=k)
    for kw in ({}, {"thresholds": t * k}):
        want = mvu_packed.mvu_int2_packed_plain(a, wp, k, **kw)
        for aa, ww in ((a, wp), (_misaligned(a), _misaligned(wp))):
            got = mvu_packed.mvu_int2_packed(aa, ww, k, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.parametrize("m", [1, 128, 4096])
def test_int2_packed_at_the_nid_fc0_rows(cuda, m):
    """NID fc0: K = 600 in 150-byte rows (no row but the first 8-byte
    aligned), N = 64, at the path's M, with its threshold epilogue."""
    g = torch.Generator().manual_seed(m)
    w2 = torch.randint(-2, 2, (64, 600), generator=g, dtype=torch.int8)
    wp = packing.pack_int2(w2).to(cuda)
    assert tuple(wp.shape) == (64, 150)
    a = torch.randint(0, 4, (m, 600), generator=g, dtype=torch.int32).to(cuda)
    t = torch.sort(torch.randint(-300, 300, (64, 3), generator=g, dtype=torch.int32),
                   1).values.to(cuda)
    for kw in ({}, {"thresholds": t}):
        got = mvu_packed.mvu_int2_packed(a, wp, 600, **kw)
        want = mvu_packed.mvu_int2_packed_plain(a, wp, 600, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 27, 64, 600, 2304])
@pytest.mark.parametrize("m", [1, 9, 128])
def test_xnor_bits_equals_pack_then_packed_entry(cuda, m, k):
    """The bit entry equals the packed entry on pack_bits of the same
    activations (multi-bit and negative, K not a multiple of 32 among
    them), and both their plain version; misaligned activations take the
    narrow loads."""
    g = torch.Generator().manual_seed(m * 10 + k)
    a = torch.randint(-300, 300, (m, k), generator=g, dtype=torch.int32).to(cuda)
    wp = packing.pack_bits(torch.randint(0, 2, (17, k), generator=g)).to(cuda)
    want = mvu_xnor.mvu_xnor_bits_plain(a, wp)
    for aa in (a, _misaligned(a)):
        got = mvu_xnor.mvu_xnor_bits(aa, wp)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    got = mvu_xnor.mvu_xnor(packing.pack_bits(a), wp, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant", ["xnor", "binary", "standard"])
def test_cnv_engine_on_the_card(cuda, variant):
    golden = cnv_bnn.load_golden()[variant]
    kw = golden["build"]
    acc = build(cnv_bnn.build_graph(cnv_bnn.spec_for(kw), seed=golden["seed"]), **kw)
    x = torch.from_numpy(cnv_bnn.images(golden["batch"], kw["act_bits"],
                                        golden["data_seed"]))
    n_micro = acc.plan(golden["batch"]).n_micro
    ops.reset_launch_counts()
    y = acc(x)
    want = {k: 0 for k in ops.KERNELS}
    want["conv_mvu"], want[ops.kernel_name(kw["mode"])] = 6 * n_micro, 3 * n_micro
    assert ops.launch_counts() == want
    assert y.is_cuda and torch.equal(y, acc.interpret(x))
    assert golden_mod.digest_like(golden, y.cpu().numpy(), acc.graph) == golden


def test_residual_engine_on_the_card(cuda):
    golden = residual_mlp.load_golden()
    acc = build(residual_mlp.build_graph(golden["seed"]), folding=residual_mlp.foldings(),
                **golden["build"])
    x = torch.from_numpy(nid.make_dataset(golden["batch"], seed=golden["data_seed"])[0])
    n_micro = acc.plan(golden["batch"]).n_micro
    ops.reset_launch_counts()
    y = acc(x)
    want = {k: 0 for k in ops.KERNELS}
    want["mvu_int"] = 3 * n_micro
    assert ops.launch_counts() == want
    assert y.is_cuda and torch.equal(y, acc.interpret(x))
    assert golden_mod.digest_like(golden, y.cpu().numpy(), acc.graph) == golden


@pytest.mark.parametrize("config", ["nid", "residual", "cnv"])
def test_profile_on_the_card(cuda, config):
    if config == "cnv":
        golden = cnv_bnn.load_golden()["standard"]
        kw = golden["build"]
        acc = build(cnv_bnn.build_graph(cnv_bnn.spec_for(kw), seed=golden["seed"]), **kw)
        x = torch.from_numpy(cnv_bnn.images(8, kw["act_bits"], golden["data_seed"]))
    else:
        cfg = nid_mlp if config == "nid" else residual_mlp
        golden = nid_mlp.load_golden()["standard"] if config == "nid" else cfg.load_golden()
        acc = build(cfg.build_graph(golden["seed"]), folding=cfg.foldings(), **golden["build"])
        x = torch.from_numpy(nid.make_dataset(300, seed=golden["data_seed"])[0])
    tr = Tracer()
    drift = DriftMonitor.from_schedule(acc.schedule, 1e-8)
    y, plan = acc.profile(x, tr, drift=drift)
    assert y.is_cuda and torch.equal(y, acc(x))
    outer = tr.spans(name="engine.profile")[0]
    nodes = tr.spans(cat="node")
    assert len(nodes) == plan.n_micro * len(acc.engine.graph)
    assert all(outer["t0"] <= s["t0"] and s["t1"] <= outer["t1"] and s["depth"] == 2
               for s in nodes)
    assert set(drift.status()["keys"]) == {s.name for s in acc.schedule.stages}


@pytest.mark.parametrize("mode,bits", torch_random_dag.MODES)
def test_random_dags_on_the_card(cuda, mode, bits):
    for seed, depth in torch_random_dag.SWEEP:
        low, x = torch_random_dag.dag_case(seed, depth, mode, bits)
        low = dataflow.graph_to(low, cuda)
        x = torch.from_numpy(x).to(cuda)
        ops.reset_launch_counts()
        got = FusedEngine(low)(x)
        assert sum(ops.launch_counts().values()) > 0
        assert got.is_cuda and torch.equal(got, dataflow.execute(low, x))


# ------------------------------------------------------------------ serving
def _plan_launches(acc, batch):
    """The launches of one ``acc(x)`` at ``batch`` under its (tuned) plan:
    each node's kernel once a microbatch."""
    n_micro = acc.plan(batch).n_micro
    want = dict.fromkeys(ops.KERNELS, 0)
    for node in acc.engine.graph:
        if node.op in ("mvu", "conv_mvu"):
            cfg = node.attrs["config"]
            kernel = ("conv_mvu" if node.op == "conv_mvu"
                      else ops.kernel_name(cfg.mode, cfg.packed))
            want[kernel] += n_micro
    return want


@pytest.mark.parametrize("variant", VARIANTS)
def test_nid_tuned_on_the_card(cuda, variant, tmp_path, monkeypatch):
    """tune="auto" on the card: every candidate launch is a hand kernel
    (``backend="cuda"``), the entries are keyed by the card's kind, the
    tuned build equals the untuned one; tune_engine records a tile, and a
    tune="cache" rebuild measures nothing and launches its plan's kernels."""
    monkeypatch.setenv(autotune.CACHE_PATH_ENV, str(tmp_path / "cache.json"))
    golden = nid_mlp.load_golden()[variant]
    kw = dict(folding=nid_mlp.foldings(), **golden["build"])
    backends = []
    for name in ("mvu", "conv_mvu"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _fn=fn, **k: backends.append(
            k["backend"]) or _fn(*a, **k))
    cache = ScheduleCache()
    ops.reset_launch_counts()
    acc = build(nid_mlp.build_graph(golden["seed"]), tune="auto", cache=cache, **kw)
    assert set(backends) == {"cuda"} and sum(ops.launch_counts().values()) > 0
    assert all(k.startswith(device_kind(cuda) + "|") for k in cache.entries)
    x = torch.from_numpy(nid.make_dataset(golden["batch"], seed=golden["data_seed"])[0])
    plain = build(nid_mlp.build_graph(golden["seed"]), **kw)
    want = plain(x)
    assert torch.equal(acc(x), want)
    entry = autotune.tune_engine(acc.graph, golden["batch"], cache=cache,
                                 pack=kw.get("pack", "auto"))  # the build's pack policy
    assert entry["microbatch"] >= 1
    monkeypatch.setattr(autotune, "paired_timer", None)  # a timer call would raise
    again = build(nid_mlp.build_graph(golden["seed"]), tune="cache", cache=cache, **kw)
    assert again.report.tune["cache_misses"] == 0
    assert again.report.tune["engine_tile"] == entry["microbatch"]
    ops.reset_launch_counts()
    y = again(x)
    assert ops.launch_counts() == _plan_launches(again, golden["batch"])
    assert y.is_cuda and torch.equal(y, want)


def test_plain_reference_entry_raises_on_the_card(cuda):
    """A card-scoped cache entry naming the JAX package's ``xla`` backend
    (the plain reference here) raises in a tune="cache" build on the card
    instead of moving the node off its hand kernel."""
    golden = nid_mlp.load_golden()["standard"]
    kw = dict(folding=nid_mlp.foldings(), **golden["build"])
    plain = build(nid_mlp.build_graph(golden["seed"]), **kw)
    key = autotune.graph_node_keys(plain.graph, device=device_kind(cuda))[0]
    cache = ScheduleCache({key: {"backend": "xla", "block_m": 128, "block_n": 8,
                                 "block_k": 8, "block_kw": 8}})
    with pytest.raises(ValueError, match="plain reference"):
        build(nid_mlp.build_graph(golden["seed"]), tune="cache", cache=cache, **kw)


def test_device_clock_times_the_card_alone(cuda):
    """The node race's clock: a spin of twice the cycles takes twice the
    card's time, whatever the host's launch path costs around it."""
    short, long = (autotune._device_seconds(torch.cuda._sleep, (c,), cuda)
                   for c in (1 << 20, 1 << 21))
    assert 1.8 < long / short < 2.2


def _nid_standard(target):
    golden = nid_mlp.load_golden()["standard"]
    acc = build(nid_mlp.build_graph(golden["seed"]), target=target,
                folding=nid_mlp.foldings(), **golden["build"])
    return acc, golden


def test_pool_on_the_card_polls_an_event_and_resolves(cuda):
    acc, golden = _nid_standard("engine")
    pool = ReplicaPool(acc.engine)
    # the integrity bound reads the card's parameters through the host
    assert pool.output_range is not None and pool.output_range == infer_output_range(
        dataflow.graph_to(acc.engine.graph, "cpu"))
    assert [r.device for r in pool.replicas] == [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    assert pool.replicas[0].params[1].weights is acc.engine.params[1].weights
    x = nid.make_dataset(128, seed=golden["data_seed"])[0]
    ops.reset_launch_counts()
    pending = pool.dispatch(x, [], n_valid=100)
    assert pending.event is not None and pending.out.is_cuda
    launched = ops.launch_counts()
    for _ in range(10**7):
        if pending.ready():
            break
    assert pending.ready()
    ys = pending.resolve()
    assert launched["mvu_int"] == 4 * pending.plan.n_micro and pool.idle
    want = acc(torch.from_numpy(x)).cpu().numpy()[:100]
    assert ys.dtype == want.dtype and np.array_equal(ys, want)


def test_calibration_on_the_card(cuda):
    acc, _ = _nid_standard("serving")
    kind = torch.cuda.get_device_name(0).strip().lower().replace(" ", "-")
    assert device_kind(cuda) == kind and cycle_time_key(cuda) == f"cycletime|{kind}"
    assert acc.calibration["s_per_cycle"] > 0 and list(acc.cache.entries) == [
        f"cycletime|{kind}"]
    cache = ScheduleCache()
    entry = calibrate_cycle_time(acc.engine, batch=128, reps=3, cache=cache)
    assert cache.get(f"cycletime|{kind}") == entry and entry["measured_s"] > 0
    assert dataflow.interval_seconds(acc.schedule, cache=cache, device=cuda) == \
        acc.schedule.steady_state_interval * entry["s_per_cycle"]


def test_nid_served_on_the_card(cuda):
    acc, golden = _nid_standard("serving")
    x = nid.make_dataset(golden["batch"], seed=golden["data_seed"])[0]
    batcher = acc.serve(batch_buckets=(1, 8, 32, 128), slo_s=0.05)
    rng = np.random.default_rng(0)
    ops.reset_launch_counts()
    rids, at = [], 0
    while at < len(x):
        size = min(int(rng.integers(1, 129)), len(x) - at)
        while batcher.queue.depth + size > batcher.queue.capacity:
            batcher.poll()
        rids += ([batcher.submit(x[at])] if size == 1
                 else batcher.submit_batch(x[at:at + size]))
        at += size
        batcher.poll()
    batcher.drain(timeout=300)
    launched = ops.launch_counts()
    y = np.stack([batcher.results[r].out for r in rids])
    want = acc(torch.from_numpy(x)).cpu().numpy()
    assert y.dtype == want.dtype and np.array_equal(y, want)
    assert golden_mod.digest_like(golden, y, acc.graph) == golden
    c = batcher.metrics.counters
    assert c["completed"] == len(x) and c["shed"] == 0
    # every batch of at most 128 flows is one microbatch: 4 launches
    assert launched == {k: 4 * c["flushes"] if k == "mvu_int" else 0 for k in ops.KERNELS}


# ------------------------------------------------------------ CUDA graphs
def _replay_case(config, cuda):
    if config == "cnv_quick":
        kw = {"mode": "standard", "weight_bits": 2, "act_bits": 2}
        acc = build(cnv_bnn.build_graph(cnv_bnn.spec_for(kw, cnv_bnn.QUICK), seed=0), **kw)
        xs = [cnv_bnn.images(24, 2, seed, image=cnv_bnn.QUICK.image) for seed in (0, 1)]
    else:
        golden = nid_mlp.load_golden()[config]
        acc = build(nid_mlp.build_graph(golden["seed"]), folding=nid_mlp.foldings(),
                    **golden["build"])
        xs = [nid.make_dataset(1000, seed=seed)[0] for seed in (1, 2)]
    return acc, [torch.from_numpy(x).to(cuda) for x in xs]


@pytest.mark.parametrize("config", [*VARIANTS, "cnv_quick"])
def test_replay_equals_eager_on_the_card(cuda, config):
    """A key's first call runs the stream eagerly and captures it; later
    calls replay: equal to the eager stream bit for bit, launching what it
    launches, each into a buffer of its own, capturing nothing more."""
    acc, (x, x2) = _replay_case(config, cuda)
    eng = acc.engine
    n_micro = acc.plan(x.shape[0]).n_micro
    assert n_micro > 1
    ops.reset_launch_counts()
    want = eng._stream(eng.params, x, n_micro)
    want2 = eng._stream(eng.params, x2, n_micro)
    torch.cuda.synchronize()
    eager = {k: v // 2 for k, v in ops.launch_counts().items()}
    graphs = eng.captured_graphs
    ops.reset_launch_counts()
    ys = [acc(x)]  # the eager run and the capture
    torch.cuda.synchronize()
    assert ops.launch_counts() == eager and eng.captured_graphs == graphs + 1
    for xi in (x, x2, x):
        ops.reset_launch_counts()
        ys.append(acc(xi))
        torch.cuda.synchronize()
        assert ops.launch_counts() == eager
    assert eng.captured_graphs == graphs + 1
    for y, w in zip(ys, (want, want, want2, want)):
        assert y.is_cuda and y.dtype == w.dtype and torch.equal(y, w)
    assert len({y.data_ptr() for y in ys}) == len(ys)


def test_no_capture_inside_a_timed_rep_of_tune_engine(cuda, tmp_path, monkeypatch):
    """Each tile candidate captures on its first call (its bit-exactness
    check), so the paired timer, warm-up and timed reps, races replays."""
    monkeypatch.setenv(autotune.CACHE_PATH_ENV, str(tmp_path / "cache.json"))
    captures = []
    capture = engine_mod.capture_cuda_graph
    monkeypatch.setattr(engine_mod, "capture_cuda_graph",
                        lambda *a: captures.append(1) or capture(*a))
    golden = nid_mlp.load_golden()["standard"]
    acc = build(nid_mlp.build_graph(golden["seed"]), folding=nid_mlp.foldings(),
                **golden["build"])
    timed = []

    def timer(fa, fb, *args, **kw):
        before = len(captures)
        r = autotune.paired_times(fa, fb, *args, **kw)
        timed.append(len(captures) - before)
        return r

    built = len(captures)
    entry = autotune.tune_engine(acc.graph, 1024, cache=ScheduleCache(), timer=timer, reps=2)
    assert timed == [0] * 3 and len(captures) - built == 4
    assert entry["microbatch"] in (128, 256, 512, 1024)


def test_in_flight_batches_keep_their_outputs(cuda):
    """Batches in flight on one replica replay one graph: each resolves to
    its own rows, after the later replays rewrote the graph's output."""
    acc, golden = _nid_standard("engine")
    pool = ReplicaPool(acc.engine, devices=[cuda])
    pool.warmup([128])
    graphs = acc.engine.captured_graphs
    xs = [nid.make_dataset(128, seed=seed)[0] for seed in (1, 2, 3, 4)]
    ops.reset_launch_counts()
    pending = [pool.dispatch(x, [], n_valid=128) for x in xs]
    assert pool.total_inflight == 4
    got = [p.resolve() for p in reversed(pending)][::-1]
    assert acc.engine.captured_graphs == graphs and pool.idle
    assert ops.launch_counts()["mvu_int"] == 4 * 4
    for y, x in zip(got, xs):
        want = acc.engine._stream(acc.engine.params, torch.from_numpy(x).to(cuda), 1)
        assert np.array_equal(y, want.cpu().numpy())
    assert not np.array_equal(got[0], got[1])


def test_graphs_of_one_device_share_their_intermediates(cuda):
    """The graphs of one engine and card share a memory pool and a capture
    stream, so a second key's capture reuses the blocks the first one's
    intermediates freed: the FULL CNV in one microbatch of 256 images
    reserves its int32 activations once, and a key of 255 images adds
    little beside them (a quarter of the first graph's at most; its
    static input and output, not a second set of activations)."""
    golden = cnv_bnn.load_golden()["standard"]
    kw = golden["build"]
    acc = build(cnv_bnn.build_graph(cnv_bnn.spec_for(kw), seed=golden["seed"]),
                microbatches=1, **kw)
    x = torch.from_numpy(cnv_bnn.images(256, kw["act_bits"], golden["data_seed"])).to(cuda)
    assert acc.plan(256).n_micro == 1 == acc.plan(255).n_micro
    graphs = acc.engine.captured_graphs  # the build's verification ran its engine too
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = [torch.cuda.memory_reserved()]
    for xi in (x, x[:255]):
        acc(xi)  # the eager run and the capture (which empties torch's cache first)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    first, second = reserved[1] - reserved[0], reserved[2] - reserved[1]
    assert acc.engine.captured_graphs == graphs + 2
    # the first graph holds the 256 images' activations (154 MiB on an H100)
    assert first > 32 * 2**20 and second < first / 4, (
        f"the first graph reserved {first / 2**20:.1f} MiB, the second "
        f"{second / 2**20:.1f} MiB beside it")
    want = acc.engine._stream(acc.engine.params, x, 1)
    assert torch.equal(acc(x), want) and torch.equal(acc(x[:255]), want[:255])


def test_a_replay_on_another_stream_raises(cuda):
    """Every replay of an engine's graphs on a card goes to one stream, the
    caller's at the card's first capture: a call from another stream
    raises rather than race a replay in flight."""
    acc, (x, _) = _replay_case("standard", cuda)
    acc(x)  # the eager run and the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), pytest.raises(RuntimeError, match="replay on stream"):
        acc(x)
    torch.cuda.synchronize()
    assert torch.equal(acc(x), acc.engine._stream(acc.engine.params, x,
                                                  acc.plan(x.shape[0]).n_micro))


@pytest.mark.parametrize("n_stages", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["standard", "binary"])
def test_pipeline_on_the_card_equals_the_engine(cuda, mode, n_stages):
    """``as_pipeline`` of the full-width chain (eight 64 x 64 layers, 2-bit
    activations, one stream a stage of one card) equals ``acc(x)`` and
    launches the mode's kernel once a layer a microbatch, nothing else."""
    from repro_torch.configs import mvu_chain

    cfg = mvu_chain.FULL
    rng = np.random.default_rng(0)
    g = mvu_chain.build_graph(rng, cfg["d"], cfg["layers"], cfg["bits"])
    acc = build(g, target="pipeline", mode=mode, weight_bits=2 if mode == "standard" else 1,
                act_bits=cfg["bits"], folding=mvu_chain.foldings(), device="cuda")
    x = torch.from_numpy(rng.integers(0, 4, (1024, cfg["d"])).astype(np.int32)).to(cuda)
    want = acc(x)
    plan = acc.plan(1024)
    run = acc.as_pipeline([cuda] * n_stages)
    ops.reset_launch_counts()
    got = run(x.reshape(plan.n_micro, plan.microbatch, -1))
    torch.cuda.synchronize()
    kernel = ops.kernel_name(mode)
    counts = ops.launch_counts()
    assert counts == {k: plan.n_micro * cfg["layers"] if k == kernel else 0 for k in counts}
    assert got.is_cuda and torch.equal(got.reshape(want.shape), want)
    # the same ticks on the caller's stream, with no stage streams or events
    one = run(x.reshape(plan.n_micro, plan.microbatch, -1), stage_streams=False)
    assert torch.equal(one.reshape(want.shape), want)


def _lm_projection(backend, d_in, d_out, m, dtype, seed):
    """(x, QTensor, act_bits) of one LM projection on the CPU: random
    weights quantized by ``quantize_linear_params``, random activations."""
    from repro_torch.core.quantize import QTensor
    from repro_torch.models.layers import MVU_BACKENDS, quantize_linear_params

    w_bits, a_bits = MVU_BACKENDS[backend]
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn(d_in, d_out, generator=g) / d_in ** 0.5).to(dtype)
    x = (torch.randn(m, d_in, generator=g) * 3).to(dtype)
    q = quantize_linear_params({"w": w}, backend)
    return x, QTensor(q["values"], q["scale"], w_bits, True), a_bits


def _on(qt, device):
    return qt._replace(values=qt.values.to(device), scale=qt.scale.to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [4, 100])
@pytest.mark.parametrize("backend", ["mvu_w8a8", "mvu_w4a4", "mvu_binary"])
def test_quantized_linear_on_the_card(cuda, backend, m, dtype):
    """The LM projection at Yi-9B's widths (K = 4096 into N = 11008, and
    back) launches the hand kernel once and equals its plain version
    (``backend="torch"``) on the card bit for bit, both arms; at a narrower
    width the card equals the CPU bit for bit."""
    from repro_torch.core.mvu import quantized_linear

    kernel = "mvu_binary" if backend == "mvu_binary" else "mvu_int"
    for d_in, d_out in ((4096, 11008), (11008, 4096)):
        x, qt, a_bits = _lm_projection(backend, d_in, d_out, m, dtype, m)
        x, qt = x.to(cuda), _on(qt, cuda)
        ops.reset_launch_counts()
        got = quantized_linear(x, qt, act_bits=a_bits)
        torch.cuda.synchronize()
        assert ops.launch_counts()[kernel] == 1
        want = quantized_linear(x, qt, act_bits=a_bits, backend="torch")
        assert got.dtype == dtype and torch.equal(got, want)
    x, qt, a_bits = _lm_projection(backend, 512, 1024, m, dtype, m + 1)
    assert torch.equal(quantized_linear(x.to(cuda), _on(qt, cuda), act_bits=a_bits).cpu(),
                       quantized_linear(x, qt, act_bits=a_bits))


@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8"])
def test_lm_golden_run_on_the_card(cuda, backend):
    """The reduced Yi-9B in float32 on the card against the JAX package's
    golden run (``configs/yi_9b_lm_golden.json``); W8A8 launches ``mvu_int``
    for every projection of every call."""
    from repro_torch.configs import lm_golden as G
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.models.layers import PROJ_NAMES, quantize_model_params
    from repro_torch.models.model import build as build_lm

    cfg = G.golden_config(backend)
    params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED), cuda)
    if backend != "dense":
        params = quantize_model_params(params, backend)
    ops.reset_launch_counts()
    got = G.greedy_run(build_lm(cfg, device=cuda), params)
    torch.cuda.synchronize()
    n = 0 if backend == "dense" else len(PROJ_NAMES) * cfg.num_layers * (1 + G.DECODE_STEPS)
    assert ops.launch_counts() == {k: n if k == "mvu_int" else 0 for k in ops.launch_counts()}
    assert G.mismatch(G.load_golden()["variants"][backend], got) is None


@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b"])
def test_moe_lm_golden_run_on_the_card(cuda, arch, backend):
    """The reduced MoE archs in float32 on the card against the JAX
    package's golden runs, each call's dropped assignments included; W8A8
    launches ``mvu_int`` for the four attention projections only."""
    from repro_torch.configs import lm_golden as G
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.models.layers import quantize_model_params
    from repro_torch.models.model import build as build_lm

    cfg = G.golden_config(backend, arch)
    params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED), cuda)
    if backend != "dense":
        params = quantize_model_params(params, backend)
    ops.reset_launch_counts()
    got = G.greedy_run(build_lm(cfg, device=cuda), params)
    torch.cuda.synchronize()
    n = 0 if backend == "dense" else 4 * cfg.num_layers * (1 + G.DECODE_STEPS)
    assert ops.launch_counts() == {k: n if k == "mvu_int" else 0 for k in ops.launch_counts()}
    assert G.mismatch(G.load_golden(arch)["variants"][backend], got) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens", [(4, 1), (4, 114)])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b"])
def test_moe_ffn_on_the_card_equals_the_cpu(cuda, arch, tokens, dtype):
    """``moe_ffn`` of one layer at the full width's expert count, top-k and
    ``moe_d_ff`` (d cut to 256) at the decode and a prefill's rows: the
    routing on the card equal to the CPU's, the output within 1e-5 of the
    largest CPU magnitude in float32 (TF32 off) and within 2e-2,
    correlation >= 0.999, in bfloat16; no hand kernel launched."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(arch).replace(d_model=256, dtype=dtype)
    dt = getattr(torch, dtype)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, dt)
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 0.5, (*tokens, cfg.d_model))
                         .astype(np.float32)).to(dt)
    factor = 2.0 if tokens[1] == 1 else cfg.capacity_factor
    logits = x.reshape(-1, cfg.d_model).float() @ p["router"]["w"]
    want_idx = moe.route_topk(logits, cfg.num_experts_per_tok)[1]
    got_idx = moe.route_topk(logits.to(cuda), cfg.num_experts_per_tok)[1]
    assert torch.equal(got_idx.cpu(), want_idx)
    want, want_aux = moe.moe_ffn(p, cfg, x, group_size=cfg.moe_group_size,
                                 capacity_factor=factor)
    pc = {k: ({"w": v["w"].to(cuda)} if k == "router" else v.to(cuda)) for k, v in p.items()}
    ops.reset_launch_counts()
    got, aux = moe.moe_ffn(pc, cfg, x.to(cuda), group_size=cfg.moe_group_size,
                           capacity_factor=factor)
    torch.cuda.synchronize()
    assert set(ops.launch_counts().values()) == {0}
    assert got.dtype == dt and got.device.type == cuda.type
    ref, out = want.float().numpy(), got.float().cpu().numpy()
    if dtype == "float32":
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        assert np.corrcoef(ref.ravel(), out.ravel())[0, 1] >= 0.999
        assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()
    assert abs(aux.item() - want_aux.item()) <= 1e-5 * want_aux.item()


@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8", "mvu_binary"])
def test_lm_qat_golden_on_the_card(cuda, backend):
    """The reduced Yi-9B's QAT loss and gradients in float32 (remat on) on
    the card against the JAX package's golden (``configs/yi_9b_qat_golden.json``);
    the fake-quant arm launches no kernel."""
    from repro_torch.configs import lm_golden as G
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.models.model import build as build_lm

    cfg = G.qat_config(backend)
    params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED), cuda)
    ops.reset_launch_counts()
    got = G.qat_run(build_lm(cfg, device=cuda), params)
    assert not any(ops.launch_counts().values())
    assert G.qat_mismatch(G.load_qat_golden()["variants"][backend], got) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_fake_quant_weights_on_the_card_equal_the_cpu(cuda, bits, dtype):
    """``fake_quant_weights(w, bits, axis=1)`` at Yi-9B's d_in (4096, 11008):
    values and STE gradient on the card equal the CPU's bit for bit (the
    1-bit column mean in XLA:CPU's order, constants as device tensors)."""
    from repro_torch.core.quantize import fake_quant_weights

    for d_in in (4096, 11008):
        g = torch.Generator().manual_seed(d_in + bits)
        w = (torch.randn(d_in, 256, generator=g) / d_in**0.5).to(dtype)
        c = torch.randn(d_in, 256, generator=g).to(dtype)
        out = []
        for dev in ("cpu", cuda):
            wd = w.to(dev).requires_grad_(True)
            y = fake_quant_weights(wd, bits, axis=1)
            (gw,) = torch.autograd.grad((y * c.to(dev)).sum(), wd)
            out.append((y.detach().cpu(), gw.cpu()))
        assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_column_scale_of_a_stack_on_the_card_equals_the_cpu(cuda, dtype):
    """``column_scale`` of a (3, d_in, 256) stack at Yi-9B's d_in, one batch
    on the card, equals the CPU's bit for bit."""
    from repro_torch.core.quantize import column_scale

    for d_in in (4096, 11008):
        g = torch.Generator().manual_seed(d_in)
        w = (torch.randn(3, d_in, 256, generator=g) / d_in**0.5).to(dtype)
        assert torch.equal(column_scale(w.to(cuda)).cpu(), column_scale(w))


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("clip_active", [True, False], ids=["clip", "no_clip"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_leaf_update_on_the_card_equals_the_cpu(cuda, dtype, clip_active, step):
    """The per-leaf AdamW step at a Yi-9B projection's shape (4096 x 512)
    on the card against its CPU run, given the CPU's clip, lr and bias
    corrections: bit for bit (IEEE float32 mul, add and divide on both;
    sqrt correctly rounded, through float64)."""
    from repro_torch.optim import adamw

    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    g = torch.Generator().manual_seed(step + 10 * clip_active)
    p = torch.randn(4096, 512, generator=g).to(dtype)
    grad = (torch.randn(4096, 512, generator=g) * (1.0 if clip_active else 1e-4)).to(dtype)
    mu = torch.randn(4096, 512, generator=g) * 0.01
    nu = torch.rand(4096, 512, generator=g) * 1e-4
    state = {"mu": {"w": mu}, "nu": {"w": nu}, "step": torch.tensor(step, dtype=torch.int32)}
    _, _, m = adamw.update(cfg, {"w": p}, {"w": grad}, state)
    gnorm = m["grad_norm"]
    clip = torch.minimum(torch.tensor(1.0), torch.tensor(cfg.grad_clip) / (gnorm + torch.tensor(1e-9)))
    assert (clip.item() < 1.0) == clip_active
    s = torch.tensor(float(step + 1))
    consts = [clip, m["lr"], 1 - torch.pow(torch.tensor(cfg.beta1), s),
              1 - torch.pow(torch.tensor(cfg.beta2), s)]
    want = adamw.leaf_update(cfg, p, grad, mu, nu, *consts)
    got = adamw.leaf_update(cfg, p.to(cuda), grad.to(cuda), mu.to(cuda), nu.to(cuda),
                            *[c.to(cuda) for c in consts])
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    for w, o in zip(want, got):
        assert o.device.type == cuda.type and o.dtype == w.dtype
        assert torch.equal(o.cpu().view(view[o.dtype]), w.view(view[w.dtype]))


def test_adamw_schedule_and_update_on_the_card_within_the_cpus_bounds(cuda):
    """``schedule`` over steps 0-12 and one ``update`` of the reduced Yi-9B
    tree on the card against the CPU: lr within rtol 1e-6 (the device's cos
    and pow may round another way), grad_norm within rtol 1e-6 (another
    summation order), params and moments within 1e-5 of each leaf's largest
    magnitude, the step on the card and never read by the host."""
    from repro_torch.configs import lm_golden as G
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.tree import flat_leaves

    cfg = adamw.AdamWConfig(**G.TRAIN_OPT)
    for step in range(13):
        want = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32, device=cuda))
        assert got.device.type == cuda.type and got.item() == pytest.approx(want.item(), rel=1e-6, abs=0)
    tree = lm_numpy_params(G.golden_config(), 3)
    grads = lm_numpy_params(G.golden_config(), 4)
    outs = []
    for dev in ("cpu", cuda):
        params = lm_params_from_numpy(tree, dev)
        outs.append(adamw.update(cfg, params, lm_params_from_numpy(grads, dev),
                                 adamw.init(params)))
    (wp, ws, wm), (gp, gs, gm) = outs
    assert gs["step"].device.type == cuda.type and gs["step"].item() == 1
    for k in ("lr", "grad_norm"):
        assert gm[k].item() == pytest.approx(wm[k].item(), rel=1e-6, abs=0)
    for want, got in ((wp, gp), (ws["mu"], gs["mu"]), (ws["nu"], gs["nu"])):
        for path, w in flat_leaves(want).items():
            o = flat_leaves(got)[path]
            assert o.device.type == cuda.type and float((o.cpu() - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.parametrize("backend", ["dense", "mvu_w8a8"])
def test_train_golden_on_the_card(cuda, backend):
    """The reduced Yi-9B's 4 AdamW steps in float32 on the card against the
    JAX package's jitted ``make_train_step`` golden
    (``configs/yi_9b_train_golden.json``); training launches no kernel."""
    from repro_torch.configs import lm_golden as G
    from repro_torch.convert import lm_numpy_params, lm_params_from_numpy
    from repro_torch.models.model import build as build_lm

    cfg = G.golden_config(backend)
    params = lm_params_from_numpy(lm_numpy_params(cfg, G.SEED), cuda)
    ops.reset_launch_counts()
    got = G.train_run(build_lm(cfg, device=cuda), params)
    assert not any(ops.launch_counts().values())
    assert G.train_mismatch(G.load_train_golden()["variants"][backend], got) is None


@pytest.mark.parametrize("use_async", [False, True])
def test_checkpoint_round_trip_card_disk_card(cuda, tmp_path, use_async):
    """A tree on the card (bf16 with NaN, inf and -0 among its values,
    float32, an int32 step) saved to disk and restored onto the card equals
    itself bit for bit."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.tree import flat_leaves

    g = torch.Generator().manual_seed(0)
    edge = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1.0, -3.5,
                         1e-40, 3e38])
    w = torch.randn(64, 96, generator=g)
    w.view(-1)[:9] = edge
    tree = {"params": {"w": w.to(torch.bfloat16), "b": torch.randn(96, generator=g)},
            "opt": {"mu": {"w": torch.randn(64, 96, generator=g)},
                    "step": torch.tensor(4, dtype=torch.int32)}}
    tree = {k: {p: (v.to(cuda) if not isinstance(v, dict) else {q: x.to(cuda) for q, x in
                                                               v.items()})
                for p, v in t.items()} for k, t in tree.items()}
    if use_async:
        ckpt.save_async(str(tmp_path), 4, tree).join(60)
    else:
        ckpt.save(str(tmp_path), 4, tree)
    got = ckpt.restore(str(tmp_path), ckpt.latest_step(str(tmp_path)), tree, device=cuda)
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.int32: torch.int32}
    for path, want in flat_leaves(tree).items():
        have = flat_leaves(got)[path]
        assert have.device.type == cuda.type and have.dtype == want.dtype and have.shape == want.shape
        assert torch.equal(have.view(view[have.dtype]), want.view(view[want.dtype])), path
