"""The hand kernel and the slice on the card (marked ``cuda``).

Run on a machine with an NVIDIA GPU and nvcc:
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
Elsewhere every test here skips.  No JAX: the card's machine has none.
"""

import pytest
import torch

from repro_torch.build import build
from repro_torch.configs import nid_mlp
from repro_torch.data import nid
from repro_torch.kernels import mvu_int as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(m, n, k, lo, hi, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(0, 4, (m, k), generator=g, dtype=torch.int32)
    w = torch.randint(lo, hi, (n, k), generator=g, dtype=torch.int8)
    t = torch.sort(torch.randint(-300, 300, (n, 3), generator=g, dtype=torch.int32), 1).values
    s = torch.rand(n, generator=g) + 0.01
    return [x.to(device) for x in (a, w, t, s)]


@pytest.mark.parametrize("epilogue", ["raw", "thresholds", "scale"])
@pytest.mark.parametrize("n,k", [(64, 600), (64, 64), (1, 64), (33, 95)])
@pytest.mark.parametrize("m", [1, 3, 128, 257])
def test_kernel_equals_plain(cuda, m, n, k, epilogue):
    for lo, hi in ((-1, 2), (-128, 128)):
        a, w, t, s = _inputs(m, n, k, lo, hi, cuda, seed=m + k)
        kw = {"thresholds": t} if epilogue == "thresholds" else \
            {"out_scale": s} if epilogue == "scale" else {}
        launches = K.LAUNCHES
        got = K.mvu_int(a, w, **kw)
        assert K.LAUNCHES == launches + 1 and got.is_cuda
        want = K.mvu_int_plain(a, w, **kw)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_kernel_wraps_and_widens(cuda):
    g = torch.Generator().manual_seed(1)
    a = torch.randint(-2**31, 2**31 - 1, (5, 77), generator=g, dtype=torch.int32).to(cuda)
    w = torch.randint(-128, 128, (9, 77), generator=g, dtype=torch.int8).to(cuda)
    assert torch.equal(K.mvu_int(a, w), K.mvu_int_plain(a, w))
    a8 = torch.randint(-128, 128, (5, 77), generator=g, dtype=torch.int8).to(cuda)
    assert torch.equal(K.mvu_int(a8, w), K.mvu_int_plain(a8.int(), w))


def test_kernel_rejects_non_contiguous_and_mixed_devices(cuda):
    a, w, _, _ = _inputs(8, 4, 32, -1, 2, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.mvu_int(torch.cat([a, a], 1)[:, ::2], w)
    with pytest.raises(ValueError, match="is on cpu"):
        K.mvu_int(a, w.cpu())


def test_nid_engine_on_the_card(cuda):
    golden = nid_mlp.load_golden()
    acc = build(nid_mlp.build_graph(golden["seed"]), weight_bits=golden["weight_bits"],
                act_bits=golden["act_bits"], folding=nid_mlp.foldings())
    x = torch.from_numpy(nid.make_dataset(golden["batch"], seed=golden["data_seed"])[0])
    K.LAUNCHES = 0
    y = acc(x)
    assert K.LAUNCHES == 4 * acc.plan(golden["batch"]).n_micro and y.is_cuda
    assert torch.equal(y, acc.interpret(x))
    meta = {k: golden[k] for k in ("seed", "data_seed", "batch", "weight_bits", "act_bits")}
    assert nid_mlp.golden_digest(y.cpu().numpy(), nid_mlp.graph_layers(acc.graph),
                                 **meta) == golden
