"""The committed NID-MLP golden digest, recomputed by both packages on the CPU.

``src/repro_torch/configs/nid_mlp_golden.json`` records the JAX package's
NID output (batch 4096, seed 0, data seed 1, 2-bit weights and
activations).  ``chip_smoke.py`` holds the card's output to it; here the
JAX package (``scripts/nid_golden.py``) and the port both recompute it.
"""

import importlib.util
import os

import pytest
import torch

from repro_torch.build import build
from repro_torch.configs import nid_mlp
from repro_torch.data import nid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return nid_mlp.load_golden()


def test_jax_package_reproduces_the_golden_digest(golden):
    spec = importlib.util.spec_from_file_location(
        "nid_golden", os.path.join(ROOT, "scripts", "nid_golden.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.jax_digest(golden["weight_bits"], golden["act_bits"]) == golden


def test_port_reproduces_the_golden_digest(golden):
    acc = build(nid_mlp.build_graph(golden["seed"]), target="engine", mode="standard",
                weight_bits=golden["weight_bits"], act_bits=golden["act_bits"],
                folding=nid_mlp.foldings(), device="cpu")
    x = torch.from_numpy(nid.make_dataset(golden["batch"], seed=golden["data_seed"])[0])
    y = acc(x)
    meta = {k: golden[k] for k in ("seed", "data_seed", "batch", "weight_bits", "act_bits")}
    assert nid_mlp.golden_digest(y.numpy(), nid_mlp.graph_layers(acc.graph), **meta) == golden
