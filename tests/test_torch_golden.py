"""The committed NID-MLP golden digests, recomputed by both packages on the CPU.

``src/repro_torch/configs/nid_mlp_golden.json`` records the JAX package's
NID output (batch 4096, seed 0, data seed 1) for each build variant -- the
2-bit standard datapath and the xnor, binary, packed-binary and
packed-2-bit ones -- beside the variant's build kwargs.  ``chip_smoke.py``
holds the card's output to it; here the JAX package
(``scripts/nid_golden.py``) and the port both recompute every variant.
"""

import importlib.util
import os

import pytest
import torch

from repro_torch.build import build
from repro_torch.configs import golden as golden_mod, nid_mlp
from repro_torch.data import nid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ["standard", "xnor", "binary", "binary_packed", "standard_packed"]


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


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "nid_golden", os.path.join(ROOT, "scripts", "nid_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_file_holds_the_script_variants(golden, script):
    assert sorted(golden) == sorted(VARIANTS) == sorted(script.VARIANTS)
    assert all(golden[v]["build"] == script.VARIANTS[v] for v in VARIANTS)


@pytest.mark.parametrize("variant", VARIANTS)
def test_jax_package_reproduces_the_golden_digest(golden, script, variant):
    assert script.jax_digest(golden[variant]["build"]) == golden[variant]


@pytest.mark.parametrize("variant", VARIANTS)
def test_port_reproduces_the_golden_digest(golden, variant):
    g = golden[variant]
    acc = build(nid_mlp.build_graph(g["seed"]), target="engine",
                folding=nid_mlp.foldings(), device="cpu", **g["build"])
    x = torch.from_numpy(nid.make_dataset(g["batch"], seed=g["data_seed"])[0])
    y = acc(x)
    assert golden_mod.digest_like(g, y.numpy(), acc.graph) == g
