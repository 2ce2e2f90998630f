"""The port's examples (``examples/torch_*.py``) run on the CPU, as the JAX
package's examples are run: each ``main(device="cpu", out_dir=tmp_path)``
(the NID example with ``fast=True``) must finish with its own asserts --
engine equal to the interpreter, served requests equal to the engine --
and write its BuildReports into ``out_dir`` alone, never into the JAX
package's ``experiments/build/``.  On the CPU the kernel wrappers run
their plain versions; ``chip_smoke.py`` runs the same mains on the card.
"""

import glob
import importlib.util
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {  # example -> (extra kwargs, the BuildReports it writes)
    "torch_quickstart": ({}, ["quickstart_mlp"]),
    "torch_cnv_dataflow": ({}, ["cnv_quick"]),
    "torch_residual_mlp": ({"fast": True}, ["residual_mlp"]),
    "torch_nid_intrusion_detection": ({"fast": True}, ["nid_mlp"]),
    "torch_dataflow_pipeline": ({}, []),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite's workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_build_dir():
    return {p: os.path.getmtime(p)
            for p in glob.glob(os.path.join(ROOT, "experiments", "build", "*"))}


def test_every_torch_example_is_listed():
    found = sorted(os.path.basename(p)[:-3]
                   for p in glob.glob(os.path.join(ROOT, "examples", "torch_*.py")))
    assert found == sorted(EXAMPLES)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path, capsys):
    kwargs, reports = EXAMPLES[name]
    before = _jax_build_dir()
    _load(name).main(device="cpu", out_dir=str(tmp_path), **kwargs)
    out = capsys.readouterr().out
    assert "Traceback" not in out
    assert sorted(os.listdir(tmp_path)) == sorted(f"{r}_build_report.json" for r in reports)
    assert _jax_build_dir() == before  # nothing written into experiments/build/


def test_quickstart_says_which_path_ran(tmp_path, capsys):
    _load("torch_quickstart").main(device="cpu", out_dir=str(tmp_path))
    assert "ran the wrapper's plain version (CPU tensors, no launch)" in capsys.readouterr().out


def test_nid_example_returns_the_flow_record(tmp_path):
    out = _load("torch_nid_intrusion_detection").main(
        fast=True, device="cpu", out_dir=str(tmp_path))
    assert out["mvu_int_acc"] > 0.95 and out["mvu_int_acc"] >= out["float_acc"] - 0.05
    assert (out["pipeline_interval_cycles"], out["pipeline_latency_cycles"],
            out["bottleneck"]) == (12, 36, "fc0.mvu")


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_defaults_to_the_card(name):
    """``main()`` with no device asks for CUDA and raises without a card: no
    CPU retreat."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    kwargs = {"fast": True} if "fast" in EXAMPLES[name][0] else {}
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        _load(name).main(out_dir=os.devnull, **kwargs)


def test_pipeline_example_returns_its_errors():
    out = _load("torch_dataflow_pipeline").main(device="cpu")
    assert out["stages"] == 4 and out["forward_err"] < 1e-5 and out["grad_err"] < 1e-4
