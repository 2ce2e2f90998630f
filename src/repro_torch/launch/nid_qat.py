"""The paper's Section 6.5 use case on the card: the NID MLP trained with a
straight-through estimator, streamlined into the integer MVU chain.

The port of the JAX package's ``benchmarks/nid_mlp.py`` (Tables 6/7 and
``accuracy_check``), kept in the package so that ``chip_smoke.py`` and the
examples import it with only ``src`` on the path:

* :func:`layer_rows` -- per layer of Table 6: the cycle model (NF x SF plus
  FINN's pipeline depth of 5 reproduces Table 7's 17/13/13/13 cycles), the
  weight-memory and input-buffer depths and the port's resource analogs
  (``mvu_resources``: the CUDA tile's bytes);
* :func:`train` -- the float 600-64-64-64-1 MLP trained full batch with
  plain SGD, its hidden activations quantized to 2 bits in the forward pass
  and passed straight through in the backward pass;
* :func:`qat_graph` -- the trained weights as a raw IR chain (linear,
  batchnorm, quant_act), which ``build`` lowers and streamlines: BN and the
  quantizer fold into integer thresholds on the float weights;
* :func:`accuracy_check` -- data, training, the streamlined build with the
  paper's folding, the integer engine on the build's device (the
  hand-written ``mvu_int`` on the card) held bit for bit to the
  interpreter, and the integer accuracy against the float teacher;
* :func:`run_quick` -- the two claims of the reference (Table 7 cycles, the
  integer model tracking its teacher) plus the example's > 0.95.

Training is float work: its products stay ``torch.matmul``, as the
reference computes them with ``jnp`` matmuls in no Pallas kernel.  Its
numbers need not equal JAX's; the streamlined integer graph of the same
float weights does (``tests/test_torch_qat.py``).

``GOLDEN`` names the JAX package's digests of two seeded variants of the
streamlined graph (:func:`seeded_weights`, :func:`variant_graph`),
written by ``scripts/nid_qat_golden.py``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import torch

from repro_torch.configs import nid_mlp
from repro_torch.core.folding import Folding
from repro_torch.core.ir import Graph, Node
from repro_torch.core.resource_model import mvu_resources

PIPELINE_DEPTH = 5  # FINN MVU register stages (input, simd, adder, acc, out)
PAPER_RTL_CYCLES = (17, 13, 13, 13)  # Table 7
DIMS = (600, 64, 64, 64, 1)
ACT_BITS = 2  # the hidden quantizer and the input flows
WEIGHT_BITS = 8  # the streamlined weights' grid
LEARNING_RATE = 0.03
BUILD_STEPS = ("validate", "lower", "streamline", "finalize", "fold", "dataflow",
               "engine")
BN_EPS = 1e-5  # the identity batchnorm's var is 1 - eps: var + eps = 1
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "nid_qat_golden.json")
GOLDEN_VARIANTS = ("identity_bn", "seeded_bn")


def layer_rows() -> list[dict]:
    """Table 6's layers with the analytic columns of the reference's
    ``run()``: modelled and paper cycles, memory depths and the port's
    resource analogs (the compile-time columns are the kernels' nvcc build,
    which ``chip_smoke.py`` prints)."""
    rows = []
    for i, (k, n, pe, simd) in enumerate(nid_mlp.LAYERS):
        fold = Folding(pe, simd)
        res = mvu_resources(n, k, fold, mode="standard",
                            weight_bits=nid_mlp.WEIGHT_BITS, n_pixels=1)
        rows.append({
            "layer": i, "K": k, "N": n, "PE": pe, "SIMD": simd,
            "exec_cycles_model": fold.cycles(n, k, 1) + PIPELINE_DEPTH,
            "exec_cycles_paper_rtl": PAPER_RTL_CYCLES[i],
            "wmem_depth": res.weight_mem_depth,
            "inbuf_depth": res.input_buffer_depth,
            "rtl_lut_bytes": res.lut_bytes,
            "rtl_ff_bytes": res.ff_bytes,
            "rtl_bram_bytes": res.bram_bytes,
        })
    return rows


def _quantize_hidden(h: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(torch.relu(h)), 0, 2**ACT_BITS - 1)


def forward(ws, x: torch.Tensor) -> torch.Tensor:
    """The quantized forward pass: the logit of each flow."""
    h = x.to(ws[0].dtype)
    for i, w in enumerate(ws):
        h = h @ w.T
        if i < len(ws) - 1:
            h = _quantize_hidden(h)
    return h[..., 0]


def _bce_with_logits(logit: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.relu(logit) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def loss_ste(ws, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The reference's straight-through loss: the quantized forward pass,
    the float backward pass (``h + (hq - h).detach()``)."""
    h = x.to(ws[0].dtype)
    for i, w in enumerate(ws):
        h = h @ w.T
        if i < len(ws) - 1:
            h = h + (_quantize_hidden(h) - h).detach()
    return _bce_with_logits(h[..., 0], y.to(h.dtype))


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' to run "
                           "the flow on the CPU (the kernels' plain versions)")
    return dev


def train(x, y, *, steps: int = 300, seed: int = 0, device="cuda") -> list[torch.Tensor]:
    """Full-batch SGD (rate 0.03) on :func:`loss_ste` from ``randn / sqrt(K)``
    weights, drawn layer by layer from one generator seeded ``seed`` on
    ``device``; returns the four float32 weight matrices there."""
    device = _device(device)
    gen = torch.Generator(device).manual_seed(seed)
    ws = [torch.randn((n, k), generator=gen, device=device) / math.sqrt(k)
          for k, n in zip(DIMS[:-1], DIMS[1:])]
    xb = torch.as_tensor(x, device=device).to(torch.float32)
    yb = torch.as_tensor(y, device=device).to(torch.float32)
    for _ in range(steps):
        ws = [w.requires_grad_() for w in ws]
        grads = torch.autograd.grad(loss_ste(ws, xb, yb), ws)
        ws = [(w - LEARNING_RATE * g).detach() for w, g in zip(ws, grads)]
    return ws


def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v.detach().cpu() if torch.is_tensor(v) else v,
                                      dtype=np.float32))


def qat_graph(ws, bn=None) -> Graph:
    """The raw chain of the trained weights ``ws`` (4 matrices, (N, K)):
    input (600 flows' features, 2-bit); fc0-fc3; after fc0-fc2 a batchnorm
    (``bn[i]``'s gamma / beta / mean / var, or the reference's identity
    constants 1 / 0 / 0 / 1 - 1e-5) and a 2-bit quant_act at scale 1.0.
    Float32 CPU tensors; ``build`` lowers and streamlines it."""
    g = Graph([Node("input", "in", {"shape": (DIMS[0],), "bits": ACT_BITS})])
    for i, w in enumerate(ws):
        g.append(Node("linear", f"fc{i}", {}, {"w": _tensor(w)}))
        if i < len(ws) - 1:
            n = int(w.shape[0])
            p = bn[i] if bn is not None else {
                "gamma": torch.ones((n,)), "beta": torch.zeros((n,)),
                "mean": torch.zeros((n,)), "var": torch.ones((n,)) - BN_EPS}
            g.append(Node("batchnorm", f"bn{i}", {},
                          {k: _tensor(p[k]) for k in ("gamma", "beta", "mean", "var")}))
            g.append(Node("quant_act", f"act{i}", {"bits": ACT_BITS, "act_scale": 1.0}))
    return g


def build_kwargs() -> dict:
    """The streamlined build's settings (the reference's, with the engine
    step after ``dataflow``)."""
    return dict(target="engine", mode="standard", weight_bits=WEIGHT_BITS,
                act_bits=ACT_BITS, name="nid_mlp_qat", steps=BUILD_STEPS)


def build_streamlined(graph: Graph, *, device="cuda"):
    """``build`` of a raw chain (:func:`qat_graph`) through the flow's steps
    with the paper's Table 6 folding, on ``device``."""
    from repro_torch.build import build

    return build(graph, folding=nid_mlp.foldings(), device=device, **build_kwargs())


@dataclasses.dataclass
class QATRun:
    """What :func:`prepare` made: the streamlined Accelerator, the test
    flows and labels on its device and the float teacher's accuracy."""
    acc: object
    x_test: torch.Tensor
    y_test: torch.Tensor
    float_acc: float


def prepare(n_train: int = 4096, n_test: int = 1024, steps: int = 300, *,
            device="cuda") -> QATRun:
    """Steps 1-3 of :func:`accuracy_check`: the data
    (``nid.make_dataset``, seeds 0 and 1), training, the float accuracy and
    the streamlined build on ``device``."""
    from repro_torch.data.nid import make_dataset

    device = _device(device)
    x_train, y_train = make_dataset(n_train, seed=0)
    x_test, y_test = make_dataset(n_test, seed=1)
    ws = train(x_train, y_train, steps=steps, device=device)
    x_test = torch.from_numpy(x_test).to(device)
    y_test = torch.from_numpy(y_test).to(device)
    float_acc = float(((forward(ws, x_test) > 0) == y_test.bool()).to(torch.float32).mean())
    acc = build_streamlined(qat_graph(ws), device=device)
    return QATRun(acc=acc, x_test=x_test, y_test=y_test, float_acc=float_acc)


def score(run: QATRun, out: torch.Tensor) -> dict:
    """Steps 4-5 of :func:`accuracy_check` on the engine's output ``out`` =
    ``run.acc(run.x_test)``: it must equal the interpreter bit for bit
    (raises otherwise; the interpreter is never scored in its place); then
    the integer accuracy from the head's logit times its weight scale, and
    the dataflow schedule."""
    from repro_torch.core import dataflow

    acc = run.acc
    ref = acc.interpret(run.x_test)
    if not (out.dtype == ref.dtype and out.shape == ref.shape and torch.equal(out, ref)):
        raise AssertionError("the streamlined engine's acc(x) differs from "
                             "acc.interpret(x): not bit-exact")
    # the head emits its accumulator times the weight scale; scaling by the
    # scale again, as the reference does, keeps the logit's sign
    head = [n for n in acc.graph if n.op == "mvu"][-1].params["mvu"]
    logits = out[..., 0] * (head.out_scale[0] if head.out_scale is not None else 1.0)
    int_acc = float(((logits > 0) == run.y_test.bool()).to(torch.float32).mean())
    sched = dataflow.schedule(acc.graph)
    return {
        "float_acc": run.float_acc,
        "mvu_int_acc": int_acc,
        "pipeline_interval_cycles": sched.steady_state_interval,
        "pipeline_latency_cycles": sched.latency_cycles,
        "bottleneck": sched.bottleneck.name,
    }


def accuracy_check(n_train: int = 4096, n_test: int = 1024, steps: int = 300, *,
                   device="cuda") -> dict:
    """Train the float MLP on the synthetic NID flows, streamline it through
    ``build`` into the 2-bit MVU chain, run the integer engine on
    ``device`` (bit-exact with the interpreter, else it raises) and compare
    its accuracy with the float teacher's.  The reference's five keys."""
    run = prepare(n_train, n_test, steps, device=device)
    return score(run, run.acc(run.x_test))


def check_claims(rows: list[dict], acc: dict) -> dict:
    """The reference's two claims and the example's accuracy floor, from
    :func:`layer_rows` and :func:`accuracy_check`'s record; raises when one
    fails."""
    c = {
        "cycles_match_paper": all(
            r["exec_cycles_model"] == r["exec_cycles_paper_rtl"] for r in rows),
        "int_acc_tracks_float": acc["mvu_int_acc"] >= acc["float_acc"] - 0.05,
        "int_acc_above_0.95": acc["mvu_int_acc"] > 0.95,
    }
    if not all(c.values()):
        raise AssertionError(f"NID-MLP claims failed: {c}")
    return c


def run_quick(*, steps: int = 200, device="cuda") -> dict:
    """One record: Table 7 cycle parity and the QAT accuracy check; raises
    when a claim fails."""
    rows = layer_rows()
    acc = accuracy_check(steps=steps, device=device)
    c = check_claims(rows, acc)
    return {
        "name": "nid_mlp",
        "layers": rows,
        "accuracy": acc,
        "claims": c,
        "summary": f"cycles == paper; float={acc['float_acc']:.3f} "
                   f"int={acc['mvu_int_acc']:.3f}",
    }


# ------------------------------------------------------------ golden variants
def seeded_weights(seed: int = 0) -> list[np.ndarray]:
    """Float32 weights drawn with numpy: ``normal(0, 1, (N, K)) / sqrt(K)``
    per layer, in order, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 1, (n, k)) / np.sqrt(k)).astype(np.float32)
            for k, n in zip(DIMS[:-1], DIMS[1:])]


def seeded_bn(seed: int = 1) -> list[dict[str, np.ndarray]]:
    """Batchnorm constants for fc0-fc2 drawn with numpy: gammas of both
    signs (a negative gamma flips its row), shifted means and betas."""
    rng = np.random.default_rng(seed)
    out = []
    for n in DIMS[1:-1]:
        gamma = rng.uniform(0.5, 1.5, n) * rng.choice([-1.0, 1.0], n)
        out.append({k: v.astype(np.float32) for k, v in (
            ("gamma", gamma), ("beta", rng.uniform(-0.5, 0.5, n)),
            ("mean", rng.normal(0, 1, n)), ("var", rng.uniform(0.5, 2, n)))})
    return out


def variant_graph(variant: str) -> Graph:
    """The raw chain of one golden variant: :func:`seeded_weights` with the
    identity batchnorm (``identity_bn``) or :func:`seeded_bn`
    (``seeded_bn``)."""
    if variant not in GOLDEN_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; variants: {GOLDEN_VARIANTS}")
    return qat_graph(seeded_weights(0), seeded_bn(1) if variant == "seeded_bn" else None)


def load_golden() -> dict[str, dict]:
    """The golden digests, ``{variant: digest}``."""
    with open(GOLDEN) as f:
        return json.load(f)
