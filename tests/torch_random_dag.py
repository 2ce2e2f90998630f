"""Random legal DAGs for the port: the generator of ``tests/test_dag_build.py``
with the same numpy draws in the same order, as port graphs.

``tests/test_torch_dag.py`` holds these graphs against the JAX package's,
and ``chip_smoke.py`` runs the deterministic sweep on the card, so this
module imports torch and ``repro_torch`` only (the card's machine has no
JAX).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ir, lowering
from repro_torch.core.ir import Graph, Node

# (seed, depth) of the deterministic sweep, and its (mode, bits) datapaths
SWEEP = [(0, 3), (1, 4), (2, 6)]
MODES = [("standard", 2), ("binary", 2), ("xnor", 1)]
WIDTH = 12
BATCH = 8


def random_dag(seed: int, depth: int, *, width: int = WIDTH, bits: int = 2) -> Graph:
    """A random legal DAG: a quantized MLP trunk with random skip joins
    (fan-out <= 3, elementwise add/sub/mul re-quantized after each join)."""
    rng = np.random.default_rng(seed)

    def lin(name, n, k, src):
        w = (rng.normal(0, 1, (n, k)) / np.sqrt(k)).astype(np.float32)
        return Node("linear", name, {}, {"w": torch.from_numpy(w)}, inputs=(src,))

    def bnorm(name, n, src):
        return Node("batchnorm", name, {}, {
            "gamma": torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)),
            "beta": torch.from_numpy(rng.uniform(-0.5, 0.5, n).astype(np.float32)),
            "mean": torch.from_numpy(rng.normal(0, 1, n).astype(np.float32)),
            "var": torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32)),
        }, inputs=(src,))

    def qact(name, src):
        return Node("quant_act", name, {"bits": bits, "act_scale": 1.0},
                    inputs=(src,))

    g = [Node("input", "in", {"shape": (width,), "bits": bits})]
    fanout = {"in": 0}
    streams = ["in"]
    prev = "in"
    for i in range(depth):
        g += [lin(f"fc{i}", width, width, prev),
              bnorm(f"bn{i}", width, f"fc{i}"), qact(f"act{i}", f"bn{i}")]
        fanout[prev] += 1
        cur = f"act{i}"
        fanout[cur] = 0
        joinable = [s for s in streams if fanout[s] < 3 and s != cur]
        if joinable and rng.random() < 0.6:
            src = joinable[int(rng.integers(len(joinable)))]
            op = ("add", "sub", "mul")[int(rng.integers(3))]
            g.append(Node(op, f"join{i}", {"scales": (1, 1)},
                          inputs=(cur, src)))
            # re-quantize the joined stream so every MVU still consumes a
            # bits-wide activation (xnor packs 1-bit inputs)
            g.append(qact(f"jq{i}", f"join{i}"))
            fanout[cur] += 1
            fanout[src] += 1
            cur = f"jq{i}"
            fanout[cur] = 0
        streams.append(cur)
        prev = cur
    g.append(lin("head", 2, width, prev))
    fanout[prev] += 1
    return Graph(g)


def dag_case(seed: int, depth: int, mode: str, bits: int) -> tuple[Graph, np.ndarray]:
    """The lowered, finalized random DAG (CPU tensors) and its input batch,
    as ``tests/test_dag_build.py`` makes them."""
    g = random_dag(seed, depth, bits=bits)
    ir.validate_graph(g)
    low = lowering.finalize(lowering.streamline(lowering.lower_to_mvu(
        g, mode=mode, weight_bits=bits, act_bits=bits)))
    x = np.random.default_rng(seed + 99).integers(
        0, 2**bits, (BATCH, WIDTH)).astype(np.int32)
    return low, x
