"""Skip-connection variant of the NID MLP: the DAG-IR proof workload.

The Table 6 use case re-shaped as a residual network: the trunk embeds
the 600-feature input to 64 channels, a branch stacks a second quantized
64x64 layer, and an elementwise ``add`` joins the branch back onto the
trunk activation (FINN's streaming elementwise-binary node) before the
1-output head.  Topology::

    in -> fc0/bn0/act0 --+--> fc1/bn1/act1 --+
                         |                   +--> res(add) -> fc2
                         +-------------------+

The graph cannot be expressed as a chain: ``act0`` fans out to both the
branch and the join, and ``res`` has two input streams.  Everything else
(2-bit weights/activations, folding per Table 6) matches ``nid_mlp``.

``build_graph`` draws the same numpy values in the same order as the JAX
package's ``configs/residual_mlp.py``, so both packages start from
identical float weights.  ``GOLDEN`` names the file of the JAX package's
output digest for one fixed input (``scripts/residual_golden.py`` makes
it), which the tests and ``chip_smoke.py`` hold the port to.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core.folding import Folding
from repro_torch.core.ir import Graph, Node

# (in_features K, out_features N, PE, SIMD) per linear layer
LAYERS = [
    (600, 64, 64, 50),   # fc0: trunk embedding
    (64, 64, 16, 32),    # fc1: the residual branch
    (64, 1, 1, 8),       # fc2: head after the join
]
WEIGHT_BITS = 2
INPUT_BITS = 2

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "residual_mlp_golden.json")


def foldings() -> list[Folding]:
    return [Folding(pe, simd) for (_, _, pe, simd) in LAYERS]


def build_graph(seed: int = 0) -> Graph:
    """The residual MLP as a RAW IR DAG (linear + bn + quant_act with
    random trained-like weights as float32 CPU tensors, explicit
    ``inputs`` edges) -- ``repro_torch.build.build`` does the lowering."""
    rng = np.random.default_rng(seed)

    def linear(name: str, k: int, n: int, src: str) -> Node:
        w = (rng.normal(0, 1, (n, k)) / np.sqrt(k)).astype(np.float32)
        return Node("linear", name, {}, {"w": torch.from_numpy(w)}, inputs=(src,))

    def bn(name: str, n: int, src: str) -> Node:
        return Node("batchnorm", name, {}, {
            "gamma": torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)),
            "beta": torch.from_numpy(rng.uniform(-0.5, 0.5, n).astype(np.float32)),
            "mean": torch.from_numpy(rng.normal(0, 1, n).astype(np.float32)),
            "var": torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32)),
        }, inputs=(src,))

    def qact(name: str, src: str) -> Node:
        return Node("quant_act", name, {"bits": INPUT_BITS, "act_scale": 1.0},
                    inputs=(src,))

    (k0, n0, _, _), (k1, n1, _, _), (k2, n2, _, _) = LAYERS
    return Graph([
        Node("input", "in", {"shape": (k0,), "bits": INPUT_BITS}),
        # trunk: embed to 64 channels, quantize
        linear("fc0", k0, n0, "in"), bn("bn0", n0, "fc0"), qact("act0", "bn0"),
        # branch off act0: one more quantized 64x64 layer
        linear("fc1", k1, n1, "act0"), bn("bn1", n1, "fc1"), qact("act1", "bn1"),
        # fan-in: act1 + act0 (streaming elementwise add, equal shapes)
        Node("add", "res", {"scales": (1, 1)}, inputs=("act1", "act0")),
        # head consumes the joined stream
        linear("fc2", k2, n2, "res"),
    ])


def load_golden() -> dict:
    """The golden digest of the JAX package's engine build; its ``build``
    holds the build kwargs (mode, bits)."""
    with open(GOLDEN) as f:
        return json.load(f)
