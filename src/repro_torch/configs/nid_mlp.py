"""The paper's real-world use case (Table 6): 4-layer MLP for network
intrusion detection on UNSW-NB15, 2-bit weights and activations.

Layers (IFMch -> OFMch, PE, SIMD): 600->64 (64,50), 64->64 (16,32),
64->64 (16,32), 64->1 (1,8).

``build_graph`` draws the same numpy values in the same order as the JAX
package's ``configs/nid_mlp.py``, so both packages start from identical
float weights.  ``GOLDEN`` names the file of the JAX package's output
digests for one fixed input (``configs/golden.py`` computes one), a digest per
build variant -- the paper's 2-bit standard datapath and the Fig. 4
binarized and packed ones -- each beside its build kwargs.  The tests and
``chip_smoke.py`` read the variants from there and hold the port to them.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core.folding import Folding
from repro_torch.core.ir import Graph, Node

# (in_features K, out_features N, PE, SIMD) per layer, from Table 6
LAYERS = [
    (600, 64, 64, 50),
    (64, 64, 16, 32),
    (64, 64, 16, 32),
    (64, 1, 1, 8),
]
WEIGHT_BITS = 2
INPUT_BITS = 2

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "nid_mlp_golden.json")


def foldings() -> list[Folding]:
    return [Folding(pe, simd) for (_, _, pe, simd) in LAYERS]


def build_graph(seed: int = 0) -> Graph:
    """Table 6 MLP as a RAW IR chain (linear + bn + quant_act with random
    trained-like weights, float32 CPU tensors) -- ``repro_torch.build.build``
    does the lowering."""
    rng = np.random.default_rng(seed)
    dims = [k for (k, _, _, _) in LAYERS] + [LAYERS[-1][1]]
    g = Graph([Node("input", "in", {"shape": (dims[0],), "bits": INPUT_BITS})])
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        w = (rng.normal(0, 1, (n, k)) / np.sqrt(k)).astype(np.float32)
        g.append(Node("linear", f"fc{i}", {}, {"w": torch.from_numpy(w)}))
        if i < len(dims) - 2:
            g.append(Node("batchnorm", f"bn{i}", {}, {
                "gamma": torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)),
                "beta": torch.from_numpy(rng.uniform(-0.5, 0.5, n).astype(np.float32)),
                "mean": torch.from_numpy(rng.normal(0, 1, n).astype(np.float32)),
                "var": torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32)),
            }))
            g.append(Node("quant_act", f"act{i}",
                          {"bits": INPUT_BITS, "act_scale": 1.0}))
    return g


def load_golden() -> dict[str, dict]:
    """The golden digests, ``{variant: digest}``; each digest's ``build``
    holds the variant's build kwargs (mode, bits, pack)."""
    with open(GOLDEN) as f:
        return json.load(f)
