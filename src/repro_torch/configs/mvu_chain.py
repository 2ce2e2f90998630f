"""A homogeneous MVU chain: the workload the GPipe pipeline stacks.

``FusedEngine.as_pipeline`` stacks the stages of a chain whose MVUs all
share one (N, K), mode and epilogue.  Here every layer maps d -> d and is
followed by a batchnorm and a quantizer, so after ``fuse_epilogues``
every stage carries thresholds.  Two sizes:

* ``FULL``: eight of the NID-MLP's hidden layers (Table 6: 64 -> 64,
  PE 16 x SIMD 32, 2-bit activations; ``nid_mlp.LAYERS[1]``), streamed
  as the NID's burst: 4,096 flows in 32 microbatches of 128.
* ``SMALL``: the JAX package's pipeline test chain (d = 32, four layers,
  2 bits, eight microbatches of four; ``tests/test_engine.py``).

:func:`build_graph` draws its values from the caller's numpy generator
in the JAX test's order (each layer's weights, then its batchnorm), so a
graph of the JAX package built from the same draws holds the same floats
and the caller draws its input after it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import nid_mlp
from repro_torch.core.folding import Folding
from repro_torch.core.ir import Graph, Node

_K, _N, _PE, _SIMD = nid_mlp.LAYERS[1]
FULL = {"d": _K, "layers": 8, "bits": nid_mlp.INPUT_BITS, "pe": _PE, "simd": _SIMD,
        "batch": 4096, "microbatch": 128}
SMALL = {"d": 32, "layers": 4, "bits": 2, "n_micro": 8, "microbatch": 4}


def layer_arrays(rng: np.random.Generator, d: int, layers: int) -> list[dict]:
    """Each layer's float32 weights and batchnorm, drawn from ``rng``."""
    out = []
    for _ in range(layers):
        out.append({
            "w": rng.normal(0, 0.5, (d, d)).astype(np.float32),
            "gamma": rng.uniform(0.5, 1.5, d).astype(np.float32),
            "beta": rng.uniform(-0.5, 0.5, d).astype(np.float32),
            "mean": rng.normal(0, 1, d).astype(np.float32),
            "var": rng.uniform(0.5, 2, d).astype(np.float32),
        })
    return out


def build_graph(rng: np.random.Generator, d: int, layers: int, bits: int) -> Graph:
    """The chain as a RAW IR graph (linear + bn + quant_act a layer, float32
    CPU tensors); ``repro_torch.build.build`` does the lowering."""
    g = Graph([Node("input", "in", {"shape": (d,), "bits": bits})])
    for i, arr in enumerate(layer_arrays(rng, d, layers)):
        g.append(Node("linear", f"fc{i}", {}, {"w": torch.from_numpy(arr["w"])}))
        g.append(Node("batchnorm", f"bn{i}", {},
                      {k: torch.from_numpy(arr[k]) for k in ("gamma", "beta", "mean", "var")}))
        g.append(Node("quant_act", f"act{i}", {"bits": bits, "act_scale": 1.0}))
    return g


def foldings(cfg: dict = FULL) -> list[Folding]:
    """One Table 6 hidden-layer folding a layer."""
    return [Folding(cfg["pe"], cfg["simd"])] * cfg["layers"]
