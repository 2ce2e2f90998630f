"""CNV: the FINN BNN convnet topology (BNN-PYNQ's CIFAR-10 network).

The paper's MVU always sits behind the SWU for conv layers (Fig. 1); CNV is
the canonical FINN workload exercising that pairing: six 3x3 conv layers
(64, 64, 128, 128, 256, 256 channels, no padding) with 2x2 max-pools after
conv pairs, then three dense layers (512, 512, 10) -- all with fused
BN + quantized activations between compute layers.

``build_graph`` draws the same numpy values in the same order as the JAX
package's ``configs/cnv_bnn.py``, so both packages start from identical
float weights.  ``QUICK`` is a channel/image-scaled variant for tests.
The JAX package's ``cpu|...`` tuned schedules are not carried over: the
port's come from its autotuner on the card (``core/autotune.py``), and
none is committed before the first benchmark measures them (ROADMAP queue
A item 3, step 1).

``GOLDEN`` names the file of the JAX package's ``FULL`` outputs on one
fixed batch of numpy-seeded images, a digest per build variant (made by
``scripts/cnv_golden.py``); the tests and ``chip_smoke.py`` hold the port
to it.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.core.ir import Graph, Node


@dataclasses.dataclass(frozen=True)
class CNVSpec:
    image: int  # input is (image, image, 3)
    channels: tuple[int, ...]  # conv channels, 3x3 / stride 1 / pad 0 each
    pool_after: tuple[int, ...]  # conv indices followed by a 2x2 max-pool
    fc: tuple[int, ...]  # dense widths; the last one is the classifier head
    weight_bits: int = 1
    act_bits: int = 1


# The full FINN CNV: 32x32x3 -> 1x1x256 through the conv stack, then the
# 512-512-10 classifier.
FULL = CNVSpec(
    image=32,
    channels=(64, 64, 128, 128, 256, 256),
    pool_after=(1, 3),
    fc=(512, 512, 10),
)

# CI-sized CNV: same topology shape at 1/8 the channels on 16x16 inputs.
QUICK = CNVSpec(
    image=16,
    channels=(8, 8, 16, 16),
    pool_after=(1,),
    fc=(64, 10),
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cnv_bnn_golden.json")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a)


def _bn(rng, name: str, n: int) -> Node:
    return Node("batchnorm", name, {}, {
        "gamma": _t(rng.uniform(-1.5, 1.5, n).astype(np.float32)),
        "beta": _t(rng.uniform(-0.5, 0.5, n).astype(np.float32)),
        "mean": _t(rng.normal(0, 1, n).astype(np.float32)),
        "var": _t(rng.uniform(0.5, 2, n).astype(np.float32)),
    })


def build_graph(spec: CNVSpec = QUICK, *, seed: int = 0) -> Graph:
    """CNV as a RAW IR chain with trained-like random weights (float32 CPU
    tensors).  Every conv/dense layer except the classifier head is
    followed by batchnorm + quant_act, the pattern ``lowering.streamline``
    / ``lowering.fuse_epilogues`` folds into MVU threshold epilogues."""
    rng = np.random.default_rng(seed)
    bits = spec.act_bits
    g = Graph([Node("input", "in", {"shape": (spec.image, spec.image, 3), "bits": bits})])
    size, cin = spec.image, 3
    for i, cout in enumerate(spec.channels):
        w = rng.normal(0, 0.5, (3, 3, cin, cout)).astype(np.float32)
        g.append(Node("conv", f"conv{i}", {"kernel": 3, "stride": 1, "pad": 0},
                      {"w": _t(w)}))
        g.append(_bn(rng, f"bn_c{i}", cout))
        g.append(Node("quant_act", f"act_c{i}", {"bits": bits, "act_scale": 1.0}))
        size, cin = size - 2, cout
        if i in spec.pool_after:
            g.append(Node("maxpool", f"pool{i}", {"size": 2}))
            size //= 2
    g.append(Node("flatten", "flatten", {}))
    k = size * size * cin
    for i, n in enumerate(spec.fc):
        w = (rng.normal(0, 1, (n, k)) / np.sqrt(k)).astype(np.float32)
        g.append(Node("linear", f"fc{i}", {}, {"w": _t(w)}))
        if i < len(spec.fc) - 1:
            g.append(_bn(rng, f"bn_f{i}", n))
            g.append(Node("quant_act", f"act_f{i}", {"bits": bits, "act_scale": 1.0}))
        k = n
    return g


def spec_for(build_kwargs: dict, spec: CNVSpec = FULL) -> CNVSpec:
    """The spec one golden variant builds: its bit widths on ``spec``'s
    shape (the graph's input and quant_act bits are the act_bits)."""
    return dataclasses.replace(spec, act_bits=build_kwargs["act_bits"],
                               weight_bits=build_kwargs.get("weight_bits", 1))


def images(batch: int, act_bits: int, seed: int, image: int = 32) -> np.ndarray:
    """Numpy-seeded (batch, image, image, 3) int32 levels in [0, 2^act_bits):
    the golden batch (CIFAR-10 is not in the repository)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**act_bits, (batch, image, image, 3)).astype(np.int32)


def load_golden() -> dict[str, dict]:
    """The golden digests, ``{variant: digest}``; each digest's ``build``
    holds the variant's build kwargs (mode, bits)."""
    with open(GOLDEN) as f:
        return json.load(f)
