"""Carry a graph across from a plain, framework-free description.

``graph_from_numpy(nodes, device)`` takes each node as a dict

    {"op": str, "name": str, "attrs": dict, "inputs": tuple | None,
     "params": {name: np.ndarray}}

and returns the port's :class:`~repro_torch.core.ir.Graph` with every array
as a tensor on ``device``: a raw ``conv`` node's (Kd, Kd, Cin, Cout) float
weights and its kernel/stride/pad, a ``maxpool``'s size, as they come.  For
a lowered node (``mvu``, ``conv_mvu``), ``params["mvu"]`` is a dict
of ``weights`` / ``thresholds`` / ``out_scale`` arrays (None where absent)
and ``attrs["config"]`` a dict of :class:`MVUConfig` fields, ``folding`` as
``{"pe", "simd"}`` and a tuned schedule (``blocks``) as a dict of
:class:`KernelBlocks` fields (``block_m`` the burst; ``block_n`` /
``block_k`` / ``block_kw`` / ``rows_per_tile`` pick the CUDA kernel's
compiled tile, rounded up onto its set, as they pick the Pallas blocks).  The JAX package's backend names map to the
port's: ``pallas`` -> ``cuda``, ``xla`` -> ``torch``.  Packed uint32 words
arrive as the port's int32 bit patterns (see :func:`_tensor`).  Whoever
holds the JAX graph makes the description (``np.asarray`` on each param);
the port never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.folding import Folding
from repro_torch.core.ir import Graph, Node
from repro_torch.core.mvu import KernelBlocks, MVUConfig, MVUParams
from repro_torch.kernels.ops import BACKEND_NAMES


def _tensor(a, device):
    """One array as a tensor on ``device``.  uint32 arrays (the JAX
    package's packed words) become the port's int32 bit patterns by a
    ``view`` -- the same 32 bits, not a value cast; uint8 lanes stay uint8."""
    if a is None:
        return None
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def _config(d: dict) -> MVUConfig:
    d = dict(d)
    if d.get("folding") is not None:
        d["folding"] = Folding(**d["folding"])
    if d.get("blocks") is not None:
        d["blocks"] = KernelBlocks(**d["blocks"])  # an unknown field raises
    d["backend"] = BACKEND_NAMES[d.get("backend", "cuda")]
    return MVUConfig(**d)


def graph_from_numpy(nodes, device="cpu") -> Graph:
    """The port's Graph for a list of plain node dicts (see module doc)."""
    g = Graph()
    for nd in nodes:
        attrs = dict(nd.get("attrs") or {})
        if "config" in attrs:
            attrs["config"] = _config(attrs["config"])
        params = {}
        for k, v in (nd.get("params") or {}).items():
            if k == "mvu":
                params[k] = MVUParams(**{f: _tensor(v.get(f), device)
                                         for f in ("weights", "thresholds", "out_scale")})
            else:
                params[k] = _tensor(v, device)
        inputs = nd.get("inputs")
        g.append(Node(nd["op"], nd["name"], attrs, params,
                      inputs=None if inputs is None else tuple(inputs)))
    return g
