"""Golden digests: one run of a built design, as a few hashes and numbers.

A digest records the sha256 of a float32 output's bytes, its first 8
values and, per MVU or conv layer, the sha256 of its weight storage (int8
rows, 32-bit words or uint8 lanes: the bytes are the same in both
packages) and, where it has them, its thresholds and out_scale.  The
scripts ``scripts/nid_golden.py`` and ``scripts/cnv_golden.py`` make them
with the JAX package; the tests and ``chip_smoke.py`` recompute them with
the port (``configs/nid_mlp.py``, ``configs/cnv_bnn.py``).
"""

from __future__ import annotations

import hashlib

import numpy as np


def _sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def golden_digest(output: np.ndarray, layers: dict[str, dict[str, np.ndarray]],
                  **meta) -> dict:
    """The digest of one run: the float32 ``output`` and the ``layers``'
    arrays (None entries skipped); ``meta`` (seed, batch, build kwargs) is
    recorded as given."""
    out = np.asarray(output)
    if out.dtype != np.float32:
        raise ValueError(f"a golden output must be float32, got {out.dtype}")
    digest = {**meta, "output_shape": list(out.shape),
              "output_sha256": _sha256(out),
              "first8": [float(v) for v in out.reshape(-1)[:8]],
              "layers": {}}
    for name, arrays in layers.items():
        digest["layers"][name] = {
            f"{k}_sha256": _sha256(np.asarray(v)) for k, v in arrays.items()
            if v is not None}
    return digest


# the keys of a digest that say how it was made (besides the output)
META = ("seed", "data_seed", "batch", "build")


def graph_layers(graph) -> dict[str, dict[str, np.ndarray | None]]:
    """Per MVU or conv node of a built port graph, its integer weights,
    thresholds and out_scale as numpy arrays (None where absent):
    ``golden_digest``'s ``layers``."""
    def host(t):
        return None if t is None else t.cpu().numpy()

    return {n.name: {"weights": host(n.params["mvu"].weights),
                     "thresholds": host(n.params["mvu"].thresholds),
                     "out_scale": host(n.params["mvu"].out_scale)}
            for n in graph if n.op in ("mvu", "conv_mvu")}


def digest_like(golden: dict, output: np.ndarray, graph) -> dict:
    """The digest of a port run (``output`` and the built ``graph``'s
    layers) made with the meta of the golden digest ``golden``, so the two
    compare with ``==``."""
    return golden_digest(output, graph_layers(graph), **{k: golden[k] for k in META})
