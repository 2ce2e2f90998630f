"""Synthetic UNSW-NB15-like dataset for the paper's NID use case (Sec 6.5).

The real dataset (49 flow features, binary attack label) is not available
offline; we generate a statistically similar stand-in: class-conditional
mixtures over 49 base features, expanded and quantized to the 600-wide
2-bit input vector the paper's MLP consumes (Table 6: layer 0 has 600 IFM
channels at 2-bit precision).
"""

from __future__ import annotations

import numpy as np

N_RAW = 49
N_INPUT = 600
BITS = 2


def _expand(raw: np.ndarray, rng: np.random.Generator, proj: np.ndarray) -> np.ndarray:
    """49 raw features -> 600 quantized (2-bit) features via random projection."""
    x = raw @ proj  # (B, 600)
    x = (x - x.mean(0, keepdims=True)) / (x.std(0, keepdims=True) + 1e-6)
    q = np.clip(np.round((x + 2.0) / 4.0 * (2**BITS - 1)), 0, 2**BITS - 1)
    return q.astype(np.int32)


def make_dataset(n: int, *, seed: int = 0, structure_seed: int = 1234):
    """Returns (x (n, 600) int 2-bit, y (n,) {0,1}).

    ``structure_seed`` fixes the class centers and feature projection (the
    "true network distribution"); ``seed`` varies only the sampled flows,
    so train/test splits share one distribution.
    """
    srng = np.random.default_rng(structure_seed)
    proj = srng.normal(0, 1.0, (N_RAW, N_INPUT)) / np.sqrt(N_RAW)
    centers = srng.normal(0, 1.0, (2, N_RAW))
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    raw = centers[y] + rng.normal(0, 0.9, (n, N_RAW))
    # a few "protocol" features are strongly class-dependent (like UNSW's
    # service/state categoricals)
    raw[:, :6] += 2.5 * (2 * y[:, None] - 1)
    return _expand(raw, rng, proj), y.astype(np.int32)


def iterate(x, y, batch: int, *, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    while True:
        idx = rng.integers(0, n, batch)
        yield x[idx], y[idx]
