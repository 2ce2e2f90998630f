"""The serving part of the JAX package's ``repro.core.autotune``: cache keys
and the persistent schedule cache.

What serving needs from the autotuner is a place to keep one measurement
-- the realized wall-clock seconds per schedule cycle, recorded by
``repro_torch.serving.batcher.calibrate_cycle_time`` under
:func:`cycle_time_key` and read back by ``dataflow.interval_seconds`` --
plus the seeded synthetic input the serving warm-up and canary use:

* :func:`device_kind`, :func:`cycle_time_key` -- the keys,
* :class:`ScheduleCache`, :func:`default_cache` -- the JSON store,
* :func:`synth_input` -- random integer activations for a graph's input.

The tuning search itself (``Candidate``, ``tune_node``, ``tune_graph``,
``tune_engine``, ``engine_key``, ``paired_times``) is ROADMAP queue A item
3 and is not here.  Nor are the JAX package's committed ``TUNED_SCHEDULES``:
they were measured on another device, so :func:`default_cache` merges only
the user's cache file, whose keys carry the device kind.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core.ir import Graph

CACHE_VERSION = 1
DEFAULT_CACHE_PATH = os.path.join("experiments", "autotune", "cache.json")
CACHE_PATH_ENV = "REPRO_AUTOTUNE_CACHE"


# --------------------------------------------------------------------- keys
def device_kind(device=None) -> str:
    """Stable cache device key of a torch device: ``cpu``, or the card's
    name normalised as the JAX package does (``NVIDIA H100 80GB HBM3`` ->
    ``nvidia-h100-80gb-hbm3``).  ``None`` means the CUDA device, and
    raises where CUDA is absent (pass ``torch.device("cpu")`` there)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available and no device was given: pass "
                "device=torch.device('cpu') to key the CPU")
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type == "cpu":
        kind = "cpu"
    elif device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
    else:
        raise ValueError(f"no device kind for a {device.type!r} device")
    return str(kind).strip().lower().replace(" ", "-")


def cycle_time_key(device=None) -> str:
    """Cache key for the measured wall-clock seconds per schedule cycle.

    ``device`` is a device kind string (used as it is, as in the JAX
    package), a torch device (keyed by its :func:`device_kind`), or None
    (the CUDA device).  Recorded by
    ``repro_torch.serving.batcher.calibrate_cycle_time``; consumed by
    ``dataflow.interval_seconds`` to turn the steady-state interval into
    the serving batcher's flush time budget.
    """
    if not isinstance(device, str):
        device = device_kind(device)
    return f"cycletime|{device}"


# -------------------------------------------------------------------- cache
class ScheduleCache:
    """Persistent key -> entry store (JSON on disk).

    Entries are plain dicts so the cache file diffs cleanly; ``merge``
    lets several caches coexist, later entries winning.
    """

    def __init__(self, entries: dict | None = None, path: str | None = None):
        self.entries: dict[str, dict] = {k: dict(v) for k, v in (entries or {}).items()}
        self.path = path

    def get(self, key: str) -> dict | None:
        return self.entries.get(key)

    def put(self, key: str, entry: dict) -> None:
        self.entries[key] = dict(entry)

    def merge(self, other: "ScheduleCache") -> "ScheduleCache":
        self.entries.update({k: dict(v) for k, v in other.entries.items()})
        return self

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    @classmethod
    def load(cls, path: str) -> "ScheduleCache":
        with open(path) as f:
            payload = json.load(f)
        if payload.get("version") != CACHE_VERSION:
            raise ValueError(
                f"autotune cache {path} has version {payload.get('version')!r}, "
                f"expected {CACHE_VERSION}")
        return cls(payload.get("entries", {}), path=path)

    def save(self, path: str | None = None) -> str:
        path = path or self.path
        if path is None:
            raise ValueError("no cache path to save to")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"version": CACHE_VERSION, "entries": self.entries},
                      f, indent=2, sort_keys=True)
            f.write("\n")
        self.path = path
        return path


def default_cache() -> ScheduleCache:
    """The user's persistent cache -- ``$REPRO_AUTOTUNE_CACHE`` or
    ``experiments/autotune/cache.json`` -- when the file exists, else an
    empty cache.  No committed schedules are merged (see the module doc)."""
    cache = ScheduleCache()
    path = os.environ.get(CACHE_PATH_ENV, DEFAULT_CACHE_PATH)
    if os.path.exists(path):
        cache.merge(ScheduleCache.load(path))
        cache.path = path
    return cache


# ------------------------------------------------------------ engine level
def synth_input(graph: Graph, batch: int, seed: int = 0, *,
                device=None) -> torch.Tensor:
    """Random integer activations matching the graph's input node: the JAX
    package's numpy draws (same seed, same integers), as an int32 tensor on
    ``device`` (default the CPU)."""
    heads = [n for n in graph if n.op == "input"]
    if len(heads) != 1:
        raise ValueError(
            f"graph must have exactly one input node, found {len(heads)}")
    head = heads[0]
    shape = tuple(head.attrs["shape"])
    bits = head.attrs.get("bits", 1)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.integers(0, 2**bits, (batch, *shape)), dtype=torch.int32)
    return x if device is None else x.to(device)
