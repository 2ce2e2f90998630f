"""Workload configurations shared by the port's build, tests and smoke run.

The FINN graphs (``nid_mlp``, ``cnv_bnn``, ``residual_mlp``, ``mvu_chain``,
``paper_sweeps``) sit beside the ten LM architectures of the JAX package's
``repro/configs``, each a data-only module with ``CONFIG`` and its
``REDUCED`` test size: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = [
    "yi-9b",
    "command-r-plus-104b",
    "nemotron-4-15b",
    "h2o-danube-1.8b",
    "qwen2-vl-7b",
    "granite-moe-3b-a800m",
    "qwen3-moe-235b-a22b",
    "mamba2-780m",
    "jamba-1.5-large-398b",
    "whisper-tiny",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_reduced(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[name]).REDUCED


__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "get_reduced"]
