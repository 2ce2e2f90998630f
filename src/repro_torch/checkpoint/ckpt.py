"""Checkpointing: atomic, async, restore onto a device; the port of the
JAX package's ``repro/checkpoint/ckpt.py``, in its file layout.

Layout:  <dir>/step_<N:08d>/arrays.npz + manifest.json ; a checkpoint is
only visible once its final rename lands (write to ``.tmp`` then
``os.replace``), so a crash mid-save never corrupts the latest
checkpoint.  A tree is the port's nested dict of tensors; its keys in the
file are the leaves' paths joined by "/" (``opt/mu/layers/attn/wq/w``), as
the reference's ``tree_flatten_with_path`` joins them.

bfloat16: the reference's ``np.savez`` stores a bfloat16 leaf as its raw
2-byte pattern, which numpy reads back as a 2-byte void (``V2``), and its
``restore`` then fails to cast it.  The port writes a bfloat16 leaf the
same way and restores a ``V2`` leaf by viewing its bits as bfloat16, so
it reads the reference's checkpoints, bfloat16 included, bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.tree import flat_leaves, unflatten

_BF16_FILE_DTYPE = np.dtype("V2")  # how np.savez stores a bfloat16 leaf


def _host(leaf) -> np.ndarray:
    """One leaf as a host numpy array of its own: a tensor is copied (also
    on the CPU, so the caller may go on writing into it), a bfloat16
    tensor becomes its bit pattern as ``V2``."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_FILE_DTYPE)
    return t.numpy()


def _flatten(tree: dict) -> dict[str, np.ndarray]:
    """{path: host array} of a nested dict."""
    return {path: _host(leaf) for path, leaf in flat_leaves(tree).items()}


def _write(ckpt_dir: str, step: int, flat: dict, extra: dict | None) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(flat.keys()),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save(ckpt_dir: str, step: int, tree, *, extra: dict | None = None) -> str:
    """Atomic synchronous save; returns the checkpoint path."""
    return _write(ckpt_dir, step, _flatten(tree), extra)


def save_async(ckpt_dir: str, step: int, tree, *, extra: dict | None = None) -> threading.Thread:
    """Snapshot to host memory now, write in a background thread."""
    flat = _flatten(tree)  # device->host copy happens here, synchronously
    t = threading.Thread(target=_write, args=(ckpt_dir, step, flat, extra), daemon=True)
    t.start()
    return t


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def _tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host array as a CPU tensor of ``dtype``: a ``V2`` leaf is bfloat16
    bits (viewed, then cast if ``dtype`` is another type)."""
    if arr.dtype == _BF16_FILE_DTYPE:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16).to(dtype)
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.asarray(arr, np.float32)).to(dtype)
    return torch.from_numpy(np.asarray(arr)).to(dtype)


def _device(leaf, device):
    """Where a restored leaf goes: ``device``, else its ``like`` leaf's
    device, else (a meta leaf, which holds no data) the card."""
    if device is not None:
        return device
    own = getattr(leaf, "device", None)
    return "cuda" if own is None or own.type == "meta" else own


def restore(ckpt_dir: str, step: int, like, device=None):
    """Restore into the structure of ``like`` (a nested dict whose leaves
    give a ``shape`` and a torch ``dtype``: tensors, meta tensors included).

    Each leaf is read from the file in turn, in the reference's order
    (sorted paths), and moved to ``device``; None puts each leaf on its
    ``like`` leaf's device, and a meta leaf on the card, as every entry
    point of the port defaults to it.  A missing key raises ``KeyError``,
    a shape mismatch ``ValueError``, with the reference's messages."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        keys = set(z.files)
        for key, leaf in sorted(flat_leaves(like).items()):
            if key not in keys:
                raise KeyError(f"checkpoint missing {key!r}")
            arr = z[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(leaf.shape)}")
            t = _tensor(arr, leaf.dtype)
            out[key] = t.to(_device(leaf, device))
    return unflatten(like, out)


def prune(ckpt_dir: str, keep: int) -> None:
    steps = available_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
