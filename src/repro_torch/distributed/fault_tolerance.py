"""Fault tolerance: restart manager and step watchdog; the port of the JAX
package's ``repro/distributed/fault_tolerance.py``.

Failure model: a card or host failure kills the whole job; recovery is
restart-from-checkpoint, so the time to recover is dominated by (a) the
checkpoint cadence and (b) the restore time.  Accordingly:

  * CheckpointManager -- cadence + retention + async save + resume-latest
    (``resume_latest(like, device)`` restores onto ``device``, by default
    onto each ``like`` leaf's device and a meta leaf onto the card).
  * StepWatchdog      -- straggler detection: flags steps exceeding a
    multiple of the trailing-median step time.  CUDA work is
    asynchronous, so a step it times must end in a host sync (the
    reference's loop reads ``float(metrics["loss"])`` inside it).

The reference's elastic rescale (restore onto another mesh) waits for the
mesh and sharding modules (ROADMAP queue A item 7, step 3c).
"""

from __future__ import annotations

import time

from repro_torch.checkpoint import ckpt
from repro_torch.distributed.stragglers import TrailingStats


class CheckpointManager:
    def __init__(self, directory: str, *, every: int = 100, keep: int = 3,
                 use_async: bool = True):
        self.dir = directory
        self.every = every
        self.keep = keep
        self.use_async = use_async
        self._pending = None

    def maybe_save(self, step: int, tree, *, extra: dict | None = None) -> bool:
        if step % self.every:
            return False
        self.wait()
        if self.use_async:
            # the in-flight save will be the keep-th checkpoint; prune the
            # completed ones to keep-1 BEFORE launching it, so a fast save
            # thread can't land in the prune's listing and evict its
            # predecessor (keep would drop to keep-1 on disk).
            ckpt.prune(self.dir, max(self.keep - 1, 1))
            self._pending = ckpt.save_async(self.dir, step, tree, extra=extra)
        else:
            ckpt.save(self.dir, step, tree, extra=extra)
            ckpt.prune(self.dir, self.keep)
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def resume_latest(self, like, device=None):
        """Returns (step, tree) from the newest valid checkpoint, or (0, None);
        ``device`` as :func:`ckpt.restore` takes it."""
        step = ckpt.latest_step(self.dir)
        if step is None:
            return 0, None
        return step, ckpt.restore(self.dir, step, like, device)


class StepWatchdog:
    """Context-manager timer over :class:`TrailingStats` -- the straggler
    test itself (trailing-median window, tested-before-appended, 8-sample
    warmup) is shared with the serving replica health machine."""

    def __init__(self, *, window: int = 32, straggler_factor: float = 3.0):
        self._stats = TrailingStats(window=window, factor=straggler_factor,
                                    min_samples=8)
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._stats.observe(time.perf_counter() - self._t0)
        return False

    @property
    def times(self):
        return self._stats.times

    @property
    def factor(self) -> float:
        return self._stats.factor

    @property
    def stragglers(self) -> int:
        return self._stats.stragglers

    @property
    def median(self) -> float:
        return self._stats.median
