"""``EngineServer``: the dataflow graph's request-coalescing front end.

The port of ``EngineServer`` from the JAX package's ``repro/launch/serve.py``:
a shape-bucketed, manually flushed server over
:class:`repro_torch.core.engine.FusedEngine`, kept as a thin deprecated shim
over :mod:`repro_torch.serving` (bounded admission queue + continuous
batcher + replica pool).  New code should build through
``repro_torch.build.build(graph, target="serving")`` and use
``Accelerator.serve()`` / :class:`repro_torch.serving.ContinuousBatcher`.

``shard_serve_fns`` and ``serve_loop`` of the same module belong to the
multi-device and LM slices (ROADMAP queue A items 6 and 7, step 3).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

# the shim warns once per process, not once per construction: a serving
# loop that builds servers in a loop should not flood the log
_ENGINE_SERVER_WARNED = False


def _warn_engine_server_deprecated() -> None:
    global _ENGINE_SERVER_WARNED
    if _ENGINE_SERVER_WARNED:
        return
    _ENGINE_SERVER_WARNED = True
    warnings.warn(
        "EngineServer is deprecated; build an Accelerator with "
        "repro_torch.build.build(graph, target='serving') and use "
        "Accelerator.serve() / repro_torch.serving.ContinuousBatcher",
        DeprecationWarning, stacklevel=3)


@dataclasses.dataclass
class EngineRequest:
    rid: int
    x: np.ndarray | None  # legacy field; the shim no longer retains inputs
    t_submit: float = 0.0
    t_done: float = 0.0
    out: np.ndarray | None = None


class EngineServer:
    """DEPRECATED: thin shim over :mod:`repro_torch.serving`.

    The synchronous, manually flushed server delegates to the
    continuous-batching subsystem (bounded admission queue + batcher +
    replica pool) while keeping its submit/flush API and bucket semantics:
    a flush pads each pending group up to the smallest bucket batch that
    holds it, oversize backlogs split into max-bucket chunks, and samples
    are validated against the engine graph's input spec at ``submit`` (a
    malformed request fails there with a clear error, not inside the
    flush).
    """

    def __init__(self, engine, *, batch_buckets: tuple[int, ...] = (1, 8, 32, 128)):
        if not batch_buckets or any(b <= 0 for b in batch_buckets):
            raise ValueError(f"need positive bucket sizes, got {batch_buckets}")
        _warn_engine_server_deprecated()
        from repro_torch.serving import ContinuousBatcher

        self.engine = engine
        self.buckets = tuple(sorted(set(batch_buckets)))
        # manual-flush compatibility: no idle-greedy or deadline-triggered
        # launches, an effectively unbounded queue, flush() drives everything
        self._batcher = ContinuousBatcher(
            engine, batch_buckets=self.buckets, greedy_when_idle=False,
            queue_capacity=1 << 30)

    @property
    def stats(self) -> dict:
        c = self._batcher.metrics.counters
        return {"requests": c["requests"], "flushes": c["flushes"],
                "padded_samples": c["padded_samples"]}

    @property
    def _pending(self) -> list[int]:
        """Rids awaiting a flush (legacy probe; lives in the batcher queue)."""
        return self._batcher.queue.pending_rids()

    def submit(self, x: np.ndarray) -> int:
        """Queue one sample; returns its request id (resolved by flush)."""
        return self._batcher.submit(x)

    def submit_batch(self, xs: np.ndarray) -> list[int]:
        """Queue a multi-sample request (leading batch dim) as ONE block --
        no per-sample array copies -- returning one rid per sample.
        Requests larger than the biggest bucket are legal: flush splits the
        backlog across max-size bucket launches."""
        return self._batcher.submit_batch(xs)

    def _bucket_for(self, n: int) -> int:
        # No bucket holds an oversize n: returning the max bucket would
        # silently launch an unbucketed (n-sized) shape, so this raises and
        # flush() splits oversize backlogs across max-size buckets.
        return self._batcher.bucket_for(n)

    def flush(self) -> list[EngineRequest]:
        """Coalesce pending requests, run the engine, scatter the results.

        Backlogs larger than the biggest bucket split into max-bucket chunks,
        so the engine only ever sees bucket-sized batches.  Each launch is
        resolved and popped before the next starts (the legacy synchronous
        per-group execution), so the batcher's bounded result store never
        has to hold more than one bucket of a giant backlog."""
        b = self._batcher
        done: list[EngineRequest] = []
        while b.queue.depth:
            b._launch(min(b.queue.depth, b.buckets[-1]))
            for rid in sorted(b.harvest(block=True)):
                r = b.pop_result(rid)
                done.append(EngineRequest(rid, None, r.t_submit, r.t_done, r.out))
        done.sort(key=lambda r: r.rid)
        return done
