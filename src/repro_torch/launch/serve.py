"""Serving entry points; the port of the JAX package's ``repro/launch/serve.py``.

``serve_loop`` is the LM's host-scale batched serving loop (requests are
grouped, their prompts prefilled, and the group decoded in lockstep) over
a :class:`repro_torch.models.model.Model`.

``EngineServer`` is the dataflow graph's request-coalescing front end: a
shape-bucketed, manually flushed server over
:class:`repro_torch.core.engine.FusedEngine`, kept as a thin deprecated shim
over :mod:`repro_torch.serving` (bounded admission queue + continuous
batcher + replica pool).  New code should build through
``repro_torch.build.build(graph, target="serving")`` and use
``Accelerator.serve()`` / :class:`repro_torch.serving.ContinuousBatcher`.

``shard_serve_fns`` (the sharded prefill and decode) waits for ROADMAP
queue A item 7, step 5.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

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


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_done: float = 0.0


def prompt_batch(group: list[Request]) -> np.ndarray:
    """A group's prompts as one (len(group), S) int32 batch: left-aligned,
    zero-padded to the longest prompt."""
    toks = np.zeros((len(group), max(len(r.prompt) for r in group)), np.int32)
    for j, r in enumerate(group):
        toks[j, : len(r.prompt)] = r.prompt
    return toks


def serve_loop(model, params, requests: list[Request], *,
               batch: int = 4, max_len: int = 256):
    """Static-batched serving: groups requests into batches, prefills the
    (right-padded) prompts, then decodes all sequences in lockstep, greedily.

    The reference's loop, quirks kept: a short group is padded with
    copies of its first request (rid -1, dropped from the result); every
    row's first token comes from the logits at the longest prompt's last
    position, and decoding continues from there for every row; each group
    takes ``max(max_new)`` decode steps, the last one's tokens unused.  (The
    reference's ``greedy`` flag takes the argmax either way; the port has
    none.)
    """
    done: list[Request] = []
    for i in range(0, len(requests), batch):
        group = requests[i : i + batch]
        while len(group) < batch:
            group.append(Request(rid=-1, prompt=group[0].prompt, max_new=group[0].max_new))
        toks = prompt_batch(group)
        state = model.init_decode_state(batch, max_len)
        t0 = time.perf_counter()
        logits, state = model.prefill(params, {"tokens": torch.from_numpy(toks)}, state)
        nxt = torch.argmax(logits, -1)
        max_new = max(r.max_new for r in group)
        for _ in range(max_new):
            host = nxt.tolist()
            for j, r in enumerate(group):
                if r.rid >= 0 and len(r.out) < r.max_new:
                    r.out.append(host[j])
            logits, state = model.decode_step(params, state, nxt)
            nxt = torch.argmax(logits, -1)
        t1 = time.perf_counter()
        for r in group:
            if r.rid >= 0:
                r.t_done = t1 - t0
                done.append(r)
    return done
