"""Bounded admission queue with backpressure (the serving FIFO).

The paper's dataflow contract (section 5.3.2) is that a small FIFO absorbs
producer bursts while the consumer drains at the steady-state interval --
and that the FIFO must be *bounded*: a queue that can grow without limit
just moves the stall somewhere invisible.  ``AdmissionQueue`` is that FIFO
at the serving front door:

* **bounded** -- ``capacity`` samples; overflow either rejects the new
  arrival (``policy="reject"``, backpressure to the client) or sheds the
  oldest queued samples (``policy="shed"``, bounded staleness),
* **typed** -- every sample is validated against the engine graph's input
  spec at admission, so a malformed request fails with a clear error at
  ``submit`` time instead of a cryptic ``np.stack`` shape error mid-flush,
* **block-structured** -- a multi-sample submission is stored as ONE block
  (no per-sample array copies); request ids stay per-sample and blocks are
  sliced lazily when the batcher pops work.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time

import numpy as np

from repro_torch.core.ir import Graph


class QueueFull(RuntimeError):
    """Raised by ``policy="reject"`` when admission would exceed capacity."""


# SLO tiers (mirrored from repro_torch.serving.health to avoid a circular import)
TIERS = ("gold", "best_effort")


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Per-sample input contract of an engine graph (shape minus batch dim).

    ``DTYPE`` is the one canonical activation dtype (the graph-input
    convention everywhere else in the repo): admitting a single dtype keeps
    every launch at the operand dtype the kernels and ``warmup`` were run
    with -- mixed integer dtypes would each need their own conversion.
    """

    shape: tuple[int, ...]
    bits: int

    DTYPE = np.int32

    @classmethod
    def from_graph(cls, graph: Graph) -> "InputSpec":
        heads = [n for n in graph if n.op == "input"]
        if len(heads) != 1:
            raise ValueError(
                f"graph must have exactly one input node, found {len(heads)}")
        head = heads[0]
        return cls(tuple(head.attrs["shape"]), int(head.attrs.get("bits", 1)))

    def validate_batch(self, xs) -> np.ndarray:
        """Check a (B, *shape) integer batch.

        Returned as-is (no copy) when already canonical ``DTYPE``; other
        integer dtypes are converted (one copy) so every admitted block
        shares the single canonical dtype.  Non-integer dtypes are errors.
        """
        xs = np.asarray(xs)
        if xs.ndim != len(self.shape) + 1 or xs.shape[1:] != self.shape:
            raise ValueError(
                f"request shape {xs.shape[1:]} does not match the engine "
                f"input spec {self.shape} (batch of {xs.shape[0] if xs.ndim else '?'})"
            )
        if not np.issubdtype(xs.dtype, np.integer):
            raise ValueError(
                f"request dtype {xs.dtype} is not an integer type; the "
                f"engine consumes {self.bits}-bit integer activations"
            )
        if xs.dtype != self.DTYPE:
            xs = xs.astype(self.DTYPE)
        return xs

    def validate_sample(self, x) -> np.ndarray:
        x = np.asarray(x)
        if x.shape != self.shape:
            raise ValueError(
                f"request shape {x.shape} does not match the engine input "
                f"spec {self.shape}"
            )
        return self.validate_batch(x[None])


@dataclasses.dataclass
class Block:
    """One admitted submission: contiguous rids over a shared sample array."""

    rids: range
    xs: np.ndarray  # (len(rids), *spec.shape) -- a view of the caller's batch
    t_submit: float
    deadline: float
    tier: str = "gold"  # SLO tier: "gold" | "best_effort" (brownout sheds the latter first)

    def __len__(self) -> int:
        return len(self.rids)

    def split(self, n: int) -> tuple["Block", "Block"]:
        """Head block of ``n`` samples + the remainder (views, no copies)."""
        head = Block(self.rids[:n], self.xs[:n], self.t_submit, self.deadline,
                     self.tier)
        tail = Block(self.rids[n:], self.xs[n:], self.t_submit, self.deadline,
                     self.tier)
        return head, tail

    def entries(self) -> list["Entry"]:
        return [Entry(r, self.t_submit, self.deadline, self.tier)
                for r in self.rids]


@dataclasses.dataclass(frozen=True)
class Entry:
    """One popped request: what the batcher needs to track a sample.

    ``attempts`` counts completed dispatch attempts (the retry machinery
    bumps it via ``dataclasses.replace`` on every re-dispatch)."""

    rid: int
    t_submit: float
    deadline: float
    tier: str = "gold"
    attempts: int = 0


class AdmissionQueue:
    """Bounded FIFO of request blocks with per-request deadlines.

    ``admit``/``admit_batch`` validate against ``spec`` and apply the
    overflow policy; ``pop`` hands the batcher up to ``n`` samples as
    ``(entries, xs)`` with ``xs`` concatenated once (the only copy on the
    admission path, and one the padded bucket launch needs anyway).
    """

    POLICIES = ("reject", "shed")

    def __init__(self, spec: InputSpec, *, capacity: int = 1024,
                 policy: str = "reject", default_slo_s: float | None = None,
                 clock=time.perf_counter, tracer=None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if policy not in self.POLICIES:
            raise ValueError(f"policy must be one of {self.POLICIES}, got {policy!r}")
        self.spec = spec
        self.capacity = capacity
        self.policy = policy
        self.default_slo_s = default_slo_s
        self._clock = clock
        # repro_torch.telemetry.Tracer or None (zero overhead when None): the
        # queue annotates the timeline where IT drops work -- overflow
        # eviction and tier sheds -- since those never reach a dispatch span
        self.tracer = tracer
        self._blocks: collections.deque[Block] = collections.deque()
        self._depth = 0
        self._next_rid = 0
        self.shed_entries: list[Entry] = []
        # running min over block deadlines: O(1) on admit, invalidated on
        # removal and recomputed lazily -- the batcher polls min_deadline()
        # on its hot loop, which must not scan every block per tick
        self._min_dl = math.inf
        self._min_dirty = False

    # ------------------------------------------------------------ admission
    @property
    def depth(self) -> int:
        return self._depth

    def __len__(self) -> int:
        return self._depth

    def _deadline(self, now: float, deadline: float | None) -> float:
        if deadline is not None:
            return deadline
        if self.default_slo_s is None:
            return math.inf
        return now + self.default_slo_s

    def _make_room(self, n: int) -> None:
        if n > self.capacity:
            raise ValueError(
                f"batch of {n} samples exceeds the queue capacity "
                f"{self.capacity}; split the submission"
            )
        if self._depth + n <= self.capacity:
            return
        if self.policy == "reject":
            raise QueueFull(
                f"admission queue full ({self._depth}/{self.capacity} "
                f"samples pending); retry after a flush or raise capacity"
            )
        while self._depth + n > self.capacity and self._blocks:
            oldest = self._blocks[0]
            drop = min(len(oldest), self._depth + n - self.capacity)
            head, tail = oldest.split(drop)
            self.shed_entries.extend(head.entries())
            self._depth -= drop
            self._min_dirty = True
            if self.tracer is not None:
                self.tracer.instant("queue.evict", cat="serving", n=drop,
                                    rids=[head.rids[0], head.rids[-1]])
            if len(tail):
                self._blocks[0] = tail
            else:
                self._blocks.popleft()

    def _admit_block(self, xs: np.ndarray, deadline: float | None,
                     now: float | None, tier: str) -> list[int]:
        """Append one already-validated block (single validation pass)."""
        if tier not in TIERS:
            raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
        now = self._clock() if now is None else now
        self._make_room(len(xs))
        rids = range(self._next_rid, self._next_rid + len(xs))
        self._next_rid += len(xs)
        block = Block(rids, xs, now, self._deadline(now, deadline), tier)
        self._blocks.append(block)
        self._depth += len(xs)
        if not self._min_dirty:
            self._min_dl = min(self._min_dl, block.deadline)
        return list(rids)

    def admit_batch(self, xs, *, deadline: float | None = None,
                    now: float | None = None, tier: str = "gold") -> list[int]:
        """Admit a (B, *shape) batch as ONE block; returns per-sample rids."""
        return self._admit_block(self.spec.validate_batch(xs), deadline, now, tier)

    def admit(self, x, *, deadline: float | None = None,
              now: float | None = None, tier: str = "gold") -> int:
        """Admit one sample (shape = the engine input spec); returns its rid."""
        return self._admit_block(self.spec.validate_sample(x), deadline, now, tier)[0]

    def take_rids(self, n: int) -> list[int]:
        """Allocate ``n`` request ids without enqueueing anything -- the
        brownout path sheds best-effort arrivals at the front door but must
        still hand the caller real rids so its waiters terminate."""
        rids = list(range(self._next_rid, self._next_rid + n))
        self._next_rid += n
        return rids

    def shed_tier(self, tier: str) -> int:
        """Drop every queued block of ``tier`` (brownout: best-effort goes
        first); their entries land in ``shed_entries``.  Returns the count."""
        dropped = 0
        kept: collections.deque[Block] = collections.deque()
        for block in self._blocks:
            if block.tier == tier:
                self.shed_entries.extend(block.entries())
                self._depth -= len(block)
                dropped += len(block)
            else:
                kept.append(block)
        if dropped:
            self._blocks = kept
            self._min_dirty = True
            if self.tracer is not None:
                self.tracer.instant("queue.shed_tier", cat="serving",
                                    tier=tier, n=dropped)
        return dropped

    # ------------------------------------------------------------------ pop
    def oldest_deadline(self) -> float:
        return self._blocks[0].deadline if self._blocks else math.inf

    def min_deadline(self) -> float:
        """Tightest deadline anywhere in the queue -- the one the batcher's
        slack rule must honor (a later arrival may carry an earlier deadline
        than the FIFO head, e.g. a default-SLO head plus an urgent
        override).  Amortized O(1): the running min is maintained on admit
        and recomputed only after removals invalidated it."""
        if not self._blocks:
            self._min_dl, self._min_dirty = math.inf, False
            return math.inf
        if self._min_dirty:
            self._min_dl = min(b.deadline for b in self._blocks)
            self._min_dirty = False
        return self._min_dl

    def oldest_age(self, now: float | None = None) -> float:
        if not self._blocks:
            return 0.0
        now = self._clock() if now is None else now
        return now - self._blocks[0].t_submit

    def pop(self, n: int) -> tuple[list[Entry], np.ndarray]:
        """Dequeue up to ``n`` samples in FIFO order.

        Returns per-sample entries plus their activations concatenated into
        one ``(len(entries), *spec.shape)`` array.
        """
        entries: list[Entry] = []
        parts: list[np.ndarray] = []
        while self._blocks and len(entries) < n:
            block = self._blocks.popleft()
            take = min(len(block), n - len(entries))
            head, tail = block.split(take)
            entries.extend(head.entries())
            parts.append(head.xs)
            self._depth -= take
            self._min_dirty = True
            if len(tail):
                self._blocks.appendleft(tail)
        if not entries:
            return [], np.empty((0, *self.spec.shape))
        xs = parts[0] if len(parts) == 1 else np.concatenate(parts)
        return entries, xs

    def pending_rids(self) -> list[int]:
        """Rids still queued, FIFO order."""
        return [r for block in self._blocks for r in block.rids]

    def drain_shed(self) -> list[Entry]:
        """Entries dropped by the shed policy since the last call."""
        out, self.shed_entries = self.shed_entries, []
        return out
