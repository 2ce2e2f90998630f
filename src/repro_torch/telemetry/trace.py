"""Low-overhead structured tracing: nested spans, bounded buffer, Chrome export.

The paper's result is *per-stage* -- initiation intervals, critical-path
delay, FIFO occupancy -- so the runtime needs per-stage visibility, not
end-to-end aggregates.  ``Tracer`` is the one event sink every layer
(engine, pipeline executor, serving) writes into:

* **duration spans** (``span``): nested, per-thread stack discipline -- a
  span closes after every span opened inside it, so within one thread
  spans nest and never overlap (the invariant the test suite asserts),
* **async events** (``begin_async``/``end_async``): request lifecycles
  that overlap freely (hundreds of requests in flight), correlated by id,
* **instants** (``instant``): point annotations -- a retry, a hedge, a
  quarantine -- that land on the timeline where they happened,
* **counters** (``counter``): sampled time series (queue depth, ...).

Everything lands in ONE bounded in-memory ring (the FINN FIFO rule applied
to the bookkeeping): when ``capacity`` is reached the oldest events drop
and ``dropped`` counts them -- a long-running server's trace memory stays
flat.  ``to_chrome()``/``save()`` export the Chrome trace-event JSON
format, viewable in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.

Zero overhead when disabled is a hard requirement: components hold
``tracer = None`` and guard every emission with ``if tracer is not None``
-- one attribute load and an identity test, nothing allocated, nothing
called.  There is deliberately NO NullTracer object on the hot paths.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time


class SpanHandle:
    """Context manager for one open duration span.

    ``args`` stays mutable while the span is open, so a caller can attach
    facts it only learns mid-span (which replica a dispatch landed on,
    whether a probe recovered)::

        with tracer.span("dispatch", cat="serving") as sp:
            pending = pool.dispatch(xs, entries)
            sp.args["replica"] = pending.replica.index
    """

    __slots__ = ("_tracer", "name", "cat", "args", "t0", "t1", "depth")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "SpanHandle":
        stack = self._tracer._stack()
        self.depth = len(stack)
        stack.append(self)
        self.t0 = self._tracer.clock()
        return self

    def __exit__(self, *exc) -> None:
        t1 = self.t1 = self._tracer.clock()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._emit({
            "ph": "X", "name": self.name, "cat": self.cat,
            "t0": self.t0, "t1": t1, "depth": self.depth,
            "tid": threading.get_ident(), "args": self.args,
        })
        return None

    @property
    def dur(self) -> float:
        """Span duration in seconds (valid once the span has closed)."""
        return self.t1 - self.t0


class Tracer:
    """Bounded structured trace buffer with an explicit clock.

    capacity: maximum buffered events; overflow drops oldest (counted in
        :attr:`dropped`).
    clock: seconds-valued monotonic callable (``time.perf_counter``); an
        injected fake clock makes span timing deterministic in tests.
    meta: free-form dict stamped into the Chrome export's ``metadata``
        (e.g. the build name, the fault-plan seed).
    """

    def __init__(self, *, capacity: int = 65536, clock=time.perf_counter,
                 meta: dict | None = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.clock = clock
        self.meta = dict(meta or {})
        # the hot path is LOCK-FREE: deque.append (and maxlen eviction) is
        # one GIL-atomic operation, so no Lock is acquired per event (the
        # lock was ~30% of the per-event cost).  Snapshots (list(deque))
        # are GIL-consistent.  The emission counter is a plain int bump --
        # diagnostic only; concurrent bumps may very occasionally coalesce,
        # which can only UNDERcount ``dropped``, never corrupt the buffer.
        self._events: collections.deque[dict] = collections.deque(maxlen=capacity)
        self._local = threading.local()
        self._emitted = 0
        self._t_origin = clock()

    # ------------------------------------------------------------- plumbing
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _emit(self, ev: dict) -> None:
        self._events.append(ev)
        self._emitted += 1

    @property
    def dropped(self) -> int:
        """Events evicted by the capacity bound so far."""
        return max(0, self._emitted - len(self._events))

    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> list[dict]:
        """Snapshot of the buffered events (oldest first)."""
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self._emitted = 0

    # ------------------------------------------------------------- recording
    def span(self, name: str, cat: str = "", **args) -> SpanHandle:
        """Open a nested duration span (use as a context manager)."""
        return SpanHandle(self, name, cat, args)

    def emit_span(self, name: str, t0: float, t1: float, *, cat: str = "",
                  tid=None, **args) -> None:
        """Record a span with explicit timestamps, outside the per-thread
        stack -- for *reconstructed* schedules (the pipeline executor's
        per-stage occupancy lanes), where the span was not a code region.
        ``tid`` may be any hashable lane id (e.g. ``"stage0"``)."""
        self._emit({"ph": "X", "name": name, "cat": cat, "t0": t0, "t1": t1,
                    "depth": 0,
                    "tid": threading.get_ident() if tid is None else tid,
                    "args": args})

    def instant(self, name: str, cat: str = "", **args) -> None:
        """Point annotation at the current clock (a retry, a quarantine)."""
        self._emit({"ph": "i", "name": name, "cat": cat, "t": self.clock(),
                    "tid": threading.get_ident(), "args": args})

    def begin_async(self, name: str, aid, cat: str = "", *,
                    t: float | None = None, **args) -> None:
        """Open one async (overlapping) interval, correlated by ``aid``."""
        self._emit({"ph": "b", "name": name, "cat": cat, "id": aid,
                    "t": self.clock() if t is None else t,
                    "tid": threading.get_ident(), "args": args})

    def end_async(self, name: str, aid, cat: str = "", *,
                  t: float | None = None, **args) -> None:
        self._emit({"ph": "e", "name": name, "cat": cat, "id": aid,
                    "t": self.clock() if t is None else t,
                    "tid": threading.get_ident(), "args": args})

    def counter(self, name: str, value, cat: str = "") -> None:
        """Sample a time-series value (rendered as a counter track)."""
        self._emit({"ph": "C", "name": name, "cat": cat, "t": self.clock(),
                    "tid": threading.get_ident(), "args": {"value": value}})

    # --------------------------------------------------------------- export
    def spans(self, *, name: str | None = None, cat: str | None = None
              ) -> list[dict]:
        """Buffered duration spans, optionally filtered, with ``dur`` (s)."""
        out = []
        for ev in self.events():
            if ev["ph"] != "X":
                continue
            if name is not None and ev["name"] != name:
                continue
            if cat is not None and ev["cat"] != cat:
                continue
            out.append({**ev, "dur": ev["t1"] - ev["t0"]})
        return out

    def summary(self) -> dict:
        """Per-span-name aggregate (count / total / max seconds) plus the
        buffer accounting -- the compact form a BuildReport embeds."""
        agg: dict[str, dict] = {}
        events = self.events()
        for ev in events:
            if ev["ph"] != "X":
                continue
            dur = ev["t1"] - ev["t0"]
            a = agg.setdefault(ev["name"], {"count": 0, "total_s": 0.0,
                                            "max_s": 0.0})
            a["count"] += 1
            a["total_s"] += dur
            a["max_s"] = max(a["max_s"], dur)
        counts = collections.Counter(ev["ph"] for ev in events)
        return {
            "spans": {k: {"count": v["count"],
                          "total_s": round(v["total_s"], 6),
                          "max_s": round(v["max_s"], 6)}
                      for k, v in sorted(agg.items())},
            "events": {"X": counts.get("X", 0), "i": counts.get("i", 0),
                       "async": counts.get("b", 0) + counts.get("e", 0),
                       "C": counts.get("C", 0)},
            "dropped": self.dropped,
            "capacity": self.capacity,
        }

    def _us(self, t: float) -> float:
        return (t - self._t_origin) * 1e6

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (perfetto-viewable).

        Duration spans become complete (``ph:"X"``) events, instants stay
        instants, async intervals map to ``b``/``e`` pairs, counters to
        ``C`` events.  Timestamps are microseconds from the tracer's
        construction; lane ids (reconstructed-schedule spans) become
        named synthetic tids.
        """
        pid = os.getpid()
        tids: dict = {}

        def tid_of(raw) -> int:
            if isinstance(raw, int):
                return raw
            if raw not in tids:
                tids[raw] = len(tids) + 1  # small synthetic lane ids
            return tids[raw]

        out = []
        for ev in self.events():
            tid = tid_of(ev["tid"])
            base = {"name": ev["name"], "cat": ev["cat"] or "default",
                    "pid": pid, "tid": tid, "args": ev["args"]}
            if ev["ph"] == "X":
                out.append({**base, "ph": "X", "ts": self._us(ev["t0"]),
                            "dur": (ev["t1"] - ev["t0"]) * 1e6})
            elif ev["ph"] == "i":
                out.append({**base, "ph": "i", "ts": self._us(ev["t"]),
                            "s": "t"})
            elif ev["ph"] in ("b", "e"):
                out.append({**base, "ph": ev["ph"], "ts": self._us(ev["t"]),
                            "id": ev["id"]})
            elif ev["ph"] == "C":
                out.append({**base, "ph": "C", "ts": self._us(ev["t"])})
        # name the synthetic lanes so Perfetto shows "stage0", not "tid 3"
        for raw, tid in tids.items():
            if not isinstance(raw, int):
                out.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "args": {"name": str(raw)}})
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "metadata": {**self.meta, "dropped_events": self.dropped}}

    def save(self, path: str) -> str:
        """Serialize :meth:`to_chrome` to ``path`` (a ``.trace.json``)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")
        return path
