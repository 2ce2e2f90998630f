"""Pareto-frontier extraction over sweep records.

The paper's design-space story is a trade-off curve: more PE/SIMD buys
throughput, costs LUT/FF/BRAM (Figs 8-15).  The explorer reports the same
curve as the set of non-dominated sweep points -- maximize throughput,
minimize every resource analog.  Generic over plain dicts so benchmarks
and tests can reuse it on any record shape.

A copy of the JAX package's ``explore/pareto.py`` (plain Python): the
port keeps its own so it imports with torch alone.
"""

from __future__ import annotations

from collections.abc import Sequence


def dominates(a: dict, b: dict, *, maximize: Sequence[str],
              minimize: Sequence[str]) -> bool:
    """True iff ``a`` is at least as good as ``b`` on every objective and
    strictly better on at least one.  Missing keys count as worst-case."""
    at_least = True
    strictly = False
    for key in maximize:
        av = a.get(key, float("-inf"))
        bv = b.get(key, float("-inf"))
        if av < bv:
            at_least = False
            break
        if av > bv:
            strictly = True
    if at_least:
        for key in minimize:
            av = a.get(key, float("inf"))
            bv = b.get(key, float("inf"))
            if av > bv:
                at_least = False
                break
            if av < bv:
                strictly = True
    return at_least and strictly


def pareto_front(points: Sequence[dict], *, maximize: Sequence[str],
                 minimize: Sequence[str] = ()) -> list[int]:
    """Indices of the non-dominated points, in input order.

    Duplicate objective vectors all survive (none strictly dominates the
    other), which keeps deduplication the grid's job, not the frontier's.
    """
    out: list[int] = []
    for i, p in enumerate(points):
        if not any(
            dominates(q, p, maximize=maximize, minimize=minimize)
            for j, q in enumerate(points) if j != i
        ):
            out.append(i)
    return out
