"""Unified telemetry: dataflow tracing, request-lifecycle spans, and a
live cycle-model drift monitor.

Three pieces, one import surface:

* :class:`Tracer` -- nested duration spans, async request intervals,
  instants and counters in a bounded buffer, exported as Chrome
  trace-event JSON (perfetto-viewable).  Components take ``tracer=None``
  and guard every emission with ``if tracer is not None`` so a disabled
  build pays nothing.
* :class:`LogHistogram` / :class:`WindowedRate` /
  :func:`render_prometheus` -- mergeable bounded-memory time-series
  metrics and a Prometheus text exposition.
* :class:`DriftMonitor` -- measured-vs-predicted interval ratios per
  stage/replica against the calibrated cycle model, flagging keys whose
  EWMA leaves the band.

See docs/observability.md for the span taxonomy and workflows.
"""

from repro_torch.telemetry.drift import DEFAULT_BAND, DriftMonitor
from repro_torch.telemetry.metrics import (
    DEFAULT_GROWTH,
    DEFAULT_LO,
    LogHistogram,
    WindowedRate,
    render_prometheus,
)
from repro_torch.telemetry.trace import SpanHandle, Tracer

__all__ = [
    "DEFAULT_BAND",
    "DEFAULT_GROWTH",
    "DEFAULT_LO",
    "DriftMonitor",
    "LogHistogram",
    "SpanHandle",
    "Tracer",
    "WindowedRate",
    "render_prometheus",
]
