"""Pipeline-parallel streaming executor: the FINN dataflow graph as a GPipe
schedule over CUDA streams.

FINN instantiates one compute unit per layer and streams activations
through AXI links; here contiguous layer ranges become *stages*, each on
a device of its own list entry and a CUDA stream of its own, and
*microbatches* stream from stage to stage (the GPipe schedule of the JAX
package's ``distributed/pipeline.py``, whose stages are the devices of a
mesh axis joined by ``ppermute``).  A device may repeat in the list: on
one card every stage is a stream of that card, so the schedule runs, and
overlaps, on one GPU.  The correspondences:

    AXI stream / TVALID-TREADY      a CUDA event the producer records and
                                    the consumer's stream waits on
    FIFO between layers             the in-flight microbatch tensor
    FINN folding / rate balancing   equal per-stage layer counts
    II = 1 steady state             one microbatch per stage per tick
    pipeline bubbles                (S-1) fill + (S-1) drain ticks

``pipeline_apply`` is generic over the per-stage function, and autograd
flows through it, so it serves for training and for serving.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch

from repro_torch.core.engine import resolve_device


def stage_params_split(params_stacked: dict, n_stages: int) -> dict:
    """Reshape a dict of (L, ...)-stacked layer params to (n_stages, L/S, ...)."""

    def r(x):
        l = x.shape[0]
        assert l % n_stages == 0, (l, n_stages)
        return x.reshape(n_stages, l // n_stages, *x.shape[1:])

    return {k: r(v) for k, v in params_stacked.items()}


def _layers(params: dict) -> list[dict]:
    """A dict of (L, ...) tensors as L per-layer dicts, in order."""
    n_layers = next(iter(params.values())).shape[0]
    return [{k: v[i] for k, v in params.items()} for i in range(n_layers)]


def place_stages(stage_params: dict, devices: Sequence) -> list[list[dict]]:
    """The dict of (n_stages, L/S, ...) tensors as the form
    :func:`run_stages` takes: for each stage, its layers in order, each a
    dict of contiguous tensors on that stage's device.  A caller that runs
    one split many times places it once."""
    devices = [resolve_device(d) for d in devices]
    lead = {int(a.shape[0]) for a in stage_params.values()}
    if lead != {len(devices)}:
        raise ValueError(f"stage_params hold {'/'.join(map(str, sorted(lead)))} stages, "
                         f"but {len(devices)} devices were given")
    return [[{k: v.to(d).contiguous() for k, v in p.items()}
             for p in _layers({k: v[s] for k, v in stage_params.items()})]
            for s, d in enumerate(devices)]


def pipeline_apply(
    layer_fn: Callable,  # (layer_params, x) -> x
    stage_params: dict,  # (n_stages, layers_per_stage, ...) tensors
    x: torch.Tensor,  # (n_micro, micro_batch, ...)
    devices: Sequence,  # one device per stage; a device may repeat
) -> torch.Tensor:
    """Run the microbatched GPipe schedule over the stages on ``devices``:
    :func:`place_stages`, then :func:`run_stages`."""
    return run_stages(layer_fn, place_stages(stage_params, devices), x, devices)


def run_stages(layer_fn: Callable, stages: list, x: torch.Tensor, devices: Sequence,
               *, stage_streams: bool = True) -> torch.Tensor:
    """The GPipe ticks over placed stages (:func:`place_stages`).

    Stage ``s`` runs on ``devices[s]`` and at tick ``t`` (0 to
    ``n_micro + S - 2``) applies its L/S layers, in order, to microbatch
    ``t - s``; the last stage emits microbatch ``t - S + 1``.  Bubble
    ticks, where ``t - s`` is out of range, launch nothing (the JAX
    schedule computes and discards them: the outputs are the same), so a
    run makes ``n_micro x L`` layer calls.  Returns the last stage's
    ``(n_micro, micro_batch, ...)`` on ``devices[-1]``.

    On CUDA each stage runs on a stream of its own: a stage's output
    records an event that the next stage's stream waits on before it
    reads (and copies, when the devices differ), a tensor read on another
    stream than the one that allocated it is marked with
    ``record_stream``, and the caller's current stream waits on the last
    stage at the end, so the run needs no host synchronisation.  With
    ``stage_streams=False``, and on the CPU, the same ticks run in order
    on the caller's stream, with no events.
    """
    devices = [resolve_device(d) for d in devices]
    n_stages, n_micro = len(devices), int(x.shape[0])
    if len(stages) != n_stages:
        raise ValueError(f"{len(stages)} stages, but {n_stages} devices were given")
    if n_micro < n_stages:
        raise ValueError("need >= n_stages microbatches to fill the pipe "
                         f"(n_micro={n_micro}, n_stages={n_stages})")
    cuda = [d.type == "cuda" for d in devices]
    if any(cuda) and not all(cuda):
        raise ValueError(f"stages on CUDA and off it: {[str(d) for d in devices]}")
    x = x.to(devices[0])
    linked = cuda[0] and stage_streams  # stage streams joined by events
    if linked:
        streams = [torch.cuda.Stream(device=d) for d in devices]
        for st, d, layers in zip(streams, devices, stages):
            # x and the parameters were written on the caller's streams
            st.wait_stream(torch.cuda.current_stream(d))
            for p in layers:
                for a in p.values():
                    a.record_stream(st)
        x.record_stream(streams[0])
    held: list = [None] * n_stages  # (output, its event) of stage s's last tick
    out: list = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        # the last stage first: stage s reads stage s-1's output of tick t-1
        for s in reversed(range(n_stages)):
            m = t - s
            if not 0 <= m < n_micro:
                continue  # a bubble: nothing to compute
            d, ev = devices[s], None
            with torch.cuda.stream(streams[s]) if linked else contextlib.nullcontext():
                if s == 0:
                    h = x[m]
                else:
                    h, ev = held[s - 1]
                    if linked:
                        streams[s].wait_event(ev)  # the link: the producer has written h
                        h.record_stream(streams[s])
                    if devices[s - 1] != d:
                        if linked:
                            # a copy between cards runs on the source card's
                            # current stream, which reads h too
                            h.record_stream(torch.cuda.current_stream(devices[s - 1]))
                        h = h.to(d, non_blocking=True)
                for p in stages[s]:
                    h = layer_fn(p, h)
                if linked:
                    ev = torch.cuda.Event()
                    ev.record(streams[s])
            held[s] = (h, ev)
        if t >= n_stages - 1:
            out[t - n_stages + 1] = held[-1][0]
    if linked:
        caller = torch.cuda.current_stream(devices[-1])
        caller.wait_stream(streams[-1])
        for y in out:
            y.record_stream(caller)
    return torch.stack(out)


def pipeline_occupancy(n_stages: int, n_micro: int) -> dict:
    """Static GPipe schedule accounting: ticks, bubbles, occupancy.

    The schedule runs ``n_micro + n_stages - 1`` ticks; each stage computes
    for ``n_micro`` of them and idles through ``n_stages - 1`` fill/drain
    bubbles -- the paper's pipeline-fill latency term, counted in ticks
    instead of cycles.  ``occupancy`` is the busy fraction per stage.
    """
    ticks = n_micro + n_stages - 1
    bubble = n_stages - 1
    return {
        "n_stages": n_stages,
        "n_micro": n_micro,
        "ticks": ticks,
        "bubble_ticks_per_stage": bubble,
        "occupancy": n_micro / ticks if ticks else 0.0,
    }


def emit_schedule_spans(tracer, n_stages: int, n_micro: int,
                        t0: float, t1: float) -> dict:
    """Reconstruct the per-stage GPipe timeline as trace lanes.

    The stages' kernels run on their streams without a host
    synchronisation between them, so no host span can time one tick: the
    executor measures the wall interval ``[t0, t1]`` and lays the
    *static* schedule over it: tick width ``(t1-t0)/ticks``, stage ``s``
    busy with microbatch ``m`` during tick ``s + m``, idle ticks emitted
    as ``bubble`` spans.  One lane (``stageN``) per stage; returns the
    occupancy accounting.
    """
    occ = pipeline_occupancy(n_stages, n_micro)
    tick_s = (t1 - t0) / occ["ticks"]
    for s in range(n_stages):
        lane = f"stage{s}"
        for tick in range(occ["ticks"]):
            m = tick - s
            a, b = t0 + tick * tick_s, t0 + (tick + 1) * tick_s
            if 0 <= m < n_micro:
                tracer.emit_span(f"micro{m}", a, b, cat="pipeline",
                                 tid=lane, stage=s, micro=m, tick=tick)
            else:
                tracer.emit_span("bubble", a, b, cat="pipeline",
                                 tid=lane, stage=s, tick=tick)
    return occ


def sequential_reference(layer_fn, params_stacked: dict, x: torch.Tensor) -> torch.Tensor:
    """Oracle: run all layers sequentially on every microbatch."""
    layers = _layers(params_stacked)
    out = []
    for h in x:
        for p in layers:
            h = layer_fn(p, h)
        out.append(h)
    return torch.stack(out)
