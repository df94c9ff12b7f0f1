"""The card's idle time put down to the port's own host spans.

The port opens ``torch.profiler`` spans named ``<layer>.<phase>`` in its
host layers (``vocoder.*`` in ``serving/batch_vocoder.py``, ``sampler.*``
in ``diffusion/sampler.py``). They land in the traced window's host
events on the device's clock. Each idle stretch of the window that lasts
at least ``trace.SHORT_GAP_NS`` goes to the innermost program span open at
its middle, as ``Trace.idle_by_host`` names a stretch by the innermost
host event; a stretch that no program span covers (the harness's own
``portbench.*`` spans, the profiler's flushes) goes to no layer.
"""

from __future__ import annotations

from portbench.readers import _device_trace
from portbench.trace import SHORT_GAP_NS

LAYERS = ("vocoder", "sampler")


def program_spans(trace) -> list:
    """(start_ns, end_ns, name) of the window's program spans, by start
    (outer before inner at one start)."""
    prefixes = tuple(layer + "." for layer in LAYERS)
    return sorted(((s, t, name) for s, t, name in trace.host
                   if name.startswith(prefixes)),
                  key=lambda h: (h[0], -h[1]))


def idle_by_span(trace) -> dict | None:
    """{program span name: idle seconds given to it}; None when the
    window holds no program span."""
    spans = program_spans(trace)
    if not spans:
        return None
    out = {}
    mids = sorted(((s + t) // 2, t - s) for s, t in trace.gaps()
                  if t - s >= SHORT_GAP_NS)
    open_, i = [], 0
    for mid, length in mids:
        while i < len(spans) and spans[i][0] <= mid:
            open_.append(spans[i])
            i += 1
        open_ = [h for h in open_ if h[1] >= mid]
        if open_:
            # the innermost: the latest start, then the earliest end
            name = max(open_, key=lambda h: (h[0], -h[1]))[2]
            out[name] = out.get(name, 0.0) + length * 1e-9
    return out


def idle_by_layer(trace) -> dict | None:
    """{layer: idle seconds given to its spans}; None when the window
    holds no program span."""
    by_span = idle_by_span(trace)
    if by_span is None:
        return None
    out = dict.fromkeys(LAYERS, 0.0)
    for name, seconds in by_span.items():
        out[name.split(".", 1)[0]] += seconds
    return out


def host_idle_share(run, layer: str):
    """The idle seconds given to ``layer``'s spans over the window's
    seconds, in %; None off the card or with no program span."""
    trace = _device_trace(run)
    if trace is None:
        return None
    idle = idle_by_layer(trace)
    if idle is None:
        return None
    return 100.0 * idle[layer] / trace.window_s
