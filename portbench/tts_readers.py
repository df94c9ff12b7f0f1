"""The arithmetic of the text-to-wav cells' own metric readers
(``portbench/metrics/*.tts.py``). Like ``readers.py``'s, each returns None
where it finds nothing to read: off the card, or in a window that holds no
``tts.*`` span (a program without the text-to-wav entry's spans).

The port's text-to-wav entry (``training/tts_task.py:FastSpeech2Task.
synthesize``) opens ``tts.call`` holding ``tts.acoustic`` (with
``tts.length`` inside) and ``tts.vocode``, which holds the batch vocoder's
``vocoder.*`` and the graph sampler's ``sampler.*`` spans. Idle stretches go
to spans as ``program_spans.py`` gives them, over these layers: each of at
least ``trace.SHORT_GAP_NS`` whole to the innermost span open at its middle.
"""

from __future__ import annotations

from portbench import program_spans, work, work_tts
from portbench.readers import _device_trace
from portbench.trace import SHORT_GAP_NS

LAYERS = ("tts",) + program_spans.LAYERS


def spans(trace) -> list:
    """(start_ns, end_ns, name) of the window's program spans, by start
    (outer before inner at one start)."""
    prefixes = tuple(layer + "." for layer in LAYERS)
    return sorted(((s, t, name) for s, t, name in trace.host
                   if name.startswith(prefixes)),
                  key=lambda h: (h[0], -h[1]))


def idle_by_span(trace) -> dict:
    """{program span name: idle seconds given to it}."""
    found = spans(trace)
    out = {}
    mids = sorted(((s + t) // 2, t - s) for s, t in trace.gaps()
                  if t - s >= SHORT_GAP_NS)
    open_, i = [], 0
    for mid, length in mids:
        while i < len(found) and found[i][0] <= mid:
            open_.append(found[i])
            i += 1
        open_ = [h for h in open_ if h[1] >= mid]
        if open_:
            name = max(open_, key=lambda h: (h[0], -h[1]))[2]
            out[name] = out.get(name, 0.0) + length * 1e-9
    return out


def host_idle_share(run):
    """The idle seconds given to ``tts.*`` spans over the window's seconds,
    in %."""
    trace = _device_trace(run)
    if trace is None or not any(name.startswith("tts.")
                                for _, _, name in trace.host):
        return None
    idle = idle_by_span(trace)
    return 100.0 * sum(sec for name, sec in idle.items()
                       if name.startswith("tts.")) / trace.window_s


def acoustic_share(run):
    """Host time inside ``tts.acoustic`` spans (FastSpeech 2's forward up to
    its mel on the host), clipped to the traced window, over the window's
    seconds, in %."""
    trace = _device_trace(run)
    if trace is None:
        return None
    a, b = trace.window_ns
    inside = [max(0, min(t, b) - max(s, a)) for s, t, name in trace.host
              if name == "tts.acoustic"]
    if not inside:
        return None
    return 100.0 * sum(inside) * 1e-9 / trace.window_s


def mfu(run):
    """Model FLOPs of the window's calls (``work_tts.call_flops``) over the
    window's seconds at the card's bf16 peak, in %."""
    if run.platform != "gpu":
        return None
    flops = sum(work_tts.call_flops(run.config["hparams"], c.tokens, c.padded)
                for c in run.calls)
    return 100.0 * flops / (run.window_s * work.H100_BF16_PEAK)
