"""Tracing and timing helpers (``fastdiff_tpu/utils/profiling.py``).

- ``force(value)``: waits for the device and fetches one scalar that
  depends on ``value`` (its last element), a completion fence that also
  serves as a cheap finiteness probe.
- ``trace(log_dir)``: ``torch.profiler`` around a block (the CPU, and the
  card when there is one), written as a Chrome trace
  ``<log_dir>/trace.json``; the block gets the profiler, whose
  ``key_averages()`` sum the kernels by name.
- ``span(name)``: a named host span in that trace (and in any other
  ``torch.profiler`` over the block), on the profiler's clock beside the
  device's kernels and copies; with no profiler running, one shared
  no-op context, so a span costs a flag read.
- ``RTFMeter``: generation time over audio time across utterances, the
  JAX meter's arithmetic.
- ``device_timer``, ``timed_pipeline``, ``device_timer_slope``: the time of
  ``fn(*args)``. Where its output lies on the card they read CUDA events
  recorded around the calls on the current stream (the device's own
  clock); elsewhere ``time.perf_counter`` around calls that end in
  ``force``. ``device_timer_slope`` times two loop lengths and takes the
  slope, which cancels every per-measurement constant (the fence, the
  first launch's latency); the minimum over repetitions, since contention
  only ever adds time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import numpy as np
import torch


def _leaves(value) -> list:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _leaves(v)]
    return []


def _on_card(value) -> bool:
    return any(t.device.type == "cuda" for t in _leaves(value))


def force(value) -> float:
    """Wait until ``value`` (a tensor or a structure of them) is computed and
    return the float of its last tensor's last element (0.0 without a
    tensor). On the card the device is synchronized first, so everything
    queued before ``value`` is done too."""
    leaves = _leaves(value)
    if not leaves:
        return 0.0
    last = leaves[-1]
    if last.device.type == "cuda":
        torch.cuda.synchronize(last.device)
    return float(last.detach().reshape(-1)[-1:].float().sum())


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records;
    otherwise a shared ``nullcontext`` (no ``RecordFunction`` entered,
    nothing allocated). Program spans are named ``<layer>.<phase>``."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA when available) into
    ``<log_dir>/trace.json``; yields the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class RTFMeter:
    def __init__(self, sample_rate: int = 22050):
        self.sample_rate = sample_rate
        self.gen_seconds = 0.0
        self.audio_seconds = 0.0
        self.count = 0

    @contextlib.contextmanager
    def measure(self, audio_samples: int):
        """Time the block (end it with ``force`` on its output) as the
        generation of ``audio_samples`` samples."""
        t0 = time.perf_counter()
        yield
        self.gen_seconds += time.perf_counter() - t0
        self.audio_seconds += audio_samples / self.sample_rate
        self.count += 1

    @property
    def rtf(self) -> float:
        return self.gen_seconds / max(self.audio_seconds, 1e-9)

    @property
    def x_realtime(self) -> float:
        return self.audio_seconds / max(self.gen_seconds, 1e-9)

    def summary(self) -> str:
        return (f"RTF={self.rtf:.4f} ({self.x_realtime:.1f}x realtime, "
                f"{self.count} utterances, {self.audio_seconds:.1f}s audio)")


def timed_pipeline(fn: Callable, *args, n: int,
                   card: Optional[bool] = None) -> float:
    """Seconds for ``n`` calls of ``fn(*args)`` back to back and one
    ``force`` of the last output: between CUDA events on the card, by
    ``time.perf_counter`` elsewhere. ``card`` defaults to whether a tensor
    argument lies on the card (whether there is a card, when no argument
    is a tensor)."""
    if card is None:
        card = (_on_card(args) if _leaves(args)
                else torch.cuda.is_available())
    out = None
    if card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            out = fn(*args)
        end.record()
        force(out)
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    force(out)
    return time.perf_counter() - t0


def device_timer(fn: Callable, *args, iters: int = 10, warmup: int = 1,
                 pipeline: int = 1) -> float:
    """Median ms per call of ``fn(*args)`` over ``iters`` samples, each of
    ``pipeline`` calls back to back ended by one ``force``, after
    ``warmup`` forced calls (which also tell whether the output lies on
    the card)."""
    card = None
    for _ in range(warmup):
        out = fn(*args)
        card = _on_card(out)
        force(out)
    times = [timed_pipeline(fn, *args, n=pipeline, card=card) / pipeline
             for _ in range(iters)]
    return float(np.median(times) * 1000.0)


def device_timer_slope(fn: Callable, *args, n1: int = 10, n2: int = 50,
                       reps: int = 3, warmup: int = 2) -> float:
    """Per-call ms of ``fn(*args)`` with every per-measurement constant
    cancelled: ``reps`` pairs of loops of ``n1`` and ``n2`` calls (each
    ``timed_pipeline``), the slope (T2 - T1) / (n2 - n1) of each pair, and
    the smallest slope."""
    card = None
    for _ in range(warmup):
        out = fn(*args)
        card = _on_card(out)
        force(out)
    best = float("inf")
    for _ in range(reps):
        t1 = timed_pipeline(fn, *args, n=n1, card=card)
        t2 = timed_pipeline(fn, *args, n=n2, card=card)
        best = min(best, (t2 - t1) / (n2 - n1))
    return best * 1000.0
