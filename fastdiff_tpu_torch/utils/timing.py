"""Device timing for the port's experiment scripts: CUDA events around a run
of calls (eager, or replayed from a CUDA graph), and two versions raced in
turns on one card."""

from __future__ import annotations

import torch


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls of ``fn``, timed with CUDA
    events after one warm-up call (the calls are enqueued back to back,
    then synchronized)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def race(first, second, reps: int) -> tuple:
    """Time first, second, second, first; the mean ms per call of each, as
    (second, first)."""
    a1 = cuda_ms(first, reps)
    b1 = cuda_ms(second, reps)
    b2 = cuda_ms(second, reps)
    a2 = cuda_ms(first, reps)
    return (b1 + b2) / 2, (a1 + a2) / 2


def graph_ms(fn, reps: int, rounds: int = 5) -> float:
    """Mean device ms per call of ``fn``: ``reps`` calls captured in one
    CUDA graph after a warm-up call, the graph replayed ``rounds`` times
    between CUDA events. The replay costs the host nothing per call, so a
    kernel shorter than its wrapper's Python is timed by the device alone
    (``cuda_ms`` would time the host's launch rate)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * rounds)
    del graph
    return ms


def race_graph(first, second, reps: int) -> tuple:
    """``race`` with ``graph_ms``: first, second, second, first; the mean
    device ms per call of each, as (second, first)."""
    a1 = graph_ms(first, reps)
    b1 = graph_ms(second, reps)
    b2 = graph_ms(second, reps)
    a2 = graph_ms(first, reps)
    return (b1 + b2) / 2, (a1 + a2) / 2
