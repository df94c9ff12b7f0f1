"""Device timing for the port's experiment scripts: CUDA events around a run
of calls, and two versions raced in turns on one card."""

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
