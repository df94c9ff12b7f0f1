"""The reference's full reverse process on the card (the twin of
``scripts/bench_n1000.py``): N = 1000 (or ``--n 200``) steps of the
``make_param_sampler`` graph sampler at 864 frames, b = 1, on the NCL route
(K3, K1, K2), seed-0 weights of the full-width ``ModelConfig()``.

    python -m fastdiff_tpu_torch.scripts.bench_n1000 [--n 200]
        [--frames 864] [--reps 3]

It prints the first call's wall (the kernels built before it; the call
runs the reverse loop eagerly), the second call's wall (the capture of the
sampler's CUDA graphs and one sample's replays), each graph captured with
its node count and its instantiation seconds, ``torch.cuda.memory_reserved``
before and after the capture, the bytes of the runner's static buffers (mel, x,
the noise draws, the step tables), the kernel launches one replay adds,
whether a replay is bit-equal to the first call with a generator of the
same seed, and the replays' time by CUDA events (``measure``, which
``chip_smoke.py``'s phase 33 runs too), as JAX's last line:

    == N=1000: X s per 10.03 s utterance -> Y x realtime (Z ms/step)

with the card's name and power limit beside it. It writes no file.
``build`` and ``sample_once`` are the script's set-up and timed call
(``tests/test_torch_script_twins.py`` runs them at a small width on the
CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import time

import numpy as np
import torch

from fastdiff_tpu_torch.config import ModelConfig
from fastdiff_tpu_torch.diffusion.sampler import (COUNTERS,
                                                  constants_for_hparams,
                                                  make_param_sampler)
from fastdiff_tpu_torch.models.fastdiff import FastDiff, checked_device
from fastdiff_tpu_torch.utils.timing import cuda_ms

FRAMES = 864
SR = 22050


def build(n_steps: int, frames: int = FRAMES, device="cuda",
          cfg: ModelConfig | None = None) -> tuple:
    """(sampler, mel (1, frames, n_mels), audio_length): the graph
    sampler of seed-0 weights on the NCL route over the reference's
    ``N = n_steps`` schedule, and a mel drawn from numpy seed 0."""
    cfg = cfg or ModelConfig()
    device = checked_device(device)
    model = FastDiff(cfg, seed=0, infer_route="ncl", device=device).eval()
    sampler = make_param_sampler(model, constants_for_hparams({"N": n_steps}))
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, frames, cfg.cond_channels)).astype(np.float32))
    return sampler, mel, frames * cfg.total_hop


def sample_once(sampler, mel: torch.Tensor, audio_length: int,
                seed: int) -> torch.Tensor:
    """One call of the sampler with a generator of ``seed`` on the
    sampler's device: the (1, audio_length, 1) waveform."""
    device = next(sampler.model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    return sampler(None, gen, mel, audio_length)


def _node_count(graph) -> int | None:
    """The nodes of a kept graph (``cuGraphGetNodes`` of libcuda)."""
    try:
        count = ctypes.c_size_t(0)
        status = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
            ctypes.c_void_p(graph.raw_cuda_graph()), None,
            ctypes.byref(count))
    except (OSError, AttributeError, RuntimeError):
        return None
    return int(count.value) if status == 0 else None


@contextlib.contextmanager
def graph_census(found: list):
    """Inside the block every ``torch.cuda.CUDAGraph()`` keeps its graph
    (``keep_graph``) and is instantiated at the end of its capture; each
    appends ``(node count or None, instantiation seconds)`` to ``found``.
    Where torch's graphs cannot be kept (an older torch, or one without
    CUDA) the block runs as it is."""
    original = torch.cuda.CUDAGraph
    try:
        original(keep_graph=True)
    except (TypeError, RuntimeError):
        yield
        return

    def kept(keep_graph=False):
        graph = original(keep_graph=True)
        end = graph.capture_end

        def capture_end():
            end()
            t0 = time.perf_counter()
            graph.instantiate()
            found.append((_node_count(graph), time.perf_counter() - t0))
        graph.capture_end = capture_end
        return graph

    torch.cuda.CUDAGraph = kept
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = original


def buffer_bytes(sampler) -> int:
    """Bytes of the tensors the sampler's runners hold as attributes (or
    in lists): mel, x, the noise draws and the step tables."""
    total = 0
    for runner in sampler._runners.values():
        for value in vars(runner).values():
            items = value if isinstance(value, (list, tuple)) else [value]
            total += sum(t.numel() * t.element_size() for t in items
                         if isinstance(t, torch.Tensor))
    return total


def smi_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi: not available"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else \
        "nvidia-smi: not available"


def _counts() -> list:
    return [dict(counter) for counter in COUNTERS]


def measure(sampler, mel: torch.Tensor, audio_length: int,
            reps: int) -> dict:
    """One shape's measurement on the card: the first call's wall
    (``first_s``, the eager loop), the second call's (``capture_s``: the
    capture of the sampler's graphs and one sample's replays), each
    graph's ``(nodes, instantiation seconds)``, ``memory_reserved`` before
    and after the second call, the runner's buffer and draw bytes, the
    launches one replay adds (``launches``, ``replay_launches``) and the
    second call's rise of the counters (``second_launches``), whether the
    second call is bit-equal to the first (the same seed) and finite in
    the right shape, and the mean ms of ``reps`` calls by CUDA events
    (``replay_ms``) with ms a step and x realtime."""
    device = next(sampler.model.parameters()).device
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    first = sample_once(sampler, mel, audio_length, 1)
    torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    reserved = torch.cuda.memory_reserved(device)
    graphs = []
    counts = _counts()
    t0 = time.perf_counter()
    with graph_census(graphs):
        second = sample_once(sampler, mel, audio_length, 1)
    torch.cuda.synchronize(device)
    capture_s = time.perf_counter() - t0
    second_launches = {key: n - before.get(key, 0)
                       for counter, before in zip(COUNTERS, counts)
                       for key, n in counter.items()
                       if n != before.get(key, 0)}
    runner = next(iter(sampler._runners.values()))
    row = dict(
        first_s=first_s, capture_s=capture_s, graphs=graphs,
        reserved_before=reserved,
        reserved_after=torch.cuda.memory_reserved(device),
        buffer_bytes=buffer_bytes(sampler),
        draw_bytes=sum(z.numel() * z.element_size() for z in runner.zs),
        block=runner.block,
        launches=sampler.replay_launches(mel, audio_length),
        second_launches=second_launches,
        bit_equal=bool(torch.equal(first, second)),
        finite=bool(torch.isfinite(second).all()),
        shape_ok=tuple(second.shape) == (mel.shape[0], audio_length, 1))
    del first, second
    ms = cuda_ms(lambda: sample_once(sampler, mel, audio_length, 2), reps)
    n_steps = sampler.constants.n_steps
    audio_s = audio_length / SR
    row.update(replay_ms=ms, ms_per_step=ms / n_steps, audio_s=audio_s,
               x_realtime=audio_s / (ms / 1e3))
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=1000)
    parser.add_argument("--frames", type=int, default=FRAMES)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    device = checked_device("cuda")
    from fastdiff_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"| kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    sampler, mel, length = build(args.n, args.frames, device)
    row = measure(sampler, mel, length, args.reps)
    print(f"| first call (eager loop) {row['first_s']:.2f} s", flush=True)
    print(f"| second call (capture + one sample's replays) "
          f"{row['capture_s']:.2f} s; graphs of {row['block']} steps "
          + ", ".join(f"{nodes} nodes instantiated in {s:.3f} s"
                      for nodes, s in row["graphs"])
          + f"; memory_reserved {row['reserved_before'] / 2 ** 30:.3f} -> "
          f"{row['reserved_after'] / 2 ** 30:.3f} GiB; runner buffers "
          f"{row['buffer_bytes'] / 2 ** 20:.1f} MiB (draws "
          f"{row['draw_bytes'] / 2 ** 20:.2f} MiB); launches per replay "
          f"{row['launches']}; replay bit-equal to the first call: "
          f"{row['bit_equal']}", flush=True)
    if not row["finite"]:
        raise SystemExit("the sampler's output is not finite")
    best = row["replay_ms"] / 1e3
    print(f"== N={args.n}: {best:.3f} s per {row['audio_s']:.2f} s "
          f"utterance -> {row['x_realtime']:.2f}x realtime "
          f"({row['ms_per_step']:.3f} ms/step)"
          f" [{torch.cuda.get_device_name(0)}; {smi_line()}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
