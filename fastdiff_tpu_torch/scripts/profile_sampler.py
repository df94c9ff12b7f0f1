"""Where the device time of the N = 4 sampler, or of a train step, goes, per
route, on the card.

    python -m fastdiff_tpu_torch.scripts.profile_sampler [ncl] [nwc] ...
        [--frames 864] [--samples 2] [--top 8] [--graph]
    python -m fastdiff_tpu_torch.scripts.profile_sampler --train [ncl_sr]
        [ncl_vjp] [plain] [--samples 2] [--top 10]
    python -m fastdiff_tpu_torch.scripts.profile_sampler --tts
        [--tokens 23 152] [--samples 2] [--top 10]
    python -m fastdiff_tpu_torch.scripts.profile_sampler --tts_train
        [--frames 517] [--samples 2] [--top 10]

For each route (``ncl``, ``nwc`` with the down kernel, ``ncl_fh``,
``plain``), two warm-up samples of ``--frames`` mel frames (b = 1, seeded
random weights and mel), then ``torch.profiler`` over ``--samples`` samples:
the device's busy time per sample (the sum of its kernels' and copies'
self device time), the number of device events per sample, the host wall
time per sample (profiler on), the device's idle gaps inside the profiled
window (the span from the first device event's start to the last one's
end, less the union of the events' intervals: idle ms and share, the
idle ms in gaps of at most 5 us, the number of longer gaps and the
largest) and the ``--top`` largest
device costs per sample by name. With ``--graph`` each sample is a replay
of the sampler's CUDA graph (``diffusion/sampler.py:make_sampler``; the
shape's eager first call and its capture come before the profile), with
the eager loop's profile beside it. With ``--train`` the routes are the training routes and a sample is
one ``FastDiffTask.train_step`` at the recipe (20 x 25,600 samples, a fixed
seeded batch, two warm-up steps): the same profile per step, and the
step's forward (loss), backward (gradients) and optimizer (finite check and
AdamW) timed apart with CUDA events over 3 more steps. With ``--tts`` a
sample is one FastSpeech 2 forward at the full width of
``fastdiff_tpu/configs/fs2_ljspeech.yaml`` (seed-0 weights, inference mode
at t_mel = ``max_frames``, as ``FastSpeech2Task.infer_mel`` runs it) on
``--tokens`` random phone ids, with TF32 off and with cuDNN TF32 on
(torch's default): the same profile, and the forward's ms by CUDA events
(the module called as ``infer_mel`` calls it). With ``--tts_train`` a sample is one
``FastSpeech2Task.train_step`` at ``fs2_ljspeech.yaml``'s full width and
batch (48 utterances of ``--frames`` / 4 to ``--frames`` frames, 0.29
phones a frame, as the ``en`` processor's graphemes give on chip_smoke's
phase 24 corpus; seeded records through ``collate_tts``), TF32 off: the same
profile per step and the step's forward, backward and optimizer apart by
CUDA events over 3 more steps. Prints one JSON object with the card's name
beside the routes.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from fastdiff_tpu_torch.config import ModelConfig
from fastdiff_tpu_torch.diffusion.sampler import (constants_for_hparams,
                                                  make_sampler, sample)
from fastdiff_tpu_torch.models.fastdiff import (INFER_ROUTES, TRAIN_ROUTES,
                                                FastDiff, checked_device)

HOP = 256
FS2_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "fastdiff_tpu", "configs", "fs2_ljspeech.yaml")
TRAIN_BATCH, TRAIN_FRAMES = 20, 100     # the training recipe


def _cuda_device(device):
    dev = checked_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the profile reads the card's device time: it "
                           "needs a CUDA device")
    return dev


def _gaps(prof, per: int) -> dict:
    """The device's idle time inside the profiled window: its span (first
    device event's start to the last one's end) less the union of the
    events' intervals, per ``per``; the idle time in gaps of at most 5 us
    (kernel to kernel), the number of longer gaps and the largest."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {"span_ms": 0.0, "idle_ms": 0.0, "idle_share": None,
                "idle_in_short_gaps_ms": 0.0, "gaps_over_5us": 0,
                "largest_gap_us": 0.0}
    busy, gaps, end = 0.0, [], spans[0][0]
    for lo, hi in spans:
        if lo > end:
            gaps.append(lo - end)
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    span = end - spans[0][0]
    return {"span_ms": span / 1e3 / per, "idle_ms": (span - busy) / 1e3 / per,
            "idle_share": (span - busy) / span if span else None,
            "idle_in_short_gaps_ms": sum(g for g in gaps if g <= 5) / 1e3
            / per,
            "gaps_over_5us": sum(g > 5 for g in gaps) / per,
            "largest_gap_us": max(gaps, default=0.0)}


def _device_profile(prof, per: int, top: int) -> dict:
    """Busy time, event count, idle gaps and the largest costs per ``per``
    of a profile's device events."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {
        "gaps": _gaps(prof, per),
        "device_busy_ms": busy_us / 1e3 / per,
        "device_events": sum(e.count for e in rows) / per,
        "top": [{"name": e.key[:80],
                 "ms": e.self_device_time_total / 1e3 / per,
                 "calls": e.count / per}
                for e in rows[:top]],
    }


_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]


def profile_train(route: str, steps: int = 2, split_steps: int = 3,
                  top: int = 10, seed: int = 0, device="cuda") -> dict:
    """Device time per train step at the recipe on a training ``route``,
    and the step's forward / backward / optimizer split."""
    from fastdiff_tpu_torch.training.task import FastDiffTask
    dev = _cuda_device(device)
    task = FastDiffTask({"use_pallas_block": route if route != "plain"
                         else False}, device=dev)
    state = task.build_state(seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    length = TRAIN_FRAMES * HOP
    batch = {"wavs": (torch.randn((TRAIN_BATCH, length, 1), generator=gen,
                                  device=dev) * 0.3).cpu().numpy(),
             "mels": (torch.randn((TRAIN_BATCH, TRAIN_FRAMES, 80),
                                  generator=gen, device=dev) - 4.0)
             .cpu().numpy()}
    ts = torch.randint(0, 1000, (TRAIN_BATCH, 1, 1), generator=gen,
                       device=dev)
    z = torch.randn((TRAIN_BATCH, length, 1), generator=gen, device=dev)
    for _ in range(2):
        task.train_step(state, batch, ts=ts, z=z)
    torch.cuda.synchronize()
    # forward, backward, optimizer apart: train_step's own calls
    model, params = state.model, list(state.model.parameters())
    split = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    for _ in range(split_steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = task.loss(model, batch, ts=ts, z=z)
        ev[1].record()
        grads = torch.autograd.grad(loss, params)
        ev[2].record()
        if bool(torch.stack([torch.isfinite(loss)] + [
                torch.isfinite(g).all() for g in grads]).all()):
            state.optimizer.step(grads)
        ev[3].record()
        torch.cuda.synchronize()
        for i, key in enumerate(split):
            split[key] += ev[i].elapsed_time(ev[i + 1]) / split_steps
        del loss, grads
    with torch.profiler.profile(activities=_ACTIVITIES) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            task.train_step(state, batch, ts=ts, z=z)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    out = _device_profile(prof, steps, top)
    return {"route": route, "steps": steps,
            "device_busy_ms_per_step": out["device_busy_ms"],
            "device_events_per_step": out["device_events"],
            "wall_ms_per_step_profiled": wall,
            "split_ms": split,
            "top": [{"name": r["name"], "ms_per_step": r["ms"],
                     "calls_per_step": r["calls"]} for r in out["top"]]}


def profile_route(route: str, frames: int = 864, samples: int = 2,
                  top: int = 8, seed: int = 0, device="cuda",
                  graph: bool = False) -> dict:
    """Device busy time, idle gaps and the largest device costs per sample
    of the N = 4 sampler on ``route``: the eager loop, or with ``graph``
    replays of its CUDA graph."""
    dev = _cuda_device(device)
    cfg = ModelConfig()
    model = FastDiff(cfg, seed=seed, device=dev, infer_route=route,
                     down_kernel=route == "nwc").eval()
    const = constants_for_hparams({"N": 4})
    mel = torch.randn((1, frames, cfg.cond_channels),
                      generator=torch.Generator(device=dev).manual_seed(seed),
                      device=dev)
    runner = make_sampler(model, const) if graph else None

    def run():
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        if graph:
            return runner(g, mel, frames * HOP)
        return sample(model, mel, const, frames * HOP, generator=g)

    with torch.inference_mode():
        for _ in range(2):              # a graph's shape: warm-up, capture
            run()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=_ACTIVITIES) as prof:
            t0 = time.perf_counter()
            for _ in range(samples):
                run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / samples
    out = _device_profile(prof, samples, top)
    return {
        "route": route, "frames": frames, "samples": samples,
        "graph": graph,
        "device_busy_ms_per_sample": out["device_busy_ms"],
        "device_events_per_sample": out["device_events"],
        "wall_ms_per_sample_profiled": wall,
        "gaps": out["gaps"],
        "top": [{"name": r["name"], "ms_per_sample": r["ms"],
                 "calls_per_sample": r["calls"]} for r in out["top"]],
    }


def profile_tts(tokens: int, samples: int = 2, top: int = 10,
                cudnn_tf32: bool = False, seed: int = 0,
                device="cuda") -> dict:
    """Device busy time, idle gaps and the largest device costs per
    FastSpeech 2 forward (inference mode, t_mel = max_frames) on ``tokens``
    phone ids, at full width, matmul TF32 off and cuDNN TF32 as given."""
    from fastdiff_tpu_torch.training.tts_task import FastSpeech2Task
    from fastdiff_tpu_torch.utils.hparams import set_hparams
    from fastdiff_tpu_torch.utils.timing import cuda_ms
    dev = _cuda_device(device)
    hp = set_hparams(config=FS2_CONFIG, hparams_str="vocab_size=64",
                     print_hparams=False, global_hparams=False)
    task = FastSpeech2Task(hp, device=dev)
    model = task.build_state(seed=seed).model
    ids = torch.randint(3, 64, (1, tokens), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            seed + 1))

    def run():
        return model(ids)

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    try:
        with torch.inference_mode():
            module_ms = cuda_ms(run, 5)
            frames = int(run()["mel_mask"].sum())
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=_ACTIVITIES) as prof:
                t0 = time.perf_counter()
                for _ in range(samples):
                    run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / samples
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    out = _device_profile(prof, samples, top)
    return {
        "route": "fastspeech2", "tokens": tokens, "frames": frames,
        "t_mel": task.model_cfg.max_len, "cudnn_tf32": cudnn_tf32,
        "samples": samples, "module_ms": module_ms,
        "device_busy_ms_per_sample": out["device_busy_ms"],
        "device_events_per_sample": out["device_events"],
        "wall_ms_per_sample_profiled": wall,
        "gaps": out["gaps"],
        "top": [{"name": r["name"], "ms_per_sample": r["ms"],
                 "calls_per_sample": r["calls"]} for r in out["top"]],
    }


def profile_tts_train(frames: int = 517, samples: int = 2, top: int = 10,
                      seed: int = 0, device="cuda") -> dict:
    """Device time per FastSpeech 2 train step at the recipe's width and
    batch, TF32 off, and the step's forward / backward / optimizer split."""
    import numpy as np

    from fastdiff_tpu_torch.training.tts_task import (FastSpeech2Task,
                                                      collate_tts)
    from fastdiff_tpu_torch.utils.hparams import set_hparams
    dev = _cuda_device(device)
    hp = set_hparams(config=FS2_CONFIG, hparams_str="vocab_size=64",
                     print_hparams=False, global_hparams=False)
    task = FastSpeech2Task(hp, device=dev)
    state = task.build_state(seed=seed)
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(int(hp["max_sentences"])):
        t_mel = int(rng.integers(frames // 4, frames + 1))
        t_ph = max(2, round(0.29 * t_mel))
        f0 = rng.uniform(90, 240, t_mel)
        f0[rng.uniform(size=t_mel) < 0.2] = 0.0
        items.append({"phone": rng.integers(3, 64, t_ph),
                      "mel": rng.uniform(-5, 1, (t_mel, 80)),
                      "f0": f0, "mel2ph": np.sort(
                          rng.integers(1, t_ph + 1, t_mel))})
    pad = (max(len(i["phone"]) for i in items) + 7) // 8 * 8
    frame_pad = (max(len(i["mel"]) for i in items) + 31) // 32 * 32
    batch = collate_tts(items, pad, frame_pad, 80)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for _ in range(2):
            task.train_step(state, batch)
        torch.cuda.synchronize()
        model, params = state.model, list(state.model.parameters())
        split = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            loss = task.loss(model, task._to_device(batch))["total"]
            ev[1].record()
            grads = torch.autograd.grad(loss, params)
            ev[2].record()
            state.optimizer.step(grads)
            ev[3].record()
            torch.cuda.synchronize()
            for i, key in enumerate(split):
                split[key] += ev[i].elapsed_time(ev[i + 1]) / 3
            del loss, grads
        with torch.profiler.profile(activities=_ACTIVITIES) as prof:
            t0 = time.perf_counter()
            for _ in range(samples):
                task.train_step(state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / samples
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    out = _device_profile(prof, samples, top)
    return {"route": "fastspeech2_train",
            "batch": [list(batch["tokens"].shape), list(batch["mels"].shape)],
            "real_frames": int((batch["mel2ph"] > 0).sum()),
            "steps": samples, "split_ms": split,
            "device_busy_ms_per_step": out["device_busy_ms"],
            "device_events_per_step": out["device_events"],
            "wall_ms_per_step_profiled": wall,
            "gaps": out["gaps"],
            "top": [{"name": r["name"], "ms_per_step": r["ms"],
                     "calls_per_step": r["calls"]} for r in out["top"]]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("routes", nargs="*")
    parser.add_argument("--frames", type=int, default=None,
                        help="mel frames per sample (default 864), or with "
                        "--tts_train the longest utterance (default 517)")
    parser.add_argument("--samples", type=int, default=2)
    parser.add_argument("--top", type=int, default=None,
                        help="device costs listed per route (default 8, "
                        "10 with --train)")
    parser.add_argument("--train", action="store_true",
                        help="profile train steps on training routes")
    parser.add_argument("--graph", action="store_true",
                        help="profile replays of the sampler's CUDA graph, "
                        "with the eager loop beside them")
    parser.add_argument("--tts", action="store_true",
                        help="profile the FastSpeech 2 forward")
    parser.add_argument("--tokens", type=int, nargs="+", default=[23, 152])
    parser.add_argument("--tts_train", action="store_true",
                        help="profile the FastSpeech 2 train step")
    args = parser.parse_args()
    known = TRAIN_ROUTES if args.train else INFER_ROUTES
    routes = args.routes or (["ncl_sr"] if args.train else ["ncl", "nwc"])
    for route in routes:
        if route not in known:
            parser.error(f"route {route!r} is not one of {known}")
    if args.tts_train:
        results = [profile_tts_train(args.frames or 517, args.samples,
                                     top=args.top or 10)]
    elif args.tts:
        results = [profile_tts(n, args.samples, top=args.top or 10,
                               cudnn_tf32=tf32)
                   for n in args.tokens for tf32 in (False, True)]
    elif args.train:
        results = [profile_train(r, args.samples, top=args.top or 10)
                   for r in routes]
    else:
        results = [profile_route(r, args.frames or 864, args.samples,
                                 top=args.top or 8, graph=graph)
                   for r in routes
                   for graph in ((True, False) if args.graph else (False,))]
    report = {"device": torch.cuda.get_device_name(0) if
              torch.cuda.is_available() else None, "routes": results}
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
