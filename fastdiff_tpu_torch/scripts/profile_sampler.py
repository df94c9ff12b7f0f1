"""Where the device time of the N = 4 sampler goes, per route, on the card.

    python -m fastdiff_tpu_torch.scripts.profile_sampler [ncl] [nwc] ...
        [--frames 864] [--samples 2]

For each route (``ncl``, ``nwc`` with the down kernel, ``ncl_fh``,
``plain``), one warm-up sample of ``--frames`` mel frames (b = 1, seeded
random weights and mel), then ``torch.profiler`` over ``--samples`` samples:
the device's busy time per sample (the sum of its kernels' and copies'
self device time), the number of device events per sample, the host wall
time per sample (profiler on) and the largest device costs per sample by
name. Prints one JSON object with the card's name beside the routes.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from fastdiff_tpu_torch.config import ModelConfig
from fastdiff_tpu_torch.diffusion.sampler import constants_for_hparams, sample
from fastdiff_tpu_torch.models.fastdiff import (INFER_ROUTES, FastDiff,
                                                checked_device)

HOP = 256


def profile_route(route: str, frames: int = 864, samples: int = 2,
                  top: int = 8, seed: int = 0, device="cuda") -> dict:
    """Device busy time and the largest device costs per sample of the
    N = 4 sampler on ``route``."""
    dev = checked_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the profile reads the card's device time: it "
                           "needs a CUDA device")
    cfg = ModelConfig()
    model = FastDiff(cfg, seed=seed, device=dev, infer_route=route,
                     down_kernel=route == "nwc").eval()
    const = constants_for_hparams({"N": 4})
    mel = torch.randn((1, frames, cfg.cond_channels),
                      generator=torch.Generator(device=dev).manual_seed(seed),
                      device=dev)

    def run():
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        return sample(model, mel, const, frames * HOP, generator=g)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        run()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(samples):
                run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / samples
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {
        "route": route, "frames": frames, "samples": samples,
        "device_busy_ms_per_sample": busy_us / 1e3 / samples,
        "device_events_per_sample": sum(e.count for e in rows) / samples,
        "wall_ms_per_sample_profiled": wall,
        "top": [{"name": e.key[:80],
                 "ms_per_sample": e.self_device_time_total / 1e3 / samples,
                 "calls_per_sample": e.count / samples}
                for e in rows[:top]],
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("routes", nargs="*", default=["ncl", "nwc"])
    parser.add_argument("--frames", type=int, default=864)
    parser.add_argument("--samples", type=int, default=2)
    args = parser.parse_args()
    for route in args.routes:
        if route not in INFER_ROUTES:
            parser.error(f"route {route!r} is not one of {INFER_ROUTES}")
    report = {"device": torch.cuda.get_device_name(0) if
              torch.cuda.is_available() else None,
              "routes": [profile_route(r, args.frames, args.samples)
                         for r in args.routes]}
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
