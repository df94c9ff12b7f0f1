"""Experiments B and D of ``scripts/exp_r4b.py`` on the card, the port's twin.

    python -m fastdiff_tpu_torch.scripts.exp_r4b [B] [D] [--device cuda]
        [--rows 100 256 864]

- B: the predictor head's grid order and M tile. K10
  (``ops/lvc_head.py:taug_head_variant``: Kernel A's persistent wgmma +
  TMA kernel on the walk ``head_gemm_walk_plan`` makes of each (order,
  M tile) of the script's list) against its plain version, at M x 192 @
  192 x 26,624 (4 layers x 64 x rows_p 104, the port's row padding; the
  TPU script pads rows to 128) for each M of ``--rows`` (864 frames by
  default), beside Kernel A (the shipped head, N-major walk). Every kernel
  is raced in turns against ``torch.addmm`` (a yardstick the port never
  calls) by CUDA-graph replay (device time alone); the plain version is
  timed with CUDA events.
- D: the fused-head route against the NCL route. The N = 4 sampler at 864
  frames (10 s) on ``FastDiff(infer_route="ncl")`` and ``"ncl_fh"`` with
  the same seeded weights and noise, at b = 1 and b = 4, raced in turns
  (ncl, ncl_fh, ncl_fh, ncl) with CUDA events, as CUDA graphs
  (``make_sampler``) and as the eager loop; the max |ncl - ncl_fh| of the
  waveforms.

Experiments A and C (the sampler state's layout, the NCL downsample as a
selection matmul) test TPU layouts and are not ported. Runs on the card
unless ``--device cpu`` (B's plain versions only, no times).
"""

from __future__ import annotations

import argparse
import json

import torch

from fastdiff_tpu_torch.config import ModelConfig
from fastdiff_tpu_torch.diffusion.sampler import (constants_for_hparams,
                                                  make_sampler, sample)
from fastdiff_tpu_torch.models.fastdiff import FastDiff, checked_device
from fastdiff_tpu_torch.ops import lvc_head
from fastdiff_tpu_torch.utils.timing import cuda_ms, race_graph

SECONDS = 10.0
HOP = 256
FRAMES = 864          # 10 s at 22,050 Hz in hops of 256, bucketed as bench.py
# (name, order, M tile): scripts/exp_r4b.py's experiment-B list
VARIANTS = (("m_outer m216 (shipped)", "m_outer", 216),
            ("w_resident m216", "w_res", 216),
            ("m_outer m432", "m_outer", 432),
            ("w_resident m432", "w_res", 432),
            ("w_resident m864", "w_res", 864))


def exp_b(device="cuda", reps: int = 20, seed: int = 0,
          m: int = FRAMES) -> dict:
    """K10 at every variant against its plain version at ``m`` rows: max
    abs error (and its bound, one bf16 ulp of the largest output) and, on
    the card, ms per call raced against ``torch.addmm``'s (CUDA graphs)
    and the plain version's ms; then Kernel A raced the same way."""
    dev = checked_device(device)
    cfg = ModelConfig()
    layers, c = cfg.lvc_layers_each_block, cfg.inner_channels
    rows_p = lvc_head.rows_padded(c)
    k = cfg.kpnet_conv_size * cfg.kpnet_hidden_channels
    n = layers * 2 * c * rows_p
    gen = torch.Generator(device=dev).manual_seed(seed)
    tap = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=dev) * 0.05).to(
        torch.bfloat16)
    b = torch.randn((n,), generator=gen, device=dev)
    ref = lvc_head.taug_head_variant_plain(tap, w, b)
    bound = 2.0 ** -7 * float(ref.float().abs().max()) + 1e-6
    timed = dev.type == "cuda"
    report = {"shape": [m, k, n], "err_bound": bound, "variants": []}
    b_bf16 = b.to(torch.bfloat16)

    def library():
        return torch.addmm(b_bf16, tap, w)

    for name, order, m_tile in VARIANTS:
        def run(order=order, m_tile=m_tile):
            return lvc_head.taug_head_variant(tap, w, b, order=order,
                                              m_tile=m_tile)
        out = run()
        row = {"name": name, "order": order, "m_tile": m_tile,
               "max_abs_err": float((out.float() - ref.float()).abs().max())}
        if timed:
            row["ms"], row["library_ms"] = race_graph(library, run, reps)
            row["plain_ms"] = cuda_ms(
                lambda: lvc_head.taug_head_variant_plain(tap, w, b), 5)
        report["variants"].append(row)
    if timed:
        report["taug_head_ms"], report["library_ms"] = race_graph(
            library, lambda: lvc_head.taug_head_matmul(tap, w, b), reps)
    return report


def exp_d(device="cuda", batches=(1, 4), reps: int = 3,
          seed: int = 0) -> dict:
    """The N = 4 sampler on the ``ncl`` and ``ncl_fh`` routes at 10 s per
    item, raced in turns, as CUDA graphs and eagerly: ms per batch and per
    item, x realtime, and the max |ncl - ncl_fh| of the waveforms drawn
    from the same noise."""
    dev = checked_device(device)
    if dev.type != "cuda":
        raise RuntimeError("experiment D times the card: it needs a CUDA "
                           "device")
    cfg = ModelConfig()
    const = constants_for_hparams({"N": 4})
    models = {r: FastDiff(cfg, seed=seed, device=dev, infer_route=r).eval()
              for r in ("ncl", "ncl_fh")}
    runs = {r: make_sampler(m, const) for r, m in models.items()}
    length = FRAMES * HOP
    report = {"device": torch.cuda.get_device_name(dev), "frames": FRAMES,
              "batches": {}}
    with torch.inference_mode():
        for batch in batches:
            mel = torch.randn((batch, FRAMES, cfg.cond_channels),
                              generator=torch.Generator(device=dev)
                              .manual_seed(seed), device=dev)

            def graph(route, mel=mel):
                g = torch.Generator(device=dev).manual_seed(seed + 1)
                return runs[route](g, mel, length)

            def eager(route, mel=mel):
                g = torch.Generator(device=dev).manual_seed(seed + 1)
                return sample(models[route], mel, const, length, generator=g)

            wavs = {r: graph(r) for r in models}
            times = {(r, how): [] for r in models
                     for how in ("graph", "eager")}
            for how, fn in (("graph", graph), ("eager", eager)):
                for r in ("ncl", "ncl_fh", "ncl_fh", "ncl"):
                    times[r, how].append(cuda_ms(lambda: fn(r), reps))
            row = {"max_abs_diff": float(
                (wavs["ncl"] - wavs["ncl_fh"]).abs().max())}
            for r in models:
                ms, eager_ms = (sum(times[r, how]) / 2
                                for how in ("graph", "eager"))
                row[r] = {"ms": ms, "ms_per_item": ms / batch,
                          "x_realtime": batch * SECONDS / (ms / 1e3),
                          "runs": times[r, "graph"], "eager_ms": eager_ms,
                          "eager_runs": times[r, "eager"]}
            report["batches"][batch] = row
    return report


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("which", nargs="*", default=["B", "D"])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rows", type=int, nargs="*", default=[FRAMES])
    args = parser.parse_args()
    out = {}
    if "B" in args.which:
        out["B"] = {m: exp_b(args.device, m=m) for m in args.rows}
    if "D" in args.which:
        out["D"] = exp_d(args.device)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
