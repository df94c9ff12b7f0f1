"""K9's tensor-core ``lvc_stage`` (``csrc/stage_micro.cu``) taken apart on the
card.

    python -m fastdiff_tpu_torch.scripts.exp_lvc_stage [--tf 1]

Builds variants of the kernel's source, each into a library of its own
(one ``nvcc`` per variant, all started together, under
``build/kernels/exp_lvc_stage``):

- ``kernel``: the source as it is;
- ``no_repack``: without the per-warp repack of the tap rows (the mma.syncs
  read whatever the A buffer holds);
- ``no_mma``: without the mma.sync loop (the accumulators stay zero);
- ``no_store``: without the global stores of the output rows;
- ``io_only``: without the repack and the mma.syncs, so the ring's copies,
  the stmatrix staging and the stores alone;
- ``loads_only``: without repack, mma.syncs and stores: the ring's copies
  and barriers alone.

Each runs at the hop-256 shape (221,184 samples, 864 frames, b 1) at the
walk grain ``--tf``, timed by CUDA-graph replay (device time alone) in
turns (kernel, no_repack, ..., loads_only, loads_only, ..., kernel),
beside ``torch.bmm`` over frames. Prints one JSON object: ms per call of
each variant, each variant's ptxas registers and spills, the bound, and
the full kernel's error against its plain version (the variants' outputs
are not checked). Needs the card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.scripts import bench_mosaic_micro as micro
from fastdiff_tpu_torch.utils.timing import graph_ms

SOURCE = _build.CSRC / "stage_micro.cu"
OUT_DIR = _build.BUILD_DIR / "exp_lvc_stage"
HOP, FRAMES = 256, 864
_REPACK = ("    // 1. repack:", "    // 2. Z (32 x 64)")
_MMA = ("#pragma unroll\n    for (int ks = 0; ks < LVC_KPAD / 16; ++ks) {",
        "    __syncwarp();\n    if (lane == 0) mbar_arrive(empty + 8 * s);")
_STORE = ("    const int rows_here = min(32, n - r_begin);",
          "    __syncwarp();\n  });")


def _cut(src: str, region: tuple) -> str:
    start, end = region
    a = src.index(start)
    return src[:a] + src[src.index(end, a):]


def variant_sources() -> dict:
    """name -> source text; raises if the kernel's source no longer has the
    lines a variant removes."""
    src = SOURCE.read_text()
    for start, end in (_REPACK, _MMA, _STORE):
        if start not in src or end not in src[src.index(start):]:
            raise RuntimeError(f"{SOURCE} changed: update exp_lvc_stage's "
                               "edits")
    cuts = {"kernel": (), "no_repack": (_REPACK,), "no_mma": (_MMA,),
            "no_store": (_STORE,), "io_only": (_REPACK, _MMA),
            "loads_only": (_REPACK, _MMA, _STORE)}
    out = {}
    for name, regions in cuts.items():
        text = src
        for region in regions:
            text = _cut(text, region)
        out[name] = text
    return out


def build_variants() -> tuple:
    """(name -> loaded library, name -> ptxas's lines for lvc_stage_kernel),
    one nvcc per variant started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variant_sources().items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-shared", "-o", str(OUT_DIR / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out[-4000:]}")
        lines = out.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry" in line and "lvc_stage_kernel" in line)
        ptxas[name] = [line.split(":", 1)[-1].strip()
                       for line in lines[at + 1:at + 4]
                       if "registers" in line or "spill" in line]
        lib = ctypes.CDLL(str(OUT_DIR / f"lib{name}.so"))
        lib.lvc_stage_launch.argtypes = _build.SIGNATURES["lvc_stage_launch"]
        libs[name] = lib
    return libs, ptxas


def run(tf: int = 1, reps: int = 20, seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("exp_lvc_stage times the card: it needs a CUDA "
                           "device")
    dev = torch.device("cuda", 0)
    libs, ptxas = build_variants()
    gen = torch.Generator(device=dev).manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    length = HOP * FRAMES
    tap = (torch.randn((1, length, micro.ROWS), generator=gen, device=dev)
           * 0.1).bfloat16()
    kern = (torch.randn((1, FRAMES, micro.ROWS, micro.C2), generator=gen,
                        device=dev) * 0.1).bfloat16()
    out = torch.empty((1, length, micro.C2), dtype=torch.bfloat16,
                      device=dev)
    grid = micro.lvc_stage_grid(1, FRAMES, tf, sms)

    def launch(lib):
        code = lib.lvc_stage_launch(
            tap.data_ptr(), kern.data_ptr(), out.data_ptr(), 1, length,
            FRAMES, HOP, micro.ROWS, tf, micro.LVC_K_PAD, micro.LVC_STAGES,
            micro.LVC_SMEM_BYTES, grid,
            torch.cuda.current_stream().cuda_stream)
        _build.check(code, "lvc_stage_launch")

    launch(libs["kernel"])
    torch.cuda.synchronize()
    ref = micro.lvc_stage_plain(tap, kern, HOP)
    err = float((out.float() - ref.float()).abs().max())
    calls = {name: (lambda lib=lib: launch(lib)) for name, lib in libs.items()}
    calls["torch.bmm"] = lambda: torch.bmm(
        tap.view(FRAMES, HOP, micro.ROWS), kern.view(FRAMES, micro.ROWS,
                                                     micro.C2))
    order = list(calls) + list(calls)[::-1]
    times = {name: [] for name in calls}
    for name in order:
        times[name].append(graph_ms(calls[name], reps))
    bound_ms, bound_by = micro.bound_ms(
        2.0 * length * micro.ROWS * micro.C2,
        2.0 * (length * (micro.ROWS + micro.C2)
               + FRAMES * micro.ROWS * micro.C2))
    return {"device": torch.cuda.get_device_name(0), "hop": HOP,
            "frames": FRAMES, "tf": tf, "grid": grid, "ptxas": ptxas,
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            "ms": {n: sum(t) / len(t) for n, t in times.items()},
            "runs": times}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tf", type=int, default=1)
    args = parser.parse_args()
    print(json.dumps(run(args.tf), indent=1))


if __name__ == "__main__":
    main()
