"""K9's tensor-core stage kernels (``csrc/stage_micro.cu``: ``lvc_stage``,
``conv_stage``) taken apart on the card.

    python -m fastdiff_tpu_torch.scripts.exp_lvc_stage [--stage lvc|conv]
        [--tf 1]

Builds variants of the kernel's source, each into a library of its own
(one ``nvcc`` per variant, all started together, under
``build/kernels/exp_lvc_stage/<stage>``). For ``lvc_stage``:

- ``kernel``: the source as it is;
- ``no_repack``: without the per-warp repack of the tap rows (the mma.syncs
  read whatever the A buffer holds);
- ``no_mma``: without the mma.sync loop (the accumulators stay zero);
- ``no_store``: without the global stores of the output rows;
- ``io_only``: without the repack and the mma.syncs, so the ring's copies,
  the stmatrix staging and the stores alone;
- ``loads_only``: without repack, mma.syncs and stores: the ring's copies
  and barriers alone.

For ``conv_stage`` the same, with its mma.syncs in two parts:
``no_layer0`` (layer 0's 7 k16 steps over the repacked rows),
``no_chain`` (layers 1-3, chained in registers) and ``no_mma`` (both).

Each runs at the hop-256 shape (221,184 samples: 864 frames, b 1, for
``lvc_stage`` at the walk grain ``--tf``; 221,184 rows for ``conv_stage``
at the wrapper's default ``tile_s``), timed by CUDA-graph replay (device time alone) in turns
(kernel, no_repack, ..., loads_only, loads_only, ..., kernel), beside its
library call (``torch.bmm`` over frames; chained ``torch.matmul``). Prints
one JSON object: ms per call of each variant, each variant's ptxas
registers and spills, the bound, and the full kernel's error against its
plain version (the variants' outputs are not checked), with the card's
name and power limit. Needs the card and the CUDA toolkit.
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
# lvc_stage_kernel's regions (the first in the source)
_REPACK = ("    // 1. repack:", "    // 2. Z (32 x 64)")
_MMA = ("#pragma unroll\n    for (int ks = 0; ks < LVC_KPAD / 16; ++ks) {",
        "    __syncwarp();\n    if (lane == 0) mbar_arrive(empty + 8 * s);")
_STORE = ("    const int rows_here = min(32, n - r_begin);",
          "    __syncwarp();\n  });")
# conv_stage_kernel's regions, searched from its definition
_C_REPACK = ("    repack_rows(smem + (span - base)",
             "    if (lane == 0) mbar_arrive(empty + 8 * s);")
_C_LAYER0 = ("    // layer 0: Y (32 x 32)", "    // layers 1-3: x =")
_C_CHAIN = ("    // layers 1-3: x =", "    // one rounding per value, stmatrix")
_C_STORE = ("    const int mine = min(32, n - r_begin);",
            "    __syncwarp();\n  });")
# stage -> (its kernel, variant -> the regions it cuts)
CUTS = {
    "lvc": ("lvc_stage_kernel", {
        "kernel": (), "no_repack": (_REPACK,), "no_mma": (_MMA,),
        "no_store": (_STORE,), "io_only": (_REPACK, _MMA),
        "loads_only": (_REPACK, _MMA, _STORE)}),
    "conv": ("conv_stage_kernel", {
        "kernel": (), "no_repack": (_C_REPACK,), "no_layer0": (_C_LAYER0,),
        "no_chain": (_C_CHAIN,), "no_mma": (_C_LAYER0, _C_CHAIN),
        "no_store": (_C_STORE,), "io_only": (_C_REPACK, _C_LAYER0, _C_CHAIN),
        "loads_only": (_C_REPACK, _C_LAYER0, _C_CHAIN, _C_STORE)}),
}


def kernel_body(src: str, kernel: str) -> str:
    """The text of ``kernel``'s definition in ``src``: from its name to the
    first line that closes a function."""
    a = src.index(f"\n{kernel}(")
    return src[a:src.index("\n}\n", a) + 3]


def _cut(src: str, kernel: str, region: tuple) -> str:
    start, end = region
    a = src.index(start, src.index(f"\n{kernel}("))
    return src[:a] + src[src.index(end, a):]


def variant_sources(stage: str = "lvc") -> dict:
    """name -> source text of ``stage``'s variants; raises if the kernel's
    source no longer has the lines a variant removes."""
    src = SOURCE.read_text()
    kernel, cuts = CUTS[stage]
    body = kernel_body(src, kernel)
    for start, end in {r for regions in cuts.values() for r in regions}:
        if start not in body or end not in body[body.index(start):]:
            raise RuntimeError(f"{SOURCE} changed: update exp_lvc_stage's "
                               "edits")
    out = {}
    for name, regions in cuts.items():
        text = src
        for region in regions:
            text = _cut(text, kernel, region)
        out[name] = text
    return out


def build_variants(stage: str = "lvc") -> tuple:
    """(name -> loaded library, name -> ptxas's lines for the stage's
    kernel), one nvcc per variant started together."""
    kernel = CUTS[stage][0]
    out_dir = OUT_DIR / stage
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variant_sources(stage).items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-shared", "-o", str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out[-4000:]}")
        lines = out.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry" in line and kernel in line)
        ptxas[name] = [line.split(":", 1)[-1].strip()
                       for line in lines[at + 1:at + 4]
                       if "registers" in line or "spill" in line]
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        entry = f"{stage}_stage_launch"
        getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
        libs[name] = lib
    return libs, ptxas


def run(stage: str = "lvc", tf: int = 1, reps: int = 20,
        seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("exp_lvc_stage times the card: it needs a CUDA "
                           "device")
    dev = torch.device("cuda", 0)
    libs, ptxas = build_variants(stage)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    length = HOP * FRAMES
    tap = (torch.randn((1, length, micro.ROWS), generator=gen, device=dev)
           * 0.1).bfloat16()
    report = {"device": torch.cuda.get_device_name(0), "stage": stage,
              "rows": length, "ptxas": ptxas}
    if stage == "lvc":
        kern = (torch.randn((1, FRAMES, micro.ROWS, micro.C2), generator=gen,
                            device=dev) * 0.1).bfloat16()
        out = torch.empty((1, length, micro.C2), dtype=torch.bfloat16,
                          device=dev)
        grid = micro.lvc_stage_grid(1, FRAMES, tf, sms)

        def launch(lib):
            code = lib.lvc_stage_launch(
                tap.data_ptr(), kern.data_ptr(), out.data_ptr(), 1, length,
                FRAMES, HOP, micro.ROWS, tf, micro.LVC_K_PAD,
                micro.LVC_STAGES, micro.LVC_SMEM_BYTES, grid,
                torch.cuda.current_stream().cuda_stream)
            _build.check(code, "lvc_stage_launch")

        plain = lambda: micro.lvc_stage_plain(tap, kern, HOP)
        library = ("torch.bmm", lambda: torch.bmm(
            tap.view(FRAMES, HOP, micro.ROWS),
            kern.view(FRAMES, micro.ROWS, micro.C2)))
        flop = 2.0 * length * micro.ROWS * micro.C2
        nbytes = 2.0 * (length * (micro.ROWS + micro.C2)
                        + FRAMES * micro.ROWS * micro.C2)
        report.update(hop=HOP, frames=FRAMES, tf=tf, grid=grid)
    else:
        w = (torch.randn((micro.LAYERS, micro.ROWS, micro.C), generator=gen,
                         device=dev) * 0.1).bfloat16()
        out = torch.empty((1, length, micro.C), dtype=torch.bfloat16,
                          device=dev)
        tile_s = micro.CONV_TILE_S
        grid = micro.conv_stage_grid(length, tile_s, sms)

        def launch(lib):
            code = lib.conv_stage_launch(
                tap.data_ptr(), w.data_ptr(), out.data_ptr(), 1, length,
                micro.ROWS, tile_s, micro.CONV_STAGES, micro.CONV_SMEM_BYTES,
                grid, torch.cuda.current_stream().cuda_stream)
            _build.check(code, "conv_stage_launch")

        plain = lambda: micro.conv_stage_plain(tap, w)
        library = ("chained torch.matmul",
                   lambda: micro._conv_library(tap, w))
        flop = micro.LAYERS * 2.0 * length * micro.ROWS * micro.C
        nbytes = 2.0 * length * (micro.ROWS + micro.C)
        report.update(tile_s=tile_s, grid=grid)

    launch(libs["kernel"])
    torch.cuda.synchronize()
    ref = plain()
    report["max_abs_err"] = float((out.float() - ref.float()).abs().max())
    calls = {name: (lambda lib=lib: launch(lib)) for name, lib in libs.items()}
    calls[library[0]] = library[1]
    order = list(calls) + list(calls)[::-1]
    times = {name: [] for name in calls}
    for name in order:
        times[name].append(graph_ms(calls[name], reps))
    report["bound_ms"], report["bound_by"] = micro.bound_ms(flop, nbytes)
    report["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    report["ms"] = {n: sum(t) / len(t) for n, t in times.items()}
    report["runs"] = times
    return report


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--stage", choices=sorted(CUTS), default="lvc")
    parser.add_argument("--tf", type=int, default=1)
    args = parser.parse_args()
    print(json.dumps(run(args.stage, args.tf), indent=1))


if __name__ == "__main__":
    main()
