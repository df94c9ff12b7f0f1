"""The tensor-core Kernel B (K1, K2, ``csrc/lvc_block_ncl_tc.cu``) taken apart
on the card.

    python -m fastdiff_tpu_torch.scripts.exp_block_tc [--frames 864]
        [--hops 8 64 256]

Builds variants of the kernel's source, each into a library of its own
(one ``nvcc`` per variant, all started together, under
``build/kernels/exp_block_tc``):

- ``kernel``: the source as it is;
- ``no_lvc``: without the LVC and gate stage (the carry keeps s);
- ``no_conv``: without the dilated conv (the LVC reads whatever y holds);
- ``io_only``: without both, so the loads of x, W_i and skip, the skip-add
  and the stores alone.

Each runs the block (no epilogue) at b 1 and ``--frames`` frames of each
hop with the tile ``block_tile_plan`` picks, timed by CUDA-graph replay
(device time alone) in turns (kernel, no_lvc, no_conv, io_only, io_only,
no_conv, no_lvc, kernel). Prints one JSON object: ms per call of each
variant and hop, each variant's ptxas registers and spills, and the full
kernel's error against its plain version (the variants' outputs are not
checked). Needs the card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from fastdiff_tpu_torch.ops import _build, lvc_block_ncl, lvc_head
from fastdiff_tpu_torch.utils.timing import graph_ms

SOURCE = _build.CSRC / "lvc_block_ncl_tc.cu"
OUT_DIR = _build.BUILD_DIR / "exp_block_tc"
_LVC = ("    lvc_gate_tc<WIDE, SAVE>(kern_b, i, ybuf, carry, rows_p, hop, F, "
        "g0, ext,\n                            warp, lane, z_i, tile);\n")
_CONV = ("    conv_tc<WIDE, SAVE>(act, ws, wb, ybuf, d, g0, ext, L, warp, lane, "
         "y_i,\n                        tile);\n")


def variant_sources() -> dict:
    """name -> source text; raises if the kernel's source no longer has the
    lines a variant removes."""
    src = SOURCE.read_text()
    if _LVC not in src or _CONV not in src:
        raise RuntimeError(f"{SOURCE} changed: update exp_block_tc's edits")
    return {"kernel": src, "no_lvc": src.replace(_LVC, ""),
            "no_conv": src.replace(_CONV, ""),
            "io_only": src.replace(_LVC, "").replace(_CONV, "")}


def build_variants() -> tuple:
    """(name -> loaded library, name -> ptxas's register and spill lines),
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
        ptxas[name] = [line.split(":", 1)[-1].strip()
                       for line in out.splitlines()
                       if "registers" in line or "spill" in line]
        lib = ctypes.CDLL(str(OUT_DIR / f"lib{name}.so"))
        lib.lvc_block_ncl_launch.argtypes = _build.SIGNATURES[
            "lvc_block_ncl_launch"]
        libs[name] = lib
    return libs, ptxas


def run(frames: int = 864, hops=(8, 64, 256), reps: int = 20,
        seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("exp_block_tc times the card: it needs a CUDA "
                           "device")
    dev = torch.device("cuda", 0)
    libs, ptxas = build_variants()
    gen = torch.Generator(device=dev).manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    c, layers = lvc_block_ncl.KERNEL_CHANNELS, lvc_block_ncl.KERNEL_LAYERS
    rows, rows_p = 3 * c + 1, lvc_head.rows_padded(c)
    report = {"device": torch.cuda.get_device_name(0), "frames": frames,
              "ptxas": ptxas, "hops": {}}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).bfloat16()

    with torch.inference_mode():
        wstack_t = randn(layers, c, rows, scale=0.1)
        for hop in hops:
            length = frames * hop
            x, skip = randn(1, c, length), randn(1, c, length)
            kern = torch.zeros((1, frames, layers, 2 * c, rows_p),
                               dtype=torch.bfloat16, device=dev)
            kern[..., :rows] = randn(1, frames, layers, 2 * c, rows,
                                     scale=0.05)
            out = torch.empty_like(x)
            plan = lvc_block_ncl.block_tile_plan(1, length, sms)

            def launch(lib):
                code = lib.lvc_block_ncl_launch(
                    x.data_ptr(), skip.data_ptr(), kern.data_ptr(),
                    wstack_t.data_ptr(), None, out.data_ptr(), None, 1, c,
                    length, frames, hop, rows_p, layers, plan.tile,
                    torch.cuda.current_stream().cuda_stream)
                _build.check(code, "lvc_block_ncl_launch")

            launch(libs["kernel"])
            torch.cuda.synchronize()
            ref = lvc_block_ncl.lvc_block_ncl_plain(x, skip, kern, wstack_t,
                                                    hop)
            err = float((out.float() - ref.float()).abs().max())
            order = list(libs) + list(libs)[::-1]
            times = {name: [] for name in libs}
            for name in order:
                times[name].append(graph_ms(lambda: launch(libs[name]),
                                            reps))
            report["hops"][hop] = {
                "tile": plan.tile, "blocks": plan.blocks,
                "waves": plan.waves, "max_abs_err": err,
                "ms": {n: sum(t) / len(t) for n, t in times.items()},
                "runs": times}
            del x, skip, kern, out, ref
    return report


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=864)
    parser.add_argument("--hops", type=int, nargs="*", default=[8, 64, 256])
    args = parser.parse_args()
    print(json.dumps(run(args.frames, tuple(args.hops)), indent=1))


if __name__ == "__main__":
    main()
