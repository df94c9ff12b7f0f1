"""The head GEMM (K3 and K7, ``csrc/taug_head.cu``) taken apart on the card.

    python -m fastdiff_tpu_torch.scripts.exp_head_gemm [--rows 256 864 2000]

Builds three variants of the kernel's source, each into a library of its
own (one ``nvcc`` per variant, all started together, under
``build/kernels/exp_head_gemm``):

- ``kernel``: the source as it is;
- ``no_store``: without the epilogue's TMA stores (nothing is written);
- ``mma_only``: without the epilogue (the accumulators are summed and
  dropped; the w_head slots are still released), so loads and wgmmas alone.

Each runs at K3's shape (K = 192, N = 4 * 64 * 104) for every M of
``--rows``, timed by CUDA-graph replay (device time alone) in turns with
``torch.addmm`` (addmm, kernel, no_store, mma_only, mma_only, no_store,
kernel, addmm). Prints one JSON object: ms per call of each, the bound and
the achieved TB/s of the full kernel, the kernel's error against its plain
version (the variants' outputs are not checked: they write nothing or
garbage), and the host's time per call (us, enqueue only) of the port's
wrapper ``lvc_head.taug_head_matmul``, of the bare C entry and of
``torch.addmm``. Needs the card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import torch

from fastdiff_tpu_torch.ops import _build, lvc_head
from fastdiff_tpu_torch.utils.timing import graph_ms

SOURCE = _build.CSRC / "taug_head.cu"
OUT_DIR = _build.BUILD_DIR / "exp_head_gemm"
K, N = 192, 4 * 64 * 104
_STORES = ("        tma_store(&map_out, tile, nt * HN, row);\n"
           "        tma_store(&map_out, tile + OUT_HALF, nt * HN + 64, row);\n")
_EPILOGUE_START = "    // epilogue: bias, one rounding"
_EPILOGUE_END = '  if (leader) asm volatile("cp.async.bulk.wait_group 0;'
_DROP_ACC = """    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc += d[i];
    if (acc == 1.2345e30f)
      asm volatile("st.shared.f32 [%0], %1;" ::"r"(my_tiles), "f"(acc));
    if (leader && last_of_tile) mbar_arrive(empty_b + 8 * slot);
"""


def variant_sources() -> dict:
    """name -> source text; raises if the kernel's source no longer has the
    lines a variant removes."""
    src = SOURCE.read_text()
    if _STORES not in src or _EPILOGUE_START not in src:
        raise RuntimeError(f"{SOURCE} changed: update exp_head_gemm's edits")
    epilogue = src[src.index(_EPILOGUE_START):src.index(_EPILOGUE_END)]
    epilogue = epilogue[:epilogue.rindex("  }\n")]
    return {"kernel": src, "no_store": src.replace(_STORES, ""),
            "mma_only": src.replace(epilogue, _DROP_ACC)}


def build_variants() -> dict:
    """name -> loaded library, one nvcc per variant started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variant_sources().items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-shared", "-o", str(OUT_DIR / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out[-4000:]}")
        lib = ctypes.CDLL(str(OUT_DIR / f"lib{name}.so"))
        lib.taug_head_launch.argtypes = _build.SIGNATURES["taug_head_launch"]
        libs[name] = lib
    return libs


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn``, enqueue only (no sync inside
    the loop); the card drains the queue afterwards."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def run(rows=(256, 864, 2000), reps: int = 20, seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("exp_head_gemm times the card: it needs a CUDA "
                           "device")
    dev = torch.device("cuda", 0)
    libs = build_variants()
    gen = torch.Generator(device=dev).manual_seed(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    report = {"device": torch.cuda.get_device_name(0), "k": K, "n": N,
              "rows": {}}
    with torch.inference_mode():
        for m in rows:
            tap = torch.randn((m, K), generator=gen, device=dev).bfloat16()
            w = (torch.randn((K, N), generator=gen, device=dev) * 0.05
                 ).bfloat16()
            b = torch.randn((N,), generator=gen, device=dev) * 0.1
            b_bf16 = b.bfloat16()
            out = torch.empty((m, N), dtype=torch.bfloat16, device=dev)
            plan = lvc_head.head_gemm_plan(m, N, K, sms)

            def launch(lib):
                code = lib.taug_head_launch(
                    tap.data_ptr(), w.data_ptr(), b.data_ptr(),
                    out.data_ptr(), m, N, K, *plan.c_args,
                    torch.cuda.current_stream().cuda_stream)
                _build.check(code, "taug_head_launch")

            launch(libs["kernel"])
            torch.cuda.synchronize()
            err = float((out.float() - lvc_head.taug_head_matmul_plain(
                tap, w, b).float()).abs().max())
            calls = {"addmm": lambda: torch.addmm(b_bf16, tap, w, out=out)}
            for name, lib in libs.items():
                calls[name] = lambda lib=lib: launch(lib)
            order = list(calls) + list(calls)[::-1]
            times = {name: [] for name in calls}
            for name in order:
                times[name].append(graph_ms(calls[name], reps))
            ms = {name: sum(t) / len(t) for name, t in times.items()}
            nbytes = 2.0 * (m * K + K * N + m * N) + 4.0 * N
            host = {"wrapper": host_us(
                        lambda: lvc_head.taug_head_matmul(tap, w, b)),
                    "c_entry": host_us(calls["kernel"]),
                    "addmm": host_us(calls["addmm"])}
            report["rows"][m] = {
                "ms": ms, "runs": times, "max_abs_err": err,
                "host_us_per_call": host,
                "bound_ms": nbytes / 3.35e12 * 1e3,
                "kernel_tb_per_s": nbytes / ms["kernel"] / 1e9}
    return report


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, nargs="*",
                        default=[256, 864, 2000])
    args = parser.parse_args()
    print(json.dumps(run(tuple(args.rows)), indent=1))


if __name__ == "__main__":
    main()
