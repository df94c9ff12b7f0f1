"""Build ``csrc/*.cu`` with ``nvcc`` into one shared library, load it with ctypes.

The library has a plain C interface (no PyTorch headers), so a cold build
takes seconds: one ``nvcc -c`` per source, all started together, then one
link. It goes to ``build/kernels/`` at the repository root, named by a hash
of the sources (``*.cu`` and the ``*.cuh`` they include), and is built on
first use: a run from a clean checkout builds it once, and an edited source
never loads a stale binary. ``nvcc``'s resource report (``-Xptxas -v``:
registers, shared memory, spills per kernel) is kept beside it as
``build.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types. Each returns cudaGetLastError().
SIGNATURES = {
    # tap, w_head, b_head, out, M, N, K, then lvc_head.head_gemm_plan's
    # tile_m, tile_n, stages, units, grid, smem; stream
    "taug_head_launch": [_P, _P, _P, _P, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _P],
    # x, skip, kern, wstack_t, final_wb (or NULL), out, fin (or NULL),
    # B, C, L, F, hop, rows_p, layers, then lvc_block_ncl.block_tile_plan's
    # tile; stream (hop % 8 == 0)
    "lvc_block_ncl_launch": [_P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, skip, kern, wstack_t, out, s_all, y_all, z_all,
    # B, C, L, F, hop, rows_p, layers, then block_tile_plan's tile; stream
    # (hop % 8 == 0)
    "lvc_block_ncl_sr_launch": [_P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # tap, w_aug, b_aug, out, M, N, K, tile_m, tile_n, stages, units,
    # grid, smem, stream
    "aug_head_launch": [_P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _P],
    # x, skip, kern_aug, wstack, out, B, C, L, F, hop, rows, layers, then
    # lvc_block_pallas.nwc_tile_plan's tile and shared memory; stream
    # (hop % 8 == 0)
    "lvc_block_nwc_launch": [_P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # audio, first_aug, res_aug, conv_aug, skip0, skip1, skip2, x,
    # B, L, C, stream
    "downpath_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # audio, first_aug, res_aug, conv_aug, bias (f32), skip0, skip1, skip2,
    # x (NCL), B, L, C, stream (L % 2048 == 0)
    "downpath_ncl_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _P],
    # x, skip, tap_c, w_head, b_head, wstack_t, final_wb (or NULL), out,
    # fin (or NULL), B, C, L, F, hop, khead, rows_p, layers, then
    # lvc_block_ncl.fh_tile_plan's tile, frames, grid and shared memory;
    # stream (hop % 8 == 0)
    "lvc_block_ncl_fh_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _P],
    # as taug_head_launch, then lvc_head.head_gemm_walk_plan's stripe
    "taug_head_variant_launch": [_P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _P],
    # tap, w, out, B, E, rows, tile_s, then the kernel's geometry (ring
    # stages, shared memory) and its grid; stream
    "conv_stage_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # tap, kern, out, B, L, F, hop, rows, tf, then the kernel's geometry
    # (padded K, ring stages, shared memory) and its grid; stream
    "lvc_stage_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _P],
    # x, x_out (or NULL), skip, part_t, mel, w_dil, b_dil, w1, b1, w2, b2,
    # w_mel, b_mel, w_res, b_res, w_skip, b_skip, B, C, C_skip, L, T',
    # n_mels, stride, dilation, x_bf16, skip_read, then
    # wavenet_block.launch_grid's grid and smem_bytes; stream
    "wavenet_block_launch": [_P] * 17 + [_I] * 12 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfastdiff_kernels_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels if this source set has no library yet: every
    source in its own ``nvcc -c`` process, all at once, then one link."""
    target = library_path()
    if target.exists():
        return target
    objs = BUILD_DIR / f"obj.{os.getpid()}"
    objs.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    procs = [(src, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(objs / f"{src.stem}.o"),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for src in sources]
    logs, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out[-4000:]}")
    if not failed:
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp),
             *[str(objs / f"{src.stem}.o") for src in sources]],
            capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr[-4000:]}")
    (BUILD_DIR / "build.log").write_text("".join(logs))
    shutil.rmtree(objs, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, target)
    return target


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.fastdiff_cuda_error_string.argtypes = [_I]
    lib.fastdiff_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (launch refused,
    bad configuration, or an earlier asynchronous fault)."""
    if code != 0:
        msg = library().fastdiff_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
