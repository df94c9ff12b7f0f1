"""The LVC block's matmul stages timed alone at the hop-256 block's scale:
the port's twin of ``scripts/bench_mosaic_micro.py``.

    python -m fastdiff_tpu_torch.scripts.bench_mosaic_micro [--device cuda]

Each stage is a hand-written kernel (K9, ``csrc/stage_micro.cu``) beside
its plain PyTorch version, at L = 221,184 samples (864 frames of hop 256):

- ``conv_stage``: 4 chained (E, 97) @ (97, 32) dots, each output re-fed as
  [y, y, y, 1] (f32 sums, a bf16 rounding between layers), on the tensor
  cores with the layers chained in registers; the grain of its persistent
  walk ``tile_s`` (rows per unit) swept over 256 and the script's tiles
  2,048 / 4,096 / 8,192, every setting's output checked identical to the
  others', and a ragged call (b 2 x 1,000 rows) against plain;
- ``lvc_stage``: one layer's per-frame grouped GEMM, tap (L, 97) @
  kern[l // hop] (97, 64) -> (L, 64) bf16, on the tensor cores; the grain
  of its persistent walk ``tf`` (frames per unit) swept over 1 / 2 / 4 / 8
  (the script's "batched" and "unroll" variants are two Mosaic lowerings
  of the same product and have no counterpart here);
- ``gate_stage``: sigmoid(z[:C]) * tanh(z[C:]) at (L, 64) f32, plain only.

Each kernel setting is raced in turns against one PyTorch call of the same
function (chained ``torch.matmul`` in bf16 for the conv, ``torch.bmm`` over
frames for the LVC; a yardstick the port never calls), both by CUDA-graph
replay (``utils/timing.race_graph``: device time alone), with its plain
version's time (CUDA events) beside them and the least time the card could
take (bytes at 3.35 TB/s or FLOPs at 989 TFLOP/s bf16, the larger). Runs
on the card unless ``--device cpu`` (plain versions only, no times).
"""

from __future__ import annotations

import argparse
import json

import torch

from fastdiff_tpu_torch.models.fastdiff import checked_device
from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.utils.timing import cuda_ms, race_graph

ROWS = 97          # 3 * 32 taps + 1 bias row
C = 32
C2 = 64
LAYERS = 4
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
CONV_TILES = (256, 2048, 4096, 8192)
CONV_TILE_S = 256    # the wrapper's default: the fastest of CONV_TILES
LVC_TFS = (1, 2, 4, 8)
RAGGED = (2, 1000)   # (B, E) of conv_stage's ragged call

# lvc_stage's geometry (csrc/stage_micro.cu, which refuses any other): K = 97
# padded to 7 k16 steps, pieces of at most 256 rows of one frame in a ring
# of 2 stages (one frame's kernels as 112 rows of 128 bytes, a piece's
# 16-byte-aligned tap span with slack), 8 consumer warps of 32 rows each
# with a repacked A buffer of 240-byte rows, mbarriers, 1 KB of alignment
LVC_K_PAD, LVC_PIECE_ROWS, LVC_STAGES, LVC_WARPS = 112, 256, 2, 8
_TAP_STAGE_BYTES, _A_ROW, _SMEM_ALIGN = 49_792, 120, 1024
LVC_SMEM_BYTES = (_SMEM_ALIGN + LVC_STAGES * (LVC_K_PAD * C2 * 2
                                              + _TAP_STAGE_BYTES)
                  + LVC_WARPS * 32 * _A_ROW * 2 + 16 * LVC_STAGES)

# conv_stage's geometry (csrc/stage_micro.cu, which refuses any other):
# lvc_stage's pieces, warps, tap stages and repacked rows in a ring of 2
# stages, beside the weights staged once (layer 0's 112 rows and layers
# 1-3's rows 0..95 as rows of 40 bf16, the `1` column's 3 x 32 weights as
# f32), mbarriers
CONV_STAGES, _W_ROW = 2, 40
CONV_SMEM_BYTES = ((LVC_K_PAD + (LAYERS - 1) * (ROWS - 1)) * _W_ROW * 2
                   + (LAYERS - 1) * C * 4 + CONV_STAGES * _TAP_STAGE_BYTES
                   + LVC_WARPS * 32 * _A_ROW * 2 + 16 * CONV_STAGES)

# launches of the CUDA kernels since the last reset (plain runs not counted)
LAUNCHES = {"conv_stage": 0, "lvc_stage": 0}


def bound_ms(flop: float, nbytes: float) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv_stage_plain(tap: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """tap (B, E, 97), w (layers, 97, C) -> (B, E, C): each layer's dot
    summed in float32 and rounded to tap.dtype, re-fed as [y, y, y, 1]."""
    x = tap
    for i in range(w.shape[0]):
        y = (x.float() @ w[i].float()).to(tap.dtype)
        x = torch.cat([y, y, y, torch.ones_like(y[..., :1])], dim=-1)
    return x[..., :w.shape[-1]]


def lvc_stage_plain(tap: torch.Tensor, kern: torch.Tensor,
                    hop: int) -> torch.Tensor:
    """tap (B, L, 97), kern (B, F, 97, 2C) -> (B, L, 2C): sample l times
    the kernels of frame l // hop, summed in float32, rounded to
    tap.dtype."""
    b, length, rows = tap.shape
    frames = kern.shape[1]
    z = tap.float().reshape(b, frames, hop, rows) @ kern.float()
    return z.reshape(b, length, -1).to(tap.dtype)


def gate_stage(z: torch.Tensor) -> torch.Tensor:
    """The per-layer gate alone: sigmoid(z[..., :C]) * tanh(z[..., C:])."""
    return torch.sigmoid(z[..., :C]) * torch.tanh(z[..., C:])


def _check(fn: str, tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.bfloat16:
            raise ValueError(f"{fn}: operands must be bf16 on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: operands must be contiguous and 16-byte "
                             "aligned")


def conv_stage_grid(rows: int, tile_s: int, sms: int) -> int:
    """Persistent blocks of ``conv_stage``'s kernel: one per SM, or one per
    unit of ``tile_s`` rows if there are fewer units."""
    return min(sms, -(-rows // tile_s))


def conv_stage(tap: torch.Tensor, w: torch.Tensor,
               tile_s: int = CONV_TILE_S) -> torch.Tensor:
    """K9 conv stage: ``conv_stage_plain``'s function on the tensor cores.
    ``tile_s`` (>= 1) is the grain of the kernel's persistent walk: tap's
    B * E rows go to the blocks in units of ``tile_s`` rows, unit u to
    block u % grid, so it sets the balance over the SMs and nothing else;
    every tile_s gives the same output. Raises on any device for shapes the
    kernel does not take (97 rows, w (4, 97, 32), tile_s >= 1); then CPU
    tensors run the plain version and CUDA tensors (bf16, 16-byte aligned)
    launch ``csrc/stage_micro.cu`` or raise."""
    if (tap.dim() != 3 or tap.shape[-1] != ROWS
            or tuple(w.shape) != (LAYERS, ROWS, C) or tile_s < 1):
        raise ValueError(f"conv_stage: tap {tuple(tap.shape)}, w "
                         f"{tuple(w.shape)}, tile_s {tile_s}")
    if tap.device.type == "cpu":
        return conv_stage_plain(tap, w)
    _check("conv_stage", (tap, w))
    b, e, rows = tap.shape
    out = tap.new_empty((b, e, C))
    if out.numel() == 0:
        return out
    grid = conv_stage_grid(b * e, tile_s, torch.cuda.get_device_properties(
        tap.device).multi_processor_count)
    with torch.cuda.device(tap.device):
        code = _build.library().conv_stage_launch(
            tap.data_ptr(), w.data_ptr(), out.data_ptr(), b, e, rows, tile_s,
            CONV_STAGES, CONV_SMEM_BYTES, grid,
            torch.cuda.current_stream().cuda_stream)
    _build.check(code, "conv_stage_launch")
    LAUNCHES["conv_stage"] += 1
    return out


def lvc_stage_grid(b: int, frames: int, tf: int, sms: int) -> int:
    """Persistent blocks of ``lvc_stage``'s kernel: one per SM, or one per
    unit of ``tf`` frames if there are fewer units."""
    return min(sms, b * -(-frames // tf))


def lvc_stage(tap: torch.Tensor, kern: torch.Tensor, hop: int,
              tf: int = 1) -> torch.Tensor:
    """K9 LVC stage: ``lvc_stage_plain``'s function on the tensor cores.
    ``tf`` (>= 1) is the grain of the kernel's persistent walk: the frames
    go to the blocks in units of ``tf`` frames, unit u to block u % grid,
    so it sets the balance over the SMs and nothing else; every tf gives
    the same output. Raises on any device for shapes the kernel does not
    take (97 rows, 2C = 64, F * hop == L, tf >= 1); then CPU tensors run
    the plain version and CUDA tensors (bf16, 16-byte aligned) launch
    ``csrc/stage_micro.cu`` or raise."""
    b, length, rows = tap.shape
    frames = kern.shape[1] if kern.dim() == 4 else 0
    if (rows != ROWS or tuple(kern.shape) != (b, frames, ROWS, C2)
            or tf < 1 or hop < 1 or frames * hop != length):
        raise ValueError(f"lvc_stage: tap {tuple(tap.shape)}, kern "
                         f"{tuple(kern.shape)}, hop {hop}, tf {tf}")
    if tap.device.type == "cpu":
        return lvc_stage_plain(tap, kern, hop)
    _check("lvc_stage", (tap, kern))
    out = tap.new_empty((b, length, C2))
    if out.numel() == 0:
        return out
    grid = lvc_stage_grid(b, frames, tf, torch.cuda.get_device_properties(
        tap.device).multi_processor_count)
    with torch.cuda.device(tap.device):
        code = _build.library().lvc_stage_launch(
            tap.data_ptr(), kern.data_ptr(), out.data_ptr(), b, length,
            frames, hop, rows, tf, LVC_K_PAD, LVC_STAGES, LVC_SMEM_BYTES,
            grid, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "lvc_stage_launch")
    LAUNCHES["lvc_stage"] += 1
    return out


def _conv_library(tap, w):
    """The conv stage as chained bf16 ``torch.matmul`` calls."""
    x = tap
    for i in range(w.shape[0]):
        y = torch.matmul(x, w[i])
        x = torch.cat([y, y, y, torch.ones_like(y[..., :1])], dim=-1)
    return y


def _compare(out: torch.Tensor, ref: torch.Tensor, ulps: int) -> dict:
    """max abs and rel L2 error of ``out`` against ``ref``, and the max abs
    error's bound: f32 sums in another order, one bf16 ulp of the largest
    output per rounding a flip can reach (4 for the chained conv)."""
    diff = out.float() - ref.float()
    return {"max_abs_err": float(diff.abs().max()),
            "rel_l2": float(diff.norm() / ref.float().norm()),
            "err_bound": ulps * 2.0 ** -7 * float(ref.float().abs().max())
            + 1e-6}


def run(device="cuda", hop: int = 256, length: int = 221184,
        reps: int = 20, seed: int = 0) -> dict:
    """Every stage at (1, length) against its plain version: per kernel
    setting its max abs error against the plain output, that error's bound
    and the rel L2 error; whether every setting's output is the same
    (``identical``); ``conv_stage`` at each setting on a ragged (B, E) =
    ``RAGGED`` against plain; on the card each setting's ms raced against
    the library call's (CUDA graphs) and the plain version's ms; the
    bound."""
    dev = checked_device(device)
    frames = length // hop
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * 0.1).to(dtype)

    tap = randn(1, length, ROWS)
    w = randn(LAYERS, ROWS, C)
    kern = randn(1, frames, ROWS, C2)
    z = randn(1, length, C2, dtype=torch.float32)
    tap_ragged = randn(*RAGGED, ROWS)
    timed = dev.type == "cuda"
    report = {"device": torch.cuda.get_device_name(dev) if timed else "cpu",
              "hop": hop, "length": length}
    stages = {
        "conv_stage": (CONV_TILES, "tile_s",
                       lambda p: conv_stage(tap, w, p),
                       lambda: conv_stage_plain(tap, w),
                       lambda: _conv_library(tap, w),
                       # 4 dots; tap read, out written once
                       bound_ms(LAYERS * 2.0 * length * ROWS * C,
                                2.0 * length * (ROWS + C)),
                       4),
        "lvc_stage": (LVC_TFS, "tf",
                      lambda p: lvc_stage(tap, kern, hop, p),
                      lambda: lvc_stage_plain(tap, kern, hop),
                      lambda: torch.bmm(tap.view(frames, hop, ROWS),
                                        kern.view(frames, ROWS, C2)),
                      bound_ms(2.0 * length * ROWS * C2,
                               2.0 * (length * (ROWS + C2)
                                      + frames * ROWS * C2)),
                      1),
    }
    for name, (params, key, kernel, plain, library, bound, ulps) in \
            stages.items():
        ref = plain()
        rows, outs = [], []
        for p in params:
            outs.append(kernel(p))
            row = {key: p, **_compare(outs[-1], ref, ulps)}
            if timed:
                row["ms"], row["library_ms"] = race_graph(
                    library, lambda: kernel(p), reps)
                row["plain_ms"] = cuda_ms(plain, reps)
            rows.append(row)
        report[name] = {"rows": rows, "bound_ms": bound[0],
                        "bound_by": bound[1],
                        "identical": all(torch.equal(o, outs[0])
                                         for o in outs)}
        del outs
    ref = conv_stage_plain(tap_ragged, w)
    report["conv_stage"]["ragged"] = [
        {"tile_s": p, **_compare(conv_stage(tap_ragged, w, p), ref, 4)}
        for p in CONV_TILES]
    if timed:
        report["gate_stage_ms"] = cuda_ms(lambda: gate_stage(z), reps)
    return report


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    print(json.dumps(run(args.device, reps=args.reps), indent=1))


if __name__ == "__main__":
    main()
