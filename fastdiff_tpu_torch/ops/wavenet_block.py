"""DiffWave's residual block (``models/wavenet.py``), one call per block and
reverse step.

For block n with dilation d = 2^(n mod cycle), x (B, C, L), the running
skip sum (B, C_skip, L) f32, t_n = fc_t(t_emb) (B, C) f32 and the mel
(B, T', M) in the compute dtype:

    a = x + t_n                                  (in x's dtype)
    z = conv_d(a) + conv1x1(W_mel, cond(mel))    (B, 2C, L)
    out = tanh(z[:C]) * sigmoid(z[C:])
    x' = (x + conv1x1(W_res, out)) * sqrt(1/2)   (f32)
    skip_sum' = skip_sum + conv1x1(W_skip, out)  (f32)

``wavenet_block_plain`` is that chain as ``WaveNet.forward`` runs it (each
conv in the compute dtype with f32 sums, ``ops/nn.py:conv1d_ncl``; cond and
its projection ``ops/wavenet_cond.py:wavenet_cond_plain``).

On a CUDA tensor ``wavenet_block`` launches the hand-written kernel
(``csrc/wavenet_block.cu``): one launch reads x and the skip sum once and
writes x' and the skip sum once; a, the conditioning, z, the gate, and
the res and skip outputs stay on chip. The dilated conv and the mel
projection share one f32 sum and the gate is taken in f32 from it, so the
kernel rounds fewer times than the plain chain, never more (the source
says where). On a CPU tensor it runs ``wavenet_block_plain``. The kernel
takes bf16, 64 residual and 64 skip channels, 80 mel bins, s = 8 or 16, L
a multiple of 8 and a dilation of at most ``TILE`` or a multiple of 8
(``supports``, ``supports_dilation``, ``fits_length``); it has no
backward, so ``WaveNet`` takes it only with gradients off.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.ops import nn as fnn
from fastdiff_tpu_torch.ops import wavenet_cond
from fastdiff_tpu_torch.ops.lvc_head import sm_count

# launches of the CUDA kernel since the last reset (plain runs not counted)
LAUNCHES = {"wavenet_block": 0}

SQRT_HALF = float(np.float32(math.sqrt(0.5)))

# The kernel's geometry (csrc/wavenet_block.cu, which refuses any other
# shared-memory size): 64 residual and skip channels, 80 mel bins; groups
# of GT threads, GROUPS a block, each on tiles of TILE samples; bf16 rows
# of [W_dil | W_mel] padded to WROW, of [W_res; W_skip] to W2ROW, of the
# sample-major window (at most XROWS rows) to XROW, of the conditioning to
# CROW; f32 mel and stage-1 rows of UROW (bins -1 .. 80).
C = CS = 64
N_MELS = 80
STRIDES = (8, 16)
TILE, GT, GROUPS = 64, 128, 3
THREADS = GROUPS * GT
KX = 3 * C
K1 = KX + N_MELS
WROW, W2ROW, XROW = K1 + 8, C + 8, C + 8
XROWS = 3 * TILE
CROW, UROW = N_MELS + 8, N_MELS + 2
OROW, SROW = C + 8, TILE + 8
SMEM_MAX_BLOCK = 232_448         # the most one block may take
SMEM_RESERVED = 1024             # the runtime's share of each block
LENGTH_MULTIPLE = 8              # 16-byte rows of x


class BlockWeights(NamedTuple):
    """One block's weights, f32, weight norm resolved: the dilated conv
    (2C, C, 3) and (2C,); the upsamplers' ((1, 1, 3, 2s), (1,)) pairs; the
    mel projection (2C, M, 1) and (2C,); the res and skip 1x1 convs (C, C,
    1), (C,) and (C_skip, C, 1), (C_skip,)."""
    w_dil: torch.Tensor
    b_dil: torch.Tensor
    ups: Sequence[Tuple[torch.Tensor, torch.Tensor]]
    mel_w: torch.Tensor
    mel_b: torch.Tensor
    w_res: torch.Tensor
    b_res: torch.Tensor
    w_skip: torch.Tensor
    b_skip: torch.Tensor


def stage1_rows(stride: int) -> int:
    """Stage-1 positions one tile reaches: its TILE / s and one each side."""
    return TILE // stride + 2


def mel_frames(stride: int) -> int:
    """Mel frames one tile's stage-1 positions reach, at most."""
    return (stage1_rows(stride) - 1) // stride + 3


def group_bytes(stride: int) -> int:
    """One group's shared memory: the window and the conditioning tile in
    bf16, the stage-1 and mel rows in f32, rounded up to 128 bytes."""
    rows = stage1_rows(stride) + mel_frames(stride)
    raw = 2 * XROWS * XROW + 2 * TILE * CROW + 4 * UROW * rows
    return -(-raw // 128) * 128


def smem_bytes(stride: int) -> int:
    """Dynamic shared memory of one block: the two weight tiles in bf16,
    GROUPS group regions, the upsamplers' taps, the two bias vectors and the
    two upsampler biases (16 bytes) in f32."""
    return (2 * 2 * C * WROW + 2 * (C + CS) * W2ROW + GROUPS * group_bytes(stride)
            + 4 * (2 * 3 * 2 * stride + 2 * C + C + CS) + 16)


def supports(res_channels: int, skip_channels: int, n_mels: int,
             stride: int, dtype) -> bool:
    """Whether the kernel is built for these widths: 64 residual and skip
    channels, 80 mel bins, s = 8 or 16, bf16."""
    return (dtype == torch.bfloat16 and res_channels == C
            and skip_channels == CS and n_mels == N_MELS
            and stride in STRIDES)


def fits_length(length: int, frames: int, stride: int) -> bool:
    """Whether the kernel takes L samples of conditioning from T' frames:
    L a positive multiple of ``LENGTH_MULTIPLE``, at most T' s^2."""
    return (length > 0 and length % LENGTH_MULTIPLE == 0
            and length <= frames * stride * stride)


def supports_dilation(dilation: int) -> bool:
    """A dilation of at most TILE (one window with a halo rounded up to 8),
    or a multiple of 8 (three segments, 16-byte aligned)."""
    return dilation >= 1 and (dilation <= TILE or dilation % 8 == 0)


def window(dilation: int) -> Tuple[int, Tuple[int, int, int], Tuple[int, ...]]:
    """The window of one tile at dilation d, as the kernel lays it out:
    (rows, the first row of taps 0 / 1 / 2, each row's offset from the
    tile's first sample). Where d <= TILE the rows are [t0 - e, t0 + TILE +
    e), e = d rounded up to 8; else three segments of TILE rows at t0 - d,
    t0 and t0 + d."""
    if dilation <= TILE:
        e = -(-dilation // 8) * 8
        rows = TILE + 2 * e
        return rows, (e - dilation, e, e + dilation), tuple(
            r - e for r in range(rows))
    rows = 3 * TILE
    return rows, (0, TILE, 2 * TILE), tuple(
        (r // TILE - 1) * dilation + r % TILE for r in range(rows))


def launch_grid(batch: int, length: int, sms: int) -> int:
    """The persistent grid: one block an SM, or fewer where the tiles do
    not fill GROUPS groups on each."""
    tiles = batch * -(-length // TILE)
    return min(-(-tiles // GROUPS), sms)


def wavenet_block_plain(x: torch.Tensor, skip_sum: Optional[torch.Tensor],
                        part_t: torch.Tensor, mel: torch.Tensor,
                        w: BlockWeights, *, dilation: int, stride: int,
                        want_x: bool = True):
    """Plain PyTorch version, the chain of ``WaveNet.forward``: x (B, C, L)
    in the compute dtype (block 0) or f32, skip_sum (B, C_skip, L) f32 or
    None (a sum of nothing yet), part_t (B, C) f32, mel (B, T', M) in the
    compute dtype. Returns (x', the new skip sum); x' is None unless
    ``want_x``."""
    dtype = mel.dtype
    c = x.shape[1]
    h = x + part_t[:, :, None].to(x.dtype)
    h = fnn.conv1d_ncl(w.w_dil, w.b_dil, h, dilation=dilation,
                       compute_dtype=dtype)
    h = wavenet_cond.wavenet_cond_plain(h, mel, w.ups, w.mel_w, w.mel_b,
                                        stride=stride)
    out = torch.tanh(h[:, :c]) * torch.sigmoid(h[:, c:])
    x_new = None
    if want_x:
        res = fnn.conv1d_ncl(w.w_res, w.b_res, out, compute_dtype=dtype)
        x_new = (x + res).float() * SQRT_HALF
    skip = fnn.conv1d_ncl(w.w_skip, w.b_skip, out, compute_dtype=dtype)
    skip_sum = skip.float() if skip_sum is None else skip_sum + skip
    return x_new, skip_sum


def check_operands(x: torch.Tensor, skip_sum: Optional[torch.Tensor],
                   part_t: torch.Tensor, mel: torch.Tensor, w: BlockWeights,
                   *, dilation: int, stride: int) -> None:
    """Raise ``ValueError`` unless the kernel takes these operands: x (B,
    64, L) f32, or bf16 (block 0), skip_sum (B, 64, L) f32 or None, part_t
    (B, 64) f32, mel (B, T', 80) bf16, the weights f32 in their shapes, all
    contiguous on x's device, x and skip_sum 16-byte aligned; ``supports``,
    ``supports_dilation`` and ``fits_length`` true."""
    if x.dim() != 3 or mel.dim() != 3 or mel.shape[0] != x.shape[0]:
        raise ValueError(f"wavenet_block: x {tuple(x.shape)}, mel "
                         f"{tuple(mel.shape)}")
    batch, channels, length = x.shape
    frames, n_mels = mel.shape[1], mel.shape[2]
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            mel.dtype != torch.bfloat16:
        raise ValueError(f"wavenet_block: x must be f32 or bf16 and mel "
                         f"bf16, got {x.dtype}, {mel.dtype}")
    skip_channels = w.w_skip.shape[0]
    if not supports(channels, skip_channels, n_mels, stride, mel.dtype):
        raise ValueError(f"wavenet_block: no kernel for {channels} residual "
                         f"and {skip_channels} skip channels, {n_mels} mel "
                         f"bins, stride {stride}")
    if not supports_dilation(dilation):
        raise ValueError(f"wavenet_block: no kernel for dilation {dilation}")
    if not fits_length(length, frames, stride):
        raise ValueError(f"wavenet_block: L = {length} must be a positive "
                         f"multiple of {LENGTH_MULTIPLE}, at most "
                         f"{frames} x {stride}^2")
    (w1, b1), (w2, b2) = w.ups
    shapes = (("w_dil", w.w_dil, (2 * C, C, 3)), ("b_dil", w.b_dil, (2 * C,)),
              ("w1", w1, (1, 1, 3, 2 * stride)), ("b1", b1, (1,)),
              ("w2", w2, (1, 1, 3, 2 * stride)), ("b2", b2, (1,)),
              ("mel_w", w.mel_w, (2 * C, n_mels, 1)),
              ("mel_b", w.mel_b, (2 * C,)),
              ("w_res", w.w_res, (C, C, 1)), ("b_res", w.b_res, (C,)),
              ("w_skip", w.w_skip, (CS, C, 1)), ("b_skip", w.b_skip, (CS,)),
              ("part_t", part_t, (batch, C)))
    if skip_sum is not None:
        shapes += (("skip_sum", skip_sum, (batch, CS, length)),)
    for name, t, shape in shapes:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"wavenet_block: {name} must be f32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, t in [("x", x), ("mel", mel)] + [(n, t) for n, t, _ in shapes]:
        if t.device != x.device:
            raise ValueError(f"wavenet_block: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"wavenet_block: {name} must be contiguous")
    for name, t in (("x", x), ("skip_sum", skip_sum)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"wavenet_block: {name} must be 16-byte aligned")


def wavenet_block(x: torch.Tensor, skip_sum: Optional[torch.Tensor],
                  part_t: torch.Tensor, mel: torch.Tensor, w: BlockWeights,
                  *, dilation: int, stride: int, want_x: bool = True):
    """One residual block, as ``wavenet_block_plain``.

    CPU tensors run ``wavenet_block_plain``. CUDA tensors launch
    ``csrc/wavenet_block.cu`` or raise (``check_operands``); skip_sum is
    updated in place and returned, or written anew where it is None; x' is
    a new f32 tensor, or None unless ``want_x``."""
    if x.device.type == "cpu":
        return wavenet_block_plain(x, skip_sum, part_t, mel, w,
                                   dilation=dilation, stride=stride,
                                   want_x=want_x)
    if x.device.type != "cuda":
        raise ValueError(f"wavenet_block: unsupported device {x.device}")
    check_operands(x, skip_sum, part_t, mel, w, dilation=dilation,
                   stride=stride)
    batch, channels, length = x.shape
    frames, n_mels = mel.shape[1], mel.shape[2]
    (w1, b1), (w2, b2) = w.ups
    skip_read = skip_sum is not None
    if skip_sum is None:
        skip_sum = torch.empty((batch, CS, length), device=x.device)
    x_out = torch.empty((batch, C, length), device=x.device) if want_x \
        else None
    smem = smem_bytes(stride)
    grid = launch_grid(batch, length, sm_count(x.device.index))
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.wavenet_block_launch(
            x.data_ptr(), x_out.data_ptr() if want_x else None,
            skip_sum.data_ptr(), part_t.data_ptr(), mel.data_ptr(),
            w.w_dil.data_ptr(), w.b_dil.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), w.mel_w.data_ptr(),
            w.mel_b.data_ptr(), w.w_res.data_ptr(), w.b_res.data_ptr(),
            w.w_skip.data_ptr(), w.b_skip.data_ptr(), batch, channels, CS,
            length, frames, n_mels, stride, dilation,
            int(x.dtype == torch.bfloat16), int(skip_read), grid, smem,
            stream)
    _build.check(code, "wavenet_block_launch")
    LAUNCHES["wavenet_block"] += 1
    return x_out, skip_sum
