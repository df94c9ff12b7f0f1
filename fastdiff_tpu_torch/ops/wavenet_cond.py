"""DiffWave's per-block mel conditioning: its two upsamplers, the 1x1
projection and the add into the block's dilated-conv output.

For residual block n of ``models/wavenet.py`` (mel (B, T', M), h (B, 2C, L)
the dilated conv's output, L <= T' s^2):

    cond = act(up_2(act(up_1(mel))))[..., :L]     (B, M, L)
    h    = h + conv1x1(W_mel, b_mel, cond)        (B, 2C, L)

each ``up`` a weight-normed ConvTranspose2d(1, 1, (3, 2s), stride (1, s),
padding (1, s // 2)) over (mel bins, frames) and ``act`` its bias and leaky
ReLU 0.4 (``upsample_plain``).

On a CUDA tensor ``wavenet_cond`` launches the hand-written kernel
(``csrc/wavenet_cond.cu``), which rebuilds the conditioning of each tile of
samples from the mel in shared memory and adds the projection into h in
place, so neither the (B, M, L) conditioning nor the (B, 2C, L) projection
reaches device memory; on a CPU tensor it runs ``wavenet_cond_plain``. The
kernel takes bf16 h and mel, 2C a multiple of 64 up to 256, 80 mel bins,
s = 8 or 16 and L a multiple of 8 (``supports``, ``fits_length``); it has no
backward, so ``WaveNet`` takes it only with gradients off, and runs
``wavenet_cond_plain`` (differentiable) otherwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.ops import nn as fnn
from fastdiff_tpu_torch.ops.lvc_head import sm_count

# launches of the CUDA kernel since the last reset (plain runs not counted)
LAUNCHES = {"wavenet_cond": 0}

# The kernel's geometry (csrc/wavenet_cond.cu, which refuses any other
# shared-memory size): tiles of TILE samples, output channels in passes of
# CH_TILE up to MAX_CH2, 80 mel bins; bf16 rows of W_mel and the
# conditioning padded to CROW, of the staged h to HROW, f32 mel and stage-1
# rows of UROW (bins -1 .. 80).
TILE, CH_TILE, MAX_CH2 = 128, 64, 256
N_MELS = 80
STRIDES = (8, 16)
BLOCKS_PER_SM = 2
CROW, HROW, UROW = N_MELS + 8, TILE + 8, N_MELS + 2
SMEM_PER_SM = 233_472            # an H100 SM's shared memory
SMEM_RESERVED = 1024             # the runtime's share of each block
LENGTH_MULTIPLE = 8              # 16-byte rows of h


def stage1_rows(stride: int) -> int:
    """Stage-1 positions one tile reaches: its TILE / s and one each side."""
    return TILE // stride + 2


def mel_frames(stride: int) -> int:
    """Mel frames one tile's stage-1 positions reach, at most."""
    return (stage1_rows(stride) - 1) // stride + 3


def smem_bytes(ch2: int, stride: int) -> int:
    """Dynamic shared memory of one block: W_mel, the h tile and the
    conditioning tile in bf16, the upsamplers' taps, the projection's bias,
    the two upsampler biases (16 bytes) and the stage-1 and mel rows in
    f32."""
    return (ch2 * (2 * CROW + 2 * HROW + 4) + 2 * TILE * CROW
            + 4 * (2 * 3 * 2 * stride) + 16
            + 4 * UROW * (stage1_rows(stride) + mel_frames(stride)))


def supports(ch2: int, n_mels: int, stride: int, dtype) -> bool:
    """Whether the kernel is built for these widths: 2C a multiple of
    CH_TILE up to MAX_CH2, 80 mel bins, s = 8 or 16, bf16."""
    return (dtype == torch.bfloat16 and n_mels == N_MELS
            and stride in STRIDES and 0 < ch2 <= MAX_CH2
            and ch2 % CH_TILE == 0)


def fits_length(length: int, frames: int, stride: int) -> bool:
    """Whether the kernel takes L samples of conditioning from T' frames."""
    return (length > 0 and length % LENGTH_MULTIPLE == 0
            and length <= frames * stride * stride)


def launch_grid(batch: int, length: int, ch2: int, stride: int,
                sms: int) -> int:
    """The persistent grid: every tile, or as many blocks as fit on the
    card's SMs at once, whichever is fewer."""
    per_sm = min(BLOCKS_PER_SM, SMEM_PER_SM
                 // (smem_bytes(ch2, stride) + SMEM_RESERVED))
    return min(batch * -(-length // TILE), per_sm * sms)


def upsample_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   stride: int, dtype) -> torch.Tensor:
    """One upsampler: x (B, 1, M, W) -> (B, 1, M, W s) in ``dtype``: the
    transposed conv on float32 copies of x and of the kernel w (1, 1, 3, 2s)
    rounded to ``dtype``, rounded to ``dtype``; + the bias b (1,) in
    ``dtype``; leaky ReLU 0.4."""
    y = F.conv_transpose2d(x.float(), w.to(dtype).float(), stride=(1, stride),
                           padding=(1, stride // 2)).to(dtype)
    y = y + b.to(dtype)
    return fnn.leaky_relu(y, 0.4).to(dtype)


def wavenet_cond_plain(h: torch.Tensor, mel: torch.Tensor, ups,
                       mel_w: torch.Tensor, mel_b: torch.Tensor, *,
                       stride: int) -> torch.Tensor:
    """Plain PyTorch version: h (B, 2C, L) + the projection of the
    upsampled mel (B, T', M), both in the compute dtype (h's). ``ups`` is
    the two upsamplers' ((1, 1, 3, 2s) kernel, (1,) bias), mel_w (2C, M, 1)
    and mel_b (2C,) the projection's weight and bias, all float32."""
    dtype = h.dtype
    cond = mel.transpose(1, 2)[:, None]
    for w, b in ups:
        cond = upsample_plain(cond, w, b, stride, dtype)
    cond = cond[:, 0, :, :h.shape[-1]]
    return h + fnn.conv1d_ncl(mel_w, mel_b, cond, compute_dtype=dtype)


def wavenet_cond(h: torch.Tensor, mel: torch.Tensor, ups,
                 mel_w: torch.Tensor, mel_b: torch.Tensor, *,
                 stride: int) -> torch.Tensor:
    """h + the projection of the upsampled mel, as ``wavenet_cond_plain``.

    CPU tensors run ``wavenet_cond_plain``. CUDA tensors launch
    ``csrc/wavenet_cond.cu``, which writes the result into h and returns
    it, or raise: h (B, 2C, L) (16-byte aligned) and mel (B, T', 80) bf16
    and contiguous, ``supports`` and ``fits_length`` true, the weights
    float32 and contiguous on h's device."""
    if h.device.type == "cpu":
        return wavenet_cond_plain(h, mel, ups, mel_w, mel_b, stride=stride)
    if h.device.type != "cuda":
        raise ValueError(f"wavenet_cond: unsupported device {h.device}")
    (w1, b1), (w2, b2) = ups
    batch, ch2, length = h.shape
    if mel.dim() != 3 or mel.shape[0] != batch:
        raise ValueError(f"wavenet_cond: mel {tuple(mel.shape)} for h "
                         f"{tuple(h.shape)}")
    frames, n_mels = mel.shape[1], mel.shape[2]
    if h.dtype != torch.bfloat16 or mel.dtype != torch.bfloat16:
        raise ValueError(f"wavenet_cond: h and mel must be bf16, got "
                         f"{h.dtype}, {mel.dtype}")
    if not supports(ch2, n_mels, stride, h.dtype):
        raise ValueError(f"wavenet_cond: no kernel for 2C = {ch2}, {n_mels} "
                         f"mel bins, stride {stride}")
    if not fits_length(length, frames, stride):
        raise ValueError(f"wavenet_cond: L = {length} must be a positive "
                         f"multiple of {LENGTH_MULTIPLE}, at most "
                         f"{frames} x {stride}^2")
    shapes = (("w1", w1, (1, 1, 3, 2 * stride)), ("b1", b1, (1,)),
              ("w2", w2, (1, 1, 3, 2 * stride)), ("b2", b2, (1,)),
              ("mel_w", mel_w, (ch2, n_mels, 1)), ("mel_b", mel_b, (ch2,)))
    for name, t, shape in shapes:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"wavenet_cond: {name} must be f32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, t in (("h", h), ("mel", mel)) + tuple(
            (name, t) for name, t, _ in shapes):
        if t.device != h.device:
            raise ValueError(f"wavenet_cond: {name} on {t.device}, h on "
                             f"{h.device}")
        if not t.is_contiguous():
            raise ValueError(f"wavenet_cond: {name} must be contiguous")
    if h.data_ptr() % 16:
        raise ValueError("wavenet_cond: h must be 16-byte aligned")
    smem = smem_bytes(ch2, stride)
    grid = launch_grid(batch, length, ch2, stride, sm_count(h.device.index))
    lib = _build.library()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.wavenet_cond_launch(
            h.data_ptr(), mel.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), mel_w.data_ptr(), mel_b.data_ptr(),
            batch, ch2, length, frames, n_mels, stride, grid, smem, stream)
    _build.check(code, "wavenet_cond_launch")
    LAUNCHES["wavenet_cond"] += 1
    return h
