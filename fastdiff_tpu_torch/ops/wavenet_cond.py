"""DiffWave's per-block mel conditioning: its two upsamplers, the 1x1
projection and the add into the block's dilated-conv output.

For residual block n of ``models/wavenet.py`` (mel (B, T', M), h (B, 2C, L)
the dilated conv's output, L <= T' s^2):

    cond = act(up_2(act(up_1(mel))))[..., :L]     (B, M, L)
    h    = h + conv1x1(W_mel, b_mel, cond)        (B, 2C, L)

each ``up`` a weight-normed ConvTranspose2d(1, 1, (3, 2s), stride (1, s),
padding (1, s // 2)) over (mel bins, frames) and ``act`` its bias and leaky
ReLU 0.4 (``upsample_plain``).

The plain version here is what ``ops/wavenet_block.py:wavenet_block_plain``
runs (differentiable, any widths); the block kernel
(``csrc/wavenet_block.cu``) builds the same conditioning on chip with the
stages of ``csrc/wavenet_cond.cuh``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fastdiff_tpu_torch.ops import nn as fnn


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

