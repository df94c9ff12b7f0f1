"""The whole 4-layer LVC block, NCL: Kernel B and its operands.

Counterpart of ``fastdiff_tpu/ops/lvc_block_ncl.py:lvc_block_ncl_aug`` (with
and without its ``final_wb`` epilogue). Layer i of the block, d = 3^i:

    s     = carry + skip
    y     = leaky0.2(W_i . [a(t-d); a; a(t+d); 1]),   a = leaky0.2(s)
    z     = K_{i,f} . [y(t-1); y; y(t+1); 1]          per frame f = t // hop
    carry = s + sigmoid(z[:C]) * tanh(z[C:])

``W_i`` is row i of ``wstack_t`` (layers, C, 3C+1), its last column the conv
bias; ``K_{i,f}`` is ``kern_taug[b, f, i, :, :3C+1]`` from the predictor head
(``ops/lvc_head.py``). With ``final_wb`` (8, C) the block also returns the
model's final k=7 C->1 conv of the carry, in float32.

The JAX kernel only fuses blocks whose hop and frame count fit its tiling
(``fusable``); Kernel B takes any hop >= 1 and any frame count, so every
block of every request runs through it. On a CUDA tensor
``lvc_block_ncl`` launches ``csrc/lvc_block_ncl.cu``; on a CPU tensor it
runs the plain version, which keeps the kernel's cast points.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.ops.lvc import lvc_gated_residual
from fastdiff_tpu_torch.ops.nn import leaky_relu

# launches of the CUDA kernel since the last reset (plain runs not counted)
LAUNCHES = {"lvc_block_ncl": 0, "lvc_block_ncl_final": 0}

# what csrc/lvc_block_ncl.cu is built for
KERNEL_CHANNELS = 32
KERNEL_LAYERS = 4


def stack_conv_weights(conv_ws, conv_bs, dtype=torch.bfloat16) -> torch.Tensor:
    """Dilated k=3 conv weights (C, C, 3) + biases (C,) -> wstack_t
    (layers, C, 3C+1) with wstack_t[i, o, k*C + c] = W_i[o, c, k] and the
    bias in the last column."""
    rows = [torch.cat([w.permute(0, 2, 1).reshape(w.shape[0], -1),
                       b[:, None]], dim=1)
            for w, b in zip(conv_ws, conv_bs)]
    return torch.stack(rows).to(dtype).contiguous()


def final_conv_wb(w: torch.Tensor, b: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Final conv weight (1, C, 7) + bias (1,) -> (8, C): rows 0..6 the taps,
    row 7 the bias in every column."""
    taps = w[0].t()
    return torch.cat([taps, b.reshape(1, 1).expand(1, w.shape[1])],
                     dim=0).to(dtype).contiguous()


def lvc_block_ncl_plain(x: torch.Tensor, skip: torch.Tensor,
                        kern_taug: torch.Tensor, wstack_t: torch.Tensor,
                        hop: int, final_wb: torch.Tensor | None = None):
    """Plain PyTorch Kernel B, with the kernel's cast points: sums in
    float32, s / y / the gate rounded to x.dtype where the kernel rounds."""
    b, c, length = x.shape
    _, frames, layers, c2, _ = kern_taug.shape
    rows = 3 * c
    carry = x
    for i in range(layers):
        d = 3 ** i
        s = carry + skip
        a = leaky_relu(s)
        w = wstack_t[i, :, :rows].reshape(c, 3, c).permute(0, 2, 1)
        y = F.conv1d(a.float(), w.float(), wstack_t[i, :, rows].float(),
                     padding=d, dilation=d)
        y = leaky_relu(y).to(x.dtype)
        k_i = kern_taug[:, :, i]                             # (B, F, 2C, R)
        kernel = k_i[..., :rows].reshape(b, frames, c2, 3, c).permute(
            0, 1, 3, 4, 2)                                   # (B, F, 3, C, 2C)
        carry = lvc_gated_residual(s, y, kernel, k_i[..., rows], hop)
    if final_wb is None:
        return carry
    fin = F.conv1d(carry.float(), final_wb[:7].float().t()[None],
                   final_wb[7, :1].float(), padding=3)
    return carry, fin


def _check_cuda_operands(x, skip, kern_taug, wstack_t, hop, final_wb):
    b, c, length = x.shape
    if kern_taug.dim() != 5:
        raise ValueError(f"kern_taug must be 5-D, got {tuple(kern_taug.shape)}")
    _, frames, layers, c2, rows_p = kern_taug.shape
    named = [("x", x), ("skip", skip), ("kern_taug", kern_taug),
             ("wstack_t", wstack_t)]
    if final_wb is not None:
        named.append(("final_wb", final_wb))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"lvc_block_ncl: {name} on {t.device}, "
                             f"x on {x.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"lvc_block_ncl: {name} must be bf16, "
                             f"got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"lvc_block_ncl: {name} must be contiguous and "
                             "16-byte aligned")
    if c != KERNEL_CHANNELS or layers != KERNEL_LAYERS:
        raise ValueError(f"lvc_block_ncl: the kernel is built for C="
                         f"{KERNEL_CHANNELS}, {KERNEL_LAYERS} layers; got "
                         f"C={c}, {layers} layers")
    if (skip.shape != x.shape or kern_taug.shape[0] != b or c2 != 2 * c
            or rows_p % 8 or rows_p < 3 * c + 1 or hop < 1
            or frames * hop != length
            or wstack_t.shape != (layers, c, 3 * c + 1)
            or (final_wb is not None and final_wb.shape != (8, c))):
        raise ValueError(
            f"lvc_block_ncl: bad shapes x {tuple(x.shape)}, skip "
            f"{tuple(skip.shape)}, kern_taug {tuple(kern_taug.shape)}, "
            f"wstack_t {tuple(wstack_t.shape)}, hop {hop}")


def lvc_block_ncl(x: torch.Tensor, skip: torch.Tensor,
                  kern_taug: torch.Tensor, wstack_t: torch.Tensor, hop: int,
                  final_wb: torch.Tensor | None = None):
    """Kernel B: x, skip (B, C, L); kern_taug (B, F, layers, 2C, rows_p);
    wstack_t (layers, C, 3C+1); L == F * hop -> carry (B, C, L), plus
    (B, 1, L) float32 when ``final_wb`` (8, C) is given.

    CPU tensors run ``lvc_block_ncl_plain``. CUDA tensors (all bf16, C = 32,
    4 layers) launch ``csrc/lvc_block_ncl.cu`` or raise."""
    if x.device.type == "cpu":
        return lvc_block_ncl_plain(x, skip, kern_taug, wstack_t, hop,
                                   final_wb)
    if x.device.type != "cuda":
        raise ValueError(f"lvc_block_ncl: unsupported device {x.device}")
    _check_cuda_operands(x, skip, kern_taug, wstack_t, hop, final_wb)
    b, c, length = x.shape
    _, frames, layers, _, rows_p = kern_taug.shape
    out = torch.empty_like(x)
    fin = (torch.empty((b, 1, length), dtype=torch.float32, device=x.device)
           if final_wb is not None else None)
    if b == 0 or length == 0:
        return out if fin is None else (out, fin)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lvc_block_ncl_launch(
            x.data_ptr(), skip.data_ptr(), kern_taug.data_ptr(),
            wstack_t.data_ptr(),
            None if final_wb is None else final_wb.data_ptr(),
            out.data_ptr(), None if fin is None else fin.data_ptr(),
            b, c, length, frames, hop, rows_p, layers, stream)
    _build.check(code, "lvc_block_ncl_launch")
    if fin is None:
        LAUNCHES["lvc_block_ncl"] += 1
        return out
    LAUNCHES["lvc_block_ncl_final"] += 1
    return out, fin
