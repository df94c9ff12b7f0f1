"""The NWC LVC block and its row-major head: K6, K7 and their operands.

Counterpart of ``fastdiff_tpu/ops/lvc_block_pallas.py``, the kernels of the
NWC route (``use_pallas_block: true``). Activations are (B, L, C), channels
minor. The block's math is the NCL block's (``ops/lvc_block_ncl.py``); only
the layouts differ:

- ``kern_aug`` (B, F, layers, 3C+1, 2C): per frame and layer, contraction
  row r < 3C holds tap r // C, input channel r % C, and row 3C the bias;
  no padding (``augment_lvc_kernels``);
- ``wstack`` (layers, 3C+1, C): the dilated conv weights in the same row
  order, the bias in row 3C (``stack_conv_weights``).

Two kernels:

- **K6**, ``lvc_block_nwc``: the whole 4-layer block. At hops that are
  multiples of 8 it is ``csrc/lvc_block_nwc_tc.cu``, on the tensor cores
  with the stages of ``csrc/lvc_block_tc.cuh`` and a tile from
  ``nwc_tile_plan``; there is no kernel at other hops. The route calls it
  where JAX's ``fusable`` admits the block (hop >= 64, at least 2 frames).
- **K7**, ``aug_head_matmul``: the predictor head ``tap @ w_aug + b_aug``
  written row-major, which read as (B, F, layers, 3C+1, 2C) is ``kern_aug``
  with no copy. It is ``csrc/taug_head.cu``'s GEMM: K3 and K7 differ only in
  the column order of the packed weights.

On a CUDA tensor each wrapper launches its kernel or raises (K6 raises at
a hop ``tensor_core_hop`` refuses, which no configuration has); on a CPU
tensor it runs the plain version beside it.

The trainable NWC route (``use_pallas_block: true`` in training, JAX's
``nwc_vjp``) runs both under autograd: ``AugHead`` is K7 forward with the
plain matmul VJP (JAX's ``_aug_head_bwd``), ``LVCBlockNWCRecompute`` is K6
forward with a backward that recomputes ``lvc_block_nwc_plain`` and
differentiates it (JAX's ``_aug_bwd`` through ``_unfused_from_aug``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.ops.lvc import lvc_gated_residual_nwc
from fastdiff_tpu_torch.ops.lvc_block_ncl import (BlockPlan, TC_APAD,
                                                  TC_HALO, TC_ROW, TC_WROW,
                                                  TC_YPAD, _sm_count,
                                                  block_tile_plan, check_hop)
from fastdiff_tpu_torch.ops.lvc_head import (head_matmul_backward,
                                             launch_head_gemm)
from fastdiff_tpu_torch.ops.nn import leaky_relu

# launches of the CUDA kernels since the last reset (plain runs not
# counted): lvc_block_nwc K6, aug_head K7
LAUNCHES = {"lvc_block_nwc": 0, "aug_head": 0}

# what csrc/lvc_block_nwc_tc.cu is built for
KERNEL_CHANNELS = 32
KERNEL_LAYERS = 4
_MIN_FUSED_HOP = 64

# the tensor-core K6's ring of K_{i,f} slabs (csrc/lvc_block_nwc_tc.cu)
NWC_STAGES = 2
NWC_SLOT = 13_312            # one 12,416-byte slab in 13 swizzle atoms
NWC_ALIGN = 1024


def nwc_smem_bytes(ext: int) -> int:
    """Dynamic shared memory of a tensor-core K6 block whose extent is
    ``ext`` samples (``tc::nwc_smem_bytes``): the alignment slack, the conv's
    input ``a`` sharing its bytes with the ring of K_{i,f} slabs, carry,
    ybuf with its pad rows, W_i, its bias and two mbarriers."""
    union = max((ext + 2 * TC_APAD) * TC_ROW * 2, NWC_STAGES * NWC_SLOT)
    return (NWC_ALIGN + union + (2 * ext + 2 * TC_YPAD) * TC_ROW * 2
            + KERNEL_CHANNELS * TC_WROW * 2 + KERNEL_CHANNELS * 4 + 16)


def nwc_tile_plan(b: int, length: int, sms: int = 132) -> BlockPlan:
    """The tensor-core K6's tile for a (b, length, C) block call: K1's
    (``block_tile_plan``: waves x extent, two blocks per SM), with K6's
    shared memory."""
    plan = block_tile_plan(b, length, sms)
    return plan._replace(smem_bytes=nwc_smem_bytes(plan.ext))


def aug_rows(c: int, k: int = 3) -> int:
    """Contraction rows of the augmented operands: K*C taps + 1 bias row."""
    return k * c + 1


def fusable(hop: int, n_frames: int) -> bool:
    """JAX's route gate for the fused NWC block (``fusable``)."""
    return hop >= _MIN_FUSED_HOP and n_frames >= 2


def stack_conv_weights(conv_ws, conv_bs, dtype=torch.bfloat16) -> torch.Tensor:
    """Dilated k=3 conv weights (C, C, 3) in PyTorch's (O, I, K) layout +
    biases (C,) -> wstack (layers, 3C+1, C) with wstack[i, k*C + c, o] =
    W_i[o, c, k] and the bias in row 3C."""
    rows = [torch.cat([w.permute(2, 1, 0).reshape(-1, w.shape[0]),
                       b[None, :]], dim=0)
            for w, b in zip(conv_ws, conv_bs)]
    return torch.stack(rows).to(dtype).contiguous()


def augment_lvc_kernels(kernels: torch.Tensor,
                        biases: torch.Tensor) -> torch.Tensor:
    """(B, F, layers, K, C, 2C) kernels + (B, F, layers, 2C) biases
    -> kern_aug (B, F, layers, K*C+1, 2C), the bias in the last row."""
    b, f, layers, k, c, c2 = kernels.shape
    kflat = kernels.reshape(b, f, layers, k * c, c2)
    return torch.cat([kflat, biases[..., None, :].to(kflat.dtype)], dim=3)


def split_aug_kernels(kern_aug: torch.Tensor, k: int = 3) -> tuple:
    """Inverse of ``augment_lvc_kernels``: -> (kernels, biases)."""
    b, f, layers, rows, c2 = kern_aug.shape
    c = (rows - 1) // k
    kernels = kern_aug[..., :k * c, :].reshape(b, f, layers, k, c, c2)
    return kernels, kern_aug[..., k * c, :]


def pack_aug_head(kernel_w: torch.Tensor, kernel_b: torch.Tensor,
                  bias_w: torch.Tensor, bias_b: torch.Tensor, *, layers: int,
                  c: int, k: int = 3, dtype=torch.bfloat16) -> tuple:
    """Merge the predictor heads into K7's (w_aug, b_aug), as JAX's
    ``_kernel_predictor_apply_aug`` does: kernel_w (layers*K*C*2C, hid,
    ksz) with output channels in (layers, K, C, 2C) order, bias_w
    (layers*2C, hid, ksz). Returns w_aug (ksz*hid, layers*(K*C+1)*2C) in
    ``dtype``, contraction index tap*hid + h, and b_aug float32."""
    cout = 2 * c
    _, hid, ksz = kernel_w.shape
    kw = kernel_w.permute(2, 1, 0).reshape(ksz, hid, layers, k * c, cout)
    bw = bias_w.permute(2, 1, 0).reshape(ksz, hid, layers, 1, cout)
    w = torch.cat([kw, bw], dim=3).reshape(ksz * hid, -1).to(dtype)
    b = torch.cat([kernel_b.reshape(layers, k * c, cout),
                   bias_b.reshape(layers, 1, cout)], dim=1).reshape(-1)
    return w.contiguous(), b.float().contiguous()


def aug_head_matmul_plain(tap: torch.Tensor, w_aug: torch.Tensor,
                          b_aug: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K7: f32 accumulate, f32 bias, round to tap.dtype."""
    return (tap.float() @ w_aug.float() + b_aug.float()).to(tap.dtype)


def aug_head_matmul(tap: torch.Tensor, w_aug: torch.Tensor,
                    b_aug: torch.Tensor) -> torch.Tensor:
    """K7: tap (M, K) @ w_aug (K, N) + b_aug (N,) -> (M, N) row-major.

    CPU tensors run ``aug_head_matmul_plain``. CUDA tensors launch
    ``csrc/taug_head.cu`` (bf16 tap and weights, f32 bias, K a multiple of
    8 and at most 256, N of 16) or raise. JAX falls back to ``jnp.dot`` where no
    128-multiple tile divides N, a TPU tiling limit the card does not
    have."""
    if tap.device.type == "cpu":
        return aug_head_matmul_plain(tap, w_aug, b_aug)
    out = launch_head_gemm("aug_head_launch", "aug_head_matmul", tap, w_aug,
                           b_aug, n_multiple=16)
    if out.shape[0]:
        LAUNCHES["aug_head"] += 1
    return out


class AugHead(torch.autograd.Function):
    """Trainable K7: ``apply(tap, w_aug, b_aug)`` runs ``aug_head_matmul``;
    the backward is JAX's ``_aug_head_bwd``, the plain matmul VJP (JAX too
    computes it outside any kernel): dtap = g @ w_aug^T rounded to tap's
    dtype, dw = tap^T @ g rounded to w_aug's dtype, db = sum of g in
    float32."""

    @staticmethod
    def forward(ctx, tap, w_aug, b_aug):
        ctx.save_for_backward(tap, w_aug)
        ctx.b_dtype = b_aug.dtype
        return aug_head_matmul(tap, w_aug, b_aug)

    @staticmethod
    def backward(ctx, g):
        return head_matmul_backward(*ctx.saved_tensors, ctx.b_dtype, g)


def unfused_reference(x, skip, kernels, biases, conv_ws, conv_bs,
                      hop: int) -> torch.Tensor:
    """JAX's ``_unfused_reference``: x, skip (B, L, C); kernels (B, F,
    layers, K, C, 2C); biases (B, F, layers, 2C); conv_ws (layers, K, C, C)
    in JAX's (K, I, O) order per layer; conv_bs (layers, C). Sums in
    float32; s, y and the gate rounded to x.dtype where JAX rounds."""
    dtype = x.dtype
    for i in range(kernels.shape[2]):
        d = 3 ** i
        x = x + skip
        w = conv_ws[i].to(dtype).permute(2, 1, 0)            # (O, I, K)
        yc = F.conv1d(leaky_relu(x).transpose(1, 2).float(), w.float(),
                      padding=d, dilation=d).transpose(1, 2)
        y = leaky_relu((yc + conv_bs[i].float()).to(dtype))
        x = lvc_gated_residual_nwc(x, y, kernels[:, :, i].to(dtype),
                                   biases[:, :, i].float(), hop)
    return x


def lvc_block_nwc_plain(x: torch.Tensor, skip: torch.Tensor,
                        kern_aug: torch.Tensor, wstack: torch.Tensor,
                        hop: int) -> torch.Tensor:
    """Plain PyTorch K6 (JAX's ``_unfused_from_aug``): the block from the
    augmented operands through ``unfused_reference``."""
    kernels, biases = split_aug_kernels(kern_aug)
    c = x.shape[-1]
    conv_ws = wstack[:, :3 * c].reshape(wstack.shape[0], 3, c, c)
    return unfused_reference(x, skip, kernels, biases.float(), conv_ws,
                             wstack[:, 3 * c].float(), hop)


def _check_cuda_operands(x, skip, kern_aug, wstack, hop):
    check_hop(hop, "lvc_block_nwc")
    b, length, c = x.shape
    if kern_aug.dim() != 5:
        raise ValueError(f"kern_aug must be 5-D, got {tuple(kern_aug.shape)}")
    _, frames, layers, rows, c2 = kern_aug.shape
    for name, t in (("x", x), ("skip", skip), ("kern_aug", kern_aug),
                    ("wstack", wstack)):
        if t.device != x.device:
            raise ValueError(f"lvc_block_nwc: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"lvc_block_nwc: {name} must be bf16, got "
                             f"{t.dtype}")
        # the tensor-core kernel's TMA reads kern_aug in swizzled boxes
        align = 128 if name == "kern_aug" else 16
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"lvc_block_nwc: {name} must be contiguous and "
                             f"{align}-byte aligned")
    if c != KERNEL_CHANNELS or layers != KERNEL_LAYERS:
        raise ValueError(f"lvc_block_nwc: the kernel is built for C="
                         f"{KERNEL_CHANNELS}, {KERNEL_LAYERS} layers; got "
                         f"C={c}, {layers} layers")
    if (skip.shape != x.shape or kern_aug.shape[0] != b or c2 != 2 * c
            or rows != aug_rows(c) or hop < 1 or frames * hop != length
            or wstack.shape != (layers, rows, c)):
        raise ValueError(
            f"lvc_block_nwc: bad shapes x {tuple(x.shape)}, skip "
            f"{tuple(skip.shape)}, kern_aug {tuple(kern_aug.shape)}, wstack "
            f"{tuple(wstack.shape)}, hop {hop}")


def lvc_block_nwc(x: torch.Tensor, skip: torch.Tensor,
                  kern_aug: torch.Tensor, wstack: torch.Tensor,
                  hop: int) -> torch.Tensor:
    """K6: x, skip (B, L, C); kern_aug (B, F, layers, 3C+1, 2C); wstack
    (layers, 3C+1, C); L == F * hop -> (B, L, C).

    CPU tensors run ``lvc_block_nwc_plain``. CUDA tensors (all bf16, C =
    32, 4 layers, kern_aug 128-byte aligned, a hop that ``tensor_core_hop``
    takes) launch the tensor-core kernel (``csrc/lvc_block_nwc_tc.cu``) or
    raise."""
    if x.device.type == "cpu":
        return lvc_block_nwc_plain(x, skip, kern_aug, wstack, hop)
    return _launch_nwc(x, skip, kern_aug, wstack, hop)


def _launch_nwc(x, skip, kern_aug, wstack, hop) -> torch.Tensor:
    """Check the operands, allocate out, plan the tile and launch
    ``lvc_block_nwc_launch``; counts the launch under
    ``LAUNCHES["lvc_block_nwc"]``."""
    if x.device.type != "cuda":
        raise ValueError(f"lvc_block_nwc: unsupported device {x.device}")
    _check_cuda_operands(x, skip, kern_aug, wstack, hop)
    b, length, c = x.shape
    _, frames, layers, rows, _ = kern_aug.shape
    out = torch.empty_like(x)
    if b == 0 or length == 0:
        return out
    plan = nwc_tile_plan(b, length, _sm_count(x.device.index or 0))
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lvc_block_nwc_launch(
            x.data_ptr(), skip.data_ptr(), kern_aug.data_ptr(),
            wstack.data_ptr(), out.data_ptr(), b, c, length, frames, hop,
            rows, layers, plan.tile, plan.smem_bytes, stream)
    _build.check(code, "lvc_block_nwc_launch")
    LAUNCHES["lvc_block_nwc"] += 1
    return out


class LVCBlockNWCRecompute(torch.autograd.Function):
    """Trainable K6: ``apply(x, skip, kern_aug, wstack, hop) -> out`` runs
    ``lvc_block_nwc``; the backward recomputes ``lvc_block_nwc_plain``
    under autograd and differentiates it, as JAX's ``_aug_bwd``
    differentiates ``_unfused_from_aug``."""

    @staticmethod
    def forward(ctx, x, skip, kern_aug, wstack, hop):
        ctx.save_for_backward(x, skip, kern_aug, wstack)
        ctx.hop = hop
        return lvc_block_nwc(x, skip, kern_aug, wstack, hop)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = lvc_block_nwc_plain(*inputs, ctx.hop)
        return (*torch.autograd.grad(out, inputs, g), None)
