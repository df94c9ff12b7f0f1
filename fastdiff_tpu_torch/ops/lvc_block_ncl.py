"""The whole 4-layer LVC block, NCL: Kernel B, Kernel B-SR, their operands
and the two trainable forms of the block.

Counterpart of ``fastdiff_tpu/ops/lvc_block_ncl.py:lvc_block_ncl_aug`` (with
and without its ``final_wb`` epilogue), ``lvc_block_ncl_aug_sr`` and the
custom VJPs of ``lvc_block_ncl`` and ``lvc_block_ncl_taug_sr``. Layer i of
the block, d = 3^i:

    s     = carry + skip
    y     = leaky0.2(W_i . [a(t-d); a; a(t+d); 1]),   a = leaky0.2(s)
    z     = K_{i,f} . [y(t-1); y; y(t+1); 1]          per frame f = t // hop
    carry = s + sigmoid(z[:C]) * tanh(z[C:])

``W_i`` is row i of ``wstack_t`` (layers, C, 3C+1), its last column the conv
bias; ``K_{i,f}`` is ``kern_taug[b, f, i, :, :3C+1]`` from the predictor head
(``ops/lvc_head.py``). With ``final_wb`` (8, C) the block also returns the
model's final k=7 C->1 conv of the carry, in float32.

The JAX kernels only fuse the blocks whose hop and frame count fit their
tiling (``fusable``) and run the plain version (XLA) on the rest. On a CUDA
tensor ``lvc_block_ncl`` launches the tensor-core kernel
(``csrc/lvc_block_ncl_tc.cu``, tiles from ``block_tile_plan``) at any frame
count when the hop is a multiple of 8 (``tensor_core_hop``), and raises at
any other hop, which no configuration has; on a CPU tensor it runs the
plain version, which keeps the kernel's cast points. Kernel B-SR
(``lvc_block_ncl_sr``) dispatches the same way, to the tensor-core kernel's
SAVE instantiation or to ``lvc_block_ncl_sr_plain``.

K5 (``lvc_block_ncl_fh``, JAX's ``lvc_block_ncl_fh``) is Kernel B with the
predictor head (Kernel A's GEMM) run inside the kernel: it takes the trunk
taps (B, F, 192) and the merged head weights instead of ``kern_taug``,
which then never reaches device memory. At hops that are multiples of 8 it
runs on the tensor cores (``csrc/lvc_block_ncl_fh.cu``, tiles from
``fh_tile_plan``) and has no kernel at other hops. Its plain version is
Kernel A's plain head followed by Kernel B's, with their cast points. The
``ncl_fh`` route runs it on the blocks ``fusable`` admits.

Training (``models/fastdiff.py`` routes):

- ``ncl_sr``: ``LVCBlockSR``. The forward is Kernel B-SR
  (``lvc_block_ncl_sr``), which also writes s, y and z of every layer; the
  backward is ``lvc_block_sr_backward``, plain PyTorch over those saved
  values, with no recompute of the forward.
- ``ncl_vjp``: ``LVCBlockRecompute``. The forward is Kernel B; the backward
  recomputes the plain block under autograd and differentiates it.

The JAX package has no Pallas backward either: both backwards are the same
plain math as its ``_sr_backward`` and ``_nat_bwd``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fastdiff_tpu_torch.ops import _build, lvc_head
from fastdiff_tpu_torch.ops.lvc import (location_variable_convolution,
                                        lvc_gated_residual)
from fastdiff_tpu_torch.ops.nn import leaky_relu

# launches of the CUDA kernels since the last reset (plain runs not counted):
# lvc_block_ncl / _final Kernel B without / with the epilogue,
# lvc_block_ncl_sr Kernel B-SR, lvc_block_ncl_fh / _final K5
LAUNCHES = {"lvc_block_ncl": 0, "lvc_block_ncl_final": 0,
            "lvc_block_ncl_sr": 0, "lvc_block_ncl_fh": 0,
            "lvc_block_ncl_fh_final": 0}

# what csrc/lvc_block_ncl_tc.cu and csrc/lvc_block_ncl_fh.cu are built for
KERNEL_CHANNELS = 32
KERNEL_LAYERS = 4
KERNEL_HEAD_K = 192          # K5's head contraction: conv taps x hidden

# the tensor-core Kernel B's geometry (csrc/lvc_block_tc.cuh, namespace tc)
TC_HALO = 48                 # samples recomputed on each side of a tile
TC_THREADS = 256
TC_BLOCKS_PER_SM = 2
TC_TILE_MAX = 328
TC_ROW = 40                  # bf16 per sample row of an activation buffer
TC_WROW = 104                # bf16 per staged W_i row
TC_APAD = 27                 # zero rows around the conv's input
TC_YPAD = 1                  # zero rows around the LVC's input
SMEM_PER_BLOCK = 232_448
H100_SMS = 132

_MIN_FUSED_HOP = 8
_MIN_HALO = 48

# the tensor-core K5's geometry (csrc/lvc_block_ncl_fh.cu, namespace tc)
FH_THREADS = TC_THREADS + 32   # 8 consumer warps and one producer warp
FH_ROWS_P = 104                # kern_taug rows: 97 padded to 8
FH_GROUP = 8                   # output channels of one slab group
FH_COLS = 64                   # w_head columns per chunk (one swizzle row)
FH_CHUNKS = 2 * FH_GROUP * FH_ROWS_P // FH_COLS   # chunks per group: 26
FH_CHUNK_BYTES = KERNEL_HEAD_K * FH_COLS * 2      # 24,576
FH_STAGES = 3                  # w_head ring stages
FH_TROW = KERNEL_HEAD_K + 8    # bf16 per staged tap row (400 bytes)
FH_FRAME = 2 * FH_GROUP * FH_ROWS_P * 2 + 16      # a frame's group slab
FH_ALIGN = 1024
FH_BAR_BYTES = 64
FH_NPAD_MAX = 32               # head frames per CTA: 4 n8 tiles at most
W_HEAD_BYTES = KERNEL_HEAD_K * KERNEL_LAYERS * 2 * KERNEL_CHANNELS \
    * FH_ROWS_P * 2            # 10,223,616: all of w_head, once per CTA


def tc_smem_bytes(ext: int) -> int:
    """Dynamic shared memory of a tensor-core block whose extent (tile plus
    halos) is ``ext`` samples: carry, a and y with their pad rows, W_i, its
    bias and the final conv (``tc::smem_bytes``)."""
    return ((3 * ext + 2 * TC_APAD + 2 * TC_YPAD) * TC_ROW * 2
            + KERNEL_CHANNELS * TC_WROW * 2 + 9 * KERNEL_CHANNELS * 4)


def tensor_core_hop(hop: int) -> bool:
    """Whether the tensor-core kernels take this hop: a multiple of 8, so
    that no n8 tile of samples straddles two frames. The LVC ops raise on a
    CUDA tensor at any other hop."""
    return hop >= 8 and hop % 8 == 0


class BlockPlan(NamedTuple):
    tile: int                # output samples per block
    ext: int                 # tile + both halos
    blocks: int              # grid size, batch rows included
    waves: int               # ceil(blocks / (SMs x blocks per SM))
    smem_bytes: int


def block_tile_plan(b: int, length: int, sms: int = H100_SMS) -> BlockPlan:
    """The tensor-core Kernel B's tile for a (b, C, length) block call: the
    multiple of 8 up to ``TC_TILE_MAX`` that minimises waves x extent (the
    time of the slowest SM, counting the recomputed halo), the larger tile
    on a tie. Two blocks share an SM."""
    if b < 1 or length < 1:
        raise ValueError(f"block_tile_plan: empty block ({b}, {length})")
    slots = sms * TC_BLOCKS_PER_SM
    best = None
    for tile in range(TC_TILE_MAX, 7, -8):
        blocks = b * -(-length // tile)
        waves = -(-blocks // slots)
        cost = waves * (tile + 2 * TC_HALO)
        if best is None or cost < best[0]:
            best = (cost, tile, blocks, waves)
    _, tile, blocks, waves = best
    ext = tile + 2 * TC_HALO
    return BlockPlan(tile, ext, blocks, waves, tc_smem_bytes(ext))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fh_frames_max(ext: int, hop: int) -> int:
    """The most frames ``ext`` consecutive samples can touch."""
    return (ext + hop - 2) // hop + 1


def fh_smem_bytes(ext: int, npad: int) -> int:
    """Dynamic shared memory of a tensor-core K5 block whose extent is
    ``ext`` samples and whose head covers ``npad`` frames (``tc::
    fh_smem_bytes``): the alignment slack, the w_head ring, carry and ybuf
    with its pad rows, the conv's input ``a`` sharing its bytes with the
    group's slabs, the taps, W_i, its bias, the final conv and the
    mbarriers."""
    c = KERNEL_CHANNELS
    union = max((ext + 2 * TC_APAD) * TC_ROW * 2, npad * FH_FRAME)
    return (FH_ALIGN + FH_STAGES * FH_CHUNK_BYTES
            + (2 * ext + 2 * TC_YPAD) * TC_ROW * 2 + union
            + npad * FH_TROW * 2 + c * TC_WROW * 2 + 9 * c * 4
            + FH_BAR_BYTES)


class FhPlan(NamedTuple):
    tile: int                # output samples per CTA
    ext: int                 # tile + both halos
    npad: int                # frames the head covers, a multiple of 8
    grid_x: int              # CTAs per batch row
    blocks: int              # grid_x * b
    waves: int               # one CTA per SM
    smem_bytes: int
    l2_bytes: int            # w_head bytes from L2 into the SMs per call

    @property
    def c_args(self) -> tuple:
        """What the C entry takes after ``layers``."""
        return (self.tile, self.npad, self.grid_x, self.smem_bytes)


def fh_tile_plan(b: int, frames: int, hop: int,
                 sms: int = H100_SMS) -> FhPlan:
    """The tensor-core K5's tile for a (b, C, frames * hop) block call: of
    the multiples of 8 whose shared memory fits, the one that minimises
    waves x extent (one CTA per SM), the larger tile on a tie. Every CTA
    streams all of w_head once, so L2 serves ``blocks * W_HEAD_BYTES``
    bytes. The head covers at most ``FH_NPAD_MAX`` frames."""
    if b < 1 or frames < 1 or hop < 8 or hop % 8:
        raise ValueError(f"fh_tile_plan: no tensor-core K5 for b {b}, "
                         f"{frames} frames, hop {hop}")
    length = frames * hop
    best = None
    for tile in range(8, length + 8, 8):
        ext = tile + 2 * TC_HALO
        npad = -(-fh_frames_max(ext, hop) // 8) * 8
        smem = fh_smem_bytes(ext, npad)
        if smem > SMEM_PER_BLOCK or npad > FH_NPAD_MAX:
            break
        grid_x = -(-length // tile)
        waves = -(-(grid_x * b) // sms)
        cost = waves * ext
        if best is None or cost <= best[0]:
            best = (cost, tile, ext, npad, grid_x, waves, smem)
    _, tile, ext, npad, grid_x, waves, smem = best
    blocks = grid_x * b
    return FhPlan(tile, ext, npad, grid_x, blocks, waves, smem,
                  blocks * W_HEAD_BYTES)


def fusable(hop: int, n_frames: int) -> bool:
    """The blocks JAX's NCL kernels tile (``fastdiff_tpu/ops/lvc_block_ncl.py:
    fusable``): hop >= 8, at least 2 frames, and a frame count that is a
    whole number of halo units (the halo is the smallest multiple of
    lcm(hop, 128) covering 48 samples: 16 frames at hop 8, 2 at hop 64, 1 at
    hop 256). The ``ncl_fh`` route runs K5 on these blocks only."""
    if hop < _MIN_FUSED_HOP or n_frames < 2:
        return False
    halo = max(hop, _MIN_HALO, 128)
    while halo % 128 or halo % hop:
        halo += hop
    hf = halo // hop
    return n_frames % hf == 0 and n_frames >= hf


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


def _conv_stage(carry, skip, wstack_t, i: int):
    """Layer i up to the LVC: s = carry + skip, y = leaky(dilated conv of
    leaky(s)) summed in float32 and rounded to carry.dtype."""
    c = carry.shape[1]
    rows, d = 3 * c, 3 ** i
    s = carry + skip
    w = wstack_t[i, :, :rows].reshape(c, 3, c).permute(0, 2, 1)
    y = F.conv1d(leaky_relu(s).float(), w.float(),
                 wstack_t[i, :, rows].float(), padding=d, dilation=d)
    return s, leaky_relu(y).to(carry.dtype)


def _lvc_operands(kern_taug, i: int, c: int):
    """Layer i's per-frame LVC kernels (B, F, 3, C, 2C) and biases
    (B, F, 2C) out of kern_taug (B, F, layers, 2C, rows_p)."""
    b, frames, _, c2, _ = kern_taug.shape
    k_i = kern_taug[:, :, i]                                 # (B, F, 2C, R)
    kernel = k_i[..., :3 * c].reshape(b, frames, c2, 3, c).permute(
        0, 1, 3, 4, 2)
    return kernel, k_i[..., 3 * c]


def lvc_block_ncl_plain(x: torch.Tensor, skip: torch.Tensor,
                        kern_taug: torch.Tensor, wstack_t: torch.Tensor,
                        hop: int, final_wb: torch.Tensor | None = None):
    """Plain PyTorch Kernel B, with the kernel's cast points: sums in
    float32, s / y / the gate rounded to x.dtype where the kernel rounds."""
    c = x.shape[1]
    carry = x
    for i in range(kern_taug.shape[2]):
        s, y = _conv_stage(carry, skip, wstack_t, i)
        kernel, bias = _lvc_operands(kern_taug, i, c)
        carry = lvc_gated_residual(s, y, kernel, bias, hop)
    if final_wb is None:
        return carry
    fin = F.conv1d(carry.float(), final_wb[:7].float().t()[None],
                   final_wb[7, :1].float(), padding=3)
    return carry, fin


def lvc_block_ncl_sr_plain(x: torch.Tensor, skip: torch.Tensor,
                           kern_taug: torch.Tensor, wstack_t: torch.Tensor,
                           hop: int) -> tuple:
    """Plain PyTorch Kernel B-SR: ``lvc_block_ncl_plain``'s math and cast
    points, returning (out, s_all, y_all, z_all) with s_all, y_all (B,
    layers, C, L) and z_all (B, layers, 2C, L) in x.dtype (z summed in
    float32, then rounded)."""
    c = x.shape[1]
    carry = x
    saved = ([], [], [])
    for i in range(kern_taug.shape[2]):
        s, y = _conv_stage(carry, skip, wstack_t, i)
        kernel, bias = _lvc_operands(kern_taug, i, c)
        z = location_variable_convolution(y, kernel, bias, hop)
        carry = s + (torch.sigmoid(z[:, :c]) * torch.tanh(z[:, c:])).to(
            x.dtype)
        for kept, v in zip(saved, (s, y, z.to(x.dtype))):
            kept.append(v)
    return (carry, *(torch.stack(kept, dim=1) for kept in saved))


def check_hop(hop: int, fn: str) -> None:
    """Raise unless the tensor-core kernels take ``hop``; called before any
    operand is read."""
    if not tensor_core_hop(hop):
        raise ValueError(f"{fn}: no kernel for hop {hop}; the tensor-core "
                         "kernel takes multiples of 8")


def _check_cuda_operands(x, skip, kern_taug, wstack_t, hop, final_wb,
                         fn: str = "lvc_block_ncl"):
    check_hop(hop, fn)
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
            raise ValueError(f"{fn}: {name} on {t.device}, x on {x.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{fn}: {name} must be bf16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte "
                             "aligned")
    if c != KERNEL_CHANNELS or layers != KERNEL_LAYERS:
        raise ValueError(f"{fn}: the kernel is built for C="
                         f"{KERNEL_CHANNELS}, {KERNEL_LAYERS} layers; got "
                         f"C={c}, {layers} layers")
    if (skip.shape != x.shape or kern_taug.shape[0] != b or c2 != 2 * c
            or rows_p % 8 or rows_p < 3 * c + 1 or hop < 1
            or frames * hop != length
            or wstack_t.shape != (layers, c, 3 * c + 1)
            or (final_wb is not None and final_wb.shape != (8, c))):
        raise ValueError(
            f"{fn}: bad shapes x {tuple(x.shape)}, skip "
            f"{tuple(skip.shape)}, kern_taug {tuple(kern_taug.shape)}, "
            f"wstack_t {tuple(wstack_t.shape)}, hop {hop}")


def lvc_block_ncl(x: torch.Tensor, skip: torch.Tensor,
                  kern_taug: torch.Tensor, wstack_t: torch.Tensor, hop: int,
                  final_wb: torch.Tensor | None = None):
    """Kernel B: x, skip (B, C, L); kern_taug (B, F, layers, 2C, rows_p);
    wstack_t (layers, C, 3C+1); L == F * hop -> carry (B, C, L), plus
    (B, 1, L) float32 when ``final_wb`` (8, C) is given.

    CPU tensors run ``lvc_block_ncl_plain``. CUDA tensors (all bf16, C =
    32, 4 layers, a hop that ``tensor_core_hop`` takes) launch the
    tensor-core kernel (``csrc/lvc_block_ncl_tc.cu``) or raise."""
    if x.device.type == "cpu":
        return lvc_block_ncl_plain(x, skip, kern_taug, wstack_t, hop,
                                   final_wb)
    return _launch_block(x, skip, kern_taug, wstack_t, hop, final_wb)


def _launch_block(x, skip, kern_taug, wstack_t, hop, final_wb):
    """Check the operands, allocate out (and fin), plan the tile and launch
    ``lvc_block_ncl_launch``; counts the launch under
    ``LAUNCHES["lvc_block_ncl"]`` or, with the epilogue,
    ``LAUNCHES["lvc_block_ncl_final"]``."""
    if x.device.type != "cuda":
        raise ValueError(f"lvc_block_ncl: unsupported device {x.device}")
    _check_cuda_operands(x, skip, kern_taug, wstack_t, hop, final_wb)
    b, c, length = x.shape
    _, frames, layers, _, rows_p = kern_taug.shape
    out = torch.empty_like(x)
    fin = (x.new_empty((b, 1, length), dtype=torch.float32)
           if final_wb is not None else None)
    if b == 0 or length == 0:
        return out if fin is None else (out, fin)
    plan = block_tile_plan(b, length, _sm_count(x.device.index or 0))
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lvc_block_ncl_launch(
            x.data_ptr(), skip.data_ptr(), kern_taug.data_ptr(),
            wstack_t.data_ptr(),
            None if final_wb is None else final_wb.data_ptr(),
            out.data_ptr(), None if fin is None else fin.data_ptr(),
            b, c, length, frames, hop, rows_p, layers, plan.tile, stream)
    _build.check(code, "lvc_block_ncl_launch")
    LAUNCHES["lvc_block_ncl" if final_wb is None
             else "lvc_block_ncl_final"] += 1
    return out if fin is None else (out, fin)


def lvc_block_ncl_fh_plain(x: torch.Tensor, skip: torch.Tensor,
                           tap_c: torch.Tensor, w_head: torch.Tensor,
                           b_head: torch.Tensor, wstack_t: torch.Tensor,
                           hop: int, final_wb: torch.Tensor | None = None):
    """Plain PyTorch K5: Kernel A's plain head over the taps, then Kernel B's
    plain block, with both cast points (bit-identical to the two on the
    CPU)."""
    b, frames, k = tap_c.shape
    kern = lvc_head.taug_head_matmul_plain(
        tap_c.reshape(b * frames, k), w_head, b_head).reshape(
            b, frames, wstack_t.shape[0], 2 * x.shape[1], -1)
    return lvc_block_ncl_plain(x, skip, kern, wstack_t, hop, final_wb)


def _check_fh_operands(x, skip, tap_c, w_head, b_head, wstack_t, hop,
                       final_wb):
    fn = "lvc_block_ncl_fh"
    check_hop(hop, fn)
    b, c, length = x.shape
    if tap_c.dim() != 3 or w_head.dim() != 2 or b_head.dim() != 1:
        raise ValueError(f"{fn}: tap_c (B, F, K), w_head (K, N) and b_head "
                         f"(N,) expected, got {tuple(tap_c.shape)}, "
                         f"{tuple(w_head.shape)}, {tuple(b_head.shape)}")
    _, frames, khead = tap_c.shape
    layers = wstack_t.shape[0]
    slabs = layers * 2 * c            # (layer, output channel) rows of w_head
    named = [("x", x, torch.bfloat16), ("skip", skip, torch.bfloat16),
             ("tap_c", tap_c, torch.bfloat16),
             ("w_head", w_head, torch.bfloat16),
             ("b_head", b_head, torch.float32),
             ("wstack_t", wstack_t, torch.bfloat16)]
    if final_wb is not None:
        named.append(("final_wb", final_wb, torch.bfloat16))
    for name, t, dtype in named:
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise ValueError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
        # the tensor-core kernel's TMA reads w_head in swizzled boxes
        align = 128 if name == "w_head" else 16
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{fn}: {name} must be contiguous and "
                             f"{align}-byte aligned")
    if (c != KERNEL_CHANNELS or layers != KERNEL_LAYERS
            or khead != KERNEL_HEAD_K):
        raise ValueError(f"{fn}: the kernel is built for C={KERNEL_CHANNELS}"
                         f", {KERNEL_LAYERS} layers, K={KERNEL_HEAD_K}; got "
                         f"C={c}, {layers} layers, K={khead}")
    rows_p = w_head.shape[1] // slabs
    if (skip.shape != x.shape or tap_c.shape[0] != b or hop < 1
            or frames * hop != length or w_head.shape[0] != khead
            or w_head.shape[1] != slabs * rows_p or rows_p % 8
            or rows_p < 3 * c + 1 or b_head.shape != (w_head.shape[1],)
            or wstack_t.shape != (layers, c, 3 * c + 1)
            or (final_wb is not None and final_wb.shape != (8, c))):
        raise ValueError(
            f"{fn}: bad shapes x {tuple(x.shape)}, skip {tuple(skip.shape)}, "
            f"tap_c {tuple(tap_c.shape)}, w_head {tuple(w_head.shape)}, "
            f"b_head {tuple(b_head.shape)}, wstack_t "
            f"{tuple(wstack_t.shape)}, hop {hop}")
    return rows_p


def lvc_block_ncl_fh(x: torch.Tensor, skip: torch.Tensor,
                     tap_c: torch.Tensor, w_head: torch.Tensor,
                     b_head: torch.Tensor, wstack_t: torch.Tensor, hop: int,
                     final_wb: torch.Tensor | None = None):
    """K5: x, skip (B, C, L); tap_c (B, F, K) trunk taps (``lvc_head.
    frame_taps``); w_head (K, layers*2C*rows_p), b_head (layers*2C*rows_p,)
    float32 (``lvc_head.pack_head``); wstack_t (layers, C, 3C+1); L == F *
    hop -> carry (B, C, L), plus (B, 1, L) float32 with ``final_wb`` (8, C).

    CPU tensors run ``lvc_block_ncl_fh_plain``. CUDA tensors (bf16 but the
    f32 bias, C = 32, 4 layers, K = 192, w_head 128-byte aligned, a hop that
    ``tensor_core_hop`` takes) launch the tensor-core kernel
    (``csrc/lvc_block_ncl_fh.cu``, its tile from ``fh_tile_plan``) or
    raise."""
    if x.device.type == "cpu":
        return lvc_block_ncl_fh_plain(x, skip, tap_c, w_head, b_head,
                                      wstack_t, hop, final_wb)
    return _launch_fh(x, skip, tap_c, w_head, b_head, wstack_t, hop,
                      final_wb)


def _launch_fh(x, skip, tap_c, w_head, b_head, wstack_t, hop, final_wb):
    """Check the operands, allocate out (and fin), plan the tile and launch
    ``lvc_block_ncl_fh_launch``; counts the launch under
    ``LAUNCHES["lvc_block_ncl_fh"]`` or, with the epilogue,
    ``LAUNCHES["lvc_block_ncl_fh_final"]``."""
    if x.device.type != "cuda":
        raise ValueError(f"lvc_block_ncl_fh: unsupported device {x.device}")
    rows_p = _check_fh_operands(x, skip, tap_c, w_head, b_head, wstack_t,
                                hop, final_wb)
    b, c, length = x.shape
    frames, khead = tap_c.shape[1:]
    out = torch.empty_like(x)
    fin = (x.new_empty((b, 1, length), dtype=torch.float32)
           if final_wb is not None else None)
    if b == 0 or length == 0:
        return out if fin is None else (out, fin)
    plan = fh_tile_plan(b, frames, hop, _sm_count(x.device.index or 0))
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lvc_block_ncl_fh_launch(
            x.data_ptr(), skip.data_ptr(), tap_c.data_ptr(),
            w_head.data_ptr(), b_head.data_ptr(), wstack_t.data_ptr(),
            None if final_wb is None else final_wb.data_ptr(),
            out.data_ptr(), None if fin is None else fin.data_ptr(),
            b, c, length, frames, hop, khead, rows_p, wstack_t.shape[0],
            *plan.c_args, stream)
    _build.check(code, "lvc_block_ncl_fh_launch")
    LAUNCHES["lvc_block_ncl_fh" if final_wb is None
             else "lvc_block_ncl_fh_final"] += 1
    return out if fin is None else (out, fin)


def lvc_block_ncl_sr(x: torch.Tensor, skip: torch.Tensor,
                     kern_taug: torch.Tensor, wstack_t: torch.Tensor,
                     hop: int) -> tuple:
    """Kernel B-SR: Kernel B's operands -> (out (B, C, L), s_all, y_all
    (B, layers, C, L), z_all (B, layers, 2C, L)), the residuals that
    ``lvc_block_sr_backward`` reads.

    CPU tensors run ``lvc_block_ncl_sr_plain``. CUDA tensors (all bf16, C =
    32, 4 layers, a hop that ``tensor_core_hop`` takes) launch the
    tensor-core kernel's SAVE instantiation (``csrc/lvc_block_ncl_tc.cu``,
    the tile from ``block_tile_plan``) or raise."""
    if x.device.type == "cpu":
        return lvc_block_ncl_sr_plain(x, skip, kern_taug, wstack_t, hop)
    return _launch_sr(x, skip, kern_taug, wstack_t, hop)


def _launch_sr(x, skip, kern_taug, wstack_t, hop) -> tuple:
    """Check the operands, allocate out and the residuals, plan the tile and
    launch ``lvc_block_ncl_sr_launch``; counts the launch under
    ``LAUNCHES["lvc_block_ncl_sr"]``."""
    if x.device.type != "cuda":
        raise ValueError(f"lvc_block_ncl_sr: unsupported device {x.device}")
    _check_cuda_operands(x, skip, kern_taug, wstack_t, hop, None,
                         "lvc_block_ncl_sr")
    b, c, length = x.shape
    _, frames, layers, _, rows_p = kern_taug.shape
    out = torch.empty_like(x)
    s_all = x.new_empty((b, layers, c, length))
    y_all = x.new_empty((b, layers, c, length))
    z_all = x.new_empty((b, layers, 2 * c, length))
    if b == 0 or length == 0:
        return out, s_all, y_all, z_all
    plan = block_tile_plan(b, length, _sm_count(x.device.index or 0))
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.lvc_block_ncl_sr_launch(
            x.data_ptr(), skip.data_ptr(), kern_taug.data_ptr(),
            wstack_t.data_ptr(), out.data_ptr(), s_all.data_ptr(),
            y_all.data_ptr(), z_all.data_ptr(), b, c, length, frames, hop,
            rows_p, layers, plan.tile, stream)
    _build.check(code, "lvc_block_ncl_sr_launch")
    LAUNCHES["lvc_block_ncl_sr"] += 1
    return out, s_all, y_all, z_all


def _shift(a: torch.Tensor, k: int) -> torch.Tensor:
    """Time shift with zero fill: out[..., l] = a[..., l - k]."""
    length = a.shape[-1]
    if k == 0:
        return a
    if abs(k) >= length:
        return torch.zeros_like(a)
    if k > 0:
        return F.pad(a[..., :length - k], (k, 0))
    return F.pad(a[..., -k:], (0, -k))


def _leaky_grad(v: torch.Tensor) -> torch.Tensor:
    """leaky0.2' read from a saved value's sign (leaky keeps the sign)."""
    return torch.where(v > 0, 1.0, 0.2)


def lvc_block_sr_backward(kern_taug, wstack_t, s_all, y_all, z_all,
                          g: torch.Tensor, hop: int) -> tuple:
    """Backward of the block from Kernel B-SR's residuals, op for op the
    JAX ``_sr_backward``: g = dL/d out (B, C, L) -> (dx, dskip, dkern_taug,
    dwstack_t). Per layer, last first:

        dz     = g * d(sigmoid(z[:C]) * tanh(z[C:]))          rounded to s's dtype
        dK_f   = dz_f @ tap_y_f^T,  dtap_y = K_f^T @ dz_f     per frame f
        dy     = taps of dtap_y folded back * leaky'(y)       rounded
        dW_i   = dy @ tap_a^T,      da = taps of W_i^T @ dy folded back
        ds     = g + da * leaky'(s);  dskip += ds;  g = ds

    Products of rounded operands are summed in float32; dkern is padded
    with zeros to kern_taug's rows_p."""
    b, layers, c, length = s_all.shape
    rows = 3 * c + 1
    frames = length // hop
    cdtype = s_all.dtype
    ones = torch.ones((b, 1, length), dtype=cdtype, device=s_all.device)
    g = g.float()
    dskip = torch.zeros_like(g)
    dks, dws = [], []
    for i in reversed(range(layers)):
        d = 3 ** i
        s_i, y_i = s_all[:, i], y_all[:, i]
        z_i = z_all[:, i].float()
        sg = torch.sigmoid(z_i[:, :c])
        th = torch.tanh(z_i[:, c:])
        dz = torch.cat([g * th * sg * (1.0 - sg), g * sg * (1.0 - th * th)],
                       dim=1).to(cdtype)                       # (B, 2C, L)
        # LVC backward: the per-frame products, transposed
        dz_r = dz.float().reshape(b, 2 * c, frames, hop)
        tap_y = torch.cat([_shift(y_i, 1), y_i, _shift(y_i, -1), ones], dim=1)
        tap_y_r = tap_y.float().reshape(b, rows, frames, hop)
        dks.append(torch.einsum("bcfh,brfh->bfcr", dz_r, tap_y_r))
        k_i = kern_taug[:, :, i, :, :rows].float()             # (B, F, 2C, R)
        dtap = torch.einsum("bfcr,bcfh->brfh", k_i, dz_r).reshape(
            b, rows, length)
        dy = (_shift(dtap[:, :c], -1) + dtap[:, c:2 * c]
              + _shift(dtap[:, 2 * c:3 * c], 1))
        dy_raw = (dy * _leaky_grad(y_i)).to(cdtype).float()
        # dilated-conv backward
        a_i = leaky_relu(s_i)
        tap_a = torch.cat([_shift(a_i, d), a_i, _shift(a_i, -d), ones], dim=1)
        dtap_a = torch.einsum("cr,bcl->brl", wstack_t[i].float(), dy_raw)
        dws.append(torch.einsum("bcl,brl->cr", dy_raw, tap_a.float()))
        da = (_shift(dtap_a[:, :c], -d) + dtap_a[:, c:2 * c]
              + _shift(dtap_a[:, 2 * c:3 * c], d))
        ds = g + da * _leaky_grad(s_i)
        dskip = dskip + ds
        g = ds
    dkern = F.pad(torch.stack(dks[::-1], dim=2),
                  (0, kern_taug.shape[-1] - rows))
    dwstack = torch.stack(dws[::-1], dim=0)
    return (g.to(cdtype), dskip.to(cdtype), dkern.to(kern_taug.dtype),
            dwstack.to(wstack_t.dtype))


class LVCBlockSR(torch.autograd.Function):
    """The ``ncl_sr`` block: Kernel B-SR forward (``lvc_block_ncl_sr``),
    saved-residual backward (``lvc_block_sr_backward``), no recompute.
    ``apply(x, skip, kern_taug, wstack_t, hop) -> out``."""

    @staticmethod
    def forward(ctx, x, skip, kern_taug, wstack_t, hop):
        out, s_all, y_all, z_all = lvc_block_ncl_sr(x, skip, kern_taug,
                                                    wstack_t, hop)
        ctx.save_for_backward(kern_taug, wstack_t, s_all, y_all, z_all)
        ctx.hop = hop
        return out

    @staticmethod
    def backward(ctx, g):
        grads = lvc_block_sr_backward(*ctx.saved_tensors, g, ctx.hop)
        return (*grads, None)


class LVCBlockRecompute(torch.autograd.Function):
    """The ``ncl_vjp`` block: Kernel B forward (``lvc_block_ncl``); the
    backward recomputes ``lvc_block_ncl_plain`` under autograd and
    differentiates it, as JAX's ``_nat_bwd`` does through its unfused
    reference. ``apply(x, skip, kern_taug, wstack_t, hop) -> out``."""

    @staticmethod
    def forward(ctx, x, skip, kern_taug, wstack_t, hop):
        ctx.save_for_backward(x, skip, kern_taug, wstack_t)
        ctx.hop = hop
        return lvc_block_ncl(x, skip, kern_taug, wstack_t, hop)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = lvc_block_ncl_plain(*inputs, ctx.hop)
        return (*torch.autograd.grad(out, inputs, g), None)
