"""The LVC kernel-predictor head: Kernel A and its operands.

Counterpart of ``fastdiff_tpu/ops/lvc_block_pallas.py:taug_head_matmul_5d``
and of the operand packing in ``fastdiff_tpu/models/fastdiff.py:
_taug_head_operands``. The predictor's ``kernel_conv`` and ``bias_conv``
heads (k=3 convs over the trunk) are merged into one matrix product

    kern[m, n] = bf16( sum_k tap[m, k] * w_head[k, n] + b_head[n] )

whose output, read as (B, F, layers, 2C, rows_p), is the LVC block's
``kern_taug`` operand: row r < 3C of a (2C, rows_p) slab holds tap r // C,
input channel r % C; row 3C is the bias; rows above are zero padding.
``rows_p`` rounds 3C + 1 up to a multiple of 8 so that every row starts on
a 16-byte boundary for the kernels' vector loads (104 at C = 32; the TPU
package pads to its 128-lane tile instead).

On a CUDA tensor ``taug_head_matmul`` launches the hand-written kernel
(``csrc/taug_head.cu``: a persistent ``wgmma`` + TMA GEMM for ``sm_90a``,
whose tile walk ``head_gemm_plan`` computes); on a CPU tensor it runs the
plain version.
``TaugHead`` is the trainable form: Kernel A forward, and the plain matmul
VJP of the JAX ``_taug5d_bwd`` as its backward. ``pack_head`` and
``head_taps`` are differentiable.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from fastdiff_tpu_torch.ops import _build

# launches of the CUDA kernels since the last reset (plain runs not counted)
LAUNCHES = {"taug_head": 0, "taug_head_variant": 0}

# K10's walk orders (head_gemm_walk_plan): a stripe of M tiles across every
# N tile, stripe after stripe ("m_outer"), or every M tile under one N tile,
# N tile after N tile ("w_res", weight-resident: K3's walk)
VARIANT_ORDERS = ("m_outer", "w_res")

# The head GEMM's geometry (csrc/taug_head.cu, which refuses any other):
# 128 x 128 output units, K in chunks of 64 (one 128-byte swizzled row of
# bf16, at most 4 chunks), a tap ring of 16 KB stages, two slots of a w_head
# tile (K x 128) and its f32 bias, two bf16 staging tiles of 64 x 128 per
# consumer warpgroup, mbarriers and 1 KB of alignment slack, within the
# 232,448 bytes of shared memory a block can use.
HEAD_TILE_M, HEAD_TILE_N, HEAD_CHUNK_K = 128, 128, 64
HEAD_MAX_STAGES, HEAD_MAX_CHUNKS = 8, 4
SMEM_PER_BLOCK = 232_448
_A_STAGE_BYTES = HEAD_TILE_M * HEAD_CHUNK_K * 2
_B_CHUNK_BYTES = HEAD_CHUNK_K * HEAD_TILE_N * 2
_OUT_TILE_BYTES = 64 * HEAD_TILE_N * 2
_SMEM_SLACK = 1024 + 256 + 2 * HEAD_TILE_N * 4   # alignment, mbarriers, bias


@dataclasses.dataclass(frozen=True)
class HeadGemmPlan:
    """The persistent head GEMM's walk over its output: ``units`` tiles of
    ``tile_m`` x ``tile_n`` in the order of ``unit_tile``, block b running
    ``ranges[b]`` = [begin, end). The M tiles go in stripes of ``stripe``,
    each stripe walked N tile by N tile; ``stripe == m_tiles`` (K3, K7) is
    the N-major walk, unit u at N tile u // m_tiles and M tile u % m_tiles.
    A block reloads its w_head tile only when the N tile changes."""
    tile_m: int
    tile_n: int
    k_chunks: int
    stages: int
    m_tiles: int
    n_tiles: int
    units: int
    grid: int
    ranges: tuple
    smem_bytes: int
    stripe: int

    @property
    def c_args(self) -> tuple:
        """The int arguments K3's and K7's C entries take after M, N, K
        (K10's take ``stripe`` after them)."""
        return (self.tile_m, self.tile_n, self.stages, self.units, self.grid,
                self.smem_bytes)

    def unit_tile(self, u: int) -> tuple:
        """(M tile, N tile) of unit u: the position that
        ``csrc/taug_head.cu``'s ``Walk`` reaches at u."""
        per = self.stripe * self.n_tiles
        k, r = divmod(u, per)
        rows = min(self.stripe, self.m_tiles - k * self.stripe)
        nt, mt = divmod(r, rows)
        return k * self.stripe + mt, nt


@functools.lru_cache(maxsize=256)
def head_gemm_plan(m: int, n: int, k: int, sms: int = 132) -> HeadGemmPlan:
    """The tile walk of ``csrc/taug_head.cu`` for tap (m, k) @ w (k, n) on a
    card of ``sms`` SMs: one block per SM (or per unit, if fewer), each a
    contiguous run of units, the runs differing by at most one unit. Raises
    if k is too deep for the shared memory (k > 256)."""
    k_chunks = -(-k // HEAD_CHUNK_K)
    fixed = (_SMEM_SLACK + 2 * k_chunks * _B_CHUNK_BYTES
             + 4 * _OUT_TILE_BYTES)
    stages = min(HEAD_MAX_STAGES, (SMEM_PER_BLOCK - fixed) // _A_STAGE_BYTES)
    if m < 1 or n < 1 or k_chunks > HEAD_MAX_CHUNKS:
        raise ValueError(f"head GEMM: no plan for ({m}, {k}) @ ({k}, {n}) "
                         "(K at most 256)")
    m_tiles = -(-m // HEAD_TILE_M)
    n_tiles = -(-n // HEAD_TILE_N)
    units = m_tiles * n_tiles
    grid = min(sms, units)
    per, extra = divmod(units, grid)
    starts = [b * per + min(b, extra) for b in range(grid + 1)]
    return HeadGemmPlan(
        tile_m=HEAD_TILE_M, tile_n=HEAD_TILE_N, k_chunks=k_chunks,
        stages=stages, m_tiles=m_tiles, n_tiles=n_tiles, units=units,
        grid=grid, ranges=tuple(zip(starts[:-1], starts[1:])),
        smem_bytes=fixed + stages * _A_STAGE_BYTES, stripe=m_tiles)


def check_walk(order: str, m_tile: int) -> None:
    """Raise unless (order, m_tile) is a walk of experiment B."""
    if order not in VARIANT_ORDERS or m_tile < 1:
        raise ValueError(f"taug_head_variant: order {order!r} (one of "
                         f"{VARIANT_ORDERS}), m_tile {m_tile} (at least 1)")


@functools.lru_cache(maxsize=256)
def head_gemm_walk_plan(m: int, n: int, k: int, order: str, m_tile: int,
                        sms: int = 132) -> HeadGemmPlan:
    """K10's plan: ``head_gemm_plan``'s units, grid and balanced runs on the
    walk of experiment B's (order, m_tile). An M tile of ``m_tile`` rows is
    a stripe of ceil(m_tile / 128) units of 128 rows (216 -> 2, 432 -> 4,
    864 -> 7), at most all of them. "m_outer" walks a stripe across every
    N tile before the next stripe; "w_res" keeps a w_head tile for every M
    tile, which is K3's N-major walk whatever m_tile is."""
    check_walk(order, m_tile)
    plan = head_gemm_plan(m, n, k, sms)
    if order == "w_res":
        return plan
    return dataclasses.replace(
        plan, stripe=min(plan.m_tiles, -(-m_tile // HEAD_TILE_M)))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index``."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def rows_padded(c: int, k: int = 3) -> int:
    """Rows of one (2C, rows_p) kernel slab: K*C + 1 rounded up to 8."""
    return -(-(k * c + 1) // 8) * 8


def pack_head(kernel_w: torch.Tensor, kernel_b: torch.Tensor,
              bias_w: torch.Tensor, bias_b: torch.Tensor, *, layers: int,
              c: int, k: int = 3, dtype=torch.bfloat16) -> tuple:
    """Merge the predictor heads into (w_head, b_head).

    kernel_w (layers*K*C*2C, hid, ksz), its output channels in (layers, K,
    C, 2C) order; bias_w (layers*2C, hid, ksz). Returns w_head (ksz*hid,
    layers*2C*rows_p) in ``dtype`` with contraction index tap*hid + h, and
    b_head (layers*2C*rows_p,) float32."""
    cout = 2 * c
    rows = k * c
    rows_p = rows_padded(c, k)
    _, hid, ksz = kernel_w.shape
    kw = kernel_w.reshape(layers, rows, cout, hid, ksz).permute(4, 3, 0, 2, 1)
    bw = bias_w.reshape(layers, 1, cout, hid, ksz).permute(4, 3, 0, 2, 1)
    w = F.pad(torch.cat([kw, bw], dim=-1), (0, rows_p - rows - 1))
    kb = kernel_b.reshape(layers, rows, cout).permute(0, 2, 1)
    bb = bias_b.reshape(layers, cout, 1)
    b = F.pad(torch.cat([kb, bb], dim=-1), (0, rows_p - rows - 1))
    w_head = w.reshape(ksz * hid, layers * cout * rows_p).to(dtype)
    return w_head.contiguous(), b.reshape(-1).float().contiguous()


def frame_taps(trunk: torch.Tensor, ksz: int = 3) -> torch.Tensor:
    """Trunk output (B, hid, F) -> zero-padded k-tap rows per frame
    (B, F, ksz*hid), contraction index tap*hid + h: K5's ``tap_c``."""
    b, hid, frames = trunk.shape
    pad = (ksz - 1) // 2
    cp = F.pad(trunk, (pad, pad))
    taps = torch.stack([cp[:, :, t:t + frames] for t in range(ksz)], dim=1)
    return taps.permute(0, 3, 1, 2).reshape(b, frames, ksz * hid).contiguous()


def head_taps(trunk: torch.Tensor, ksz: int = 3) -> torch.Tensor:
    """Trunk output (B, hid, F) -> zero-padded k-tap rows (B*F, ksz*hid),
    Kernel A's ``tap``."""
    taps = frame_taps(trunk, ksz)
    return taps.reshape(-1, taps.shape[-1])


def taug_head_matmul_plain(tap: torch.Tensor, w_head: torch.Tensor,
                           b_head: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Kernel A: f32 accumulate, f32 bias, round to tap.dtype."""
    return (tap.float() @ w_head.float() + b_head.float()).to(tap.dtype)


def taug_head_matmul(tap: torch.Tensor, w_head: torch.Tensor,
                     b_head: torch.Tensor) -> torch.Tensor:
    """Kernel A: tap (M, K) @ w_head (K, N) + b_head (N,) -> (M, N).

    CPU tensors run ``taug_head_matmul_plain``. CUDA tensors launch
    ``csrc/taug_head.cu`` (bf16 tap and weights, f32 bias, K at most 256)
    or raise."""
    if tap.device.type == "cpu":
        return taug_head_matmul_plain(tap, w_head, b_head)
    out = launch_head_gemm("taug_head_launch", "taug_head_matmul", tap,
                           w_head, b_head, n_multiple=8)
    if out.shape[0]:
        LAUNCHES["taug_head"] += 1
    return out


def taug_head_variant_plain(tap: torch.Tensor, w_head: torch.Tensor,
                            b_head: torch.Tensor, *, order: str = "m_outer",
                            m_tile: int = 216) -> torch.Tensor:
    """Plain PyTorch K10: Kernel A's plain head (order and tile change only
    how the kernel walks the output)."""
    del order, m_tile
    return taug_head_matmul_plain(tap, w_head, b_head)


def taug_head_variant(tap: torch.Tensor, w_head: torch.Tensor,
                      b_head: torch.Tensor, *, order: str = "m_outer",
                      m_tile: int = 216) -> torch.Tensor:
    """K10, the head GEMM of ``scripts/exp_r4b.py:_taug_head_variant``: tap
    (M, K) @ w_head (K, N) + b_head (N,) -> (M, N) row-major, as Kernel A,
    on the walk that ``head_gemm_walk_plan`` makes of the grid ``order``
    ("m_outer" or "w_res") and the M tile ``m_tile`` (rows, at least 1).

    CPU tensors run ``taug_head_variant_plain``. CUDA tensors launch K3's
    kernel through ``csrc/taug_head.cu``'s variant entry (K a multiple of
    8, at most 256) or raise."""
    check_walk(order, m_tile)
    if tap.device.type == "cpu":
        return taug_head_variant_plain(tap, w_head, b_head, order=order,
                                       m_tile=m_tile)
    out = launch_head_gemm("taug_head_variant_launch", "taug_head_variant",
                           tap, w_head, b_head, n_multiple=8,
                           walk=(order, m_tile))
    if out.shape[0]:
        LAUNCHES["taug_head_variant"] += 1
    return out


def launch_head_gemm(entry: str, fn: str, tap: torch.Tensor,
                     w_head: torch.Tensor, b_head: torch.Tensor, *,
                     n_multiple: int, walk: tuple = None) -> torch.Tensor:
    """Check the operands of ``csrc/taug_head.cu``'s GEMM and launch it
    through the C entry ``entry``: tap (M, K) bf16 @ w_head (K, N) bf16 +
    b_head (N,) f32 -> (M, N) bf16, row-major. K must be a multiple of 8,
    at most 256, and N of ``n_multiple``; raises on anything else. The
    entry takes ``head_gemm_plan``'s ints after M, N, K (K3, K7), or, for a
    ``walk`` (order, m_tile), ``head_gemm_walk_plan``'s and its stripe
    (K10)."""
    if tap.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {tap.device}")
    m, k = tap.shape
    k2, n = w_head.shape
    for name, t in (("w_head", w_head), ("b_head", b_head)):
        if t.device != tap.device:
            raise ValueError(f"{fn}: {name} on {t.device}, tap on "
                             f"{tap.device}")
    if tap.dtype != torch.bfloat16 or w_head.dtype != torch.bfloat16:
        raise ValueError(f"{fn}: tap and w_head must be bf16, got "
                         f"{tap.dtype}, {w_head.dtype}")
    if b_head.dtype != torch.float32 or b_head.shape != (n,):
        raise ValueError(f"{fn}: b_head must be f32 ({n},), got "
                         f"{b_head.dtype} {tuple(b_head.shape)}")
    if k2 != k or k % 8 or n % n_multiple:
        raise ValueError(f"{fn}: shapes {tuple(tap.shape)} @ "
                         f"{tuple(w_head.shape)} (K must be a multiple of 8 "
                         f"and N of {n_multiple})")
    for name, t in (("tap", tap), ("w_head", w_head), ("b_head", b_head)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte "
                             "aligned")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=tap.device)
    if m == 0:
        return out
    sms = sm_count(out.device.index)
    if walk is None:
        extra = head_gemm_plan(m, n, k, sms).c_args
    else:
        plan = head_gemm_walk_plan(m, n, k, *walk, sms)
        extra = plan.c_args + (plan.stripe,)
    lib = _build.library()
    with torch.cuda.device(tap.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(tap.data_ptr(), w_head.data_ptr(),
                                   b_head.data_ptr(), out.data_ptr(),
                                   m, n, k, *extra, stream)
    _build.check(code, entry)
    return out


class TaugHead(torch.autograd.Function):
    """Trainable Kernel A: ``apply(tap, w_head, b_head)`` runs
    ``taug_head_matmul``; the backward is JAX's ``_taug5d_bwd``:
    dtap = g @ w_head^T rounded to tap's dtype, dw = tap^T @ g rounded to
    w_head's dtype, db = sum of g in float32 (products of the rounded
    operands, summed in float32)."""

    @staticmethod
    def forward(ctx, tap, w_head, b_head):
        ctx.save_for_backward(tap, w_head)
        ctx.b_dtype = b_head.dtype
        return taug_head_matmul(tap, w_head, b_head)

    @staticmethod
    def backward(ctx, g):
        return head_matmul_backward(*ctx.saved_tensors, ctx.b_dtype, g)


def head_matmul_backward(tap: torch.Tensor, w_head: torch.Tensor, b_dtype,
                         g: torch.Tensor) -> tuple:
    """The plain matmul VJP of a head GEMM (JAX's ``_taug5d_bwd`` and
    ``_aug_head_bwd``): g (M, N) -> dtap = g @ w_head^T rounded to tap's
    dtype, dw = tap^T @ g rounded to w_head's dtype, db = sum of g in
    float32 cast to ``b_dtype`` (products of the rounded operands, summed
    in float32)."""
    gf = g.reshape(g.shape[0], -1)
    dtap = (gf.float() @ w_head.to(gf.dtype).float().t()).to(tap.dtype)
    dw = (tap.float().t() @ gf.to(tap.dtype).float()).to(w_head.dtype)
    db = gf.float().sum(dim=0).to(b_dtype)
    return dtap, dw, db
