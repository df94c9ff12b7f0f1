"""The fused down path: K8, its plain versions and its packed weights.

Counterpart of ``fastdiff_tpu/ops/downpath_pallas.py`` (``use_pallas_down:
true``). The denoiser's down path is the first k=7 conv and the three
DBlocks:

    af    = bf16(audio)                                  (B, L, 1)
    x     = bf16(first conv of af, f32 sums + bias)      skip0, rate 1
    for f in factors (4, 8, 8):
        x   = x[::f]                                     nearest downsample
        res = x @ Wr + br                                f32
        y   = x; three times, d = 1, 2, 4:
              y = bf16(conv_d(leaky0.2(y)) + b)
        x   = y + bf16(res)                              bf16 add
    outputs: skip0, skip1 (rate 4), skip2 (rate 32), x (rate 256)

with zero padding at every stage's sequence edges. The weights are packed
as JAX packs them (``pack_downpath_weights``): each operand's last row is
its bias, tap rows k-major.

Two layouts of the same kernel, ``csrc/downpath.cu``:

- NWC, (B, L_r, C): ``downpath_fused``, where JAX runs its kernel (the
  ``nwc`` and ``plain`` routes with ``use_pallas_down``), with JAX's cast
  points: the biases are the packs' bf16 rows (``downpath_plain``).
- NCL, (B, C, L_r): ``downpath_ncl``, the ``ncl`` / ``ncl_fh`` inference
  routes, where JAX's ``_fastdiff_apply_ncl`` runs XLA, with that route's
  cast points: the biases in float32 (``pack_downpath_bias``), added to the
  float32 sums (``downpath_ncl_plain``, the module chain's own ops).

Each launches the kernel on a CUDA tensor (bf16 outputs, C = 32, factors
(4, 8, 8); L a multiple of 256, for NCL of 2048) or raises, and runs its
plain version on a CPU tensor. The routes call them where the length is
``downpath_fusable``, as JAX does.

The kernel runs in two launches (one call, one count in ``LAUNCHES``, under
``downpath`` for NWC and ``downpath_ncl`` for NCL): stage 1 writes skip0
and, over tiles of ``STAGE1_TILE`` rate-4 samples with ``STAGE1_HALO`` of
halo on each side, DBlock 1's skip1; stage 2 reads skip1 back and runs
DBlocks 2 and 3 over tiles of ``STAGE2_TILE`` rate-256 samples. The
constants below are the source's (``namespace dp``); ``downpath_plan``
gives the grids.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.ops import nn as fnn
from fastdiff_tpu_torch.ops.nn import leaky_relu

# launches of the CUDA kernel since the last reset (plain runs not counted),
# one key a layout (NWC, NCL); one per call, though a call makes two launches
LAUNCHES = {"downpath": 0, "downpath_ncl": 0}

# what csrc/downpath.cu is built for
KERNEL_CHANNELS = 32
KERNEL_FACTORS = (4, 8, 8)
KERNEL_TAPS = 7
KERNEL_LAYERS = 3

# its geometry (csrc/downpath.cu, namespace dp), in samples of each rate
THREADS = 256
BLOCKS_PER_SM = 2
ROW = 40                     # bf16 per sample row of an activation buffer
WROW = 104                   # bf16 per staged conv weight row
PAD = 4                      # zero rows around a buffer: the largest dilation
STAGE1_TILE = 256            # T1: rate-4 outputs per stage-1 block
STAGE1_HALO = 8              # H1: rate-4 rows of halo on each side
STAGE1_EXT = STAGE1_TILE + 2 * STAGE1_HALO        # E1
AUDIO_OFF = 4 * STAGE1_HALO + 4                   # AOFF
AUDIO_SPAN = 4 * STAGE1_EXT + 8                   # ASPAN
STAGE2_TILE = 8              # T3: rate-256 outputs per stage-2 block
STAGE3_HALO = 8              # H3: p3 rows before the tile
STAGE3_EXT = 24              # E3
STAGE2_HALO = 72             # H2: x2 rows before the tile's first sample
STAGE2_EXT = 208             # E2
# NCL: bf16 per channel row of DBlocks 1, 2, 3's channel-major outputs
NCL_ROWS = (328, 264, 72)    # CS1, CS2, CS3
NCL_ALIGN = 2048             # the NCL layout's L: whole 16-byte vectors of x
DWEIGHTS_BYTES = (KERNEL_LAYERS * KERNEL_CHANNELS * WROW * 2
                  + KERNEL_CHANNELS * ROW * 2 + KERNEL_LAYERS
                  * KERNEL_CHANNELS * 4 + KERNEL_CHANNELS * 4)
SMEM1 = DWEIGHTS_BYTES + AUDIO_SPAN * 4 + 3 * (STAGE1_EXT + 2 * PAD) * ROW * 2
SMEM2 = 2 * DWEIGHTS_BYTES + 3 * (STAGE2_EXT + 2 * PAD) * ROW * 2


class DownPlan(NamedTuple):
    stage1_blocks: int       # grid of stage 1, batch rows included
    stage2_blocks: int
    smem1: int               # dynamic shared memory per block
    smem2: int


def downpath_plan(b: int, length: int) -> DownPlan:
    """The two launches' grids for a (b, length) call."""
    n1, n3 = length // 4, length // 256
    return DownPlan(b * -(-n1 // STAGE1_TILE), b * -(-n3 // STAGE2_TILE),
                    SMEM1, SMEM2)


@torch.no_grad()
def pack_downpath_weights(first_audio_conv, downsample,
                          dtype=torch.bfloat16) -> tuple:
    """The model's first conv and DBlocks -> (first_aug (K0+1, C), res_aug
    (nb, C+1, C), conv_aug (nb, layers, 3C+1, C)), JAX's packing: row
    k*C + i of a conv operand is tap k, input channel i; the last row is
    the bias. Takes modules with PyTorch-layout ``weight`` (O, I, K) and
    ``bias``; the packs are constants (no autograd)."""
    wf = first_audio_conv.weight                             # (C, 1, K0)
    first = torch.cat([wf[:, 0, :].t(), first_audio_conv.bias[None, :]])
    res, conv = [], []
    for blk in downsample:
        rd = blk.residual_dense
        res.append(torch.cat([rd.weight[:, :, 0].t(), rd.bias[None, :]]))
        conv.append(torch.stack([
            torch.cat([cv.weight.permute(2, 1, 0).reshape(
                -1, cv.weight.shape[0]), cv.bias[None, :]])
            for cv in blk.convs]))
    return (first.to(dtype).contiguous(),
            torch.stack(res).to(dtype).contiguous(),
            torch.stack(conv).to(dtype).contiguous())


@torch.no_grad()
def pack_downpath_bias(first_audio_conv, downsample) -> torch.Tensor:
    """The NCL layout's biases, float32 (1 + nb (layers + 1), C): the first
    conv's, then per DBlock its convs' and its residual's."""
    rows = [first_audio_conv.bias]
    for blk in downsample:
        rows += [cv.bias for cv in blk.convs] + [blk.residual_dense.bias]
    return torch.stack(rows).float().contiguous()


def required_halo(factors, k0: int = 7, n_layers: int = 3) -> int:
    """Whole-path receptive field at input rate, rounded up to a multiple
    of the final rate (JAX's ``required_halo``; 2048 for (4, 8, 8))."""
    rf = (k0 - 1) // 2
    rate, prod = 1, 1
    for f in factors:
        prod *= f
    for f in factors:
        rate *= f
        rf += (2 ** n_layers - 1) * rate
    return -(-rf // prod) * prod


def downpath_fusable(length: int, factors) -> bool:
    """JAX's route gate: at least 2 halo units and a halo-aligned length."""
    halo = required_halo(factors)
    return length % halo == 0 and length // halo >= 2


def _conv_nwc(x: torch.Tensor, w_aug: torch.Tensor, offsets) -> torch.Tensor:
    """f32 sum over taps of x shifted by each offset (zero filled) @ its
    rows of w_aug, plus the bias row: x (B, L, I), w_aug (T*I+1, O)."""
    cin = x.shape[-1]
    taps = len(offsets)
    w = w_aug[:-1].float().reshape(taps, cin, -1).permute(2, 1, 0)
    d = offsets[1] - offsets[0] if taps > 1 else 1
    y = F.conv1d(x.transpose(1, 2).float(), w, w_aug[-1].float(),
                 padding=-offsets[0], dilation=d)
    return y.transpose(1, 2)


def downpath_plain(audio: torch.Tensor, first_aug: torch.Tensor,
                   res_aug: torch.Tensor, conv_aug: torch.Tensor,
                   factors) -> tuple:
    """Plain PyTorch K8 with the kernel's cast points (those of JAX's
    ``_unfused_reference``): audio (B, L, 1) float32 -> (skip0, skip1,
    skip2, x) in bf16, NWC."""
    k0 = first_aug.shape[0] - 1
    half = (k0 - 1) // 2
    x = _conv_nwc(audio.to(torch.bfloat16), first_aug,
                  range(-half, half + 1)).to(torch.bfloat16)
    outs = [x]
    for bi, f in enumerate(factors):
        x = x[:, ::f]
        res = _conv_nwc(x, res_aug[bi], (0,))
        y = x
        for li in range(conv_aug.shape[1]):
            d = 2 ** li
            y = _conv_nwc(leaky_relu(y), conv_aug[bi, li],
                          (-d, 0, d)).to(torch.bfloat16)
        x = y + res.to(torch.bfloat16)
        outs.append(x)
    return tuple(outs)


def _unpack_conv(w_aug: torch.Tensor, taps: int) -> torch.Tensor:
    """A packed operand (taps*I+1, O) -> its weight (O, I, taps), float32,
    the bias row left out."""
    return (w_aug[:-1].float().reshape(taps, -1, w_aug.shape[-1])
            .permute(2, 1, 0).contiguous())


def downpath_ncl_plain(audio: torch.Tensor, first_aug: torch.Tensor,
                       res_aug: torch.Tensor, conv_aug: torch.Tensor,
                       bias: torch.Tensor, factors) -> tuple:
    """The NCL route's down path as its module chain computes it
    (``FastDiff._down_path`` with ``DBlock.forward``), op for op, from the
    packs' bf16 weights and the float32 biases: audio (B, L, 1) float32 ->
    (skip0, skip1, skip2, x) in bf16, NCL."""
    bf16 = torch.bfloat16
    b, length, _ = audio.shape
    k0 = first_aug.shape[0] - 1
    n_layers = conv_aug.shape[1]
    x = fnn.conv1d_ncl(_unpack_conv(first_aug, k0), bias[0],
                       audio.to(bf16).reshape(b, 1, length),
                       compute_dtype=bf16)
    outs = [x]
    for bi, f in enumerate(factors):
        rows = bias[1 + bi * (n_layers + 1):]
        x = fnn.nearest_downsample_ncl(x, f)
        residual = fnn.conv1d_ncl(_unpack_conv(res_aug[bi], 1),
                                  rows[n_layers], x, compute_dtype=bf16)
        for li in range(n_layers):
            x = fnn.conv1d_ncl(_unpack_conv(conv_aug[bi, li], 3), rows[li],
                               fnn.leaky_relu(x, 0.2), dilation=2 ** li,
                               compute_dtype=bf16)
        x = x + residual
        outs.append(x)
    return tuple(outs)


def _check_cuda_operands(audio, first_aug, res_aug, conv_aug, factors,
                         what: str = "downpath_fused", align: int = 256):
    b, length, ch = audio.shape
    if audio.dtype != torch.float32 or ch != 1:
        raise ValueError(f"{what}: audio must be f32 (B, L, 1), got "
                         f"{audio.dtype} {tuple(audio.shape)}")
    for name, t in (("audio", audio), ("first_aug", first_aug),
                    ("res_aug", res_aug), ("conv_aug", conv_aug)):
        if t.device != audio.device:
            raise ValueError(f"{what}: {name} on {t.device}, audio "
                             f"on {audio.device}")
        if name != "audio" and t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: {name} must be bf16, got "
                             f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous "
                             "and 16-byte aligned")
    c = first_aug.shape[1]
    nb, n_layers = conv_aug.shape[:2]
    if (c != KERNEL_CHANNELS or tuple(factors) != KERNEL_FACTORS
            or first_aug.shape[0] != KERNEL_TAPS + 1
            or n_layers != KERNEL_LAYERS or nb != len(KERNEL_FACTORS)):
        raise ValueError(
            f"{what}: the kernel is built for C={KERNEL_CHANNELS}, "
            f"factors {KERNEL_FACTORS}, a k={KERNEL_TAPS} first conv and "
            f"{KERNEL_LAYERS} layers per block; got C={c}, factors "
            f"{tuple(factors)}, first_aug {tuple(first_aug.shape)}, conv_aug "
            f"{tuple(conv_aug.shape)}")
    if (res_aug.shape != (nb, c + 1, c)
            or conv_aug.shape != (nb, n_layers, 3 * c + 1, c)
            or length % align):
        raise ValueError(
            f"{what}: bad shapes audio {tuple(audio.shape)} (L must "
            f"be a multiple of {align}), res_aug {tuple(res_aug.shape)}, "
            f"conv_aug {tuple(conv_aug.shape)}")


def _outputs(audio, c: int, factors, ncl: bool) -> list:
    b, length, _ = audio.shape
    outs, rate = [], 1
    for f in (1, *factors):
        rate *= f
        shape = (b, c, length // rate) if ncl else (b, length // rate, c)
        outs.append(audio.new_empty(shape, dtype=torch.bfloat16))
    return outs


def _launch(name: str, audio, weights, factors, ncl: bool) -> tuple:
    """Allocates the four outputs in the layout, launches the C entry
    ``{name}_launch`` on checked operands (``weights``: its operands after
    the audio, in its order) and counts one ``LAUNCHES[name]``."""
    b, length, _ = audio.shape
    c = weights[0].shape[1]
    outs = _outputs(audio, c, factors, ncl)
    if b == 0 or length == 0:
        return tuple(outs)
    entry = f"{name}_launch"
    lib = _build.library()
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(
            audio.data_ptr(), *(w.data_ptr() for w in weights),
            *(o.data_ptr() for o in outs), b, length, c, stream)
    _build.check(code, entry)
    LAUNCHES[name] += 1
    return tuple(outs)


def downpath_fused(audio: torch.Tensor, first_aug: torch.Tensor,
                   res_aug: torch.Tensor, conv_aug: torch.Tensor,
                   factors) -> tuple:
    """K8: audio (B, L, 1) float32 and the packed weights -> (skip0 (B, L,
    C), skip1 (B, L/4, C), skip2 (B, L/32, C), x (B, L/256, C)), bf16.

    CPU tensors run ``downpath_plain``. CUDA tensors launch
    ``csrc/downpath.cu`` (its two stages, counted as one launch) or
    raise."""
    if audio.device.type == "cpu":
        return downpath_plain(audio, first_aug, res_aug, conv_aug, factors)
    if audio.device.type != "cuda":
        raise ValueError(f"downpath_fused: unsupported device {audio.device}")
    _check_cuda_operands(audio, first_aug, res_aug, conv_aug, factors)
    return _launch("downpath", audio, (first_aug, res_aug, conv_aug),
                   factors, ncl=False)


def check_ncl_operands(audio, first_aug, res_aug, conv_aug, bias, factors):
    """What ``downpath_ncl`` checks before it launches; raises ValueError."""
    _check_cuda_operands(audio, first_aug, res_aug, conv_aug, factors,
                         "downpath_ncl", NCL_ALIGN)
    nb, n_layers = conv_aug.shape[:2]
    want = (1 + nb * (n_layers + 1), first_aug.shape[1])
    if (bias.dtype != torch.float32 or tuple(bias.shape) != want
            or bias.device != audio.device or not bias.is_contiguous()
            or bias.data_ptr() % 16):
        raise ValueError(
            f"downpath_ncl: bias must be contiguous, 16-byte aligned f32 "
            f"{want} on {audio.device}, got {bias.dtype} "
            f"{tuple(bias.shape)} on {bias.device}")


def downpath_ncl(audio: torch.Tensor, first_aug: torch.Tensor,
                 res_aug: torch.Tensor, conv_aug: torch.Tensor,
                 bias: torch.Tensor, factors) -> tuple:
    """K8 with the NCL layout and cast points: audio (B, L, 1) float32, the
    packed weights and the float32 biases -> (skip0 (B, C, L), skip1 (B, C,
    L/4), skip2 (B, C, L/32), x (B, C, L/256)), bf16.

    CPU tensors run ``downpath_ncl_plain``, the module chain bit for bit.
    CUDA tensors are checked (``check_ncl_operands``: L a multiple of 2048)
    and launch ``csrc/downpath.cu``'s NCL stages (counted as one
    ``LAUNCHES["downpath_ncl"]``), or raise."""
    if audio.device.type == "cpu":
        return downpath_ncl_plain(audio, first_aug, res_aug, conv_aug, bias,
                                  factors)
    if audio.device.type != "cuda":
        raise ValueError(f"downpath_ncl: unsupported device {audio.device}")
    check_ncl_operands(audio, first_aug, res_aug, conv_aug, bias, factors)
    return _launch("downpath_ncl", audio,
                   (first_aug, res_aug, conv_aug, bias), factors, ncl=True)
