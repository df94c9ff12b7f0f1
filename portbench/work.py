"""The yardstick of work: the card's published peaks, model FLOPs per
vocoder call from a configuration's widths and a call's shape, and the
operations and bytes of the port's LVC kernels (K1 / K2, Kernel B; K3,
Kernel A) per call.

A call is one sampler run of N reverse steps over ``batch`` rows of
``frames`` mel frames (the padded bucket), ``frames * hop`` samples each.
A multiply-add counts as two FLOPs; elementwise work is not counted.
"""

from __future__ import annotations

H100_BF16_PEAK = 989e12          # dense bf16 FLOP/s, SXM, 700 W
H100_HBM_BYTES_PER_S = 3.35e12   # HBM3 bandwidth


def _prod(values) -> int:
    out = 1
    for v in values:
        out *= int(v)
    return out


def conv_flops(cin: int, cout: int, k: int) -> int:
    """FLOPs per output position of a dense 1-D convolution."""
    return 2 * cin * cout * k


def fastdiff_flops_per_forward(cfg: dict, frames: int) -> float:
    """One FastDiff denoiser forward over one row of ``frames`` frames."""
    c, cond = int(cfg["inner_channels"]), int(cfg["cond_channels"])
    hid, ksz = int(cfg["kpnet_hidden_channels"]), int(cfg["kpnet_conv_size"])
    layers, k = int(cfg["lvc_layers_each_block"]), int(cfg["lvc_kernel_size"])
    ratios = [int(r) for r in cfg["upsample_ratios"]]
    length = frames * _prod(ratios)
    total = conv_flops(1, c, 7) * length              # first conv, 1 -> C
    total += conv_flops(c, 1, 7) * length             # final conv, C -> 1
    size = length
    for factor in ratios[::-1]:                       # DBlocks
        size //= factor
        total += size * (conv_flops(c, c, 1) + 3 * conv_flops(c, c, 3))
    hop = 1
    for r in ratios:                                  # LVC blocks
        hop *= r
        out_len = frames * hop
        total += out_len * conv_flops(c, c, 2 * r) / r    # transposed conv
        total += out_len * layers * (conv_flops(c, c, k)
                                     + conv_flops(c, 2 * c, k))
        total += frames * (conv_flops(cond, hid, 5)
                           + 6 * conv_flops(hid, hid, ksz)
                           + conv_flops(hid, layers * k * c * 2 * c, ksz)
                           + conv_flops(hid, layers * 2 * c, ksz))
    return float(total)


def wavenet_flops_per_forward(cfg: dict, frames: int, hop: int) -> float:
    """One DiffWave (WaveNet) denoiser forward over one row."""
    c, skip = int(cfg["res_channels"]), int(cfg["skip_channels"])
    cond, layers = int(cfg["cond_channels"]), int(cfg["num_res_layers"])
    s = 8 if cfg["multiband"] else 16
    length = frames * hop
    per_layer = (conv_flops(c, 2 * c, 3) + conv_flops(cond, 2 * c, 1)
                 + conv_flops(c, c, 1) + conv_flops(c, skip, 1))
    # two transposed 2-D upsamplers (3 x 2s taps, stride s: 6 taps an
    # output) over the mel's bins, at frames * s and at frames * s * s
    upsample = cond * 2 * 6 * (frames * s + frames * s * s)
    return float(length * (conv_flops(1, c, 1) + layers * per_layer
                           + conv_flops(skip, skip, 1) + conv_flops(skip, 1, 1))
                 + layers * upsample)


def model_flops(family: str, cfg: dict, batch: int, frames: int) -> float:
    """FLOPs of one vocoder call: N forwards over ``batch`` rows."""
    n_steps = int(cfg["N"])
    if family == "fastdiff":
        per = fastdiff_flops_per_forward(cfg, frames)
    elif family == "wavenet":
        per = wavenet_flops_per_forward(cfg, frames, int(cfg["hop_size"]))
    else:
        raise ValueError(f"no FLOP count for the family {family!r}")
    return n_steps * batch * per


def rows_padded(c: int, k: int) -> int:
    """Rows of one LVC kernel slab in the port's packing: K*C + 1 (the
    bias row) rounded up to 8."""
    return -(-(k * c + 1) // 8) * 8


def gemm_work(m: int, k: int, n: int) -> tuple:
    """(FLOP, bytes) of (M, K) @ (K, N) + float32 bias (N,) -> (M, N), bf16
    operands: each operand read once, the output written once."""
    return 2.0 * m * k * n, 2.0 * (m * k + k * n + m * n) + 4.0 * n


def block_work(b: int, c: int, length: int, kern_bytes: float,
               final: bool, layers: int) -> tuple:
    """(FLOP, bytes) of one Kernel B call: per sample and layer the dilated
    conv (2 C (3C+1)) and the LVC (2 2C (3C+1)); x and skip read and out
    written once in bf16, the kernel operand read once, and the final
    conv (k 7, C -> 1) with its float32 output where it is fused."""
    rows = 3 * c + 1
    flop = b * length * layers * 2.0 * 3 * c * rows
    nbytes = 3 * 2.0 * b * c * length + kern_bytes
    if final:
        flop += 2.0 * 7 * c * b * length
        nbytes += 4.0 * b * length
    return flop, nbytes


def least_seconds(works) -> float:
    """The least time the card could take for a run of kernel calls, each
    (FLOP, bytes): the sum over calls of the larger of bytes at the HBM
    rate and FLOPs at the bf16 peak."""
    return sum(max(nbytes / H100_HBM_BYTES_PER_S, flop / H100_BF16_PEAK)
               for flop, nbytes in works)


def lvc_kernel_works(cfg: dict, batch: int, frames: int) -> dict:
    """{"lvc_block": [...], "taug_head": [...]}: the (FLOP, bytes) of each
    Kernel B (K1, and K2 with the final conv on the last block) and each
    Kernel A (K3) launch of one FastDiff call on the NCL route."""
    c, hid = int(cfg["inner_channels"]), int(cfg["kpnet_hidden_channels"])
    ksz, layers = int(cfg["kpnet_conv_size"]), int(cfg["lvc_layers_each_block"])
    k = int(cfg["lvc_kernel_size"])
    ratios = [int(r) for r in cfg["upsample_ratios"]]
    n_out = layers * 2 * c * rows_padded(c, k)
    blocks, heads = [], []
    hop = 1
    for n, r in enumerate(ratios):
        hop *= r
        heads.append(gemm_work(batch * frames, ksz * hid, n_out))
        blocks.append(block_work(batch, c, frames * hop,
                                 2.0 * batch * frames * n_out,
                                 final=n == len(ratios) - 1, layers=layers))
    n_steps = int(cfg["N"])
    return {"lvc_block": blocks * n_steps, "taug_head": heads * n_steps}
