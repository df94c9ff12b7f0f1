"""FastDiff denoiser, NCL inference forward (``fastdiff_tpu/models/fastdiff.py``).

    input conv (k=7, 1->C)
      -> 3 DBlocks (nearest downsample x4, x8, x8), skips saved
      -> 3 time-aware LVC blocks (transposed-conv upsample x8, x8, x4; hops
         8, 64, 256), each conditioned on mel + a projection of the
         diffusion-step embedding through a kernel predictor
      -> output conv (k=7, C->1), run as the last LVC block's epilogue

Same function as the JAX ``use_pallas_block="ncl"`` route
(``_fastdiff_apply_ncl``). Parameter names mirror the JAX tree from
``init_fastdiff``; weights are the weight-norm-fused ones (``bridge.py``
converts a JAX tree). The operands of the two kernels (merged head weights,
stacked conv weights, final-conv taps) are packed once, by ``pack``, when
weights are set: they are constant during inference.

``use_kernels`` picks the LVC head and block implementation: True calls the
kernel wrappers (CUDA kernels on the card, their plain versions on CPU
tensors); False calls the plain versions everywhere.
"""

from __future__ import annotations

import torch
from torch import nn

from fastdiff_tpu.config import ModelConfig
from fastdiff_tpu_torch.ops import lvc_block_ncl as block_ops
from fastdiff_tpu_torch.ops import lvc_head
from fastdiff_tpu_torch.ops import nn as fnn


def _conv_apply(conv: nn.Conv1d, x, dtype, dilation: int = 1):
    return fnn.conv1d_ncl(conv.weight, conv.bias, x, dilation=dilation,
                          compute_dtype=dtype)


class DBlock(nn.Module):
    """Nearest downsample + 3 dilated k=3 convs + 1x1 residual
    (``_dblock_apply_ncl``; the 1x1 conv runs after the downsample, which is
    exact since it is pointwise in time)."""

    def __init__(self, c: int):
        super().__init__()
        self.residual_dense = nn.Conv1d(c, c, 1)
        self.convs = nn.ModuleList([nn.Conv1d(c, c, 3) for _ in range(3)])

    def forward(self, x, factor: int, dtype):
        x = fnn.nearest_downsample_ncl(x, factor)
        residual = _conv_apply(self.residual_dense, x, dtype)
        for i, conv in enumerate(self.convs):
            x = _conv_apply(conv, fnn.leaky_relu(x, 0.2), dtype, 2 ** i)
        return x + residual


class KernelPredictor(nn.Module):
    """Conv trunk over the conditioning mel + the merged LVC kernel head."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        c, hid, ksz = (cfg.inner_channels, cfg.kpnet_hidden_channels,
                       cfg.kpnet_conv_size)
        layers, k = cfg.lvc_layers_each_block, cfg.lvc_kernel_size
        self.input_conv = nn.Conv1d(cfg.cond_channels, hid, 5)
        self.residual_convs = nn.ModuleList(
            [nn.Conv1d(hid, hid, ksz) for _ in range(6)])
        # output channels in (layers, K, Cin, Cout) order
        self.kernel_conv = nn.Conv1d(hid, layers * k * c * 2 * c, ksz)
        self.bias_conv = nn.Conv1d(hid, layers * 2 * c, ksz)

    def trunk(self, cond, dtype):
        """``_kp_trunk``: cond (B, cond_ch, F) -> (B, hid, F)."""
        c = fnn.leaky_relu(_conv_apply(self.input_conv, cond, dtype), 0.1)
        r = c
        for conv in self.residual_convs:
            r = fnn.leaky_relu(_conv_apply(conv, r, dtype), 0.1)
        return c + r


class LVCBlock(nn.Module):
    """Time-aware LVC block (``_lvc_block_apply_ncl``)."""

    def __init__(self, cfg: ModelConfig, ratio: int, hop: int):
        super().__init__()
        c = cfg.inner_channels
        self.ratio, self.hop = ratio, hop
        self.layers = cfg.lvc_layers_each_block
        self.upsample = nn.ConvTranspose1d(c, c, 2 * ratio)
        self.fc_t = nn.Linear(cfg.diffusion_step_embed_dim_out,
                              cfg.cond_channels)
        self.kernel_predictor = KernelPredictor(cfg)
        self.convs = nn.ModuleList(
            [nn.Conv1d(c, c, cfg.lvc_kernel_size)
             for _ in range(self.layers)])

    @torch.no_grad()
    def pack(self, dtype):
        kp = self.kernel_predictor
        c = self.convs[0].weight.shape[0]
        w_head, b_head = lvc_head.pack_head(
            kp.kernel_conv.weight, kp.kernel_conv.bias, kp.bias_conv.weight,
            kp.bias_conv.bias, layers=self.layers, c=c, dtype=dtype)
        wstack_t = block_ops.stack_conv_weights(
            [cv.weight for cv in self.convs], [cv.bias for cv in self.convs],
            dtype=dtype)
        self.register_buffer("w_head", w_head, persistent=False)
        self.register_buffer("b_head", b_head, persistent=False)
        self.register_buffer("wstack_t", wstack_t, persistent=False)

    def forward(self, x, skip, mel, emb, dtype, use_kernels: bool,
                final_wb=None):
        noise = fnn.dense(self.fc_t.weight, self.fc_t.bias, emb,
                          compute_dtype=dtype)                 # (B, cond) f32
        cond = mel + noise[:, :, None].to(mel.dtype)
        trunk = self.kernel_predictor.trunk(cond, dtype)       # (B, hid, F)
        b, _, frames = trunk.shape
        tap = lvc_head.head_taps(trunk.to(dtype))
        head = (lvc_head.taug_head_matmul if use_kernels
                else lvc_head.taug_head_matmul_plain)
        c = self.convs[0].weight.shape[0]
        kern = head(tap, self.w_head, self.b_head).reshape(
            b, frames, self.layers, 2 * c, -1)

        x = fnn.leaky_relu(x, 0.2)
        r = self.ratio
        x = fnn.conv_transpose1d_ncl(
            self.upsample.weight, self.upsample.bias, x, stride=r,
            torch_padding=r // 2 + r % 2, output_padding=r % 2,
            compute_dtype=dtype)
        block = (block_ops.lvc_block_ncl if use_kernels
                 else block_ops.lvc_block_ncl_plain)
        return block(x.to(dtype).contiguous(), skip.to(dtype).contiguous(),
                     kern, self.wstack_t, self.hop, final_wb)


class FastDiff(nn.Module):
    """Epsilon model: ``forward(audio (B, T, 1), mel (B, T', n_mels),
    t (B, 1)) -> (B, T, 1)`` float32, T == T' * prod(upsample_ratios)."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), *,
                 seed: int | None = 0, device=None):
        super().__init__()
        if cfg.audio_channels != 1:
            raise ValueError("the NCL forward needs audio_channels == 1")
        self.cfg = cfg
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        self.use_kernels = True
        c = cfg.inner_channels
        self.first_audio_conv = nn.Conv1d(cfg.audio_channels, c, 7)
        self.final_conv = nn.Conv1d(c, cfg.audio_channels, 7)
        self.fc_t1 = nn.Linear(cfg.diffusion_step_embed_dim_in,
                               cfg.diffusion_step_embed_dim_mid)
        self.fc_t2 = nn.Linear(cfg.diffusion_step_embed_dim_mid,
                               cfg.diffusion_step_embed_dim_out)
        self.lvc_blocks = nn.ModuleList(
            [LVCBlock(cfg, r, hop) for r, hop in
             zip(cfg.upsample_ratios, cfg.cond_hop_lengths)])
        # downsample[n] shrinks by the reversed ratio order
        self.downsample = nn.ModuleList(
            [DBlock(c) for _ in cfg.upsample_ratios])
        if seed is not None:
            self.init_weights(torch.Generator().manual_seed(seed))
        self.pack()
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random init with the JAX package's distributions (torch defaults:
        U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias; fan_in is
        O*K for a transposed conv). Weight norm starts at g = ||v||, so the
        fused weight equals v."""
        for module in self.modules():
            if isinstance(module, nn.ConvTranspose1d):
                fan_in = module.weight.shape[1] * module.weight.shape[2]
            elif isinstance(module, (nn.Conv1d, nn.Linear)):
                fan_in = module.weight[0].numel()
            else:
                continue
            bound = fan_in ** -0.5
            module.weight.uniform_(-bound, bound, generator=generator)
            module.bias.uniform_(-bound, bound, generator=generator)
        self.pack()

    @torch.no_grad()
    def pack(self):
        """Pack the kernels' constant operands from the current weights."""
        for block in self.lvc_blocks:
            block.pack(self.dtype)
        self.register_buffer(
            "final_wb", block_ops.final_conv_wb(
                self.final_conv.weight, self.final_conv.bias, self.dtype),
            persistent=False)

    def load_state_dict(self, state_dict, strict: bool = True, assign=False):
        result = super().load_state_dict(state_dict, strict=strict,
                                         assign=assign)
        self.pack()
        return result

    def forward(self, audio: torch.Tensor, mel: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        cfg, dtype = self.cfg, self.dtype
        emb = fnn.diffusion_step_embedding(t, cfg.diffusion_step_embed_dim_in)
        emb = fnn.swish(fnn.dense(self.fc_t1.weight, self.fc_t1.bias, emb))
        emb = fnn.swish(fnn.dense(self.fc_t2.weight, self.fc_t2.bias, emb))

        b, length, _ = audio.shape
        x = _conv_apply(self.first_audio_conv,
                        audio.to(dtype).reshape(b, 1, length), dtype)
        skips = []
        for dblock, factor in zip(self.downsample, cfg.upsample_ratios[::-1]):
            skips.append(x)
            x = dblock(x, factor, dtype)

        mel_ncl = mel.to(dtype).transpose(1, 2)
        n_blocks = len(self.lvc_blocks)
        for n, block in enumerate(self.lvc_blocks):
            last = n == n_blocks - 1
            x = block(x, skips[n_blocks - 1 - n], mel_ncl, emb, dtype,
                      self.use_kernels, self.final_wb if last else None)
        _, fin = x
        return fin.reshape(b, length, 1)


def num_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
