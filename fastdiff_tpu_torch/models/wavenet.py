"""DiffWave-style WaveNet denoiser (``fastdiff_tpu/models/wavenet.py``), the
``denoiser: wavenet`` family of ``training/task.py``.

    block n: h = x + fc_t(t_emb);  h = dilated_conv(h) (-> 2C)
             h += mel_conv(upsample_n(mel));  out = tanh(h_a) * sigmoid(h_b)
             x <- (x + res_conv(out)) * sqrt(0.5);  skip += skip_conv(out)
    head:    relu(conv1x1(skip_sum / sqrt(N))) -> zero-init 1x1 conv

Every block upsamples the mel with its own pair of ConvTranspose2d(1, 1,
(3, 2s), stride (1, s), padding (1, s // 2)) filters, each followed by
leaky ReLU 0.4 (s = 8 multiband, 16 fullband), as the reference does; the
result is cropped to the audio's length. Activations are NCL. Weight norm
stays as parameters: ``v``, ``g`` and ``bias`` of every conv (``g`` per
output channel, ``ops/nn.py:conv_weight``), and of each upsampler (a
whole-tensor norm, ``g`` a scalar), each with ``+ 1e-12`` under the square
root as JAX's. An upsampler's ``v`` is PyTorch's ConvTranspose2d kernel
(1, 1, 3, 2s); JAX stores it flipped in both spatial axes
(``models/bridge.py`` flips it).

Each residual block is one call of ``ops/wavenet_block.py``. With
gradients off (the samplers' inference mode), bf16 and the widths its
``supports`` names (64 residual and skip channels, 80 mel bins: DiffWave
BASE's) that is ``wavenet_block``: the hand-written kernel of the whole
block on a card, which raises on a length it does not take, and the plain
version on the CPU. Otherwise (training, or other widths) the block runs
``wavenet_block_plain``, whose upsamplers, crop, mel_conv and add into h
are ``ops/wavenet_cond.py:wavenet_cond_plain``.

Cast points follow JAX's: the step embedding in float32, each conv in the
compute dtype with float32 accumulation, and x in float32 from the first
residual on (JAX multiplies by a float32 scalar there).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from fastdiff_tpu_torch.models.fastdiff import WNConv
from fastdiff_tpu_torch.ops import nn as fnn
from fastdiff_tpu_torch.ops import wavenet_block

SQRT_HALF = wavenet_block.SQRT_HALF


@dataclasses.dataclass(frozen=True)
class WaveNetConfig:
    in_channels: int = 1
    res_channels: int = 64
    skip_channels: int = 64
    out_channels: int = 1
    num_res_layers: int = 30
    dilation_cycle: int = 10
    noise_scale_embed_dim_in: int = 128
    noise_scale_embed_dim_mid: int = 512
    noise_scale_embed_dim_out: int = 512
    multiband: bool = True
    cond_channels: int = 80
    compute_dtype: str = "bfloat16"

    @property
    def upsample_strides(self) -> Tuple[int, int]:
        s = 8 if self.multiband else 16
        return (s, s)

    @classmethod
    def from_hparams(cls, hp: dict) -> "WaveNetConfig":
        return cls(
            in_channels=int(hp.get("audio_channels", 1)),
            res_channels=int(hp.get("res_channels", 64)),
            skip_channels=int(hp.get("skip_channels", 64)),
            out_channels=int(hp.get("audio_channels", 1)),
            num_res_layers=int(hp.get("num_res_layers", 30)),
            dilation_cycle=int(hp.get("dilation_cycle", 10)),
            noise_scale_embed_dim_in=int(
                hp.get("diffusion_step_embed_dim_in", 128)),
            noise_scale_embed_dim_mid=int(
                hp.get("diffusion_step_embed_dim_mid", 512)),
            noise_scale_embed_dim_out=int(
                hp.get("diffusion_step_embed_dim_out", 512)),
            multiband=bool(hp.get("multiband", True)),
            cond_channels=int(hp.get("cond_channels", 80)),
            compute_dtype=str(hp.get("compute_dtype", "bfloat16")),
        )


def compute_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


class Upsampler(nn.Module):
    """The parameters of one weight-normed ConvTranspose2d(1, 1, (3, 2s),
    stride (1, s), padding (1, s // 2)) + leaky ReLU 0.4, which
    ``ops/wavenet_cond.py:upsample_plain`` and the block kernel run."""

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride
        self.v = nn.Parameter(torch.empty(1, 1, 3, 2 * stride))
        self.g = nn.Parameter(torch.empty(()))
        self.bias = nn.Parameter(torch.empty(1))

    def weight(self) -> torch.Tensor:
        """The weight-normed kernel (1, 1, 3, 2s), float32."""
        return self.g * self.v / torch.sqrt(torch.sum(self.v ** 2) + 1e-12)


class WaveNetBlock(nn.Module):
    def __init__(self, cfg: WaveNetConfig):
        super().__init__()
        c = cfg.res_channels
        self.fc_t = nn.Linear(cfg.noise_scale_embed_dim_out, c)
        self.dilated_conv = WNConv(c, 2 * c, 3)
        self.upsamplers = nn.ModuleList(
            [Upsampler(s) for s in cfg.upsample_strides])
        self.mel_conv = WNConv(cfg.cond_channels, 2 * c, 1)
        self.res_conv = WNConv(c, c, 1)
        self.skip_conv = WNConv(c, cfg.skip_channels, 1)

    def weights(self) -> wavenet_block.BlockWeights:
        """The block's weights as ``ops/wavenet_block.py`` takes them,
        weight norm resolved (f32)."""
        return wavenet_block.BlockWeights(
            self.dilated_conv.weight, self.dilated_conv.bias,
            [(up.weight(), up.bias) for up in self.upsamplers],
            self.mel_conv.weight, self.mel_conv.bias,
            self.res_conv.weight, self.res_conv.bias,
            self.skip_conv.weight, self.skip_conv.bias)


def _conv(conv, x, dtype, dilation: int = 1):
    return fnn.conv1d_ncl(conv.weight, conv.bias, x, dilation=dilation,
                          compute_dtype=dtype)


class WaveNet(nn.Module):
    """Epsilon model with the sampler's contract: ``forward(audio (B, T,
    C_in), mel (B, T', n_mels), t (B, 1)) -> (B, T, C_out)`` float32
    (JAX's ``wavenet_apply``)."""

    def __init__(self, cfg: WaveNetConfig = WaveNetConfig(), *,
                 seed: int | None = 0, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.compute_dtype)
        self.init_conv = WNConv(cfg.in_channels, cfg.res_channels, 1)
        self.fc_t1 = nn.Linear(cfg.noise_scale_embed_dim_in,
                               cfg.noise_scale_embed_dim_mid)
        self.fc_t2 = nn.Linear(cfg.noise_scale_embed_dim_mid,
                               cfg.noise_scale_embed_dim_out)
        self.final_conv = WNConv(cfg.skip_channels, cfg.skip_channels, 1)
        self.out_conv = nn.Conv1d(cfg.skip_channels, cfg.out_channels, 1)
        self.blocks = nn.ModuleList(
            [WaveNetBlock(cfg) for _ in range(cfg.num_res_layers)])
        # widths the block kernel is built for (both upsamplers share one
        # stride); others run the plain version
        self.block_kernel = wavenet_block.supports(
            cfg.res_channels, cfg.skip_channels, cfg.cond_channels,
            cfg.upsample_strides[0], self.dtype)
        if seed is not None:
            self.init_weights(torch.Generator().manual_seed(seed))
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """JAX's distributions: the dense layers torch's defaults; each conv
        kaiming-normal v (std sqrt(2 / fan_in)), g = ||v|| and a uniform
        bias; each upsampler normal v (std sqrt(2 / (6s))), g = ||v||, bias
        0; the output conv zero."""
        fnn.uniform_init_(self, generator)
        for module in self.modules():
            if isinstance(module, WNConv):
                fan_in = module.v[0].numel()
                module.v.normal_(generator=generator).mul_(
                    math.sqrt(2.0 / fan_in))
                module.bias.uniform_(-fan_in ** -0.5, fan_in ** -0.5,
                                     generator=generator)
                module.g.copy_(module.v.flatten(1).norm(dim=1))
            elif isinstance(module, Upsampler):
                module.v.normal_(generator=generator).mul_(
                    math.sqrt(2.0 / module.v.numel()))
                module.g.copy_(module.v.norm())
                module.bias.zero_()
        self.out_conv.weight.zero_()
        self.out_conv.bias.zero_()

    def _embed(self, t):
        emb = fnn.diffusion_step_embedding(t, self.cfg.noise_scale_embed_dim_in)
        emb = fnn.swish(fnn.dense(self.fc_t1.weight, self.fc_t1.bias, emb))
        return fnn.swish(fnn.dense(self.fc_t2.weight, self.fc_t2.bias, emb))

    def forward(self, audio: torch.Tensor, mel: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        cfg, dtype = self.cfg, self.dtype
        stride = cfg.upsample_strides[0]
        emb = self._embed(t)
        x = torch.relu(_conv(self.init_conv,
                             audio.to(dtype).transpose(1, 2), dtype))
        # each block: with gradients off and at its widths ops/wavenet_block.py's
        # op (the kernel on a card, which has no backward), else its plain
        # version
        kernel = self.block_kernel and not torch.is_grad_enabled()
        mel_c = mel.to(dtype).contiguous()                  # (B, T', M)
        if kernel:
            x = x.contiguous()          # the kernel reads NCL rows of x
        skip_sum = None
        last = len(self.blocks) - 1
        for n, blk in enumerate(self.blocks):
            part_t = fnn.dense(blk.fc_t.weight, blk.fc_t.bias, emb,
                               compute_dtype=dtype)
            dilation = 2 ** (n % cfg.dilation_cycle)
            if kernel:
                # the forward never reads the last block's x
                x, skip_sum = wavenet_block.wavenet_block(
                    x, skip_sum, part_t, mel_c, blk.weights(),
                    dilation=dilation, stride=stride, want_x=n < last)
            else:
                x, skip_sum = wavenet_block.wavenet_block_plain(
                    x, skip_sum, part_t, mel_c, blk.weights(),
                    dilation=dilation, stride=stride)
        skip = skip_sum * float(np.float32(math.sqrt(1.0 / cfg.num_res_layers)))
        skip = torch.relu(_conv(self.final_conv, skip.to(dtype), dtype))
        out = fnn.conv1d_ncl(self.out_conv.weight, self.out_conv.bias, skip,
                             compute_dtype=dtype)
        return out.float().transpose(1, 2)
