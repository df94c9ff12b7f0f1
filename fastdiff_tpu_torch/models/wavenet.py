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
import torch.nn.functional as F
from torch import nn

from fastdiff_tpu_torch.models.fastdiff import WNConv
from fastdiff_tpu_torch.ops import nn as fnn

SQRT_HALF = float(np.float32(math.sqrt(0.5)))


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
    """One weight-normed ConvTranspose2d(1, 1, (3, 2s), stride (1, s),
    padding (1, s // 2)) + leaky ReLU 0.4."""

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride
        self.v = nn.Parameter(torch.empty(1, 1, 3, 2 * stride))
        self.g = nn.Parameter(torch.empty(()))
        self.bias = nn.Parameter(torch.empty(1))

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """x (B, 1, n_mels, T') -> (B, 1, n_mels, T' * s) in ``dtype``."""
        w = self.g * self.v / torch.sqrt(torch.sum(self.v ** 2) + 1e-12)
        s = self.stride
        y = F.conv_transpose2d(x.float(), w.to(dtype).float(), stride=(1, s),
                               padding=(1, s // 2)).to(dtype)
        y = y + self.bias.to(dtype)
        return fnn.leaky_relu(y, 0.4).to(dtype)


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
        c = cfg.res_channels
        length = audio.shape[1]
        emb = self._embed(t)
        x = torch.relu(_conv(self.init_conv,
                             audio.to(dtype).transpose(1, 2), dtype))
        mel2d = mel.to(dtype).transpose(1, 2)[:, None]     # (B, 1, M, T')
        skip_sum = torch.zeros(audio.shape[0], cfg.skip_channels, length,
                               device=audio.device)
        for n, blk in enumerate(self.blocks):
            part_t = fnn.dense(blk.fc_t.weight, blk.fc_t.bias, emb,
                               compute_dtype=dtype)
            h = x + part_t[:, :, None].to(x.dtype)
            h = _conv(blk.dilated_conv, h, dtype,
                      dilation=2 ** (n % cfg.dilation_cycle))
            cond = mel2d
            for up in blk.upsamplers:
                cond = up(cond, dtype)
            cond = cond[:, 0, :, :length]
            h = h + _conv(blk.mel_conv, cond, dtype)
            out = torch.tanh(h[:, :c]) * torch.sigmoid(h[:, c:])
            res = _conv(blk.res_conv, out, dtype)
            x = (x + res).float() * SQRT_HALF
            skip_sum = skip_sum + _conv(blk.skip_conv, out, dtype)
        skip = skip_sum * float(np.float32(math.sqrt(1.0 / cfg.num_res_layers)))
        skip = torch.relu(_conv(self.final_conv, skip.to(dtype), dtype))
        out = fnn.conv1d_ncl(self.out_conv.weight, self.out_conv.bias, skip,
                             compute_dtype=dtype)
        return out.float().transpose(1, 2)
