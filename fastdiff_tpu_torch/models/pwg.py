"""Parallel WaveGAN generator and its diffusion-conditioned variant
(``fastdiff_tpu/models/pwg.py``).

    noise (B, T, 1) -> 1x1 conv -> ``layers`` gated residual blocks
    (dilations 2^(l % layers_per_stack)), each conditioned on the upsampled
    mel by a bias-free 1x1 conv; skip-sum / sqrt(layers) -> relu-1x1-relu-1x1
    -> waveform.

    mel upsampling (ConvInUpsampleNetwork): edge-pad by the context window,
    a valid bias-free conv_in (k = 2 * window + 1), then per scale a nearest
    time-stretch xS and one (1, 2S + 1) filter over time with padding S,
    shared by all channels (``F.conv2d`` on (B, 1, C, T)).

``PWG`` is the vocoder's generator (``pwg_apply``); ``PWGDiffusion`` adds a
FastDiff-style step embedding (128 -> 512 -> 512, swish) and per block a
Linear(512 -> residual) added to x before the block (``pwg_diffusion_apply``,
the ``denoiser: pwg`` family of ``training/task.py``). Parameters are plain
(no weight norm); activations are NCL; each conv runs in the compute dtype
with float32 accumulation.

``convert_pwg_state_dict`` / ``convert_pwg_diffusion_state_dict`` load a
state_dict in the reference's names (flat, weight norm as ``weight_g`` /
``weight_v`` or fused) into the port's names, weight norm fused as JAX's
converters fuse it (no epsilon). The reference's layouts are PyTorch's, so
only names change.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fastdiff_tpu_torch.models.wavenet import SQRT_HALF, compute_dtype
from fastdiff_tpu_torch.ops import nn as fnn

# the diffusion-step embedding MLP, 128 -> 512 -> 512 (JAX's
# init_pwg_diffusion defaults, which its task uses)
EMBED_IN, EMBED_MID, EMBED_OUT = 128, 512, 512


@dataclasses.dataclass(frozen=True)
class PWGConfig:
    in_channels: int = 1
    out_channels: int = 1
    kernel_size: int = 3
    layers: int = 30
    stacks: int = 3
    residual_channels: int = 64
    gate_channels: int = 128
    skip_channels: int = 64
    aux_channels: int = 80
    aux_context_window: int = 2
    upsample_scales: Tuple[int, ...] = (4, 4, 4, 4)
    compute_dtype: str = "bfloat16"

    @property
    def layers_per_stack(self) -> int:
        return self.layers // self.stacks

    @classmethod
    def from_hparams(cls, hp: dict) -> "PWGConfig":
        """Build from the flat hparams dict (the ``denoiser: pwg`` family)."""
        return cls(
            kernel_size=int(hp.get("pwg_kernel_size", 3)),
            layers=int(hp.get("pwg_layers", 30)),
            stacks=int(hp.get("pwg_stacks", 3)),
            residual_channels=int(hp.get("pwg_residual_channels", 64)),
            gate_channels=int(hp.get("pwg_gate_channels", 128)),
            skip_channels=int(hp.get("pwg_skip_channels", 64)),
            aux_channels=int(hp.get("audio_num_mel_bins", 80)),
            aux_context_window=int(hp.get("pwg_aux_context_window", 2)),
            upsample_scales=tuple(int(s) for s in hp.get(
                "pwg_upsample_scales", (4, 4, 4, 4))),
            compute_dtype=str(hp.get("compute_dtype", "bfloat16")),
        )


def conv_nobias(w: torch.Tensor, x: torch.Tensor, dtype,
                dilation: int = 1, valid: bool = False) -> torch.Tensor:
    """A bias-free conv in ``dtype`` (float32 accumulation): x (B, I, L),
    w (O, I, K); 'same' padding unless ``valid``."""
    k = w.shape[-1]
    pad = 0 if valid else dilation * ((k - 1) // 2)
    return F.conv1d(x.to(dtype).float(), w.to(dtype).float(), padding=pad,
                    dilation=dilation).to(dtype)


def stretch(c: torch.Tensor, up_w: torch.Tensor, scale: int,
            dtype) -> torch.Tensor:
    """One upsampling scale: c (B, C, T) -> (B, C, T * scale) by a nearest
    repeat and the shared (1, 2 * scale + 1) filter ``up_w`` (1, 1, 1,
    2 * scale + 1) over time."""
    c = torch.repeat_interleave(c, scale, dim=2)
    x = F.conv2d(c[:, None].to(dtype).float(), up_w.to(dtype).float(),
                 padding=(0, scale))
    return x[:, 0].to(dtype)


class PWGBlock(nn.Module):
    def __init__(self, cfg: PWGConfig, diffusion: bool):
        super().__init__()
        self.conv = nn.Conv1d(cfg.residual_channels, cfg.gate_channels,
                              cfg.kernel_size)
        self.aux_conv = nn.Conv1d(cfg.aux_channels, cfg.gate_channels, 1,
                                  bias=False)
        self.out_conv = nn.Conv1d(cfg.gate_channels // 2,
                                  cfg.residual_channels, 1)
        self.skip_conv = nn.Conv1d(cfg.gate_channels // 2,
                                   cfg.skip_channels, 1)
        if diffusion:
            self.fc_t = nn.Linear(EMBED_OUT, cfg.residual_channels)


class PWG(nn.Module):
    """``forward(noise (B, T, 1), mel (B, T', aux)) -> (B, T, 1)`` float32,
    T == T' * prod(upsample_scales) (JAX's ``pwg_apply``)."""

    diffusion = False

    def __init__(self, cfg: PWGConfig = PWGConfig(), *, seed: int | None = 0,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.compute_dtype)
        self.first_conv = nn.Conv1d(cfg.in_channels, cfg.residual_channels, 1)
        self.conv_in = nn.Conv1d(cfg.aux_channels, cfg.aux_channels,
                                 2 * cfg.aux_context_window + 1, bias=False)
        self.up_convs = nn.ModuleList(
            [nn.Conv2d(1, 1, (1, 2 * s + 1), bias=False)
             for s in cfg.upsample_scales])
        self.last_conv1 = nn.Conv1d(cfg.skip_channels, cfg.skip_channels, 1)
        self.last_conv2 = nn.Conv1d(cfg.skip_channels, cfg.out_channels, 1)
        self.blocks = nn.ModuleList(
            [PWGBlock(cfg, self.diffusion) for _ in range(cfg.layers)])
        if self.diffusion:
            self.fc_t1 = nn.Linear(EMBED_IN, EMBED_MID)
            self.fc_t2 = nn.Linear(EMBED_MID, EMBED_OUT)
        if seed is not None:
            self.init_weights(torch.Generator().manual_seed(seed))
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """torch's default uniform on every conv and dense layer; each
        upsampling filter the mean 1 / (2s + 1), as JAX's ``init_pwg``."""
        fnn.uniform_init_(self, generator)
        for up in self.up_convs:
            up.weight.fill_(1.0 / up.weight.shape[-1])

    def upsample_mel(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T', aux) -> (B, aux, T' * prod(scales)) in the compute dtype."""
        dtype = self.dtype
        w = self.cfg.aux_context_window
        mel = mel.transpose(1, 2)
        mel = F.pad(mel, (w, w), mode="replicate") if w else mel
        c = conv_nobias(self.conv_in.weight, mel, dtype, valid=True)
        for up, s in zip(self.up_convs, self.cfg.upsample_scales):
            c = stretch(c, up.weight, s, dtype)
        return c

    def _step_embed(self, t):
        emb = fnn.diffusion_step_embedding(t, EMBED_IN)
        emb = fnn.swish(fnn.dense(self.fc_t1.weight, self.fc_t1.bias, emb))
        return fnn.swish(fnn.dense(self.fc_t2.weight, self.fc_t2.bias, emb))

    def _run(self, x_in: torch.Tensor, mel: torch.Tensor, emb):
        cfg, dtype = self.cfg, self.dtype
        g2 = cfg.gate_channels // 2
        c = self.upsample_mel(mel)
        assert c.shape[2] == x_in.shape[1], (c.shape, x_in.shape)
        x = fnn.conv1d_ncl(self.first_conv.weight, self.first_conv.bias,
                           x_in.to(dtype).transpose(1, 2),
                           compute_dtype=dtype)
        skips = torch.zeros(x_in.shape[0], cfg.skip_channels, x_in.shape[1],
                            device=x_in.device)
        for layer, blk in enumerate(self.blocks):
            if emb is not None:
                noise = fnn.dense(blk.fc_t.weight, blk.fc_t.bias, emb,
                                  compute_dtype=dtype)
                x = x + noise[:, :, None].to(x.dtype)
            h = fnn.conv1d_ncl(blk.conv.weight, blk.conv.bias, x,
                               dilation=2 ** (layer % cfg.layers_per_stack),
                               compute_dtype=dtype)
            h = h + conv_nobias(blk.aux_conv.weight, c, dtype).to(h.dtype)
            gated = (torch.tanh(h[:, :g2]) * torch.sigmoid(h[:, g2:])).to(dtype)
            skips = skips + fnn.conv1d_ncl(blk.skip_conv.weight,
                                           blk.skip_conv.bias, gated,
                                           compute_dtype=dtype)
            out = fnn.conv1d_ncl(blk.out_conv.weight, blk.out_conv.bias,
                                 gated, compute_dtype=dtype)
            x = ((out.to(x.dtype) + x).float() * SQRT_HALF).to(dtype)
        s = skips * float(np.float32(math.sqrt(1.0 / cfg.layers)))
        s = torch.relu(s).to(dtype)
        s = torch.relu(fnn.conv1d_ncl(self.last_conv1.weight,
                                      self.last_conv1.bias, s,
                                      compute_dtype=dtype))
        out = fnn.conv1d_ncl(self.last_conv2.weight, self.last_conv2.bias,
                             s.to(dtype), compute_dtype=dtype)
        return out.float().transpose(1, 2)

    def forward(self, noise: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
        return self._run(noise, mel, None)


class PWGDiffusion(PWG):
    """The diffusion eps-model: ``forward(x_t (B, T, 1), mel (B, T', aux),
    t (B, 1)) -> (B, T, 1)`` (JAX's ``pwg_diffusion_apply``; x += fc_t(emb)
    before each residual block)."""

    diffusion = True

    def forward(self, x_t: torch.Tensor, mel: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        return self._run(x_t, mel, self._step_embed(t))


# ---------------------------------------------------------------------------
# State dicts in the reference's names (released PWG checkpoints)
# ---------------------------------------------------------------------------

def fused_weight(sd: dict, prefix: str) -> torch.Tensor:
    """``prefix``'s weight in PyTorch's layout, a (weight_g, weight_v) pair
    fused with the norm over every axis but the first (no epsilon)."""
    if f"{prefix}.weight_v" in sd:
        v = torch.as_tensor(sd[f"{prefix}.weight_v"]).float()
        g = torch.as_tensor(sd[f"{prefix}.weight_g"]).float().reshape(-1)
        norm = torch.sqrt((v ** 2).sum(dim=tuple(range(1, v.dim())),
                                       keepdim=True))
        return g.reshape((-1,) + (1,) * (v.dim() - 1)) * v / norm
    return torch.as_tensor(sd[f"{prefix}.weight"]).float()


def layers_from_reference(sd: dict, layers) -> dict:
    """The port's state_dict entries of ``layers``, (reference prefix, port
    name, bias) triples: ``name.weight`` fused and, when ``bias`` and the
    reference has one, ``name.bias``."""
    out = {}
    for prefix, name, bias in layers:
        out[f"{name}.weight"] = fused_weight(sd, prefix)
        if bias and f"{prefix}.bias" in sd:
            out[f"{name}.bias"] = torch.as_tensor(sd[f"{prefix}.bias"]).float()
    return out


def convert_pwg_state_dict(sd: dict, cfg: PWGConfig) -> dict:
    """A released PWG generator state_dict -> ``PWG(cfg)``'s state_dict."""
    layers = [("first_conv", "first_conv", True),
              ("upsample_net.conv_in", "conv_in", False),
              ("last_conv_layers.1", "last_conv1", True),
              ("last_conv_layers.3", "last_conv2", True)]
    layers += [(f"upsample_net.upsample.up_layers.{2 * i + 1}",
                f"up_convs.{i}", False)
               for i in range(len(cfg.upsample_scales))]
    for layer in range(cfg.layers):
        p, name = f"conv_layers.{layer}", f"blocks.{layer}"
        layers += [(f"{p}.conv", f"{name}.conv", True),
                   (f"{p}.conv1x1_aux", f"{name}.aux_conv", False),
                   (f"{p}.conv1x1_out", f"{name}.out_conv", True),
                   (f"{p}.conv1x1_skip", f"{name}.skip_conv", True)]
    return layers_from_reference(sd, layers)


def convert_pwg_diffusion_state_dict(sd: dict, cfg: PWGConfig) -> dict:
    """A ParallelWaveGANGenerator_Diffusion state_dict -> ``PWGDiffusion
    (cfg)``'s state_dict."""
    layers = [("fc_t1", "fc_t1", True), ("fc_t2", "fc_t2", True)]
    layers += [(f"conv_layers.{i}.fc_t", f"blocks.{i}.fc_t", True)
               for i in range(cfg.layers)]
    return {**convert_pwg_state_dict(sd, cfg),
            **layers_from_reference(sd, layers)}
