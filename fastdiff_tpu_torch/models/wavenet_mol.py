"""r9y9-style autoregressive WaveNet vocoder with a mixture-density output
(``fastdiff_tpu/models/wavenet_mol.py``).

- ``MoLWaveNet`` is the teacher-forced forward (causal dilated convs over
  the whole sequence, NCL), JAX's ``wavenet_mol_apply``;
  ``wavenet_mol_loss`` its one-step teacher-forced NLL;
- ``wavenet_incremental_logits`` and ``wavenet_generate_batched`` run the
  same network one sample at a time (``_ARLoop``): each block keeps its
  last (k - 1) * d inputs in a ring buffer, slot t - j * d mod its length
  read before slot t mod its length is written, JAX's ``lax.scan`` state.
  All blocks' rings live in one buffer, read by one gather and written by
  one scatter per step at indices taken from per-step tables by a step
  counter held on the device. The mixture draws of every step are made
  before the loop (or injected) into static buffers, so a step does no
  host work: on the card the loop runs its first chunk of steps eagerly
  on a side stream, then captures one chunk as a CUDA graph and replays it
  for the rest (a failed capture raises; nothing falls back to the eager
  loop); on the CPU it runs eagerly;
- ``wavenet_generate`` folds the conditioning into overlapping folds
  (``fold_with_overlap``), generates all folds as one batch and
  crossfades them back (``xfade_and_unfold``);
- outputs: MoL / MoG (``ops/mixture.py``) or categorical over mu-law
  classes (one-hot input); optional global conditioning by speaker id
  (an embedding table) or features, one bias-free 1x1 per block added to
  the gate.

Cast points follow JAX's: each 1x1 and causal conv in the compute dtype
(float32 by default) with float32 accumulation, skips in float32.
``convert_wavenet_state_dict`` loads an r9y9 state_dict in the reference's
names into the port's (weight norm fused, no epsilon).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fastdiff_tpu_torch.models.pwg import (conv_nobias, layers_from_reference,
                                           stretch)
from fastdiff_tpu_torch.models.wavenet import SQRT_HALF, compute_dtype
from fastdiff_tpu_torch.ops import mixture
from fastdiff_tpu_torch.ops import nn as fnn


@dataclasses.dataclass(frozen=True)
class MoLWaveNetConfig:
    out_channels: int = 30            # 10 logistics x (pi, mu, log_s)
    layers: int = 24
    stacks: int = 4
    residual_channels: int = 128
    gate_channels: int = 256
    skip_channels: int = 128
    kernel_size: int = 3
    cin_channels: int = 80
    upsample_scales: Tuple[int, ...] = (4, 4, 4, 4)
    scalar_input: bool = True         # False -> one-hot (mulaw-quantize)
    output_distribution: str = "Logistic"   # "Logistic" | "Normal"
    log_scale_min: float = -16.0
    compute_dtype: str = "float32"
    gin_channels: int = 0             # 0 -> no global conditioning
    n_speakers: int = 0               # > 0 -> id-embedding table (std 0.1)

    @property
    def layers_per_stack(self) -> int:
        return self.layers // self.stacks

    @property
    def in_channels(self) -> int:
        return 1 if self.scalar_input else self.out_channels

    @property
    def hop(self) -> int:
        return int(np.prod(self.upsample_scales))

    def dilation(self, layer: int) -> int:
        return 2 ** (layer % self.layers_per_stack)

    @property
    def receptive_field(self) -> int:
        return (self.kernel_size - 1) * sum(
            self.dilation(i) for i in range(self.layers)) + 1

    @classmethod
    def from_hparams(cls, hp: dict) -> "MoLWaveNetConfig":
        """Build from the flat hparams dict (the AR-vocoder task family)."""
        return cls(
            out_channels=int(hp.get("wn_out_channels", 30)),
            layers=int(hp.get("wn_layers", 24)),
            stacks=int(hp.get("wn_stacks", 4)),
            residual_channels=int(hp.get("wn_residual_channels", 128)),
            gate_channels=int(hp.get("wn_gate_channels", 256)),
            skip_channels=int(hp.get("wn_skip_channels", 128)),
            kernel_size=int(hp.get("wn_kernel_size", 3)),
            cin_channels=int(hp.get("audio_num_mel_bins", 80)),
            upsample_scales=tuple(int(s) for s in hp.get(
                "wn_upsample_scales", (4, 4, 4, 4))),
            scalar_input=bool(hp.get("wn_scalar_input", True)),
            output_distribution=str(hp.get("wn_output_distribution",
                                           "Logistic")),
            compute_dtype=str(hp.get("wn_compute_dtype", "float32")),
            gin_channels=int(hp.get("wn_gin_channels", 0)),
            n_speakers=int(hp.get("wn_n_speakers", 0)),
        )


def _conv1x1(conv: nn.Conv1d, x: torch.Tensor, dtype) -> torch.Tensor:
    """A 1x1 conv (NCL) in ``dtype``, float32 accumulation, float32 bias."""
    if conv.bias is None:
        return conv_nobias(conv.weight, x, dtype)
    return fnn.conv1d_ncl(conv.weight, conv.bias, x, compute_dtype=dtype)


class MoLBlock(nn.Module):
    def __init__(self, cfg: MoLWaveNetConfig):
        super().__init__()
        self.conv = nn.Conv1d(cfg.residual_channels, cfg.gate_channels,
                              cfg.kernel_size)
        self.aux_conv = nn.Conv1d(cfg.cin_channels, cfg.gate_channels, 1,
                                  bias=False)
        self.out_conv = nn.Conv1d(cfg.gate_channels // 2,
                                  cfg.residual_channels, 1)
        self.skip_conv = nn.Conv1d(cfg.gate_channels // 2,
                                   cfg.skip_channels, 1)
        if cfg.gin_channels > 0:
            self.g_conv = nn.Conv1d(cfg.gin_channels, cfg.gate_channels, 1,
                                    bias=False)


class MoLWaveNet(nn.Module):
    """Teacher-forced forward: ``forward(x (B, T, in_ch), mel (B, T', cin),
    g=None) -> (B, T, out_channels)`` float32, T == T' * hop; ``g`` is
    speaker ids (B,) or global features (B, gin_channels)."""

    def __init__(self, cfg: MoLWaveNetConfig = MoLWaveNetConfig(), *,
                 seed: int | None = 0, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.compute_dtype)
        self.first_conv = nn.Conv1d(cfg.in_channels, cfg.residual_channels, 1)
        self.conv_in = nn.Conv1d(cfg.cin_channels, cfg.cin_channels, 1,
                                 bias=False)
        self.up_convs = nn.ModuleList(
            [nn.Conv2d(1, 1, (1, 2 * s + 1), bias=False)
             for s in cfg.upsample_scales])
        self.last_conv1 = nn.Conv1d(cfg.skip_channels, cfg.skip_channels, 1)
        self.last_conv2 = nn.Conv1d(cfg.skip_channels, cfg.out_channels, 1)
        if cfg.gin_channels > 0 and cfg.n_speakers > 0:
            self.embed_speakers = nn.Embedding(cfg.n_speakers,
                                               cfg.gin_channels)
        self.blocks = nn.ModuleList([MoLBlock(cfg)
                                     for _ in range(cfg.layers)])
        if seed is not None:
            self.init_weights(torch.Generator().manual_seed(seed))
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """JAX's ``init_wavenet_mol`` distributions: torch's default uniform
        on the convs, conv_in the identity, each upsampling filter the mean
        1 / (2s + 1), the speaker table N(0, 0.1^2)."""
        fnn.uniform_init_(self, generator)
        self.conv_in.weight.copy_(torch.eye(self.cfg.cin_channels)[..., None])
        for up in self.up_convs:
            up.weight.fill_(1.0 / up.weight.shape[-1])
        if hasattr(self, "embed_speakers"):
            self.embed_speakers.weight.normal_(generator=generator).mul_(0.1)

    @property
    def device(self) -> torch.device:
        return self.first_conv.weight.device

    def upsample_cond(self, mel: torch.Tensor, dtype=torch.float32
                      ) -> torch.Tensor:
        """ConvInUpsampleNetwork: (B, T', cin) -> (B, cin, T' * hop)."""
        c = _conv1x1(self.conv_in, mel.transpose(1, 2), dtype)
        for up, s in zip(self.up_convs, self.cfg.upsample_scales):
            c = stretch(c, up.weight, s, dtype)
        return c

    def g_gate_contribs(self, g, dtype):
        """The global conditioning's gate bias per block, [(B, gate)], or
        None: g is speaker ids (B,) / (B, 1) or features (B, gin)."""
        if g is None:
            return None
        if self.cfg.gin_channels <= 0:
            raise ValueError("g passed but gin_channels == 0")
        g = torch.as_tensor(g, device=self.device)
        if not g.is_floating_point():
            g = self.embed_speakers.weight[g.reshape(g.shape[0])]
        return [_conv1x1(blk.g_conv, g[:, :, None], dtype)[:, :, 0]
                for blk in self.blocks]

    def forward(self, x: torch.Tensor, mel: torch.Tensor, g=None
                ) -> torch.Tensor:
        cfg, dtype = self.cfg, self.dtype
        g2 = cfg.gate_channels // 2
        c = self.upsample_cond(mel, dtype)
        assert c.shape[2] == x.shape[1], (c.shape, x.shape)
        g_gate = self.g_gate_contribs(g, dtype)
        h = _conv1x1(self.first_conv, x.transpose(1, 2), dtype)
        skips = torch.zeros(x.shape[0], cfg.skip_channels, x.shape[1],
                            device=x.device)
        k = cfg.kernel_size
        for layer, blk in enumerate(self.blocks):
            residual = h
            d = cfg.dilation(layer)
            z = F.conv1d(F.pad(h, ((k - 1) * d, 0)).to(dtype).float(),
                         blk.conv.weight.to(dtype).float(),
                         blk.conv.bias.float(), dilation=d).to(dtype)
            z = z + _conv1x1(blk.aux_conv, c, dtype)
            if g_gate is not None:
                z = z + g_gate[layer][:, :, None]
            gated = (torch.tanh(z[:, :g2]) * torch.sigmoid(z[:, g2:])).to(dtype)
            skips = skips + _conv1x1(blk.skip_conv, gated, dtype)
            h = ((_conv1x1(blk.out_conv, gated, dtype) + residual).float()
                 * SQRT_HALF).to(dtype)
        s = (skips * float(np.float32(math.sqrt(1.0 / cfg.layers)))).to(dtype)
        s = torch.relu(_conv1x1(self.last_conv1, torch.relu(s), dtype))
        return _conv1x1(self.last_conv2, s, dtype).float().transpose(1, 2)


def wavenet_mol_loss(model: MoLWaveNet, wav: torch.Tensor, mel: torch.Tensor,
                     g=None) -> torch.Tensor:
    """Mean per-sample NLL with one-step teacher forcing (predict wav[t]
    from wav[< t])."""
    cfg = model.cfg
    x_in = F.pad(wav[:, :-1], (0, 0, 1, 0))
    y_hat = model(x_in, mel, g=g)
    n = wav.shape[0] * wav.shape[1]
    if not cfg.scalar_input:
        ids = torch.argmax(wav, dim=-1, keepdim=True)
        logp = F.log_softmax(y_hat, dim=-1)
        return -torch.gather(logp, -1, ids).sum() / n
    if cfg.output_distribution == "Normal":
        return mixture.mix_gaussian_loss(
            y_hat, wav[..., 0], log_scale_min=cfg.log_scale_min) / n
    return mixture.discretized_mix_logistic_loss(
        y_hat, wav[..., 0], log_scale_min=cfg.log_scale_min) / n


# ---------------------------------------------------------------------------
# Autoregressive synthesis
# ---------------------------------------------------------------------------

def make_draws(cfg: MoLWaveNetConfig, steps: int, batch: int,
               generator: torch.Generator, device) -> tuple:
    """Every step's draws for ``wavenet_generate_batched``, (steps, batch,
    ...): logistic (u, u2), Normal (u or None, z), categorical (gumbel,)."""
    def uniform(*shape):
        u = torch.rand((steps, batch) + shape, generator=generator,
                       device=device)
        return u * (1.0 - 2e-5) + 1e-5
    nr_mix = cfg.out_channels // 3
    if not cfg.scalar_input:
        u = torch.rand((steps, batch, cfg.out_channels), generator=generator,
                       device=device).clamp_min(torch.finfo(torch.float32).tiny)
        return (-torch.log(-torch.log(u)),)
    if cfg.output_distribution == "Normal":
        u = uniform(nr_mix) if cfg.out_channels != 2 else None
        return (u, torch.randn((steps, batch), generator=generator,
                               device=device))
    return (uniform(nr_mix), uniform())


def _chunk(steps: int, most: int = 64) -> int:
    """The largest divisor of ``steps`` that is at most ``most``."""
    return max(k for k in range(1, min(most, steps) + 1) if steps % k == 0)


class _ARLoop:
    """The one-sample step of ``MoLWaveNet`` for ``batch`` streams over
    ``steps`` steps, on static buffers: the conditioning (steps, B, cin),
    the rings, the step counter ``t`` (a device tensor), the read / write
    index tables, the input (teacher-forced ``x_seq``, or the previous
    sample and the draws) and the output. ``run`` advances all steps."""

    def __init__(self, model: MoLWaveNet, cond: torch.Tensor, g_gate, *,
                 x_seq: torch.Tensor | None = None, draws=None,
                 deterministic: bool = False):
        cfg = model.cfg
        self.cfg, self.model = cfg, model
        self.dtype = dtype = model.dtype
        dev = cond.device
        b, steps = cond.shape[0], cond.shape[1]
        self.steps, k, c = steps, cfg.kernel_size, cfg.residual_channels
        self.g2 = cfg.gate_channels // 2

        def w(t):           # a weight rounded to the compute dtype, f32
            return t.detach().to(dtype).float()
        blocks = model.blocks
        # per block: [h | past_1 | ... | past_{k-1}] @ taps (k C, gate)
        self.taps = [torch.cat([w(blk.conv.weight[:, :, k - 1 - j]).T
                                for j in range(k)]) for blk in blocks]
        self.tap_bias = [blk.conv.bias.detach().float() for blk in blocks]
        self.aux = torch.cat([w(blk.aux_conv.weight[:, :, 0]).T
                              for blk in blocks], dim=1)     # (cin, L gate)
        self.skip_out = [torch.cat([w(blk.skip_conv.weight[:, :, 0]).T,
                                    w(blk.out_conv.weight[:, :, 0]).T], 1)
                         for blk in blocks]                 # (g2, skip + res)
        self.skip_out_bias = [torch.cat([blk.skip_conv.bias,
                                         blk.out_conv.bias]).detach().float()
                              for blk in blocks]
        self.head = [(w(conv.weight[:, :, 0]).T, conv.bias.detach().float())
                     for conv in (model.first_conv, model.last_conv1,
                                  model.last_conv2)]
        self.g_gate = g_gate
        # the rings: block l owns rows [base_l, base_l + len_l)
        lens = [(k - 1) * cfg.dilation(i) for i in range(cfg.layers)]
        bases = np.concatenate([[0], np.cumsum(lens)[:-1]])
        rows = np.arange(steps)[:, None]
        lens_j = np.repeat(lens, k - 1)
        offs = np.concatenate([[-j * cfg.dilation(i) for j in range(1, k)]
                               for i in range(cfg.layers)])
        self.read_tab = torch.from_numpy(
            (rows + offs) % lens_j + np.repeat(bases, k - 1)).to(dev)
        self.write_tab = torch.from_numpy(rows % lens + bases).to(dev)
        self.buf = torch.zeros(b, int(sum(lens)), c, dtype=dtype, device=dev)
        self.t = torch.zeros(1, dtype=torch.long, device=dev)
        self.cond = cond.transpose(0, 1).contiguous()       # (steps, B, cin)
        self.teacher = x_seq is not None
        if self.teacher:
            self.x_seq = x_seq.transpose(0, 1).contiguous().float()
            self.out = torch.zeros(steps, b, cfg.out_channels, device=dev)
        else:
            if cfg.scalar_input:
                self.x_prev = torch.zeros(b, 1, device=dev)
            else:
                self.x_prev = (torch.arange(cfg.out_channels, device=dev)
                               == 127).float().expand(b, -1).clone()
            self.draws = draws
            self.deterministic = deterministic
            self.out = torch.zeros(steps, b, device=dev)

    def _at(self, table: torch.Tensor) -> torch.Tensor:
        return table.index_select(0, self.t)[0]

    def _logits(self, x_in: torch.Tensor) -> torch.Tensor:
        """One step: x_in (B, in_ch) -> logits (B, out) f32; reads and
        writes the rings."""
        cfg, dtype, g2 = self.cfg, self.dtype, self.g2
        c_t = self._at(self.cond).to(dtype).float()
        aux = (c_t @ self.aux).to(dtype)                   # (B, L gate)
        past = self.buf.index_select(1, self._at(self.read_tab))
        past = past.reshape(past.shape[0], cfg.layers, -1)
        (first_w, first_b), (last1_w, last1_b), (last2_w, last2_b) = \
            self.head
        h = torch.addmm(first_b, x_in.to(dtype).float(), first_w).to(dtype)
        skips = torch.zeros(x_in.shape[0], cfg.skip_channels,
                            device=x_in.device)
        gate, hs = cfg.gate_channels, []
        for layer in range(cfg.layers):
            hs.append(h)
            z = torch.addmm(self.tap_bias[layer],
                            torch.cat([h, past[:, layer]], 1).float(),
                            self.taps[layer]).to(dtype)
            z = z + aux[:, layer * gate:(layer + 1) * gate]
            if self.g_gate is not None:
                z = z + self.g_gate[layer]
            gated = (torch.tanh(z[:, :g2]) * torch.sigmoid(z[:, g2:])).to(dtype)
            so = torch.addmm(self.skip_out_bias[layer], gated.float(),
                             self.skip_out[layer]).to(dtype)
            skips = skips + so[:, :cfg.skip_channels]
            h = ((so[:, cfg.skip_channels:] + h).float()
                 * SQRT_HALF).to(dtype)
        self.buf.index_copy_(1, self._at(self.write_tab),
                             torch.stack(hs, 1).to(self.buf.dtype))
        s = (skips * float(np.float32(math.sqrt(1.0 / cfg.layers)))).to(dtype)
        s = torch.relu(torch.addmm(last1_b, torch.relu(s).float(),
                                   last1_w).to(dtype))
        return torch.addmm(last2_b, s.float(), last2_w).to(dtype).float()

    def _sample(self, logits: torch.Tensor) -> tuple:
        """(next input (B, in_ch), output sample (B,))."""
        cfg = self.cfg
        if not cfg.scalar_input:
            if self.deterministic:
                idx = torch.argmax(logits, dim=-1)
            else:
                idx = torch.argmax(logits + self._at(self.draws[0]), dim=-1)
            one_hot = (torch.arange(cfg.out_channels, device=logits.device)
                       == idx[:, None]).float()
            return one_hot, mixture.inv_mulaw_quantize(idx,
                                                       cfg.out_channels - 1)
        normal = cfg.output_distribution == "Normal"
        if self.deterministic:
            mode = mixture.mix_gaussian_mode if normal else \
                mixture.mix_logistic_mode
            x = mode(logits, log_scale_min=cfg.log_scale_min)
        else:
            draws = tuple(None if d is None else self._at(d)
                          for d in self.draws)
            fn = (mixture.sample_from_mix_gaussian if normal else
                  mixture.sample_from_discretized_mix_logistic)
            x = fn(logits, log_scale_min=cfg.log_scale_min, draws=draws)
        return x[:, None], x

    def step(self):
        if self.teacher:
            self.out.index_copy_(0, self.t,
                                 self._logits(self._at(self.x_seq))[None])
        else:
            x_in, sample = self._sample(self._logits(self.x_prev))
            self.x_prev.copy_(x_in)
            self.out.index_copy_(0, self.t, sample[None])
        self.t.add_(1)

    def run(self, graph: bool) -> torch.Tensor:
        """All steps: eagerly, or (``graph``, on the card) the first chunk
        eagerly on a side stream, then the chunk captured once and
        replayed. Returns ``out``, (steps, B[, out])."""
        chunk = _chunk(self.steps)
        if not graph or chunk == self.steps:
            for _ in range(self.steps):
                self.step()
            return self.out
        current = torch.cuda.current_stream(self.t.device)
        side = torch.cuda.Stream(self.t.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(chunk):
                self.step()
        current.wait_stream(side)
        cuda_graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(cuda_graph, stream=side):
                for _ in range(chunk):
                    self.step()
        finally:
            # a capture that fails to end leaves its stream current
            torch.cuda.set_stream(current)
        for _ in range(self.steps // chunk - 1):
            cuda_graph.replay()
        return self.out


def _graph_default(graph, tensor: torch.Tensor) -> bool:
    return tensor.is_cuda if graph is None else bool(graph)


@torch.no_grad()
def wavenet_incremental_logits(model: MoLWaveNet, x_seq: torch.Tensor,
                               mel: torch.Tensor, g=None,
                               graph: bool | None = None) -> torch.Tensor:
    """Teacher-forced logits through the one-sample step: (B, T, in_ch) ->
    (B, T, out). Equals the teacher-forced forward to rounding; the check
    of the ring-buffer state machine. ``graph`` (default: on the card)
    replays the step as a CUDA graph."""
    dtype = model.dtype
    cond = model.upsample_cond(mel, dtype).transpose(1, 2)
    loop = _ARLoop(model, cond, model.g_gate_contribs(g, dtype), x_seq=x_seq)
    return loop.run(_graph_default(graph, cond)).transpose(0, 1)


@torch.no_grad()
def wavenet_generate_batched(model: MoLWaveNet, cond: torch.Tensor,
                             generator: torch.Generator | None = None, *,
                             draws=None, g=None, deterministic: bool = False,
                             graph: bool | None = None) -> torch.Tensor:
    """AR synthesis for upsampled conditioning (B, T, cin) -> (B, T): the
    MoL / MoG draw, or the categorical pick decoded from mu-law, of every
    step, fed back as the next input. ``draws`` (``make_draws``' layout)
    replace ``generator``'s; ``deterministic`` takes each mixture's mode
    (the argmax class)."""
    cfg = model.cfg
    steps = cond.shape[1]
    if draws is None and not deterministic:
        draws = make_draws(cfg, steps, cond.shape[0], generator, cond.device)
    if draws is not None:
        draws = tuple(None if d is None else
                      torch.as_tensor(d, device=cond.device).float()
                      for d in draws)
    loop = _ARLoop(model, cond, model.g_gate_contribs(g, model.dtype),
                   draws=draws, deterministic=deterministic)
    return loop.run(_graph_default(graph, cond)).transpose(0, 1)


def fold_with_overlap(c: torch.Tensor, target: int, overlap: int
                      ) -> torch.Tensor:
    """(1, T, F) -> (folds, target + 2 * overlap, F)."""
    _, total, _ = c.shape
    num_folds = (total - overlap) // (target + overlap)
    extended = num_folds * (overlap + target) + overlap
    remaining = total - extended
    if remaining != 0:
        num_folds += 1
        c = F.pad(c, (0, 0, 0, target + 2 * overlap - remaining))
    return torch.stack([c[0, i * (target + overlap):
                          i * (target + overlap) + target + 2 * overlap]
                        for i in range(num_folds)])


def xfade_and_unfold(y: np.ndarray, overlap: int) -> np.ndarray:
    """(folds, target + 2 * overlap) -> (total,) with an equal-power
    crossfade (half the overlap is silence for the AR warm-up)."""
    num_folds, length = y.shape
    target = length - 2 * overlap
    total = num_folds * (target + overlap) + overlap
    silence_len = overlap // 2
    fade_len = overlap - silence_len
    t = np.linspace(-1.0, 1.0, fade_len)
    fade_in = np.concatenate([np.zeros(silence_len), np.sqrt(0.5 * (1 + t))])
    fade_out = np.concatenate([np.ones(silence_len), np.sqrt(0.5 * (1 - t))])
    y = np.array(y, np.float64)
    y[:, :overlap] *= fade_in
    y[:, -overlap:] *= fade_out
    out = np.zeros(total)
    for i in range(num_folds):
        start = i * (target + overlap)
        out[start: start + length] += y[i]
    return out


@torch.no_grad()
def wavenet_generate(model: MoLWaveNet, mel: torch.Tensor,
                     generator: torch.Generator | None = None,
                     target: int = 12800, overlap: int = 512, g=None, *,
                     draws=None, deterministic: bool = False,
                     graph: bool | None = None) -> np.ndarray:
    """Batched-fold synthesis: mel (1, T', cin) -> wav (T,) float64. ``g``:
    the utterance's speaker id / feature row, tiled over the folds."""
    c = model.upsample_cond(mel.to(model.device)).transpose(1, 2)
    total = c.shape[1]
    folded = fold_with_overlap(c, target, overlap)
    if g is not None:
        g = torch.as_tensor(g, device=model.device)
        g = g.reshape(1, -1) if g.dim() <= 1 else g
        g = g.expand(folded.shape[0], -1)
        if not g.is_floating_point():
            g = g[:, 0]
    wav = wavenet_generate_batched(model, folded, generator, draws=draws,
                                   g=g, deterministic=deterministic,
                                   graph=graph)
    return xfade_and_unfold(wav.cpu().double().numpy(), overlap)[:total]


def convert_wavenet_state_dict(sd: dict, cfg: MoLWaveNetConfig) -> dict:
    """An r9y9 ``WaveNet`` state_dict (the reference's names, weight norm as
    ``weight_g`` / ``weight_v`` or fused) -> ``MoLWaveNet(cfg)``'s."""
    layers = [("first_conv", "first_conv", True),
              ("upsample_net.conv_in", "conv_in", False),
              ("last_conv_layers.1", "last_conv1", True),
              ("last_conv_layers.3", "last_conv2", True)]
    layers += [(f"upsample_net.upsample.up_layers.{2 * i + 1}",
                f"up_convs.{i}", False)
               for i in range(len(cfg.upsample_scales))]
    if "embed_speakers.weight" in sd:
        layers.append(("embed_speakers", "embed_speakers", False))
    for layer in range(cfg.layers):
        p, name = f"conv_layers.{layer}", f"blocks.{layer}"
        layers += [(f"{p}.conv", f"{name}.conv", True),
                   (f"{p}.conv1x1c", f"{name}.aux_conv", False),
                   (f"{p}.conv1x1_out", f"{name}.out_conv", True),
                   (f"{p}.conv1x1_skip", f"{name}.skip_conv", True)]
        if f"{p}.conv1x1g.weight_v" in sd or f"{p}.conv1x1g.weight" in sd:
            layers.append((f"{p}.conv1x1g", f"{name}.g_conv", False))
    return layers_from_reference(sd, layers)
