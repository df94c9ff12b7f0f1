"""FastSpeech 2 (text -> mel), the acoustic model of the TTS path
(``fastdiff_tpu/models/fastspeech2.py``), as an ``nn.Module``.

    phone ids -> embedding + sinusoidal positions -> encoder stack
      -> duration predictor (log domain)
      -> length regulation by the mel2ph gather (given mel2ph, or built
         from the predicted durations)
      -> variance adaptor: pitch (frame / cwt / coarse) + energy
      -> decoder stack -> linear projection to n_mels

``FastSpeech2(cfg)(tokens, ...)`` is ``fastspeech2_apply``: the same
options (``pitch_type``, ``use_uv``, ``use_energy``, ``num_spk``,
``use_spk_embed``), teacher mode (``mel2ph`` and the variances given) and
inference mode (all None; ``t_mel`` defaults to ``cfg.max_len``), and the
same output dict. Durations at inference are ``clip(round(exp(dur_pred) -
1), 1)``; ``torch.round`` rounds half to even, as ``jnp.round``. Weights
come from JAX through ``models/bridge.py:fs2_params_from_jax``; ``seed``
draws them from a ``torch.Generator`` with JAX's initializers'
distributions (not its values).

The training losses (``fastspeech2_loss``: the mel losses of
``ops/mel_losses.py``, the phone / word / sentence duration terms, the
pitch terms of each ``pitch_type`` and the energy term) and ``mel_energy``
are JAX's, term for term.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fastdiff_tpu_torch.models.transformer import (LN_EPS, SelfAttention,
                                                   TransformerStack,
                                                   sinusoidal_positions)
from fastdiff_tpu_torch.ops.cwt import N_SCALES, cwt_to_f0_t
from fastdiff_tpu_torch.ops.mel_losses import mel_loss as mel_loss_fns
from fastdiff_tpu_torch.ops.pitch import F0_BIN, denorm_f0_t, f0_to_coarse_t

ENERGY_MAX = 4.0     # quantization range for the energy embedding


@dataclasses.dataclass(frozen=True)
class FS2Config:
    vocab_size: int = 100
    hidden: int = 256
    enc_layers: int = 4
    dec_layers: int = 4
    num_heads: int = 2
    ffn_hidden: int = 1024
    ffn_kernel: int = 9
    n_mels: int = 80
    max_len: int = 3000
    predictor_hidden: int = 256
    predictor_kernel: int = 3
    use_pitch: bool = True
    pitch_type: str = "frame"       # frame | cwt | coarse
    use_uv: bool = True
    pitch_norm: str = "log"
    pitch_bins: int = 300
    use_energy: bool = False
    energy_bins: int = 256
    num_spk: int = 1
    use_spk_embed: bool = False     # external 256-d d-vector conditioning
    spk_embed_dim: int = 256

    @classmethod
    def from_hparams(cls, hp: dict) -> "FS2Config":
        return cls(
            vocab_size=int(hp.get("vocab_size", 100)),
            hidden=int(hp.get("hidden_size", 256)),
            enc_layers=int(hp.get("enc_layers", 4)),
            dec_layers=int(hp.get("dec_layers", 4)),
            num_heads=int(hp.get("num_heads", 2)),
            ffn_hidden=int(hp.get("ffn_hidden", 1024)),
            ffn_kernel=int(hp.get("enc_ffn_kernel_size", 9)),
            n_mels=int(hp.get("audio_num_mel_bins", 80)),
            max_len=int(hp.get("max_frames", 3000)),
            use_pitch=bool(hp.get("use_pitch_embed", True)),
            pitch_type=str(hp.get("pitch_type", "frame")),
            use_uv=bool(hp.get("use_uv", True)),
            pitch_norm=str(hp.get("pitch_norm", "log")),
            use_energy=bool(hp.get("use_energy_embed", False)),
            num_spk=int(hp.get("num_spk", 1)),
            use_spk_embed=bool(hp.get("use_spk_embed", False)),
        )


def pitch_out_dim(cfg: FS2Config) -> int:
    if cfg.pitch_type == "cwt":
        return N_SCALES + (1 if cfg.use_uv else 0)
    if cfg.pitch_type == "frame":
        return 2 if cfg.use_uv else 1
    return 1                                     # coarse legacy


class VariancePredictor(nn.Module):
    """2 x (conv k3 + ReLU + LN) -> linear; (B, T) when ``out_dim`` is 1,
    else (B, T, out_dim), masked (``fastspeech2.py:_predictor_apply``)."""

    def __init__(self, cfg: FS2Config, out_dim: int = 1):
        super().__init__()
        k, hid = cfg.predictor_kernel, cfg.predictor_hidden
        self.conv1 = nn.Conv1d(cfg.hidden, hid, k, padding=(k - 1) // 2)
        self.ln1 = nn.LayerNorm(hid, eps=LN_EPS)
        self.conv2 = nn.Conv1d(hid, hid, k, padding=(k - 1) // 2)
        self.ln2 = nn.LayerNorm(hid, eps=LN_EPS)
        self.out = nn.Linear(hid, out_dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.ln1(F.relu(self.conv1(x.transpose(1, 2))).transpose(1, 2))
        h = self.ln2(F.relu(self.conv2(h.transpose(1, 2))).transpose(1, 2))
        out = self.out(h)
        if out.shape[-1] == 1:
            return out[..., 0] * mask
        return out * mask[..., None]


def mel2ph_to_dur(mel2ph: torch.Tensor, n_phones: int) -> torch.Tensor:
    """(B, T_mel) 1-based frame -> phone map -> (B, n_phones) float
    durations."""
    one_hot = F.one_hot(mel2ph.long(), n_phones + 1).float()
    return one_hot.sum(dim=1)[:, 1:]


def dur_to_mel2ph(durations: torch.Tensor, t_mel: int) -> torch.Tensor:
    """(B, n_phones) durations -> (B, t_mel) 1-based mel2ph, 0 past the
    end: mel2ph[t] = 1 + #(phone ends <= t)."""
    ends = torch.cumsum(durations, dim=1)                       # (B, P)
    frames = torch.arange(t_mel, device=durations.device)
    mel2ph = 1 + (frames[None, :, None] >= ends[:, None, :]).sum(-1)
    return torch.where(frames[None, :] < ends[:, -1:], mel2ph,
                       torch.zeros_like(mel2ph))


def energy_to_coarse(energy: torch.Tensor, bins: int) -> torch.Tensor:
    """Frame energy -> 1..bins-1 uniform bins over [0, ENERGY_MAX] (0 is
    padding)."""
    scaled = energy * (bins - 1) / ENERGY_MAX
    return torch.clamp(torch.round(scaled), 1, bins - 1).long()


class FastSpeech2(nn.Module):
    def __init__(self, cfg: FS2Config, seed: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        self.tok_embed = nn.Embedding(cfg.vocab_size, h)
        stack = (h, cfg.num_heads, cfg.ffn_hidden, cfg.ffn_kernel)
        self.encoder = TransformerStack(cfg.enc_layers, *stack)
        self.decoder = TransformerStack(cfg.dec_layers, *stack)
        self.enc_ln = nn.LayerNorm(h, eps=LN_EPS)
        self.dec_ln = nn.LayerNorm(h, eps=LN_EPS)
        self.dur_predictor = VariancePredictor(cfg)
        self.mel_out = nn.Linear(h, cfg.n_mels)
        if cfg.use_pitch:
            self.pitch_predictor = VariancePredictor(cfg, pitch_out_dim(cfg))
            self.pitch_embed = nn.Embedding(cfg.pitch_bins, h)
            if cfg.pitch_type == "cwt":
                # per-utterance (logf0 mean, std) from the pooled encoder
                self.cwt_stats = nn.Linear(h, 2)
        if cfg.use_energy:
            self.energy_predictor = VariancePredictor(cfg)
            self.energy_embed = nn.Embedding(cfg.energy_bins, h)
        if cfg.num_spk > 1:
            self.spk_embed = nn.Embedding(cfg.num_spk, h)
        if cfg.use_spk_embed:
            self.spk_embed_proj = nn.Linear(cfg.spk_embed_dim, h)
        self._pos_table: Optional[torch.Tensor] = None
        if seed is not None:
            self._init_from_seed(seed)

    def _positions(self, length: int, device) -> torch.Tensor:
        """The first ``length`` rows of the sinusoidal table, kept on the
        device between calls (a row depends on its index alone, so one
        table of at least ``max_len`` rows serves every shorter length;
        building it costs the host milliseconds and a blocking copy)."""
        table = self._pos_table
        if table is None or table.shape[0] < length or \
                table.device != device:
            table = torch.from_numpy(sinusoidal_positions(
                max(length, self.cfg.max_len), self.cfg.hidden)).to(device)
            self._pos_table = table
        return table[:length]

    @torch.no_grad()
    def _init_from_seed(self, seed: int) -> None:
        """JAX's initializers' distributions (``init_fastspeech2``): token
        embedding N(0, 1/H), attention projections N(0, 1/D) with zero
        bias, convs and dense layers U(+-1/sqrt(fan_in)) for weight and
        bias, LayerNorm 1 / 0, pitch / energy / speaker tables N(0, 0.02^2).
        """
        gen = torch.Generator().manual_seed(seed)
        attention = set()
        for module in self.modules():
            if isinstance(module, SelfAttention):
                for lin in (module.qkv, module.out):
                    attention.add(lin)
                    lin.weight.copy_(torch.randn(
                        lin.weight.shape, generator=gen)
                        / math.sqrt(lin.in_features))
                    lin.bias.zero_()
        for module in self.modules():
            if isinstance(module, (nn.Conv1d, nn.Linear)) and \
                    module not in attention:
                fan_in = module.weight[0].numel()
                for p in (module.weight, module.bias):
                    p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1)
                            / math.sqrt(fan_in))
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
        for name, module in self.named_children():
            if isinstance(module, nn.Embedding):
                scale = self.cfg.hidden ** -0.5 if name == "tok_embed" \
                    else 0.02
                module.weight.copy_(torch.randn(module.weight.shape,
                                                generator=gen) * scale)

    def _pitch_branch(self, y, enc_pooled, mel_mask, f0, uv, pitch):
        """Predict pitch and embed it (the given pitch when there is one,
        else the prediction) -> (embedding (B, T, H), output extras)."""
        cfg = self.cfg
        extras: dict = {}
        pred = self.pitch_predictor(y, mel_mask)
        if cfg.pitch_type == "coarse":
            extras["pitch_pred"] = pred
            if pitch is None:
                coarse = torch.clamp(torch.round(pred), 1, F0_BIN - 1)
                coarse = torch.where(mel_mask > 0, coarse,
                                     torch.ones_like(coarse)).long()
            else:
                coarse = pitch.long()
            return self.pitch_embed.weight[coarse], extras

        uv_given = uv if cfg.use_uv else None
        if cfg.pitch_type == "cwt":
            cwt_pred = pred[..., :N_SCALES]
            stats = self.cwt_stats(enc_pooled)                  # (B, 2)
            mean_pred, std_pred = stats[:, 0], stats[:, 1]
            extras.update(cwt_pred=cwt_pred, cwt_mean_pred=mean_pred,
                          cwt_std_pred=std_pred)
            if cfg.use_uv:
                extras["uv_pred"] = pred[..., N_SCALES]
            if f0 is None:
                # inference: f0 from the predicted decomposition
                f0_denorm = cwt_to_f0_t(cwt_pred, mean_pred,
                                        torch.abs(std_pred) + 1e-4)
                if cfg.use_uv:
                    f0_denorm = torch.where(extras["uv_pred"] > 0,
                                            torch.zeros_like(f0_denorm),
                                            f0_denorm)
                f0_denorm = f0_denorm * mel_mask
            else:
                f0_denorm = denorm_f0_t(f0, uv_given, cfg.pitch_norm) \
                    * mel_mask
        else:
            # frame mode (the reference's default): (f0_norm, uv_logits)
            f0_pred = pred[..., 0]
            extras.update(pitch_pred=pred, f0_pred=f0_pred)
            if cfg.use_uv:
                extras["uv_pred"] = pred[..., 1]
            if f0 is None:
                uv_hat = (extras["uv_pred"] > 0) if cfg.use_uv else None
                f0_denorm = denorm_f0_t(f0_pred, uv_hat, cfg.pitch_norm) \
                    * mel_mask
            else:
                f0_denorm = denorm_f0_t(f0, uv_given, cfg.pitch_norm) \
                    * mel_mask
        extras["f0_denorm"] = f0_denorm
        return self.pitch_embed.weight[f0_to_coarse_t(f0_denorm)], extras

    def forward(self, tokens: torch.Tensor,
                mel2ph: Optional[torch.Tensor] = None,
                f0: Optional[torch.Tensor] = None,
                uv: Optional[torch.Tensor] = None,
                pitch: Optional[torch.Tensor] = None,
                energy: Optional[torch.Tensor] = None,
                spk_id: Optional[torch.Tensor] = None,
                spk_embed: Optional[torch.Tensor] = None,
                t_mel: Optional[int] = None) -> dict:
        """tokens (B, T_ph) int, 0 = pad. Teacher mode: ``mel2ph`` (B,
        T_mel) and, per config, ``f0`` / ``uv`` (frame, cwt), ``pitch``
        (coarse) and ``energy``. Inference: leave them None (``t_mel`` caps
        the length, default ``cfg.max_len``). Returns {mel (B, T_mel,
        n_mels), dur_pred (log domain), mel2ph, mel_mask, pitch_pred,
        energy_pred, and the pitch mode's extras}."""
        cfg = self.cfg
        tokens = tokens.long()
        src_mask = (tokens > 0).float()
        x = self.tok_embed.weight[tokens] * src_mask[..., None]
        x = x + self._positions(tokens.shape[1], x.device)[None]
        if spk_id is not None and cfg.num_spk > 1:
            x = x + self.spk_embed.weight[spk_id.long()][:, None, :]
        if spk_embed is not None and cfg.use_spk_embed:
            x = x + self.spk_embed_proj(spk_embed)[:, None, :]
        x = self.encoder(x, src_mask)
        x = self.enc_ln(x) * src_mask[..., None]

        dur_pred = self.dur_predictor(x, src_mask)
        if mel2ph is None:
            # each valid token gets at least one frame at inference
            durations = torch.clamp(torch.round(torch.exp(dur_pred) - 1.0),
                                    min=1) * src_mask
            t_mel = t_mel or cfg.max_len
            mel2ph = dur_to_mel2ph(durations, t_mel)
        else:
            mel2ph = mel2ph.long()
            t_mel = mel2ph.shape[1]

        mel_mask = (mel2ph > 0).float()
        # length regulation: encoder states by phone index, 0 -> zeros
        padded = F.pad(x, (0, 0, 1, 0))
        y = torch.gather(padded, 1,
                         mel2ph[..., None].expand(-1, -1, cfg.hidden))

        out = {"dur_pred": dur_pred, "mel2ph": mel2ph, "mel_mask": mel_mask,
               "pitch_pred": None, "energy_pred": None}
        if cfg.use_pitch:
            denom = torch.clamp(src_mask.sum(-1, keepdim=True), min=1.0)
            enc_pooled = (x * src_mask[..., None]).sum(1) / denom  # (B, H)
            pitch_embed, extras = self._pitch_branch(
                y, enc_pooled, mel_mask, f0, uv, pitch)
            out.update(extras)
            y = y + pitch_embed * mel_mask[..., None]
        if cfg.use_energy:
            energy_pred = self.energy_predictor(y, mel_mask)
            out["energy_pred"] = energy_pred
            e_src = energy if energy is not None else energy_pred
            coarse_e = torch.where(mel_mask > 0,
                                   energy_to_coarse(e_src, cfg.energy_bins),
                                   0)
            y = y + self.energy_embed.weight[coarse_e] * mel_mask[..., None]

        y = y + self._positions(t_mel, y.device)[None]
        y = self.decoder(y, mel_mask)
        y = self.dec_ln(y) * mel_mask[..., None]
        out["mel"] = self.mel_out(y) * mel_mask[..., None]
        return out


# ---------------------------------------------------------------------------
# losses (fastdiff_tpu/models/fastspeech2.py:350-483; tasks/tts/fs2.py:118-172
# and tts_base.py:182-223 semantics)
# ---------------------------------------------------------------------------

DEFAULT_LAMBDAS = {
    "lambda_ph_dur": 1.0, "lambda_word_dur": 0.0, "lambda_sent_dur": 0.0,
    "lambda_f0": 1.0, "lambda_uv": 1.0, "lambda_energy": 0.1,
    "lambda_cwt": 1.0, "lambda_cwt_stats": 0.1,
}


def duration_losses(dur_pred: torch.Tensor, dur_gt: torch.Tensor,
                    src_mask: torch.Tensor, lambdas: dict,
                    is_sil: Optional[torch.Tensor] = None) -> dict:
    """Phone-level log-MSE, and the word and sentence terms in the linear
    domain when their lambdas are > 0. ``is_sil`` (B, T_ph) marks silence
    phones, the word boundaries (word id = cumsum(is_sil) on the other
    tokens)."""
    losses = {}
    dur_gt = dur_gt.float()
    dur_target = torch.log(dur_gt + 1.0)
    denom = torch.clamp(src_mask.sum(), min=1.0)
    pdur = (((dur_pred - dur_target) ** 2) * src_mask).sum() / denom
    losses["pdur"] = pdur * lambdas["lambda_ph_dur"]

    dur_pred_lin = torch.clamp(torch.exp(dur_pred) - 1.0, min=0.0) * src_mask
    if lambdas.get("lambda_word_dur", 0.0) > 0 and is_sil is not None:
        word_id = (torch.cumsum(is_sil, dim=-1) * (1 - is_sil)).long()
        oh = F.one_hot(word_id, src_mask.shape[1] + 1).float()
        wdur_p = torch.einsum("bt,btw->bw", dur_pred_lin, oh)[:, 1:]
        wdur_g = torch.einsum("bt,btw->bw", dur_gt * src_mask, oh)[:, 1:]
        wmask = (wdur_g > 0).float()
        wdur = ((torch.log(wdur_p + 1.0) - torch.log(wdur_g + 1.0)) ** 2
                * wmask).sum() / torch.clamp(wmask.sum(), min=1.0)
        losses["wdur"] = wdur * lambdas["lambda_word_dur"]
    if lambdas.get("lambda_sent_dur", 0.0) > 0:
        sdur_p = dur_pred_lin.sum(-1)
        sdur_g = (dur_gt * src_mask).sum(-1)
        sdur = torch.mean((torch.log(sdur_p + 1.0)
                           - torch.log(sdur_g + 1.0)) ** 2)
        losses["sdur"] = sdur * lambdas["lambda_sent_dur"]
    return losses


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy with logits in JAX's stable form,
    max(x, 0) - x * y + log1p(exp(-|x|))."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(
        torch.exp(-logits.abs()))


def _masked_frames(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def pitch_losses(out: dict, batch: dict, cfg: FS2Config, lambdas: dict,
                 pitch_loss: str = "l1") -> dict:
    """The pitch terms of ``cfg.pitch_type`` (fs2.py add_pitch_loss /
    add_f0_loss)."""
    losses = {}
    mel_mask = out["mel_mask"]
    if cfg.pitch_type == "coarse":
        if out.get("pitch_pred") is None or batch.get("pitch") is None:
            return losses
        diff = (out["pitch_pred"] - batch["pitch"].float()) / F0_BIN
        losses["pitch"] = _masked_frames(diff ** 2, mel_mask)
        return losses

    if cfg.pitch_type == "cwt":
        denom = torch.clamp(mel_mask.sum() * N_SCALES, min=1.0)
        cwt_l = ((out["cwt_pred"] - batch["cwt_spec"]).abs()
                 * mel_mask[..., None]).sum() / denom
        losses["cwt"] = cwt_l * lambdas["lambda_cwt"]
        stats = ((out["cwt_mean_pred"] - batch["cwt_mean"]) ** 2
                 + (out["cwt_std_pred"] - batch["cwt_std"]) ** 2).mean()
        losses["cwt_stats"] = stats * lambdas["lambda_cwt_stats"]
        if cfg.use_uv and "uv" in batch:
            bce = sigmoid_bce(out["uv_pred"], batch["uv"])
            losses["uv"] = _masked_frames(bce, mel_mask) * lambdas["lambda_uv"]
        return losses

    # frame mode: uv BCE, then f0 on the voiced frames
    f0_gt, uv_gt = batch["f0"], batch.get("uv")
    nonpadding = mel_mask
    if cfg.use_uv and uv_gt is not None:
        bce = sigmoid_bce(out["uv_pred"], uv_gt)
        losses["uv"] = _masked_frames(bce, nonpadding) * lambdas["lambda_uv"]
        nonpadding = nonpadding * (uv_gt == 0).float()
    diff = out["f0_pred"] - f0_gt
    err = diff.abs() if pitch_loss == "l1" else diff ** 2
    losses["f0"] = _masked_frames(err, nonpadding) * lambdas["lambda_f0"]
    return losses


def fastspeech2_loss(out: dict, batch: dict, cfg: FS2Config,
                     mel_loss_and_lambda: Optional[dict] = None,
                     lambdas: Optional[dict] = None,
                     pitch_loss: str = "l1") -> dict:
    """The training loss dict of a teacher-mode forward ``out``. ``batch``
    holds tensors (per config): mels (B, T, M), dur and tokens (B, T_ph),
    f0 / uv / pitch / energy (B, T), cwt_spec / cwt_mean / cwt_std, is_sil
    (B, T_ph). ``total`` sums the terms; ``mel`` sums the mel terms."""
    lambdas = {**DEFAULT_LAMBDAS, **(lambdas or {})}
    mel_cfg = mel_loss_and_lambda or {"l1": 1.0}
    src_mask = (batch["tokens"] > 0).float()

    mel_gt = batch["mels"] * out["mel_mask"][..., None]
    mel_components = mel_loss_fns(out["mel"], mel_gt, mel_cfg)
    losses = dict(mel_components)
    losses.update(duration_losses(out["dur_pred"], batch["dur"], src_mask,
                                  lambdas, is_sil=batch.get("is_sil")))
    if cfg.use_pitch:
        losses.update(pitch_losses(out, batch, cfg, lambdas, pitch_loss))
    if cfg.use_energy and out.get("energy_pred") is not None \
            and batch.get("energy") is not None:
        e = _masked_frames((out["energy_pred"] - batch["energy"]) ** 2,
                           out["mel_mask"])
        losses["energy"] = e * lambdas["lambda_energy"]
    losses["total"] = sum(losses.values())
    losses["mel"] = sum(mel_components.values())
    return losses


def mel_energy(mel: torch.Tensor, log_base: str = "10") -> torch.Tensor:
    """Frame energy of a log mel, log10(1 + ||linear mel||) so that the
    ``energy_bins`` quantization over [0, ENERGY_MAX] covers it."""
    lin = torch.pow(10.0, mel) if log_base == "10" else torch.exp(mel)
    return torch.log10(1.0 + torch.sqrt((lin ** 2).sum(-1)))
