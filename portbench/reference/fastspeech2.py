"""FastSpeech 2 (Ren et al., "FastSpeech 2: Fast and High-Quality
End-to-End Text to Speech", arXiv:2006.04558) in plain PyTorch, float32,
with FastDiff as its vocoder (``fastdiff.py`` and ``diffusion.py``): the
``fastspeech2`` family, text to waveform.

    tokens (B, P), 0 = pad; m = tokens > 0
    x = E[tokens] * m + pos(P)
    encoder: N pre-LN FFT blocks, each
        x = (x + MHA(LN(x))) * m        padded keys' logits filled with -1e9
        x = (x + conv_k(relu(conv_k(LN(x))))) * m
    x = LN(x) * m
    d = VP_dur(x) * m                   log-domain durations
    dur = max(round(exp(d) - 1), 1) * m (round half to even)
    mel2ph[t] = 1 + #(phone ends <= t), 0 from the last end on (t < t_mel)
    y = [0; x][mel2ph]                  length regulation, 0 -> zeros
    (f0, uv) = VP_pitch(y) * mm         mm = mel2ph > 0
    f0_hz = clip(2^f0, 0, 1100), 0 where uv > 0; bin = coarse(f0_hz * mm)
    y = y + P[bin] * mm + pos(t_mel)
    decoder: N pre-LN FFT blocks over mm; mel = linear(LN(y) * mm) * mm

VP (variance predictor): conv3 -> ReLU -> LN -> conv3 -> ReLU -> LN ->
linear, its output masked. pos is the sinusoid table with sines then
cosines of t * 10000^(-i / (H/2 - 1)); coarse maps f0 to 1..255 on the mel
scale between 50 and 1,100 Hz (1 where f0_mel is 0).

Departures from the paper, each as NATSpeech (``fs2_ljspeech.yaml``) and
the port have it: pre-LN FFT blocks with a closing LayerNorm (the paper's
are post-LN); both FFN convs of kernel 9 (the paper: 9 then 1); frame-level
pitch in log2 with a voicing logit, quantized on the mel scale (the paper:
a continuous wavelet spectrogram of log-f0, 256 log-scale values); no
energy predictor (``use_energy_embed`` false); the sinusoid's ``H/2 - 1``
denominator (fairseq's); durations clipped to at least one frame.

``quant`` is applied to every operand of a product (activations and
weights) and to its result: the identity for the reference itself,
``bf16_round`` for the control, the precision below the configuration's
float32. Embedding lookups, LayerNorm and the softmax are no products.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import fastdiff
from portbench.reference.common import conv1d, identity, linear

LN_EPS = 1e-5
F0_BIN, F0_MIN, F0_MAX = 256, 50.0, 1100.0
F0_MEL_MIN = 1127.0 * math.log(1.0 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * math.log(1.0 + F0_MAX / 700.0)
PITCH_ROWS = 300                    # rows of the pitch embedding table
ACOUSTIC, VOCODER = "fs2.", "vocoder."


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 and back to float32."""
    return t.to(torch.bfloat16).float()


QUANT = {"float32": identity, "bfloat16": bf16_round}


def _sizes(hp: dict) -> dict:
    if str(hp.get("pitch_type", "frame")) != "frame" or \
            not hp.get("use_uv", True) or hp.get("use_energy_embed", False) \
            or int(hp.get("num_spk", 1)) > 1 or hp.get("use_spk_embed", False):
        raise ValueError("the reference computes FastSpeech 2 with frame-level "
                         "pitch and voicing, no energy, one speaker")
    return dict(vocab=int(hp["vocab_size"]), h=int(hp["hidden_size"]),
                enc=int(hp["enc_layers"]), dec=int(hp["dec_layers"]),
                heads=int(hp["num_heads"]), ffn=int(hp["ffn_hidden"]),
                k=int(hp["enc_ffn_kernel_size"]),
                ph=int(hp.get("predictor_hidden", 256)),
                pk=int(hp.get("predictor_kernel", 3)),
                n_mels=int(hp["audio_num_mel_bins"]),
                t_mel=int(hp["max_frames"]))


def acoustic_shapes(hp: dict) -> dict:
    """{name: shape} of FastSpeech 2, named as the port's state_dict."""
    s = _sizes(hp)
    h, shapes = s["h"], {}

    def dense(name, cout, cin):
        shapes[f"{name}.weight"] = (cout, cin)
        shapes[f"{name}.bias"] = (cout,)

    def conv(name, cout, cin, kernel):
        shapes[f"{name}.weight"] = (cout, cin, kernel)
        shapes[f"{name}.bias"] = (cout,)

    def norm(name, dim):
        shapes[f"{name}.weight"] = (dim,)
        shapes[f"{name}.bias"] = (dim,)

    def predictor(name, out_dim):
        conv(f"{name}.conv1", s["ph"], h, s["pk"])
        norm(f"{name}.ln1", s["ph"])
        conv(f"{name}.conv2", s["ph"], s["ph"], s["pk"])
        norm(f"{name}.ln2", s["ph"])
        dense(f"{name}.out", out_dim, s["ph"])

    shapes["tok_embed.weight"] = (s["vocab"], h)
    for stack in ("encoder", "decoder"):
        for i in range(s["enc"] if stack == "encoder" else s["dec"]):
            p = f"{stack}.{i}"
            norm(f"{p}.ln1", h)
            dense(f"{p}.attn.qkv", 3 * h, h)
            dense(f"{p}.attn.out", h, h)
            norm(f"{p}.ln2", h)
            conv(f"{p}.ffn.conv1", s["ffn"], h, s["k"])
            conv(f"{p}.ffn.conv2", h, s["ffn"], s["k"])
    norm("enc_ln", h)
    norm("dec_ln", h)
    predictor("dur_predictor", 1)
    dense("mel_out", s["n_mels"], h)
    predictor("pitch_predictor", 2)
    shapes["pitch_embed.weight"] = (PITCH_ROWS, h)
    return shapes


def param_shapes(hp: dict) -> dict:
    """{name: shape} of both models: FastSpeech 2's under ``fs2.``, the
    FastDiff vocoder's (``fastdiff.param_shapes``) under ``vocoder.``."""
    shapes = {ACOUSTIC + k: v for k, v in acoustic_shapes(hp).items()}
    shapes.update({VOCODER + k: v
                   for k, v in fastdiff.param_shapes(hp).items()})
    return shapes


def split(weights: dict) -> tuple:
    """(FastSpeech 2's weights, the vocoder's), each without its prefix."""
    parts = ({}, {})
    for name, t in weights.items():
        for part, prefix in zip(parts, (ACOUSTIC, VOCODER)):
            if name.startswith(prefix):
                part[name[len(prefix):]] = t
    return parts


def positions(length: int, dim: int, device) -> torch.Tensor:
    half = dim // 2
    freq = np.exp(np.arange(half) * -(np.log(10000.0) / (half - 1)))
    args = np.arange(length)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(args), np.cos(args)], axis=1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


def layer_norm(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"],
                        w[f"{name}.bias"], LN_EPS)


def conv_btc(w, name, x, quant):
    """A same-padded convolution over (B, T, C)."""
    return conv1d(x.transpose(1, 2), w[f"{name}.weight"], w[f"{name}.bias"],
                  quant).transpose(1, 2)


def dense(w, name, x, quant):
    return linear(x, w[f"{name}.weight"], w[f"{name}.bias"], quant)


def attention(w, name, x, mask, heads, quant):
    b, t, d = x.shape
    dh = d // heads
    q, k, v = (z.reshape(b, t, heads, dh).transpose(1, 2)
               for z in dense(w, f"{name}.qkv", x, quant).split(d, dim=-1))
    logits = quant(torch.matmul(quant(q), quant(k).transpose(-1, -2))) \
        / math.sqrt(dh)
    logits = logits.masked_fill(mask[:, None, None, :] <= 0, -1e9)
    weights = torch.softmax(logits, dim=-1)
    out = quant(torch.matmul(quant(weights), quant(v)))
    return dense(w, f"{name}.out", out.transpose(1, 2).reshape(b, t, d),
                 quant)


def fft_block(w, name, x, mask, heads, quant):
    m = mask[..., None]
    x = (x + attention(w, f"{name}.attn", layer_norm(w, f"{name}.ln1", x),
                       mask, heads, quant)) * m
    h = F.relu(conv_btc(w, f"{name}.ffn.conv1",
                        layer_norm(w, f"{name}.ln2", x), quant))
    return (x + conv_btc(w, f"{name}.ffn.conv2", h, quant)) * m


def predictor(w, name, x, mask, quant):
    h = layer_norm(w, f"{name}.ln1",
                   F.relu(conv_btc(w, f"{name}.conv1", x, quant)))
    h = layer_norm(w, f"{name}.ln2",
                   F.relu(conv_btc(w, f"{name}.conv2", h, quant)))
    return dense(w, f"{name}.out", h, quant) * mask[..., None]


def encode(w, hp, tokens, quant=identity) -> tuple:
    """tokens (B, P) -> (encoder output (B, P, H), src_mask (B, P))."""
    s = _sizes(hp)
    src_mask = (tokens > 0).float()
    x = w["tok_embed.weight"][tokens.long()] * src_mask[..., None]
    x = x + positions(tokens.shape[1], s["h"], x.device)[None]
    for i in range(s["enc"]):
        x = fft_block(w, f"encoder.{i}", x, src_mask, s["heads"], quant)
    return layer_norm(w, "enc_ln", x) * src_mask[..., None], src_mask


def log_durations(w, hp, x, src_mask, quant=identity):
    """The duration predictor's output d (B, P), log(1 + frames)."""
    return predictor(w, "dur_predictor", x, src_mask, quant)[..., 0]


def durations(d, src_mask):
    """The published rule: max(round(exp(d) - 1), 1) on the phones."""
    return torch.clamp(torch.round(torch.exp(d) - 1.0), min=1) * src_mask


def mel2ph(dur, t_mel: int):
    ends = torch.cumsum(dur, dim=1)
    frames = torch.arange(t_mel, device=dur.device)
    index = 1 + (frames[None, :, None] >= ends[:, None, :]).sum(-1)
    return torch.where(frames[None, :] < ends[:, -1:], index,
                       torch.zeros_like(index))


def regulate(x, m2p):
    padded = F.pad(x, (0, 0, 1, 0))
    return torch.gather(padded, 1,
                        m2p.long()[..., None].expand(-1, -1, x.shape[-1]))


def pitch(w, hp, y, mel_mask, quant=identity) -> tuple:
    """(f0 in log2 Hz, voicing logit), each (B, T), masked."""
    out = predictor(w, "pitch_predictor", y, mel_mask, quant)
    return out[..., 0], out[..., 1]


def pitch_scale(f0_hz):
    """The coarse bin before rounding: f0's mel-scale position mapped onto
    1..255 (clamped), and where its mel value is above 0."""
    f0_mel = 1127.0 * torch.log(1.0 + f0_hz / 700.0)
    scaled = (f0_mel - F0_MEL_MIN) * (F0_BIN - 2) / (F0_MEL_MAX - F0_MEL_MIN) + 1
    return torch.clamp(scaled, 1, F0_BIN - 1), f0_mel > 0


def f0_hz(f0, uv, mel_mask):
    out = torch.where(uv > 0, torch.zeros_like(f0),
                      torch.clamp(torch.exp2(f0), 0.0, F0_MAX))
    return out * mel_mask


def coarse(f0_hz_):
    scaled, voiced = pitch_scale(f0_hz_)
    return torch.where(voiced, torch.round(scaled),
                       torch.ones_like(scaled)).long()


def decode(w, hp, y, bins, mel_mask, quant=identity):
    """The regulated states (B, T, H) with the pitch bins (B, T) -> mel
    (B, T, n_mels)."""
    s = _sizes(hp)
    m = mel_mask[..., None]
    y = y + w["pitch_embed.weight"][bins.long()] * m
    y = y + positions(y.shape[1], s["h"], y.device)[None]
    for i in range(s["dec"]):
        y = fft_block(w, f"decoder.{i}", y, mel_mask, s["heads"], quant)
    y = layer_norm(w, "dec_ln", y) * m
    return dense(w, "mel_out", y, quant) * m


def forward(w, hp, tokens, quant=identity, m2p=None, bins=None) -> dict:
    """FastSpeech 2 of ``tokens`` (B, P). With ``m2p`` (B, T) the frames
    follow it, else the predicted durations at ``t_mel = max_frames``; with
    ``bins`` (B, T) the pitch embedding takes them, else the predicted
    pitch's. Returns every continuous value a decision rounds (``d``, the
    ``f0`` / ``uv`` logits), the decisions taken and the mel."""
    x, src_mask = encode(w, hp, tokens, quant)
    d = log_durations(w, hp, x, src_mask, quant)
    if m2p is None:
        m2p = mel2ph(durations(d, src_mask), int(hp["max_frames"]))
    mel_mask = (m2p > 0).float()
    y = regulate(x, m2p)
    f0, uv = pitch(w, hp, y, mel_mask, quant)
    if bins is None:
        bins = coarse(f0_hz(f0, uv, mel_mask))
    mel = decode(w, hp, y, bins, mel_mask, quant)
    return {"d": d, "mel2ph": m2p, "mel_mask": mel_mask, "f0": f0, "uv": uv,
            "bins": bins, "mel": mel}
