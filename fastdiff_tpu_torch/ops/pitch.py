"""F0 / pitch extraction without parselmouth/pyworld.

The port's copy of ``fastdiff_tpu/ops/pitch.py``: the numpy functions as
they are, and the in-graph ``f0_to_coarse_jnp`` / ``denorm_f0_jnp`` as the
torch functions ``f0_to_coarse_t`` / ``denorm_f0_t`` with the same
constants.

The reference extracts f0 with parselmouth (or pyworld) and maps it to
coarse 1..255 pitch bins aligned to mel frames
(reference: data_gen/tts/data_gen_utils.py:150-191 ``get_pitch``,
utils/pitch_utils.py f0_to_coarse semantics). Neither library ships in this
image, so f0 comes from a native YIN implementation (difference function +
cumulative-mean normalization + parabolic interpolation), vectorized in
numpy. Voicing is decided by the standard CMND threshold.
"""

from __future__ import annotations

import numpy as np
import torch

from fastdiff_tpu_torch.config import AudioConfig

F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
_F0_MEL_MIN = 1127.0 * np.log(1.0 + F0_MIN / 700.0)
_F0_MEL_MAX = 1127.0 * np.log(1.0 + F0_MAX / 700.0)


def yin_f0(wav: np.ndarray, sample_rate: int, hop_size: int,
           frame_size: int = 2048, fmin: float = 70.0, fmax: float = 500.0,
           threshold: float = 0.15) -> np.ndarray:
    """Frame-level f0 via YIN; 0 for unvoiced frames. Returns (n_frames,)
    with n_frames = 1 + len(wav)//hop (mel-frame aligned)."""
    wav = np.asarray(wav, dtype=np.float64)
    n_frames = 1 + len(wav) // hop_size
    tau_min = max(2, int(sample_rate / fmax))
    tau_max = min(frame_size // 2, int(sample_rate / fmin))

    pad = frame_size // 2
    padded = np.pad(wav, (pad, pad + frame_size))
    f0 = np.zeros(n_frames, dtype=np.float32)

    # frame matrix (n_frames, frame_size)
    idx = np.arange(n_frames)[:, None] * hop_size + np.arange(frame_size)[None, :]
    frames = padded[idx]

    # difference function via autocorrelation (vectorized over frames):
    # d(tau) = r(0) + r_tau(0) - 2*corr(tau)
    fft_size = 1
    while fft_size < 2 * frame_size:
        fft_size *= 2
    spec = np.fft.rfft(frames, fft_size, axis=1)
    corr = np.fft.irfft(spec * np.conj(spec), axis=1)[:, : tau_max + 1]
    sq = frames ** 2
    cumsq = np.concatenate([np.zeros((n_frames, 1)), np.cumsum(sq, axis=1)],
                           axis=1)
    energy0 = corr[:, :1]
    # r_tau(0) = sum_{j=tau}^{W-1} x_j^2  over the frame window
    r_tau = (cumsq[:, frame_size:frame_size + 1]
             - cumsq[:, : tau_max + 1])
    diff = energy0 + r_tau - 2.0 * corr
    diff[:, 0] = 1.0

    # cumulative mean normalized difference
    cumdiff = np.cumsum(diff[:, 1:], axis=1)
    taus = np.arange(1, tau_max + 1)
    cmnd = np.ones((n_frames, tau_max + 1))
    cmnd[:, 1:] = diff[:, 1:] * taus[None, :] / np.maximum(cumdiff, 1e-12)

    for i in range(n_frames):
        row = cmnd[i]
        tau = -1
        for t in range(tau_min, tau_max):
            if row[t] < threshold:
                while t + 1 < tau_max and row[t + 1] < row[t]:
                    t += 1
                tau = t
                break
        if tau < 0:
            tau = int(np.argmin(row[tau_min:tau_max])) + tau_min
            if row[tau] >= 0.45:      # no confident minimum: unvoiced
                continue
        # parabolic interpolation around tau
        if 1 <= tau < tau_max - 1:
            a, b, c = row[tau - 1], row[tau], row[tau + 1]
            denom = a + c - 2 * b
            shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            tau_refined = tau + np.clip(shift, -1, 1)
        else:
            tau_refined = float(tau)
        f0[i] = sample_rate / tau_refined
    return f0


def f0_to_coarse(f0: np.ndarray) -> np.ndarray:
    """Continuous f0 -> 1..255 mel-scaled bins, 0/1 for unvoiced (the
    reference's coarse pitch mapping used for pitch embeddings)."""
    f0 = np.asarray(f0, dtype=np.float64)
    f0_mel = 1127.0 * np.log(1.0 + f0 / 700.0)
    voiced = f0_mel > 0
    scaled = (f0_mel - _F0_MEL_MIN) * (F0_BIN - 2) / (_F0_MEL_MAX - _F0_MEL_MIN) + 1
    coarse = np.where(voiced, np.rint(np.clip(scaled, 1, F0_BIN - 1)), 1)
    return coarse.astype(np.int64)


def f0_to_coarse_t(f0: torch.Tensor) -> torch.Tensor:
    """``f0_to_coarse`` on a tensor, in its dtype (the model's pitch
    embedding lookup, ``fastdiff_tpu/ops/pitch.py:f0_to_coarse_jnp``):
    round half to even, as ``jnp.round``; int64 bin ids."""
    f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = (f0_mel - _F0_MEL_MIN) * (F0_BIN - 2) / (
        _F0_MEL_MAX - _F0_MEL_MIN) + 1
    coarse = torch.where(f0_mel > 0,
                         torch.round(torch.clamp(scaled, 1, F0_BIN - 1)),
                         torch.ones_like(scaled))
    return coarse.long()


def norm_f0(f0: np.ndarray, uv, pitch_norm: str = "log") -> np.ndarray:
    """Normalize f0 (log2 domain by default); unvoiced positions -> 0
    (reference: utils/pitch_utils.py:149-157, pitch_norm='log')."""
    f0 = np.asarray(f0, np.float32)
    out = np.log2(f0 + 1e-8) if pitch_norm == "log" else f0.copy()
    if uv is not None:
        out[np.asarray(uv) > 0] = 0.0
    return out


def norm_interp_f0(f0: np.ndarray, pitch_norm: str = "log"):
    """(f0_normalized_interpolated, uv) — unvoiced gaps filled by linear
    interpolation so the frame-level pitch target is continuous
    (reference: utils/pitch_utils.py:160-176)."""
    f0 = np.asarray(f0, np.float32)
    uv = (f0 == 0).astype(np.float32)
    out = norm_f0(f0, uv, pitch_norm)
    voiced = uv == 0
    if voiced.any() and (~voiced).any():
        idx = np.arange(len(f0))
        out[~voiced] = np.interp(idx[~voiced], idx[voiced], out[voiced])
    return out.astype(np.float32), uv


def denorm_f0_t(f0: torch.Tensor, uv, pitch_norm: str = "log"
                ) -> torch.Tensor:
    """Inverse of ``norm_f0`` on a tensor; clips to [0, F0_MAX], unvoiced
    (``uv > 0``) -> 0 (``fastdiff_tpu/ops/pitch.py:denorm_f0_jnp``)."""
    out = torch.exp2(f0) if pitch_norm == "log" else f0
    out = torch.clamp(out, 0.0, F0_MAX)
    if uv is not None:
        out = torch.where(uv > 0, torch.zeros_like(out), out)
    return out


def get_pitch(wav: np.ndarray, mel_frames: int, cfg: AudioConfig):
    """(f0, coarse_pitch) aligned to mel frames (get_pitch contract,
    data_gen_utils.py:150-191): both length ``mel_frames``."""
    f0 = yin_f0(wav, cfg.sample_rate, cfg.hop_size)
    if len(f0) < mel_frames:
        f0 = np.pad(f0, (0, mel_frames - len(f0)))
    f0 = f0[:mel_frames]
    return f0.astype(np.float32), f0_to_coarse(f0)
