"""Spectral-subtraction denoising for vocoder outputs
(``fastdiff_tpu/vocoders/denoise.py``; reference:
vocoders/vocoder_utils.py:7-16 ``denoise`` — subtract a noise profile
estimated from the first frames, gated by ``vocoder_denoise_c``).

The STFT magnitude and phase are numpy on the host, as in the JAX module;
the inverse STFT is the port's torch ``ops/dsp.py:istft`` (the twin of
``istft_jax``) on ``device``, the CUDA card unless the caller names
another.
"""

from __future__ import annotations

import numpy as np
import torch

from fastdiff_tpu_torch.config import AudioConfig
from fastdiff_tpu_torch.models.fastdiff import checked_device
from fastdiff_tpu_torch.ops import dsp


def denoise(wav: np.ndarray, cfg: AudioConfig = None, c: float = 0.1,
            noise_frames: int = 5, device="cuda") -> np.ndarray:
    """Subtract ``c`` times the leading-frame noise magnitude profile."""
    cfg = cfg or AudioConfig()
    dev = checked_device(device)
    wav = np.asarray(wav, np.float32)
    spec = dsp.stft_magnitude_np(wav, cfg.fft_size, cfg.hop_size, cfg.win_size)
    # phase from the same frames
    pad = cfg.fft_size // 2
    padded = np.pad(wav, (pad, pad))
    n_frames = spec.shape[1]
    idx = (np.arange(n_frames)[:, None] * cfg.hop_size
           + np.arange(cfg.fft_size)[None, :])
    window = dsp.hann_window(cfg.win_size, cfg.fft_size)
    cplx = np.fft.rfft(padded[idx] * window[None, :], axis=-1).T
    phase = np.angle(cplx)

    profile = spec[:, :noise_frames].mean(axis=1, keepdims=True)
    cleaned = np.maximum(spec - c * profile, 0.0)

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32)[None].to(
            dev)

    rec = dsp.istft(tensor(cleaned), tensor(phase), cfg.fft_size,
                    cfg.hop_size, cfg.win_size, len(wav))
    return rec[0].cpu().numpy()
