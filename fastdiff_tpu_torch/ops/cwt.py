"""Continuous wavelet transform of f0 contours (the ``with_f0cwt`` path).

The port's copy of ``fastdiff_tpu/ops/cwt.py``: the numpy functions as they
are, and the in-graph ``cwt_to_f0_jnp`` as the torch ``cwt_to_f0_t``.

The reference declares a ``with_f0cwt`` binarization flag whose
implementation lives in its NATSpeech ancestry (base_binarizer.py
``with_f0cwt``; the standard recipe is Suni et al., "Wavelets for
intonation modeling in HMM speech synthesis"): decompose the normalized
log-f0 contour into 10 octave-spaced Mexican-hat components so a TTS model
can predict prosody at multiple temporal resolutions, then recombine.

Pipeline:
- voiced gaps are linearly interpolated, contour -> log domain,
- per-utterance mean/std normalization (stats stored for reconstruction),
- CWT with the Ricker (Mexican hat) wavelet at scales 2^(i+1) * dt0,
  i = 0..9 (dt0 = 5 ms at the standard hop),
- inverse approximation: sum_i cwt[i] * (i + 2.5)^(-5/2) / C.

Reconstruction is approximate (the discrete inverse of a redundant
transform); tests pin correlation > 0.9 against the input contour.
"""

from __future__ import annotations

import numpy as np
import torch

N_SCALES = 10


def _ricker(points: int, a: float) -> np.ndarray:
    """Mexican-hat wavelet (scipy.signal.ricker formula)."""
    x = np.arange(points) - (points - 1) / 2.0
    amp = 2.0 / (np.sqrt(3.0 * a) * np.pi ** 0.25)
    return amp * (1.0 - (x / a) ** 2) * np.exp(-0.5 * (x / a) ** 2)


def _cwt(sig: np.ndarray, widths: np.ndarray) -> np.ndarray:
    out = np.zeros((len(widths), len(sig)))
    for i, w in enumerate(widths):
        n = min(10 * int(w), len(sig))
        wavelet = _ricker(max(n, 3), w)
        out[i] = np.convolve(sig, wavelet, mode="same")
    return out


def interp_f0(f0: np.ndarray) -> np.ndarray:
    """Fill unvoiced (0) regions by linear interpolation; all-unvoiced
    contours return a constant 100 Hz."""
    f0 = np.asarray(f0, np.float64)
    voiced = f0 > 0
    if not voiced.any():
        return np.full_like(f0, 100.0)
    idx = np.arange(len(f0))
    out = f0.copy()
    out[~voiced] = np.interp(idx[~voiced], idx[voiced], f0[voiced])
    return out


def cwt_scales(dt: float = 0.005) -> np.ndarray:
    """Octave-spaced widths in frames (dt = hop seconds)."""
    return np.asarray([2.0 ** (i + 1) for i in range(N_SCALES)])


def f0_to_cwt(f0: np.ndarray):
    """f0 (T,) Hz -> (cwt_spec (T, 10), logf0_mean, logf0_std).

    The stored spectrogram is scale-normalized (each component divided by
    (i + 2.5)^(-5/2) weights at reconstruction, not storage)."""
    cont = interp_f0(f0)
    logf0 = np.log(np.maximum(cont, 1e-2))
    mean, std = float(logf0.mean()), float(logf0.std() + 1e-8)
    norm = (logf0 - mean) / std
    spec = _cwt(norm, cwt_scales()).T.astype(np.float32)     # (T, 10)
    return spec, mean, std


def cwt_to_f0_t(cwt_spec: torch.Tensor, mean: torch.Tensor,
                std: torch.Tensor) -> torch.Tensor:
    """``cwt_to_f0`` on tensors (``fastdiff_tpu/ops/cwt.py:cwt_to_f0_jnp``):
    cwt_spec (B, T, 10), mean / std (B,) or (B, 1) -> f0 (B, T) Hz. The
    per-utterance renormalization over time uses the population std
    (``jnp.std``), so ``correction=0``."""
    spec = cwt_spec.float()
    weights = torch.tensor([(i + 1 + 2.5) ** (-2.5)
                            for i in range(spec.shape[-1])],
                           dtype=torch.float32, device=spec.device)
    recon = spec @ weights                                     # (B, T)
    recon = recon / (torch.std(recon, dim=-1, keepdim=True, correction=0)
                     + 1e-8)
    logf0 = recon * std.reshape(-1, 1) + mean.reshape(-1, 1)
    return torch.exp(logf0)


def cwt_to_f0(cwt_spec: np.ndarray, mean: float, std: float) -> np.ndarray:
    """Approximate inverse: (T, 10) + stats -> f0 (T,) Hz."""
    spec = np.asarray(cwt_spec, np.float64)
    weights = np.asarray([(i + 1 + 2.5) ** (-2.5) for i in range(spec.shape[1])])
    recon = spec @ weights
    # empirical gain calibration: match the unit-variance normalization
    recon = recon / (np.std(recon) + 1e-8)
    logf0 = recon * std + mean
    return np.exp(logf0).astype(np.float32)
