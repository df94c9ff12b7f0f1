"""Objective audio metrics for vocoder evaluation (``fastdiff_tpu/utils/
metrics.py``, copied: numpy and scipy on the host, the same arithmetic).

- MCD (mel-cepstral distortion) over DCT cepstra of the log-mel,
- log-mel L2 distance (MSD) and multi-resolution STFT distance
  (spectral-convergence + log-magnitude, the Parallel WaveGAN aux loss),
- PESQ (P.862/P.862.2 MOS-LQO), ``utils/pesq.py`` (a copy of the JAX
  package's, with its validation note),
- RTF: generation-seconds per audio-second; the caller fences the timed
  region (``torch.cuda.synchronize`` or CUDA events),
- DTW and pitch-alignment distances on YIN f0 (``ops/pitch.py``).

The features come from the port's numpy front end (``ops/dsp.py:
wav2mel_np``, ``stft_magnitude_np``), itself a copy of the JAX package's,
so every function returns what its JAX counterpart returns on the same
inputs.
"""

from __future__ import annotations

import numpy as np

from fastdiff_tpu_torch.config import AudioConfig
from fastdiff_tpu_torch.ops import dsp


def _align(a: np.ndarray, b: np.ndarray):
    n = min(len(a), len(b))
    return a[:n], b[:n]


def log_mel(wav: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    _, mel = dsp.wav2mel_np(np.asarray(wav, np.float32), cfg)
    return mel  # (n_mels, T)


def mel_spectral_distance(wav_a, wav_b, cfg: AudioConfig = None) -> float:
    """Mean L2 distance between log-mel frames (lower is better)."""
    cfg = cfg or AudioConfig()
    wav_a, wav_b = _align(np.asarray(wav_a), np.asarray(wav_b))
    ma, mb = log_mel(wav_a, cfg), log_mel(wav_b, cfg)
    t = min(ma.shape[1], mb.shape[1])
    return float(np.sqrt(((ma[:, :t] - mb[:, :t]) ** 2).sum(axis=0)).mean())


def mcd(wav_a, wav_b, cfg: AudioConfig = None, n_cep: int = 13) -> float:
    """Mel-cepstral distortion in dB (first cepstral bin / energy excluded)."""
    cfg = cfg or AudioConfig()
    wav_a, wav_b = _align(np.asarray(wav_a), np.asarray(wav_b))
    ma, mb = log_mel(wav_a, cfg), log_mel(wav_b, cfg)
    t = min(ma.shape[1], mb.shape[1])

    def cepstra(logmel):
        from scipy.fftpack import dct
        return dct(logmel.T, type=2, norm="ortho")[:, 1: n_cep]

    ca, cb = cepstra(ma[:, :t]), cepstra(mb[:, :t])
    const = 10.0 * np.sqrt(2.0) / np.log(10.0)
    return float(const * np.sqrt(((ca - cb) ** 2).sum(axis=1)).mean())


def multi_resolution_stft_distance(wav_a, wav_b,
                                   resolutions=((1024, 256, 1024),
                                                (2048, 512, 2048),
                                                (512, 128, 512))) -> float:
    """Mean of spectral-convergence + log-STFT-magnitude distances."""
    wav_a, wav_b = _align(np.asarray(wav_a, np.float32),
                          np.asarray(wav_b, np.float32))
    total = 0.0
    for n_fft, hop, win in resolutions:
        sa = dsp.stft_magnitude_np(wav_a, n_fft, hop, win)
        sb = dsp.stft_magnitude_np(wav_b, n_fft, hop, win)
        t = min(sa.shape[1], sb.shape[1])
        sa, sb = sa[:, :t], sb[:, :t]
        sc = np.linalg.norm(sb - sa) / max(np.linalg.norm(sb), 1e-9)
        mag = np.abs(np.log(np.maximum(sa, 1e-7))
                     - np.log(np.maximum(sb, 1e-7))).mean()
        total += sc + mag
    return float(total / len(resolutions))


def pesq_mos(wav_ref, wav_deg, sample_rate: int = 22050,
             mode: str = "wb") -> float:
    """PESQ MOS-LQO (P.862.2 wideband by default) — the perceptual half of
    the BASELINE parity metric pair. Delegates to ``utils/pesq.py``."""
    from fastdiff_tpu_torch.utils.pesq import pesq
    return pesq(np.asarray(wav_ref), np.asarray(wav_deg), sample_rate, mode)


def laplace_var(spec: np.ndarray) -> float:
    """Laplacian variance of a spectrogram — blur/over-smoothing indicator
    (reference: utils/metrics.py:3-4)."""
    from scipy import ndimage
    return float(ndimage.laplace(np.asarray(spec, np.float64)).var())


def compute_rtf(generation_seconds: float, audio_samples: int,
                sample_rate: int = 22050) -> float:
    """Real-time factor: seconds of compute per second of audio (<1 = faster
    than real time). The working version of the reference's dead helper."""
    return float(generation_seconds * sample_rate / audio_samples)


def dtw_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Dynamic-time-warping L1 distance between two 1-D sequences,
    normalized by path length (vectorized anti-diagonal DP; the reference
    uses a numba-jitted loop, utils/pitch_distance.py:9-60)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n, m = len(a), len(b)
    cost = np.abs(a[:, None] - b[None, :])
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        prev = acc[i - 1]
        row = acc[i]
        # acc[i, j] = cost + min(acc[i-1,j], acc[i,j-1], acc[i-1,j-1])
        run = np.minimum(prev[1:], prev[:-1])   # top, diag
        c = cost[i - 1]
        # left dependency forces a sequential pass, but on a single row
        left = np.inf
        for j in range(m):
            best = min(run[j], left)
            left = row[j + 1] = c[j] + best
    return float(acc[n, m] / (n + m))


def pitch_alignment_distance(wav_a, wav_b, cfg: AudioConfig = None) -> float:
    """DTW distance between voiced f0 contours (semitone domain) — the
    pitch-accuracy metric of utils/pitch_distance.py, on native YIN f0."""
    from fastdiff_tpu_torch.ops.pitch import yin_f0
    cfg = cfg or AudioConfig()
    f0a = yin_f0(np.asarray(wav_a), cfg.sample_rate, cfg.hop_size)
    f0b = yin_f0(np.asarray(wav_b), cfg.sample_rate, cfg.hop_size)
    va, vb = f0a[f0a > 0], f0b[f0b > 0]
    if len(va) < 2 or len(vb) < 2:
        return float("nan")
    semi_a = 12.0 * np.log2(va / 440.0)
    semi_b = 12.0 * np.log2(vb / 440.0)
    return dtw_distance(semi_a, semi_b)
