"""Audio DSP front end: STFT, Slaney mel filterbank, inverse STFT and
Griffin-Lim (``fastdiff_tpu/ops/dsp.py``).

Two halves with the same math, as in the JAX module:

- numpy (host), copied: ``mel_filterbank``, ``hann_window``,
  ``stft_magnitude_np``, ``wav2mel_np`` (the binarizer's and the inference
  front end's featurizer) and ``mel_to_linear_np``. PWG-style mels are a
  hann window, a centered constant-padded STFT, the Slaney filterbank and
  ``log10(max(eps, mel))``; Tacotron-style mels pad by reflection and take
  ``ln``.
- torch, on the device of its input tensors (the twin of the ``*_jax``
  functions): ``frame_signal``, ``stft_magnitude``, ``mel_spectrogram``,
  ``istft`` (windowed overlap-add in ``n_fft / hop`` shifted adds, divided
  by the window's squared sum) and ``griffin_lim``. Griffin-Lim draws its
  initial phase from a ``torch.Generator`` (by default a CPU generator
  seeded 0, so the card and the CPU start from the same phase) or takes it
  injected. These are plain PyTorch ops: the JAX functions reach no
  Pallas kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from fastdiff_tpu_torch.config import AudioConfig


# ---------------------------------------------------------------------------
# Mel filterbank (librosa-compatible: Slaney mel scale + Slaney normalization)
# ---------------------------------------------------------------------------

def hz_to_mel(frequencies):
    """Slaney mel scale (linear below 1 kHz, log above)."""
    frequencies = np.asarray(frequencies, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = frequencies / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = frequencies >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(frequencies, 1e-10) / min_log_hz) / logstep,
        mels,
    )
    return mels


def mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=16)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float, fmax: float) -> np.ndarray:
    """Triangular mel filterbank, (n_mels, 1 + n_fft//2), float32.

    Matches ``librosa.filters.mel`` defaults (htk=False, norm='slaney'),
    the basis the reference builds at data_gen/tts/data_gen_utils.py:130.
    """
    if fmax <= 0:
        fmax = sample_rate / 2.0
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style energy normalization.
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=16)
def hann_window(win_size: int, n_fft: int) -> np.ndarray:
    """Periodic hann window, zero-padded (centered) to n_fft."""
    n = np.arange(win_size, dtype=np.float64)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)
    if n_fft > win_size:
        lpad = (n_fft - win_size) // 2
        win = np.pad(win, (lpad, n_fft - win_size - lpad))
    return win.astype(np.float32)


# ---------------------------------------------------------------------------
# Host (numpy) implementation, used by the binarizer's workers
# ---------------------------------------------------------------------------

def stft_magnitude_np(wav: np.ndarray, n_fft: int, hop_size: int,
                      win_size: int, pad_mode: str = "constant") -> np.ndarray:
    """Centered STFT magnitude |X|, shape (1 + n_fft//2, frames)."""
    wav = np.asarray(wav, dtype=np.float32)
    pad = n_fft // 2
    if pad_mode == "constant":
        padded = np.pad(wav, (pad, pad), mode="constant")
    else:
        padded = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(padded) - n_fft) // hop_size
    shape = (n_frames, n_fft)
    strides = (padded.strides[0] * hop_size, padded.strides[0])
    frames = np.lib.stride_tricks.as_strided(padded, shape=shape, strides=strides)
    window = hann_window(win_size, n_fft)
    spec = np.fft.rfft(frames * window[None, :], axis=-1)
    return np.abs(spec).T.astype(np.float32)


def wav2mel_np(wav: np.ndarray, cfg: AudioConfig, return_linear: bool = False):
    """Reference ``process_utterance`` semantics: (padded wav, log-mel).

    Returns ``wav`` zero-padded on the right to ``frames * hop`` samples and
    ``mel`` of shape (n_mels, frames). Matches
    data_gen/tts/data_gen_utils.py:122-147: constant STFT padding for the
    pwg front-end, reflect for tacotron; log10/ln compression respectively.
    With ``return_linear`` also returns the raw magnitude STFT (bins, frames)
    (the reference's with_linear binarization path, data_gen_utils.py:141-147).
    """
    pad_mode = "constant" if cfg.mel_compression == "log10" else "reflect"
    spc = stft_magnitude_np(wav, cfg.fft_size, cfg.hop_size, cfg.win_size, pad_mode)
    basis = mel_filterbank(cfg.sample_rate, cfg.fft_size, cfg.num_mels,
                           cfg.fmin, cfg.fmax)
    mel = basis @ spc
    if cfg.mel_compression == "log10":
        mel = np.log10(np.maximum(cfg.mel_eps, mel))
    else:
        mel = np.log(np.maximum(cfg.mel_eps, mel))
    # Right-pad the wav to exactly frames*hop (utils/audio.py:67-76 rule).
    n = wav.shape[0]
    r_pad = (n // cfg.hop_size + 1) * cfg.hop_size - n
    wav = np.pad(wav, (0, r_pad), mode="constant")
    wav = wav[: mel.shape[1] * cfg.hop_size]
    if return_linear:
        return (wav.astype(np.float32), mel.astype(np.float32),
                spc.astype(np.float32))
    return wav.astype(np.float32), mel.astype(np.float32)


# ---------------------------------------------------------------------------
# Device (torch) implementation, on the input tensors' device
# ---------------------------------------------------------------------------

def frame_signal(wav: torch.Tensor, n_fft: int, hop_size: int,
                 pad_mode: str = "constant") -> torch.Tensor:
    """Center-pad and frame a batch of waveforms: (B, T) -> (B, frames,
    n_fft)."""
    pad = n_fft // 2
    mode = "constant" if pad_mode == "constant" else "reflect"
    padded = F.pad(wav[:, None], (pad, pad), mode=mode)[:, 0]
    return padded.unfold(-1, n_fft, hop_size)


def _window(win_size: int, n_fft: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(hann_window(win_size, n_fft)).to(like.device)


def stft_magnitude(wav: torch.Tensor, n_fft: int, hop_size: int,
                   win_size: int, pad_mode: str = "constant") -> torch.Tensor:
    """Batched STFT magnitude: (B, T) -> (B, 1 + n_fft//2, frames)."""
    frames = frame_signal(wav, n_fft, hop_size, pad_mode)
    spec = torch.fft.rfft(frames * _window(win_size, n_fft, wav), dim=-1)
    return spec.abs().transpose(-1, -2)


def mel_spectrogram(wav: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """Batched log-mel front end: (B, T) -> (B, n_mels, frames)."""
    pad_mode = "constant" if cfg.mel_compression == "log10" else "reflect"
    spc = stft_magnitude(wav, cfg.fft_size, cfg.hop_size, cfg.win_size,
                         pad_mode)
    basis = torch.from_numpy(mel_filterbank(
        cfg.sample_rate, cfg.fft_size, cfg.num_mels, cfg.fmin,
        cfg.fmax)).to(wav.device)
    mel = torch.einsum("mf,bft->bmt", basis, spc).clamp_min(cfg.mel_eps)
    return mel.log10() if cfg.mel_compression == "log10" else mel.log()


@functools.lru_cache(maxsize=16)
def _window_sumsquare(n_fft: int, hop_size: int, win_size: int,
                      n_frames: int) -> np.ndarray:
    """Host-precomputed overlap-added squared-window envelope (constant)."""
    win = hann_window(win_size, n_fft).astype(np.float64) ** 2
    total = n_fft + hop_size * (n_frames - 1)
    out = np.zeros(total)
    for f in range(n_frames):
        out[f * hop_size: f * hop_size + n_fft] += win
    return np.maximum(out, 1e-8).astype(np.float32)


def istft(spec: torch.Tensor, phase: torch.Tensor, n_fft: int,
          hop_size: int, win_size: int, length: int) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add with window-sum normalization:
    (B, bins, frames) magnitude and phase -> (B, length). Subframe k of
    frame f (``hop`` samples) lands at output block f + k, one shifted add
    per k, in JAX's order. Requires ``hop | n_fft``."""
    if n_fft % hop_size:
        raise ValueError(f"istft requires hop {hop_size} to divide n_fft "
                         f"{n_fft}")
    frames = torch.fft.irfft(torch.polar(spec, phase).transpose(-1, -2),
                             n=n_fft, dim=-1)
    frames = frames * _window(win_size, n_fft, spec)      # (B, F, n_fft)
    b, n_frames, _ = frames.shape
    span = n_frames * hop_size
    buf = frames.new_zeros((b, n_fft + hop_size * (n_frames - 1)))
    for k in range(n_fft // hop_size):
        sub = frames[:, :, k * hop_size: (k + 1) * hop_size]
        buf[:, k * hop_size: k * hop_size + span] += sub.reshape(b, span)
    wsum = torch.from_numpy(_window_sumsquare(n_fft, hop_size, win_size,
                                              n_frames)).to(spec.device)
    pad = n_fft // 2
    return (buf / wsum)[:, pad: pad + length]


def griffin_lim(magnitude: torch.Tensor, cfg: AudioConfig,
                n_iters: int | None = None,
                generator: torch.Generator | None = None,
                phase: torch.Tensor | None = None) -> torch.Tensor:
    """Griffin-Lim phase reconstruction: (B, bins, frames) magnitude ->
    (B, frames * hop) on the magnitude's device (JAX's ``griffin_lim_jax``).
    The initial phase is ``phase``, or uniform in [-pi, pi) drawn from
    ``generator`` (on its own device; default a CPU generator seeded 0)."""
    if n_iters is None:
        n_iters = cfg.griffin_lim_iters
    b, bins, frames = magnitude.shape
    length = frames * cfg.hop_size
    if phase is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        phase = (torch.rand((b, bins, frames), generator=generator,
                            device=generator.device) * 2 - 1) * math.pi
    phase = phase.to(magnitude.device, torch.float32)
    window = _window(cfg.win_size, cfg.fft_size, magnitude)
    for _ in range(n_iters):
        wav = istft(magnitude, phase, cfg.fft_size, cfg.hop_size,
                    cfg.win_size, length)
        spec = frame_signal(wav, cfg.fft_size, cfg.hop_size, "constant")
        cplx = torch.fft.rfft(spec * window, dim=-1).transpose(-1, -2)
        phase = torch.angle(cplx)[:, :, :frames]
    return istft(magnitude, phase, cfg.fft_size, cfg.hop_size, cfg.win_size,
                 length)


# ---------------------------------------------------------------------------
# Mel denormalization helpers (inverse of the compression)
# ---------------------------------------------------------------------------

def mel_to_linear_np(mel: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Approximate inverse of the mel projection via the filterbank pseudo-inverse."""
    basis = mel_filterbank(cfg.sample_rate, cfg.fft_size, cfg.num_mels,
                           cfg.fmin, cfg.fmax)
    inv = np.linalg.pinv(basis)
    if cfg.mel_compression == "log10":
        amp = np.power(10.0, mel)
    else:
        amp = np.exp(mel)
    return np.maximum(1e-10, inv @ amp).astype(np.float32)
