"""Waveform file IO without librosa or soundfile, a copy of
``fastdiff_tpu/utils/audio_io.py``.

``load_wav`` reads PCM 8/16/32-bit and float wavs with ``scipy.io.wavfile``,
downmixes to mono and resamples by polyphase filtering; ``save_wav`` writes
16-bit PCM as x * 32767 cast without a clip (normalize first, as
``training/task.py:test_step`` does); ``to_mp3`` needs ffmpeg and raises
without it.
"""

from __future__ import annotations

import numpy as np
from scipy import signal
from scipy.io import wavfile


def load_wav(path: str, target_sr: int = None) -> tuple:
    """Read a wav file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32/float64 wav
        wav = data.astype(np.float32)
    if wav.ndim > 1:  # downmix multichannel
        wav = wav.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        g = np.gcd(int(sr), int(target_sr))
        wav = signal.resample_poly(wav, target_sr // g, sr // g).astype(np.float32)
        sr = target_sr
    return wav, sr


def save_wav(wav: np.ndarray, path: str, sr: int, norm: bool = False) -> None:
    """Write float waveform as 16-bit PCM (x32767, reference utils/audio.py:11-16)."""
    wav = np.asarray(wav, dtype=np.float32)
    if norm:
        wav = wav / max(1e-9, np.abs(wav).max())
    wavfile.write(path, sr, (wav * 32767.0).astype(np.int16))


def to_mp3(out_path: str) -> None:
    """Convert ``<out_path>.wav`` to mp3 via ffmpeg and remove the wav
    (reference: utils/audio.py:19-23). Raises if ffmpeg is unavailable."""
    import os
    import subprocess
    subprocess.check_call(
        f'ffmpeg -threads 1 -loglevel error -i "{out_path}.wav" -vn '
        f'-ar 44100 -ac 1 -b:a 192k -y -hide_banner "{out_path}.mp3"',
        shell=True)
    os.remove(f"{out_path}.wav")
