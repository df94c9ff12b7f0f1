"""Vocoder registry: name -> vocoder class, with a dotted-path fallback
(``fastdiff_tpu/vocoders/base.py``).

``hparams['vocoder']`` is looked up case-insensitively among the registered
classes (``fastdiff``, ``pwg``, ``glmel``, ``gllinear``, ``stft``); any other
name is a dotted import path, resolved by ``data/dataset.py:resolve_class``
(a ``fastdiff_tpu.`` path names the port's class). Every vocoder is built as
``cls(hparams, device=...)`` on the CUDA card unless the caller names
another device, and exposes ``spec2wav`` (spectrogram -> waveform) and the
canonical ``wav2spec`` front end, which the binarizer shares, so analysis
and synthesis agree on mel parameters.
"""

from __future__ import annotations

import numpy as np

from fastdiff_tpu_torch.config import AudioConfig
from fastdiff_tpu_torch.models.fastdiff import checked_device
from fastdiff_tpu_torch.ops.dsp import wav2mel_np
from fastdiff_tpu_torch.ops.loudness import (normalize_loudness,
                                             trim_long_silences)
from fastdiff_tpu_torch.utils import audio_io

VOCODERS = {}


def register_vocoder(cls, name: str | None = None):
    """Register ``cls`` under ``name`` (default its class name), lower
    case; usable as a class decorator."""
    VOCODERS[(name or cls.__name__).lower()] = cls
    return cls


def get_vocoder_cls(hparams: dict):
    name = str(hparams.get("vocoder", "fastdiff"))
    if name.lower() in VOCODERS:
        return VOCODERS[name.lower()]
    if "." not in name:
        raise ValueError(f"unknown vocoder {name!r}: the port registers "
                         f"{sorted(VOCODERS)}; other names are dotted class "
                         "paths")
    from fastdiff_tpu_torch.data.dataset import resolve_class
    return resolve_class(name)


class BaseVocoder:
    def __init__(self, hparams: dict | None = None, device="cuda"):
        self.hparams = dict(hparams or {})
        self.device = checked_device(device)

    def spec2wav(self, mel: np.ndarray, **kwargs) -> np.ndarray:
        """mel (T, n_mels) -> waveform (T * hop,)."""
        raise NotImplementedError

    @staticmethod
    def wav2spec(wav_fn, hparams: dict | None = None):
        """Canonical analysis front end: wav file -> (wav, mel (T, n_mels)).

        Honours the reference ``process_utterance`` flags
        (data_gen/tts/data_gen_utils.py:103-120): ``trim_long_sil`` (the
        VAD silence clipping, after a normalization to -20 LUFS, as the
        reference's trim_long_silences does) and ``loud_norm`` (BS.1770
        normalization to -22 LUFS)."""
        from fastdiff_tpu_torch.utils.hparams import hparams as global_hp
        hp = hparams if hparams is not None else global_hp
        cfg = AudioConfig.from_hparams(hp)
        wav, _ = audio_io.load_wav(wav_fn, target_sr=cfg.sample_rate)
        if hp.get("trim_long_sil"):
            wav = normalize_loudness(wav, cfg.sample_rate, -20.0)
            wav = trim_long_silences(wav, cfg.sample_rate)
        if hp.get("loud_norm"):
            wav = normalize_loudness(wav, cfg.sample_rate, -22.0)
        wav, mel = wav2mel_np(wav, cfg)
        return wav, mel.T
