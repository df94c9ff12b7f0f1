"""Griffin-Lim vocoders (``fastdiff_tpu/vocoders/gl.py``; reference:
vocoders/gl_mel.py, gl_linear.py, vocoders/stft.py): phase-reconstruction
baselines that need no model, run on the vocoder's device through
``ops/dsp.py:griffin_lim`` (``griffin_lim_iters`` iterations from the
initial phase of a CPU generator seeded 0, the same on every device)."""

from __future__ import annotations

import numpy as np
import torch

from fastdiff_tpu_torch.config import AudioConfig
from fastdiff_tpu_torch.ops import dsp
from fastdiff_tpu_torch.vocoders.base import BaseVocoder, register_vocoder


def _griffin_lim(magnitude: np.ndarray, cfg: AudioConfig,
                 device) -> np.ndarray:
    """(bins, frames) magnitude -> (frames * hop,) waveform."""
    mag = torch.from_numpy(np.asarray(magnitude, np.float32))[None]
    return dsp.griffin_lim(mag.to(device), cfg)[0].cpu().numpy()


def _amplitude(spec: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Undo the log compression of ``cfg``."""
    if cfg.mel_compression == "log10":
        return np.power(10.0, spec)
    return np.exp(spec)


@register_vocoder
class GLMel(BaseVocoder):
    """log-mel -> linear magnitude (filterbank pseudo-inverse) ->
    Griffin-Lim (reference: vocoders/gl_mel.py:12-22)."""

    def spec2wav(self, mel: np.ndarray, **kwargs) -> np.ndarray:
        cfg = AudioConfig.from_hparams(self.hparams)
        linear = dsp.mel_to_linear_np(np.asarray(mel).T, cfg)   # (bins, T)
        return _griffin_lim(linear, cfg, self.device)


@register_vocoder
class GLLinear(BaseVocoder):
    """log-linear magnitude -> Griffin-Lim (reference:
    vocoders/gl_linear.py)."""

    def spec2wav(self, linear: np.ndarray, **kwargs) -> np.ndarray:
        cfg = AudioConfig.from_hparams(self.hparams)
        return _griffin_lim(_amplitude(np.asarray(linear).T, cfg), cfg,
                            self.device)


@register_vocoder
class STFT(BaseVocoder):
    """Raw magnitude STFT -> Griffin-Lim (reference: vocoders/stft.py:9-36)."""

    def spec2wav(self, spec: np.ndarray, **kwargs) -> np.ndarray:
        cfg = AudioConfig.from_hparams(self.hparams)
        return _griffin_lim(np.asarray(spec).T, cfg, self.device)
