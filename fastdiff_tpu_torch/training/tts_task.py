"""FastSpeech 2 task, serving half (``fastdiff_tpu/training/tts_task.py``).

``FastSpeech2Task(hparams, device=...)`` sizes the model from the hparams
(``FS2Config.from_hparams``; ``vocab_size`` from the hparams or from
``binary_data_dir/phone_set.json`` plus the three reserved ids, else 100)
on the CUDA card unless the caller names another device. ``build_state``
returns the seed weights and the step, as JAX's (without an optimizer);
``infer_to_wav`` runs text -> mel -> waveform: the FastSpeech 2 forward in
inference mode (predicted durations, the mel padded to ``max_frames``, as
JAX computes it), the mel trimmed to its valid frames, then the vocoder of
the registry (``hparams['vocoder']``, FastDiff by default), which the task
builds on its first call and keeps, so its graph sampler and generator
carry over from call to call. JAX builds a vocoder per call and pads no
mel: each new frame count is a new graph shape here too.

Training is not ported yet: ``train_step``, ``val_step``, ``val_figures``
and the dataloaders raise ``NotImplementedError`` (ROADMAP.md queue 1,
the FastSpeech 2 training slice), so ``run.py`` refuses to fit this task.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from fastdiff_tpu_torch.config import AudioConfig, TrainConfig
from fastdiff_tpu_torch.models.fastdiff import checked_device
from fastdiff_tpu_torch.models.fastspeech2 import FastSpeech2, FS2Config
from fastdiff_tpu_torch.utils import audio_io
from fastdiff_tpu_torch.vocoders import get_vocoder_cls

_TRAINING = ("FastSpeech 2 training (train and val steps, dataloaders, "
             "losses) is not ported to fastdiff_tpu_torch yet: ROADMAP.md "
             "queue 1 item 11, the FastSpeech 2 training slice")


class FastSpeech2Task:
    def __init__(self, hparams: dict, device="cuda"):
        self.hparams = hparams
        self.device = checked_device(device)
        self.train_cfg = TrainConfig.from_hparams(hparams)
        self.audio_cfg = AudioConfig.from_hparams(hparams)
        vocab_size = int(hparams.get("vocab_size", 0)) or \
            self._vocab_size_from_phone_set(hparams)
        self.model_cfg = FS2Config.from_hparams(
            {**hparams, "vocab_size": vocab_size})
        self.model: Optional[FastSpeech2] = None
        self.vocoder = None

    @staticmethod
    def _vocab_size_from_phone_set(hparams: dict) -> int:
        fn = os.path.join(hparams.get("binary_data_dir", ""), "phone_set.json")
        if os.path.exists(fn):
            with open(fn) as f:
                return len(json.load(f)) + 3   # + reserved ids
        return 100

    # -- state -------------------------------------------------------------
    def build_state(self, seed: Optional[int] = None) -> Dict:
        """{'params': the seed weights (a state_dict on the task's device),
        'step': 0}."""
        seed = self.train_cfg.seed if seed is None else seed
        self.model = FastSpeech2(self.model_cfg, seed=seed).to(
            self.device).eval()
        return {"params": dict(self.model.state_dict()), "step": 0}

    # -- training: not ported yet ------------------------------------------
    def train_step(self, state, batch, generator=None):
        raise NotImplementedError(_TRAINING)

    def val_step(self, state, batch, generator=None):
        raise NotImplementedError(_TRAINING)

    def val_figures(self, state, batch):
        raise NotImplementedError(_TRAINING)

    def train_dataloader(self):
        raise NotImplementedError(_TRAINING)

    def val_dataloader(self):
        raise NotImplementedError(_TRAINING)

    # -- inference ---------------------------------------------------------
    @torch.no_grad()
    def infer_mel(self, state, tokens) -> np.ndarray:
        """tokens (T_ph,) -> mel (T_valid, n_mels) from the forward with
        predicted durations at ``t_mel = max_frames``."""
        if self.model is None:
            self.model = FastSpeech2(self.model_cfg).to(self.device).eval()
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                 device=self.device)[None]
        out = functional_call(self.model, state["params"], (tokens,))
        t_valid = int(out["mel_mask"][0].sum())
        return out["mel"][0, :t_valid].cpu().numpy()

    def infer_to_wav(self, state, tokens, out_path: str,
                     vocoder=None) -> np.ndarray:
        """tokens (T_ph,) -> mel -> waveform through the vocoder registry
        (tts_base.py after_infer role); writes the peak-normalized wav to
        ``out_path`` when one is given."""
        mel = self.infer_mel(state, tokens)
        if vocoder is None:
            if self.vocoder is None:
                self.vocoder = get_vocoder_cls(self.hparams)(
                    self.hparams, device=self.device)
            vocoder = self.vocoder
        wav = vocoder.spec2wav(mel)
        if out_path:
            audio_io.save_wav(wav / max(1e-9, np.abs(wav).max()), out_path,
                              self.audio_cfg.sample_rate)
        return wav
