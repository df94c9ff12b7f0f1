"""End-to-end TTS inference glue: acoustic model -> vocoder
(``fastdiff_tpu/tts/infer.py``).

- ``BaseTTSInfer``: the adapter contract of an acoustic model (text ->
  mel), with the text front end (normalize -> phonemes -> ids) wired in
  (reference: egs/tts/base_tts_infer.py preprocess_input).
- ``NpyMelSource``: replays precomputed ``.npy`` mels from a directory.
- ``TTSPipeline``: chains a ``BaseTTSInfer`` into a vocoder of the
  registry, built on ``device`` (the CUDA card unless the caller names
  another), and writes peak-normalized wavs.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from fastdiff_tpu_torch.text.encoder import TokenTextEncoder
from fastdiff_tpu_torch.text.processors import get_txt_processor_cls
from fastdiff_tpu_torch.utils import audio_io
from fastdiff_tpu_torch.vocoders import get_vocoder_cls


class BaseTTSInfer:
    """Adapter contract for acoustic models (text -> mel).

    Subclasses implement ``forward_model(token_ids) -> mel (T, n_mels)``.
    """

    def __init__(self, hparams: dict,
                 token_encoder: Optional[TokenTextEncoder] = None):
        self.hparams = hparams
        self.txt_processor = get_txt_processor_cls(
            hparams.get("pre_align_args", {}).get("txt_processor", "en"))
        self.token_encoder = token_encoder

    def preprocess_input(self, text: str) -> dict:
        phones, norm_text = self.txt_processor.process(text)
        item = {"text": text, "norm_text": norm_text, "phones": phones}
        if self.token_encoder is not None:
            item["token_ids"] = self.token_encoder.encode(" ".join(phones))
        return item

    def forward_model(self, token_ids: List[int]) -> np.ndarray:
        raise NotImplementedError

    def infer_once(self, text: str) -> np.ndarray:
        item = self.preprocess_input(text)
        return self.forward_model(item.get("token_ids", item["phones"]))


class NpyMelSource(BaseTTSInfer):
    """'Acoustic model' that replays precomputed mels from a directory, in
    name order (demo_tts.py:23-29 flow)."""

    def __init__(self, hparams: dict, mel_dir: str):
        super().__init__(hparams)
        self.mel_paths = sorted(
            os.path.join(mel_dir, f) for f in os.listdir(mel_dir)
            if f.endswith(".npy"))
        self._i = 0

    def infer_once(self, text: str = "") -> np.ndarray:
        mel = np.load(self.mel_paths[self._i % len(self.mel_paths)])
        self._i += 1
        return np.asarray(mel, np.float32)


class TTSPipeline:
    """text (or mel source) -> vocoder -> wav files."""

    def __init__(self, hparams: dict, acoustic: BaseTTSInfer, device="cuda"):
        self.hparams = hparams
        self.acoustic = acoustic
        self.vocoder = get_vocoder_cls(hparams)(hparams, device=device)
        self.sample_rate = int(hparams.get("audio_sample_rate", 22050))

    def synthesize(self, text: str,
                   out_wav: Optional[str] = None) -> np.ndarray:
        mel = self.acoustic.infer_once(text)          # (T, n_mels)
        wav = self.vocoder.spec2wav(mel)
        wav = wav / max(1e-9, np.abs(wav).max())
        if out_wav:
            os.makedirs(os.path.dirname(out_wav) or ".", exist_ok=True)
            audio_io.save_wav(wav, out_wav, self.sample_rate)
        return wav
