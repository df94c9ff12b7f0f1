"""Stage-2 preprocessing: metadata -> binarized pickle shards
(``fastdiff_tpu/data/binarizer.py``, numpy).

- reads ``<processed_data_dir>/metadata_phone.csv`` (columns item_name,
  wav_fn); the first ``test_num`` items form valid == test, the rest train;
- fans ``process_item`` over worker processes (``N_PROC``) and writes records
  ``{item_name, wav_fn, mel (T, n_mels) f32, wav f16, sec, len}`` with
  ``data/indexed_dataset.py`` plus ``<prefix>_lengths.npy`` of mel frame
  counts and, with ``with_wav``, the v2 flat files of the C++ loader
  (``data/native_io.py``) beside the shards, as JAX writes them;
- ``process_item`` / ``process_mel_item`` are also the inference featurizers
  of ``test_input_dir`` / ``test_mel_dir`` (``data/dataset.py``).

The mel front end is ``ops/dsp.py:wav2mel_np``; the Tacotron variant only
switches the ``AudioConfig`` (ln compression, reflect padding, fmin 0 /
fmax 8000).
"""

from __future__ import annotations

import csv
import dataclasses
import os
import random
from typing import List

import numpy as np

from fastdiff_tpu_torch.config import AudioConfig
from fastdiff_tpu_torch.data.indexed_dataset import IndexedDatasetBuilder
from fastdiff_tpu_torch.data.native_io import NativeDatasetBuilder
from fastdiff_tpu_torch.ops.dsp import wav2mel_np
from fastdiff_tpu_torch.utils import audio_io
from fastdiff_tpu_torch.utils.multiprocess import chunked_multiprocess_run


def read_metadata_csv(path: str) -> List[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class VocoderBinarizer:
    """PWG-style (log10) mel binarizer. ``device`` is the speaker encoder's
    for the TTS binarizers' ``with_spk_embed``; this one uses none."""

    def __init__(self, hparams: dict, device="cuda"):
        self.hparams = hparams
        self.device = device
        self.processed_data_dirs = str(hparams["processed_data_dir"]).split(",")
        self.binarization_args = hparams.get("binarization_args", {})
        self.item2wavfn = {}
        self.item_names: List[str] = []

    # -- metadata ----------------------------------------------------------
    def load_meta_data(self) -> None:
        for ds_id, processed_dir in enumerate(self.processed_data_dirs):
            rows = read_metadata_csv(os.path.join(processed_dir, "metadata_phone.csv"))
            for r in rows:
                item_name = r["item_name"]
                if len(self.processed_data_dirs) > 1:
                    item_name = f"ds{ds_id}_{item_name}"
                self.item2wavfn[item_name] = r["wav_fn"]
        self.item_names = sorted(self.item2wavfn.keys())
        if self.binarization_args.get("shuffle"):
            random.seed(1234)
            random.shuffle(self.item_names)

    @property
    def train_item_names(self):
        return self.item_names[int(self.hparams.get("test_num", 100)):]

    @property
    def valid_item_names(self):
        return self.item_names[: int(self.hparams.get("test_num", 100))]

    @property
    def test_item_names(self):
        return self.valid_item_names

    def meta_data(self, prefix: str):
        names = {"valid": self.valid_item_names,
                 "test": self.test_item_names}.get(prefix, self.train_item_names)
        for item_name in names:
            yield item_name, self.item2wavfn[item_name]

    # -- processing --------------------------------------------------------
    @classmethod
    def audio_config(cls, hparams: dict) -> AudioConfig:
        return AudioConfig.from_hparams(hparams)

    @classmethod
    def process_item(cls, item_name: str, wav_fn: str, binarization_args: dict,
                     hparams: dict = None):
        """Featurize one utterance (also the wav->wav inference front-end)."""
        from fastdiff_tpu_torch.utils.hparams import hparams as global_hp
        hp = hparams if hparams is not None else global_hp
        cfg = cls.audio_config(hp)
        wav, _ = audio_io.load_wav(wav_fn, target_sr=cfg.sample_rate)
        with_linear = bool((binarization_args or {}).get("with_linear"))
        out = wav2mel_np(wav, cfg, return_linear=with_linear)
        wav, mel = out[0], out[1]
        item = {
            "item_name": item_name,
            "wav_fn": wav_fn,
            "mel": mel.T.astype(np.float32),        # (T, n_mels), pwg layout
            "wav": wav.astype(np.float16),
            "sec": len(wav) / cfg.sample_rate,
            "len": mel.shape[1],
        }
        if with_linear:
            item["linear"] = out[2].T.astype(np.float32)  # (T, bins)
        return item

    @classmethod
    def process_mel_item(cls, item_name: str, mel, wav_fn, binarization_args: dict):
        """Wrap an externally produced mel (.npy) for mel->wav inference
        (reference: vocoder_binarizer.py:115-122)."""
        mel = np.asarray(mel, dtype=np.float32)
        return {"item_name": item_name, "wav_fn": wav_fn, "mel": mel,
                "wav": np.zeros((0,), dtype=np.float16), "sec": 0,
                "len": mel.shape[0]}

    def process(self) -> None:
        self.load_meta_data()
        out_dir = self.hparams["binary_data_dir"]
        os.makedirs(out_dir, exist_ok=True)
        for prefix in ("valid", "test", "train"):
            self.process_data(prefix)

    def process_data(self, prefix: str) -> None:
        out_dir = self.hparams["binary_data_dir"]
        meta = list(self.meta_data(prefix))
        args = [(item_name, wav_fn, self.binarization_args, dict(self.hparams))
                for item_name, wav_fn in meta]
        builder = IndexedDatasetBuilder(os.path.join(out_dir, prefix))
        with_wav = self.binarization_args.get("with_wav", True)
        native_builder = (NativeDatasetBuilder(os.path.join(out_dir, prefix))
                          if with_wav else None)
        lengths, total_sec = [], 0.0
        for item in chunked_multiprocess_run(
                self.process_item, args, num_workers=self.num_workers):
            if item is None:
                continue
            if not with_wav:
                item.pop("wav", None)
            builder.add_item(item)
            if native_builder is not None:
                native_builder.add_item(item["mel"], item["wav"])
            lengths.append(item["len"])
            total_sec += item["sec"]
        builder.finalize()
        if native_builder is not None:
            native_builder.finalize()
        np.save(os.path.join(out_dir, f"{prefix}_lengths.npy"), lengths)
        print(f"| {prefix} total duration: {total_sec:.3f}s ({len(lengths)} items)")

    @property
    def num_workers(self) -> int:
        return int(os.getenv("N_PROC", self.hparams.get("N_PROC", os.cpu_count() or 1)))


class TacotronVocoderBinarizer(VocoderBinarizer):
    """Tacotron-compatible mels: ln compression, reflect STFT padding,
    fmin 0 / fmax 8000 (reference: vocoder_binarizer_tacotron.py:44-47,105-125,
    data_gen/tts/tacotron/{stft,layers}.py)."""

    @classmethod
    def audio_config(cls, hparams: dict) -> AudioConfig:
        base = AudioConfig.from_hparams(hparams)
        return dataclasses.replace(
            base,
            fmin=float(hparams.get("mel_fmin", 0.0)),
            fmax=float(hparams.get("mel_fmax", 8000.0)),
            mel_eps=1e-5,
            mel_compression="ln",
        )
