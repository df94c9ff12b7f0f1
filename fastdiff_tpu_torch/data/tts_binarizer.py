"""TTS binarizer: phones, alignment and f0 on top of the vocoder records
(``fastdiff_tpu/data/tts_binarizer.py``, numpy).

The reference's ``BaseBinarizer`` (data_gen/tts/base_binarizer.py:26-336)
on the port's ``VocoderBinarizer``:

- the phone encoder over the corpus' ``ph`` column, persisted to
  ``phone_set.json``, and the speaker map ``spk_map.json``;
- ``with_align``: the item's MFA TextGrid (``tg_fn``) -> ``mel2ph`` and
  ``dur`` (``data/align.py``);
- ``with_f0``: f0 and coarse pitch (``ops/pitch.py:get_pitch``), and with
  ``with_f0cwt`` the cwt decomposition (``ops/cwt.py:f0_to_cwt``);
- the records go to the pickle shards (``data/indexed_dataset.py``) with
  ``<prefix>_lengths.npy``, one item at a time in this process, as JAX's.

- ``with_spk_embed``: the d-vector of the item's mel
  (``models/spk_encoder.py:get_speaker_encoder``, ``spk_embed_ckpt``'s
  weights or the seed ones) as ``spk_embed``, on ``device`` (the CUDA card
  unless the caller names another; only this option uses a device).
"""

from __future__ import annotations

import json
import os

import numpy as np

from fastdiff_tpu_torch.data.align import align_textgrid
from fastdiff_tpu_torch.data.binarizer import (VocoderBinarizer,
                                               read_metadata_csv)
from fastdiff_tpu_torch.data.indexed_dataset import IndexedDatasetBuilder
from fastdiff_tpu_torch.ops.cwt import f0_to_cwt
from fastdiff_tpu_torch.ops.pitch import get_pitch
from fastdiff_tpu_torch.text.encoder import UNK, TokenTextEncoder


class TTSBinarizer(VocoderBinarizer):
    """metadata_phone.csv columns: item_name, wav_fn[, txt, ph, spk, tg_fn]."""

    def __init__(self, hparams: dict, device="cuda"):
        super().__init__(hparams, device)
        self.item_meta = {}

    def load_meta_data(self) -> None:
        for ds_id, processed_dir in enumerate(self.processed_data_dirs):
            rows = read_metadata_csv(os.path.join(processed_dir, "metadata_phone.csv"))
            for r in rows:
                item_name = r["item_name"]
                if len(self.processed_data_dirs) > 1:
                    item_name = f"ds{ds_id}_{item_name}"
                self.item2wavfn[item_name] = r["wav_fn"]
                self.item_meta[item_name] = r
        self.item_names = sorted(self.item2wavfn.keys())

    # -- vocab -------------------------------------------------------------
    def build_phone_encoder(self) -> TokenTextEncoder:
        """The phone set over all items, written to ``phone_set.json``
        (read back instead when ``reset_phone_dict`` is false)."""
        out_dir = self.hparams["binary_data_dir"]
        os.makedirs(out_dir, exist_ok=True)
        phone_set_fn = os.path.join(out_dir, "phone_set.json")
        if os.path.exists(phone_set_fn) and not self.binarization_args.get(
                "reset_phone_dict", True):
            with open(phone_set_fn) as f:
                tokens = json.load(f)
        else:
            phones = set()
            for meta in self.item_meta.values():
                for p in str(meta.get("ph", "")).split():
                    phones.add(p)
            tokens = sorted(phones)
            with open(phone_set_fn, "w") as f:
                json.dump(tokens, f)
        return TokenTextEncoder(vocab_list=tokens, replace_oov=UNK)

    def build_spk_map(self) -> dict:
        out_dir = self.hparams["binary_data_dir"]
        spks = sorted({str(m.get("spk", "SPK0")) for m in self.item_meta.values()})
        spk_map = {s: i for i, s in enumerate(spks)}
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "spk_map.json"), "w") as f:
            json.dump(spk_map, f)
        return spk_map

    # -- processing --------------------------------------------------------
    def process(self) -> None:
        self.load_meta_data()
        self.phone_encoder = self.build_phone_encoder()
        self.spk_map = self.build_spk_map()
        os.makedirs(self.hparams["binary_data_dir"], exist_ok=True)
        for prefix in ("valid", "test", "train"):
            self.process_data(prefix)

    def process_data(self, prefix: str) -> None:
        out_dir = self.hparams["binary_data_dir"]
        builder = IndexedDatasetBuilder(os.path.join(out_dir, prefix))
        lengths, total_sec = [], 0.0
        for item_name, wav_fn in self.meta_data(prefix):
            item = self.process_tts_item(item_name, wav_fn)
            if item is None:
                continue
            builder.add_item(item)
            lengths.append(item["len"])
            total_sec += item["sec"]
        builder.finalize()
        np.save(os.path.join(out_dir, f"{prefix}_lengths.npy"), lengths)
        print(f"| {prefix}: {len(lengths)} items, {total_sec:.1f}s")

    def process_tts_item(self, item_name: str, wav_fn: str):
        hp = self.hparams
        args = self.binarization_args
        meta = self.item_meta[item_name]
        item = self.process_item(item_name, wav_fn, args, hparams=hp)
        if item is None:
            return None
        cfg = self.audio_config(hp)
        n_frames = item["len"]

        ph = str(meta.get("ph", "")).strip()
        if ph:
            item["ph"] = ph
            item["phone"] = np.asarray(self.phone_encoder.encode(ph), np.int64)
        item["txt"] = meta.get("txt", "")
        item["spk_id"] = self.spk_map.get(str(meta.get("spk", "SPK0")), 0)

        if args.get("with_align") and meta.get("tg_fn"):
            with open(meta["tg_fn"]) as f:
                tg_text = f.read()
            mel2ph, dur = align_textgrid(tg_text, ph.split(), n_frames,
                                         cfg.sample_rate, cfg.hop_size)
            item["mel2ph"] = mel2ph
            item["dur"] = dur
        if args.get("with_f0"):
            wav = np.asarray(item["wav"], np.float32)
            f0, coarse = get_pitch(wav, n_frames, cfg)
            item["f0"] = f0
            item["pitch"] = coarse
            if args.get("with_f0cwt"):
                spec, mean, std = f0_to_cwt(f0)
                item["cwt_spec"] = spec
                item["cwt_mean"] = mean
                item["cwt_std"] = std
        if args.get("with_spk_embed"):
            from fastdiff_tpu_torch.models.spk_encoder import \
                get_speaker_encoder
            encoder = get_speaker_encoder(str(hp.get("spk_embed_ckpt", "")),
                                          self.device)
            item["spk_embed"] = encoder.embed(item["mel"])
        return item
