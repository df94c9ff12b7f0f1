"""Chinese TTS binarizer: a word-level (character) encoder and char-level
duration / f0 on top of the TTS binarizer records
(``fastdiff_tpu/data/zh_binarizer.py``, numpy).

The reference's ``ZhBinarizer`` (data_gen/tts/binarizer_zh.py:13-129):

- a *word* vocabulary of the corpus' most frequent characters
  (``word_size``), persisted to ``word_set.json``;
- per item (``get_word``): ``ph_words`` (phones grouped per character,
  joined with ``_``), ``ph2word`` (phone -> 1-based word), ``mel2word``,
  ``dur_word``, ``words`` (``<BOS>`` + characters + ``<EOS>``) and their
  ``word_tokens``;
- ``f0_ph``: per frame, the mean voiced f0 of the character span the frame
  belongs to (``char_level_f0``).

Grouping: ``|`` / ``#`` close the current character group and are folded
into it; a phone that does not start with a letter or digit (punctuation,
``<EOS>``) closes the previous group and is a group of its own; ``<BOS>`` is
its own leading group. Without a TextGrid the phones get uniform spans, as
``collate_tts`` gives them.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import List

import numpy as np

from fastdiff_tpu_torch.data.tts_binarizer import TTSBinarizer
from fastdiff_tpu_torch.text.encoder import TokenTextEncoder

PUNCS = "!,.?;:"


def group_phones_to_words(ph_list: List[str]) -> tuple:
    """ph list -> (ph_words, ph2word 1-based).

    Boundary handling follows binarizer_zh.py:75-90: '|'/'#' end a group
    (inclusive), a non-alnum-initial phone ends the previous group and is
    its own group, '<BOS>' is its own group.
    """
    last_idx: List[int] = []
    for i, ph in enumerate(ph_list):
        if ph in ("|", "#"):
            last_idx.append(i)
        elif not ph[0].isalnum():
            if ph != "<BOS>" and i > 0 and (not last_idx or last_idx[-1] != i - 1):
                last_idx.append(i - 1)
            last_idx.append(i)
    if not last_idx or last_idx[-1] != len(ph_list) - 1:
        last_idx.append(len(ph_list) - 1)
    start_idx = [0] + [i + 1 for i in last_idx[:-1]]
    ph_words: List[str] = []
    ph2word = np.zeros(len(ph_list), dtype=np.int64)
    for w, (s, e) in enumerate(zip(start_idx, last_idx)):
        ph_words.append("_".join(ph_list[s: e + 1]))
        ph2word[s: e + 1] = w + 1                       # 1-based, 0 = pad
    return ph_words, ph2word


class ZhBinarizer(TTSBinarizer):
    """TTS binarizer with the zh word/char-level extensions."""

    DEFAULT_WORD_SIZE = 3000

    def build_word_encoder(self) -> TokenTextEncoder:
        """Character vocabulary over the corpus text, most-common
        ``word_size`` entries (binarizer_zh.py:14-30)."""
        out_dir = self.hparams["binary_data_dir"]
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, "word_set.json")
        if os.path.exists(fn) and not self.binarization_args.get(
                "reset_word_dict", True):
            with open(fn) as f:
                word_set = json.load(f)
        else:
            counts = Counter()
            for meta in self.item_meta.values():
                counts.update(list(str(meta.get("txt", ""))))
            total = sum(counts.values())
            most = counts.most_common(
                int(self.hparams.get("word_size", self.DEFAULT_WORD_SIZE)))
            n_unk = total - sum(c for _, c in most)
            word_set = [w for w, _ in most]
            with open(fn, "w") as f:
                json.dump(word_set, f)
            print(f"| #total words: {total}, #unk_words: {n_unk}")
        return TokenTextEncoder(vocab_list=word_set, replace_oov="<UNK>")

    def process(self) -> None:
        self.load_meta_data()
        self.phone_encoder = self.build_phone_encoder()
        self.spk_map = self.build_spk_map()
        self.word_encoder = self.build_word_encoder()
        os.makedirs(self.hparams["binary_data_dir"], exist_ok=True)
        for prefix in ("valid", "test", "train"):
            self.process_data(prefix)

    def process_tts_item(self, item_name: str, wav_fn: str):
        item = super().process_tts_item(item_name, wav_fn)
        if item is None or "ph" not in item:
            return item
        if "mel2ph" not in item:
            # alignment-free fallback: uniform phone spans (the reference
            # hard-requires a TextGrid, binarizer_zh.py:36-41; this repo
            # degrades to the same uniform fallback its task collate uses
            # so word/char aggregates exist without MFA)
            n_ph = len(item["ph"].split())
            bounds = np.linspace(0, item["len"], n_ph + 1).astype(np.int64)
            m2p = np.zeros(item["len"], np.int64)
            for p in range(n_ph):
                m2p[bounds[p]: bounds[p + 1]] = p + 1
            item["mel2ph"] = m2p
            item["dur"] = np.bincount(m2p, minlength=n_ph + 1)[1:]
        self._add_word_fields(item)
        if "f0" in item:
            item["f0_ph"] = char_level_f0(
                np.asarray(item["f0"], np.float32),
                np.asarray(item["mel2ph"], np.int64),
                item["ph"].split())
        return item

    def _add_word_fields(self, item: dict) -> None:
        """binarizer_zh.py:71-111 get_word equivalent."""
        ph_list = item["ph"].split()
        ph_words, ph2word = group_phones_to_words(ph_list)
        item["ph_words"] = ph_words
        item["ph2word"] = ph2word.tolist()
        if "mel2ph" in item:
            mel2ph = np.asarray(item["mel2ph"], np.int64)
            valid = np.clip(mel2ph, 1, len(ph_list)) - 1
            mel2word = ph2word[valid] * (mel2ph > 0)
            dur_word = np.bincount(mel2word,
                                   minlength=len(ph_words) + 1)[1:]
            item["mel2word"] = mel2word.tolist()
            item["dur_word"] = dur_word.tolist()
        words = list(str(item.get("txt", "")))
        if words and words[-1] in PUNCS + "。？！，；：":
            words = words[:-1]
        words = ["<BOS>"] + words + ["<EOS>"]
        item["words"] = words
        item["word_tokens"] = self.word_encoder.encode(" ".join(words))


def char_level_f0(f0: np.ndarray, mel2ph: np.ndarray,
                  ph_list: List[str]) -> np.ndarray:
    """Per-frame f0 averaged over each character span; 0 on frames whose
    phone is not a pinyin syllable (binarizer_zh.py:53-68 semantics)."""
    _, ph2word = group_phones_to_words(ph_list)
    n = min(len(f0), len(mel2ph))
    f0, mel2ph = f0[:n], mel2ph[:n]
    valid = np.clip(mel2ph, 1, len(ph_list)) - 1
    mel2word = ph2word[valid] * (mel2ph > 0)
    f0_ph = np.zeros(n, dtype=np.float64)
    # a word is a pinyin syllable when its first phone starts with a letter
    word_first_ph = {}
    for i, ph in enumerate(ph_list):
        w = int(ph2word[i])
        if w not in word_first_ph:
            word_first_ph[w] = ph
    for w in np.unique(mel2word):
        if w == 0:
            continue
        first = word_first_ph.get(int(w), "")
        if not (first[:1].isalpha()):
            continue
        span = mel2word == w
        voiced = f0[span] > 0
        if voiced.any():
            f0_ph[span] = float(f0[span][voiced].mean())
    return f0_ph.astype(np.float32)
