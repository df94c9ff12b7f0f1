"""Text processor registry: language -> (text -> phoneme tokens).

The port's copy of ``fastdiff_tpu/text/processors.py`` (the port imports
nothing of the JAX package).

Same dispatch role as the reference's ``txt_processors`` package
(reference: data_gen/tts/txt_processors/{en,zh}.py, selected by the
``pre_align_args.txt_processor`` hparam). The English processor uses
``g2p_en`` when importable (as the reference does, en.py:12-43) and
otherwise falls back to a deterministic grapheme processor, so the pipeline
works on images without G2P models. Output format matches the reference:
a list of phones with ``|`` word separators, plus the normalized text.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from fastdiff_tpu_torch.text.normalize import normalize_text

PROCESSORS = {}


def register_processor(name):
    def wrap(cls):
        PROCESSORS[name] = cls
        return cls
    return wrap


def get_txt_processor_cls(name: str):
    if name in PROCESSORS:
        return PROCESSORS[name]
    raise KeyError(f"unknown txt_processor '{name}' "
                   f"(available: {sorted(PROCESSORS)})")


class BaseTxtProcessor:
    @classmethod
    def process(cls, text: str, pre_align_args: dict = None) -> Tuple[List[str], str]:
        """text -> (phonemes with '|' word separators, normalized text)."""
        raise NotImplementedError


@register_processor("en")
class EnProcessor(BaseTxtProcessor):
    """English G2P via g2p_en when available, grapheme fallback otherwise."""

    _g2p = None
    _g2p_checked = False

    @classmethod
    def _get_g2p(cls):
        if not cls._g2p_checked:
            cls._g2p_checked = True
            try:
                from g2p_en import G2p
                cls._g2p = G2p()
            except Exception:
                cls._g2p = None
        return cls._g2p

    @classmethod
    def process(cls, text, pre_align_args=None):
        text = normalize_text(text)
        g2p = cls._get_g2p()
        if g2p is not None:
            phones = [p if p != " " else "|" for p in g2p(text)]
        else:
            phones = GraphemeProcessor.text_to_graphemes(text)
        # collapse repeated separators, strip edge separators
        phones = _clean_separators(phones)
        return phones, text


@register_processor("en_syl")
class EnSylProcessor(BaseTxtProcessor):
    """English syllable-letter tokens: each word is split into syllables by
    the native sonority-sequencing syllabifier (text/syllabify.py) and each
    syllable contributes its letters, with ``|`` separating words — the role
    of the reference's SonoriPy-based processor
    (data_gen/tts/txt_processors/en_syl.py), dependency-free."""

    @classmethod
    def process(cls, text, pre_align_args=None):
        from fastdiff_tpu_torch.text.syllabify import syllabify
        text = normalize_text(text)
        phones: List[str] = []
        for word in re.split(r"\s+", text.strip()):
            if not word:
                continue
            if phones:
                phones.append("|")
            syls = syllabify(word)
            if not syls:
                phones.extend(word)         # no nucleus: character tokens
            else:
                for syl in syls:
                    phones.extend(syl)
        return _clean_separators(phones), text


@register_processor("grapheme")
class GraphemeProcessor(BaseTxtProcessor):
    """Letter-level tokens — a dependency-free processor usable anywhere."""

    @staticmethod
    def text_to_graphemes(text: str) -> List[str]:
        tokens: List[str] = []
        for word in re.split(r"\s+", text.strip()):
            if not word:
                continue
            if tokens:
                tokens.append("|")
            for ch in word:
                tokens.append(ch)
        return tokens

    @classmethod
    def process(cls, text, pre_align_args=None):
        text = normalize_text(text)
        return _clean_separators(cls.text_to_graphemes(text)), text


PUNCS = "!,.?;:"                 # reference: data_gen_utils.py:22
_ZH_PUNC_MAP = {"。": ".", "，": ",", "！": "!", "？": "?", "；": ";",
                "：": ":", "、": ","}


@register_processor("zh")
@register_processor("zh_g2pM")
class ZhProcessor(BaseTxtProcessor):
    """Chinese: deep NSW normalization (text/zh_norm.py) + pinyin G2P with
    polyphone word contexts and tone sandhi (text/zh_g2p.py) — the role of
    the reference's zh/zh_g2pM processors (data_gen/tts/txt_processors/
    {zh,zh_g2pM}.py) without their external model dependencies. g2pM or
    pypinyin are still preferred automatically when importable.

    Output follows the reference's boundary contract (zh.py:61-90): ``#``
    marks segmentation-word boundaries, ``|`` separates syllables within a
    word, punctuation survives as its own tokens, and boundary markers
    adjacent to silence tokens are dropped."""

    # extra word-boundary phones beyond the shared '|' (zh.py sp_phonemes)
    @staticmethod
    def sp_phonemes():
        return ["|", "#"]

    @classmethod
    def process(cls, text, pre_align_args=None):
        from fastdiff_tpu_torch.text.zh_g2p import (apply_sandhi, is_hanzi,
                                                    zh_g2p, zh_segment)
        from fastdiff_tpu_torch.text.zh_norm import normalize_zh
        text = normalize_zh(text)
        phones: List[str] = []
        chars: List[str] = []     # hanzi per syllable phone, for sandhi
        for seg in zh_segment(text):
            if is_hanzi(seg[0]):
                if phones:
                    phones.append("#")          # jieba/lexicon word boundary
                for j, syl in enumerate(zh_g2p(seg)):
                    if j:
                        phones.append("|")      # char boundary within word
                    phones.append(syl)
                chars.extend(ch for ch in seg if is_hanzi(ch))
            else:
                p = _ZH_PUNC_MAP.get(seg, seg)
                if p in PUNCS:
                    phones.append(p)
        # drop boundary markers adjacent to silence tokens (zh.py:84-89)
        sil = set(PUNCS) | {"|", "#"}
        cleaned: List[str] = []
        for i, p in enumerate(phones):
            if p in ("#", "|"):
                prev_sil = i > 0 and phones[i - 1] in sil
                next_sil = i + 1 < len(phones) and phones[i + 1] in sil
                if prev_sil or next_sil:
                    continue
            cleaned.append(p)
        phones = cleaned
        # tone sandhi across word boundaries (一/不 context is the next
        # syllable regardless of segmentation)
        idx = [i for i, p in enumerate(phones)
               if p not in ("|", "#") and p not in PUNCS]
        fixed = apply_sandhi([phones[i] for i in idx], chars)
        for i, s in zip(idx, fixed):
            phones[i] = s
        return _clean_separators(phones), text


@register_processor("zh_song_seg")
@register_processor("zh_g2pM_song_seg")
class ZhSongSegProcessor(ZhProcessor):
    """Song-segment variant: ``SEP`` markers in the lyrics text survive as
    explicit ``SEP`` phones and all word-boundary markers are stripped
    (reference: data_gen/tts/txt_processors/zh_song_seg.py,
    zh_g2pM_song_seg.py — identical post-processing over the two G2P
    backends, which this repo serves with one processor)."""

    @staticmethod
    def sp_phonemes():
        return ["|", "#", "&"]

    @classmethod
    def process(cls, text, pre_align_args=None):
        text = text.replace("SEP", "&")
        ph_list, txt = super().process(text.replace("&", ""),
                                       pre_align_args)
        # the sentinel survives normalization as an unknown char -> rebuild:
        # process each SEP-delimited chunk independently, join with 'SEP'
        chunks = text.split("&")
        phones: List[str] = []
        norm_parts: List[str] = []
        for ci, chunk in enumerate(chunks):
            if ci:
                phones.append("SEP")
            ph, norm = ZhProcessor.process(chunk, pre_align_args)
            phones.extend(p for p in ph
                          if p not in ("|", "#", "<BOS>", "<EOS>"))
            norm_parts.append(norm)
        return phones, " SEP ".join(norm_parts)


def _clean_separators(phones: List[str]) -> List[str]:
    out: List[str] = []
    for p in phones:
        if p == "|" and (not out or out[-1] == "|"):
            continue
        out.append(p)
    while out and out[-1] == "|":
        out.pop()
    return out
