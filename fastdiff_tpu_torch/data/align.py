"""MFA TextGrid alignment -> frame-level phone maps (mel2ph) and durations,
a copy of ``fastdiff_tpu/data/align.py`` (numpy).

The reference's alignment stage (data_gen/tts/data_gen_utils.py:281-344
``get_mel2ph``): parse the phone tier of an MFA ``.TextGrid``, merge
adjacent silence intervals, match the intervals to the phone sequence
(silence phones may be missing from the TextGrid), turn the boundaries into
mel frames (round(sec * sr / hop)) and emit ``mel2ph`` (frame -> 1-based
phone index, 0 = padding) and per-phone durations. The parser reads the
standard Praat interval-tier format itself (no textgrid package).

Beyond JAX's module: ``format_textgrid`` writes that format, and
``mfa_textgrid`` an MFA-style TextGrid at drawn durations, for corpora
that have no aligner run (the synthetic data of ``chip_smoke.py`` and the
tests).
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np

SILENCE_MARKS = {"sil", "sp", "", "SIL", "PUNC", "<SIL>"}


def is_sil_phoneme(ph: str) -> bool:
    """Non-alphabetic-initial tokens are silence/punctuation phones
    (reference: data_gen/tts/data_gen_utils.py is_sil_phoneme)."""
    return ph == "" or not ph[0].isalpha()


def parse_textgrid(text: str) -> List[List[Tuple[float, float, str]]]:
    """Parse a Praat TextGrid into tiers of (xmin, xmax, text) intervals."""
    tiers = []
    current = None
    xmin = xmax = None
    for raw in text.splitlines():
        line = raw.strip()
        if re.match(r'item\s*\[\d+\]\s*:', line):
            current = []
            tiers.append(current)
            continue
        m = re.match(r'xmin\s*=\s*([\d.eE+-]+)', line)
        if m:
            xmin = float(m.group(1))
            continue
        m = re.match(r'xmax\s*=\s*([\d.eE+-]+)', line)
        if m:
            xmax = float(m.group(1))
            continue
        m = re.match(r'text\s*=\s*"(.*)"\s*$', line)
        if m is not None and current is not None:
            current.append((xmin, xmax, m.group(1)))
    return tiers


def _merged_phone_intervals(tiers) -> List[Tuple[float, float, str]]:
    """Take the last tier (MFA phones), blank out silence marks and merge
    adjacent blanks (reference: data_gen_utils.py:291-301)."""
    intervals = []
    for xmin, xmax, txt in tiers[-1]:
        if txt in SILENCE_MARKS:
            txt = ""
            if intervals and intervals[-1][2] == "":
                intervals[-1] = (intervals[-1][0], xmax, "")
                continue
        intervals.append((xmin, xmax, txt))
    return intervals


def align_textgrid(tg_text: str, phones: List[str], n_frames: int,
                   sample_rate: int, hop_size: int):
    """(mel2ph (n_frames,) int, durations (len(phones),) int).

    Phone-interval matching rules (data_gen_utils.py:306-331): silence
    phones in the phone list may map to blank intervals or be zero-length;
    non-silence phones must match intervals in order.
    """
    tiers = parse_textgrid(tg_text)
    intervals = _merged_phone_intervals(tiers)

    n_tg = sum(1 for _, _, t in intervals if t != "")
    n_ph = sum(1 for p in phones if not is_sil_phoneme(p))
    if n_tg != n_ph:
        raise ValueError(f"phone/interval count mismatch: {n_tg} vs {n_ph}")

    split = np.full(len(phones) + 1, -1.0)
    tg_idx, ph_idx = 0, 0
    while tg_idx < len(intervals) or ph_idx < len(phones):
        if tg_idx == len(intervals):
            if not is_sil_phoneme(phones[ph_idx]):
                raise ValueError("leftover non-silence phone after intervals")
            split[ph_idx] = np.inf
            ph_idx += 1
            continue
        xmin, xmax, txt = intervals[tg_idx]
        if txt == "" and ph_idx == len(phones):
            tg_idx += 1
            continue
        ph = phones[ph_idx]
        if txt != "" and is_sil_phoneme(ph):
            ph_idx += 1  # silence phone with no blank interval: zero length
            continue
        if txt == "" and not is_sil_phoneme(ph):
            raise ValueError(f"blank interval against phone '{ph}'")
        split[ph_idx] = xmin
        if ph_idx > 0 and split[ph_idx - 1] == -1 \
                and is_sil_phoneme(phones[ph_idx - 1]):
            split[ph_idx - 1] = split[ph_idx]
        ph_idx += 1
        tg_idx += 1

    split[0] = 0.0
    split[-1] = np.inf
    # forward-fill any remaining unset boundaries (zero-length phones)
    for i in range(1, len(split)):
        if split[i] == -1:
            split[i] = split[i - 1]
    frames = [int(min(s * sample_rate / hop_size + 0.5, n_frames))
              if np.isfinite(s) else n_frames for s in split]

    mel2ph = np.zeros(n_frames, dtype=np.int64)
    for ph_idx in range(len(phones)):
        mel2ph[frames[ph_idx]: frames[ph_idx + 1]] = ph_idx + 1
    durations = np.bincount(mel2ph, minlength=len(phones) + 1)[1:]
    return mel2ph, durations.astype(np.int64)


def format_textgrid(xmax: float, tiers) -> str:
    """Praat's long TextGrid format over [0, ``xmax``] of ``tiers``, a list
    of (name, [(xmin, xmax, text), ...]): what ``parse_textgrid`` reads."""
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "xmin = 0", f"xmax = {xmax!r}", "tiers? <exists>",
             f"size = {len(tiers)}", "item []:"]
    for t, (name, intervals) in enumerate(tiers, 1):
        lines += [f"    item [{t}]:", '        class = "IntervalTier"',
                  f'        name = "{name}"', "        xmin = 0",
                  f"        xmax = {xmax!r}",
                  f"        intervals: size = {len(intervals)}"]
        for i, (a, b, text) in enumerate(intervals, 1):
            lines += [f"        intervals [{i}]:", f"            xmin = {a!r}",
                      f"            xmax = {b!r}",
                      f'            text = "{text}"']
    return "\n".join(lines) + "\n"


def mfa_textgrid(phones, seconds: float, rng) -> str:
    """The TextGrid an MFA run would write for ``phones`` (a
    ``metadata_phone.csv`` ``ph``) over ``seconds`` of audio: ``|`` (a word
    boundary) gets no interval, ``<BOS>`` a leading ``sil``, ``<EOS>`` a
    trailing blank, other silence phones ``sp`` and every other phone its
    own interval, of durations drawn from ``rng`` (a numpy ``Generator``)
    and scaled to the audio; a one-interval words tier before it."""
    units = [p for p in phones if p != "|"]
    weights = rng.uniform(0.5, 1.5, len(units))
    ends = np.cumsum(weights) / weights.sum() * seconds
    ends[-1] = seconds
    starts = np.concatenate([[0.0], ends[:-1]])
    marks = {"<BOS>": "sil", "<EOS>": ""}
    return format_textgrid(float(seconds), [
        ("words", [(0.0, float(seconds), "")]),
        ("phones", [(float(a), float(b),
                     marks.get(p, "sp" if is_sil_phoneme(p) else p))
                    for a, b, p in zip(starts, ends, units)])])
