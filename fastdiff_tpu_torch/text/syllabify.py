"""Sonority-sequencing syllabifier for English orthography.

The port's copy of ``fastdiff_tpu/text/syllabify.py`` (the port imports
nothing of the JAX package).

Fills the role of the reference's ``syllabipy.sonoripy.SonoriPy`` used by the
``en_syl`` text processor (reference: data_gen/tts/txt_processors/en_syl.py),
implemented freshly from the Sonority Sequencing Principle so the pipeline
has no external syllabification dependency:

1. Rank every letter on a sonority scale (vowels > glides > liquids >
   nasals > fricatives > stops).
2. Nuclei are maximal vowel runs; each nucleus anchors one syllable.
3. Each inter-nucleus consonant cluster is split at its sonority minimum,
   with the minimum-sonority consonant starting the following onset
   (onset maximization at the tie).

Orthographic, not phonemic — same contract as SonoriPy: syllable strings
concatenate back to the input word.
"""

from __future__ import annotations

from typing import List

_SONORITY = {}
for _chars, _level in (
    ("aeiou", 7),     # vowels
    ("y", 6),         # glide (vocalic y handled via nucleus detection)
    ("wh", 5),        # glides
    ("lr", 4),        # liquids
    ("mn", 3),        # nasals
    ("fvszx", 2),     # fricatives
    ("bcdgjkpqt", 1),  # stops / affricates
):
    for _c in _chars:
        _SONORITY[_c] = _level

_VOWELS = set("aeiou")


def _is_nucleus(word: str, i: int) -> bool:
    """Vowel letters always; 'y' only when not adjacent to a vowel letter
    (so 'yes' has one nucleus 'e', 'rhythm' has nucleus 'y')."""
    ch = word[i]
    if ch in _VOWELS:
        return True
    if ch != "y":
        return False
    prev_v = i > 0 and word[i - 1] in _VOWELS
    next_v = i + 1 < len(word) and word[i + 1] in _VOWELS
    return not (prev_v or next_v)


def syllabify(word: str) -> List[str]:
    """Split a single word into syllable substrings.

    Returns [] for inputs with no alphabetic nucleus (numbers, punctuation)
    — the caller falls back to character tokens, matching the reference's
    ``len(syl) == 0`` branch (en_syl.py:12-14).
    """
    lower = word.lower()
    if not lower or not any(c.isalpha() for c in lower):
        return []

    # nucleus groups: runs of nucleus positions
    nuclei: List[tuple] = []      # (start, end) exclusive
    i = 0
    while i < len(lower):
        if lower[i].isalpha() and _is_nucleus(lower, i):
            j = i
            while j < len(lower) and lower[j].isalpha() and _is_nucleus(lower, j):
                j += 1
            nuclei.append((i, j))
            i = j
        else:
            i += 1
    if not nuclei:
        return [word]
    # final silent 'e': "make", "stone" — drop the last nucleus when it is a
    # lone 'e' at word end preceded by a consonant, unless it is the only one
    if len(nuclei) > 1:
        s, e = nuclei[-1]
        if (lower[s:e] == "e" and e == len(lower)
                and not _is_nucleus(lower, s - 1)):
            nuclei.pop()
    if len(nuclei) == 1:
        return [word]

    # split each inter-nucleus cluster at its sonority minimum; the minimum
    # consonant opens the next syllable's onset
    cuts: List[int] = []
    for (_, prev_end), (next_start, _) in zip(nuclei, nuclei[1:]):
        cluster = range(prev_end, next_start)
        if not len(cluster):
            cuts.append(prev_end)   # vowel hiatus: split between nuclei
            continue
        son = [_SONORITY.get(lower[k], 0) for k in cluster]
        # last index of the minimum -> onset-maximizing cut before it
        m = len(son) - 1 - son[::-1].index(min(son))
        cuts.append(prev_end + m)
    pieces = []
    starts = [0] + cuts
    ends = cuts + [len(word)]
    for s, e in zip(starts, ends):
        if e > s:
            pieces.append(word[s:e])
    return pieces
