"""English text normalization for the TTS front-end.

The port's copy of ``fastdiff_tpu/text/normalize.py`` (the port imports
nothing of the JAX package).

Covers the behaviors the reference's English processor applies before G2P
(reference: data_gen/tts/txt_processors/en.py:46-62 and the number-expansion
in utils/text_norm.py): unicode/quote cleanup, abbreviation expansion,
number -> words, punctuation collapse to the ``!,.?;:`` set, lowercasing.
Fresh implementation (standard digit-expansion recurrences), no nltk/inflect
dependency.
"""

from __future__ import annotations

import re
import unicodedata

_ABBREVIATIONS = [(re.compile(rf"\b{abbr}\.", re.IGNORECASE), full) for abbr, full in [
    ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
    ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
    ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
    ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
    ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
]]

_UNITS = ["", "one", "two", "three", "four", "five", "six", "seven", "eight",
          "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
          "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand"),
           (100, "hundred")]


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _UNITS[n] if n else "zero"
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + (f" {_UNITS[rem]}" if rem else "")
    for value, name in _SCALES:
        if n >= value:
            major, rem = divmod(n, value)
            out = f"{number_to_words(major)} {name}"
            if rem:
                out += f" {number_to_words(rem)}"
            return out
    return str(n)


def _expand_decimal(match: re.Match) -> str:
    whole, frac = match.group(1), match.group(2)
    digits = " ".join(number_to_words(int(d)) if d.isdigit() else d
                      for d in frac)
    return f"{number_to_words(int(whole))} point {digits}"


def _expand_ordinal(match: re.Match) -> str:
    n = int(match.group(1))
    words = number_to_words(n)
    specials = {"one": "first", "two": "second", "three": "third",
                "five": "fifth", "eight": "eighth", "nine": "ninth",
                "twelve": "twelfth"}
    head, _, last = words.rpartition(" ")
    if last in specials:
        last = specials[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return (head + " " + last).strip()


def _expand_year_or_number(match: re.Match) -> str:
    n = int(match.group(0).replace(",", ""))
    if 1000 <= n < 3000 and n % 100:  # read years as pairs: 1984 -> nineteen eighty four
        hi, lo = divmod(n, 100)
        if lo < 10:
            return f"{number_to_words(hi)} oh {number_to_words(lo)}"
        return f"{number_to_words(hi)} {number_to_words(lo)}"
    return number_to_words(n)


def normalize_text(text: str) -> str:
    """Normalize raw text to a clean lowercase pronounceable form."""
    text = unicodedata.normalize("NFKC", text)
    text = text.replace("‘", "'").replace("’", "'")
    text = text.replace("“", '"').replace("”", '"')
    for pattern, replacement in _ABBREVIATIONS:
        text = pattern.sub(replacement, text)
    text = re.sub(r"\$(\d+)", lambda m: f"{m.group(1)} dollars", text)
    text = re.sub(r"(\d+)\.(\d+)", _expand_decimal, text)
    text = re.sub(r"(\d+)(st|nd|rd|th)\b", _expand_ordinal, text)
    text = re.sub(r"\d+(?:,\d{3})*", _expand_year_or_number, text)
    text = text.lower()
    # collapse punctuation to the reference's retained set (en.py:52-60)
    text = re.sub(r"[\-—_]", " ", text)
    text = re.sub(r"[\"'()\[\]{}]", "", text)
    text = re.sub(r"[^a-z!,.?;: ]", "", text)
    text = re.sub(r"([!,.?;:])+", r"\1", text)
    text = re.sub(r"\s+", " ", text).strip()
    return text
