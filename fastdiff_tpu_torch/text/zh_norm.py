"""Deep Chinese text normalization: NSW (non-standard word) -> hanzi.

The port's copy of ``fastdiff_tpu/text/zh_norm.py`` (the port imports
nothing of the JAX package).

Fresh implementation of the behaviors of the reference's 797-line
``utils/text_norm.py`` (itself a fork of a public NSW normalizer): turn
numbers, dates, times, percentages, fractions, money, phone numbers and
full-width ASCII into speakable hanzi so the G2P only ever sees real
characters. Implemented from the normalization rules, property-tested in
tests/test_zh_text.py; no code shared with the reference.

Coverage:
- cardinal numbers with 万/亿 grouping and correct 零 insertion
  (103 -> 一百零三, 1030 -> 一千零三十, 15 -> 十五 not 一十五),
- decimals (0.5 -> 零点五), negatives (负), percents (10.5% -> 百分之十点五),
  per-mille, fractions (1/3 -> 三分之一), ranges (3~5 -> 三到五),
- dates (2021年3月15日, 2021-03-15, 2021/3/15 -> 二〇二一年三月十五日:
  years read digit-wise), times (8:30 -> 八点三十分, 8:05 -> 八点零五分),
- money (¥12.50 -> 十二点五元),
- phone/ID numbers (11-digit mobiles etc. read digit-wise, 1 -> 幺),
- full-width alphanumerics -> half-width, whitespace squeeze.
"""

from __future__ import annotations

import re

_DIGITS = "零一二三四五六七八九"
_TEL_DIGITS = "零幺二三四五六七八九"   # phone reading: 1 -> 幺
_UNITS_SMALL = ["", "十", "百", "千"]
_UNITS_BIG = ["", "万", "亿", "万亿"]


def num_to_hanzi(num: int) -> str:
    """Non-negative integer -> hanzi reading with 万/亿 grouping."""
    if num == 0:
        return _DIGITS[0]
    parts = []                      # 4-digit groups, least significant first
    while num > 0:
        parts.append(num % 10000)
        num //= 10000
    out = ""
    for gi in range(len(parts) - 1, -1, -1):
        g = parts[gi]
        if g == 0:
            # a whole zero group forces a 零 if something follows
            if out and not out.endswith(_DIGITS[0]) and any(parts[:gi]):
                out += _DIGITS[0]
            continue
        group = _group_to_hanzi(g)
        # groups after the first need 零 when the group has no thousands digit
        if out and g < 1000 and not out.endswith(_DIGITS[0]):
            out += _DIGITS[0]
        out += group + _UNITS_BIG[gi]
    # 一十X -> 十X only at the very front (15 -> 十五, but 115 -> 一百一十五)
    if out.startswith("一十"):
        out = out[1:]
    return out


def _group_to_hanzi(g: int) -> str:
    """0 < g < 10000 -> hanzi with internal 零 handling."""
    digits = [int(d) for d in str(g)]
    n = len(digits)
    out, zero_pending = "", False
    for i, d in enumerate(digits):
        unit = _UNITS_SMALL[n - 1 - i]
        if d == 0:
            if out:
                zero_pending = True
            continue
        if zero_pending:
            out += _DIGITS[0]
            zero_pending = False
        out += _DIGITS[d] + unit
    return out


def digits_to_hanzi(s: str, telephone: bool = False) -> str:
    table = _TEL_DIGITS if telephone else _DIGITS
    return "".join(table[int(c)] if c.isdigit() else c for c in s)


def number_to_hanzi(s: str) -> str:
    """Decimal-string ('-12.5') -> hanzi reading."""
    s = s.strip()
    neg = s.startswith("-") or s.startswith("负")
    s = s.lstrip("-负+")
    if "." in s:
        int_part, frac = s.split(".", 1)
        int_part = int_part or "0"
        out = num_to_hanzi(int(int_part)) + "点" + digits_to_hanzi(frac)
    else:
        out = num_to_hanzi(int(s or "0"))
    return ("负" if neg else "") + out


def _full_to_half(text: str) -> str:
    out = []
    for ch in text:
        code = ord(ch)
        if code == 0x3000:
            out.append(" ")
        elif 0xFF01 <= code <= 0xFF5E:
            out.append(chr(code - 0xFEE0))
        else:
            out.append(ch)
    return "".join(out)


_RE_DATE_CN = re.compile(r"(\d{2,4})年(?:(\d{1,2})月)?(?:(\d{1,2})[日号])?")
    # \b fails between hanzi and digits (both are \w): use digit lookarounds
_RE_DATE_SEP = re.compile(r"(?<!\d)(\d{4})[-/](\d{1,2})[-/](\d{1,2})(?!\d)")
_RE_TIME = re.compile(r"(?<![\d:])(\d{1,2}):(\d{2})(?::(\d{2}))?(?![\d:])")
_RE_PHONE = re.compile(r"(?<!\d)(1\d{10}|\d{3,4}-\d{7,8}|\d{7,8})(?!\d)")
_RE_LONG_DIGITS = re.compile(r"(?<!\d)\d{12,}(?!\d)")
_RE_PERCENT = re.compile(r"(-?\d+(?:\.\d+)?)\s*(%|％|‰)")
_RE_FRACTION = re.compile(r"(?<![\d.])(\d+)/(\d+)(?![\d.])")
_RE_RANGE = re.compile(r"(\d+(?:\.\d+)?)\s*[~～]\s*(\d+(?:\.\d+)?)")
_RE_MONEY = re.compile(r"[¥￥]\s*(\d+(?:\.\d+)?)")
_RE_CELSIUS = re.compile(r"(-?\d+(?:\.\d+)?)\s*(?:℃|°C)")
_RE_NUMBER = re.compile(r"-?\d+(?:\.\d+)?")


def _read_year(y: str) -> str:
    table = {"0": "〇"}
    return "".join(table.get(c, _DIGITS[int(c)]) for c in y)


def _strip_trailing_zero_frac(frac: str) -> str:
    return frac.rstrip("0")


def normalize_zh(text: str) -> str:
    """Full Chinese NSW normalization pipeline (see module docstring)."""
    text = _full_to_half(text)

    def date_cn(m):
        out = _read_year(m.group(1)) + "年"
        if m.group(2):
            out += num_to_hanzi(int(m.group(2))) + "月"
        if m.group(3):
            out += num_to_hanzi(int(m.group(3))) + "日"
        return out

    def date_sep(m):
        return (_read_year(m.group(1)) + "年" + num_to_hanzi(int(m.group(2)))
                + "月" + num_to_hanzi(int(m.group(3))) + "日")

    def time_(m):
        h, mi, sec = m.group(1), m.group(2), m.group(3)
        out = num_to_hanzi(int(h)) + "点"
        if mi == "00" and not sec:
            out += "整"
        else:
            if mi.startswith("0") and mi != "00":
                out += _DIGITS[0] + num_to_hanzi(int(mi)) + "分"
            elif int(mi):
                out += num_to_hanzi(int(mi)) + "分"
        if sec:
            out += num_to_hanzi(int(sec)) + "秒"
        return out

    def percent(m):
        prefix = {"%": "百分之", "％": "百分之", "‰": "千分之"}[m.group(2)]
        return prefix + number_to_hanzi(m.group(1))

    def fraction(m):
        return (num_to_hanzi(int(m.group(2))) + "分之"
                + num_to_hanzi(int(m.group(1))))

    def range_(m):
        return number_to_hanzi(m.group(1)) + "到" + number_to_hanzi(m.group(2))

    def money(m):
        amount = m.group(1)
        if "." in amount:
            amount = amount.rstrip("0").rstrip(".")
        return number_to_hanzi(amount) + "元"

    def celsius(m):
        return number_to_hanzi(m.group(1)) + "摄氏度"

    def phone(m):
        return digits_to_hanzi(m.group(0).replace("-", ""), telephone=True)

    text = _RE_DATE_SEP.sub(date_sep, text)
    text = _RE_DATE_CN.sub(date_cn, text)
    text = _RE_TIME.sub(time_, text)
    text = _RE_MONEY.sub(money, text)
    text = _RE_CELSIUS.sub(celsius, text)
    text = _RE_PERCENT.sub(percent, text)
    text = _RE_RANGE.sub(range_, text)
    text = _RE_FRACTION.sub(fraction, text)
    text = _RE_PHONE.sub(phone, text)
    text = _RE_LONG_DIGITS.sub(lambda m: digits_to_hanzi(m.group(0)), text)
    text = _RE_NUMBER.sub(lambda m: number_to_hanzi(m.group(0)), text)
    text = re.sub(r"\s+", " ", text).strip()
    return text
