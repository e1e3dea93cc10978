"""English text normalization for TTS front-ends.

The port's copy of ``stylish_tts_tpu/textproc/normalize.py`` (the port imports
nothing of the JAX package).

Self-contained equivalent of the reference's ttab token normalization
(reference: lib/ttab/tokens.py — numbers, ordinals, years, currency,
abbreviations): expands everything a TTS front-end must not see as
digits or periods-with-capitals.
"""

from __future__ import annotations

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALE = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"),
          (100, "hundred")]

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}

ABBREVIATIONS = {
    "mr": "mister", "mrs": "missus", "ms": "miss", "dr": "doctor",
    "prof": "professor", "st": "saint", "jr": "junior", "sr": "senior",
    "vs": "versus", "etc": "et cetera", "no": "number", "dept": "department",
    "capt": "captain", "gen": "general", "lt": "lieutenant", "col": "colonel",
    "sgt": "sergeant", "rev": "reverend", "hon": "honorable",
}


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rest = divmod(n, 10)
        return _TENS[tens] + ("-" + _ONES[rest] if rest else "")
    for value, name in _SCALE:
        if n >= value:
            major, rest = divmod(n, value)
            out = number_to_words(major) + " " + name
            if rest:
                joiner = " and " if rest < 100 else " "
                out += joiner + number_to_words(rest)
            return out
    return _ONES[0]


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    parts = words.rsplit(" ", 1)
    last = parts[-1]
    if "-" in last:
        head, tail = last.rsplit("-", 1)
        tail = _ORDINAL_SPECIAL.get(tail) or _ordinal_suffix(tail)
        last = head + "-" + tail
    else:
        last = _ORDINAL_SPECIAL.get(last) or _ordinal_suffix(last)
    parts[-1] = last
    return " ".join(parts)


def _ordinal_suffix(word: str) -> str:
    if word.endswith("y"):
        return word[:-1] + "ieth"
    if word.endswith("t"):
        return word + "h"
    return word + "th"


def year_to_words(n: int) -> str:
    if 1000 <= n <= 1999 or (2010 <= n <= 2099 and n % 100 >= 10):
        hi, lo = divmod(n, 100)
        if lo == 0:
            return number_to_words(hi) + " hundred"
        if lo < 10:
            return number_to_words(hi) + " oh " + number_to_words(lo)
        return number_to_words(hi) + " " + number_to_words(lo)
    return number_to_words(n)


def _expand_currency(match: re.Match) -> str:
    amount = match.group(1).replace(",", "")
    if "." in amount:
        dollars, cents = amount.split(".")
        out = number_to_words(int(dollars)) + (
            " dollar" if dollars == "1" else " dollars"
        )
        if int(cents or 0):
            out += " and " + number_to_words(int(cents)) + (
                " cent" if cents == "01" else " cents"
            )
        return out
    n = int(amount)
    return number_to_words(n) + (" dollar" if n == 1 else " dollars")


def _expand_decimal(match: re.Match) -> str:
    whole, frac = match.group(1), match.group(2)
    out = number_to_words(int(whole)) + " point"
    for digit in frac:
        out += " " + _ONES[int(digit)]
    return out


def _expand_ordinal(match: re.Match) -> str:
    return ordinal_to_words(int(match.group(1)))


def _expand_year(match: re.Match) -> str:
    return year_to_words(int(match.group(0)))


def _expand_number(match: re.Match) -> str:
    return number_to_words(int(match.group(0).replace(",", "")))


def _expand_abbreviation(match: re.Match) -> str:
    word = match.group(1)
    expansion = ABBREVIATIONS[word.lower()]
    if word[0].isupper():
        expansion = expansion.capitalize()
    return expansion


_ABBR_RE = re.compile(
    r"\b(" + "|".join(sorted(ABBREVIATIONS, key=len, reverse=True)) + r")\.",
    re.IGNORECASE,
)


def normalize_text(text: str) -> str:
    """Expand currency, decimals, ordinals, years, integers, abbreviations."""
    text = _ABBR_RE.sub(_expand_abbreviation, text)
    text = re.sub(r"\$([0-9][0-9,]*(?:\.[0-9]{2})?)", _expand_currency, text)
    text = re.sub(r"\b([0-9]+)\.([0-9]+)\b", _expand_decimal, text)
    text = re.sub(r"\b([0-9]+)(?:st|nd|rd|th)\b", _expand_ordinal, text)
    text = re.sub(r"\b1[0-9]{3}\b|\b20[0-9]{2}\b", _expand_year, text)
    text = re.sub(r"\b[0-9][0-9,]*\b", _expand_number, text)
    text = re.sub(r"\s+", " ", text).strip()
    return text
