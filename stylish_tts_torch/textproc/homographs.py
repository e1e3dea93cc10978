"""Homograph (heteronym) disambiguation for the text front end.

The port's copy of ``stylish_tts_tpu/textproc/homographs.py`` (the port imports
nothing of the JAX package).

The reference resolves homographs with ModernBERT embeddings + spaCy
POS + kNN over curated training vectors (reference
lib/ttab/homographs.py:17-200).  That stack needs downloaded models;
this is the hermetic equivalent: a curated heteronym lexicon keyed by
part-of-speech sense, with a lightweight contextual POS classifier
(determiner/modal/auxiliary cues + per-word priors).  With network
access a heavier disambiguator can be slotted in behind the same
``resolve``/``pronunciation_overrides`` API.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

# word -> {sense: IPA}. "noun" covers noun/adjective senses; "verb" the
# verbal sense; "past" a tense-distinguished sense (read/read).
HETERONYMS: Dict[str, Dict[str, str]] = {
    "read": {"verb": "ɹˈiːd", "past": "ɹˈɛd", "noun": "ɹˈiːd"},
    "lead": {"verb": "lˈiːd", "noun": "lˈɛd"},  # metal is the noun default
    "bass": {"noun": "bˈeɪs", "fish": "bˈæs"},
    "live": {"verb": "lˈɪv", "noun": "lˈaɪv"},  # adj sense sounds like noun
    "wind": {"noun": "wˈɪnd", "verb": "wˈaɪnd"},
    "tear": {"noun": "tˈɪɹ", "verb": "tˈɛɹ"},
    "bow": {"noun": "bˈoʊ", "verb": "bˈaʊ"},
    "close": {"verb": "klˈoʊz", "noun": "klˈoʊs"},
    "record": {"noun": "ɹˈɛkɚd", "verb": "ɹɪkˈɔːɹd"},
    "present": {"noun": "pɹˈɛzənt", "verb": "pɹɪzˈɛnt"},
    "object": {"noun": "ˈɑːbʤɛkt", "verb": "əbʤˈɛkt"},
    "produce": {"noun": "pɹˈoʊduːs", "verb": "pɹədˈuːs"},
    "conduct": {"noun": "kˈɑːndʌkt", "verb": "kəndˈʌkt"},
    "content": {"noun": "kˈɑːntɛnt", "verb": "kəntˈɛnt"},
    "desert": {"noun": "dˈɛzɚt", "verb": "dɪzˈɜːt"},
    "minute": {"noun": "mˈɪnɪt", "adj": "maɪnˈuːt"},
    "refuse": {"verb": "ɹɪfjˈuːz", "noun": "ɹˈɛfjuːs"},
    "wound": {"noun": "wˈuːnd", "past": "wˈaʊnd"},
    "use": {"verb": "jˈuːz", "noun": "jˈuːs"},
    "sow": {"verb": "sˈoʊ", "noun": "sˈaʊ"},
    "dove": {"noun": "dˈʌv", "past": "dˈoʊv"},
    "project": {"noun": "pɹˈɑːʤɛkt", "verb": "pɹəʤˈɛkt"},
    "contract": {"noun": "kˈɑːntɹækt", "verb": "kəntɹˈækt"},
    "permit": {"noun": "pˈɜːmɪt", "verb": "pɚmˈɪt"},
    "rebel": {"noun": "ɹˈɛbəl", "verb": "ɹɪbˈɛl"},
    "invalid": {"noun": "ˈɪnvəlɪd", "adj": "ɪnvˈælɪd"},
    # initial-stress noun vs final-stress verb (the regular English
    # stress-shift class; reference disambiguates these with the same
    # ModernBERT+kNN path as the irregular ones above)
    "subject": {"noun": "sˈʌbʤɪkt", "verb": "səbʤˈɛkt"},
    "suspect": {"noun": "sˈʌspɛkt", "verb": "səspˈɛkt"},
    "increase": {"noun": "ˈɪnkɹiːs", "verb": "ɪnkɹˈiːs"},
    "decrease": {"noun": "dˈiːkɹiːs", "verb": "dɪkɹˈiːs"},
    "insult": {"noun": "ˈɪnsʌlt", "verb": "ɪnsˈʌlt"},
    "conflict": {"noun": "kˈɑːnflɪkt", "verb": "kənflˈɪkt"},
    "contest": {"noun": "kˈɑːntɛst", "verb": "kəntˈɛst"},
    "contrast": {"noun": "kˈɑːntɹæst", "verb": "kəntɹˈæst"},
    "convert": {"noun": "kˈɑːnvɜːt", "verb": "kənvˈɜːt"},
    "convict": {"noun": "kˈɑːnvɪkt", "verb": "kənvˈɪkt"},
    "export": {"noun": "ˈɛkspɔːɹt", "verb": "ɛkspˈɔːɹt"},
    "import": {"noun": "ˈɪmpɔːɹt", "verb": "ɪmpˈɔːɹt"},
    "impact": {"noun": "ˈɪmpækt", "verb": "ɪmpˈækt"},
    "progress": {"noun": "pɹˈɑːɡɹɛs", "verb": "pɹəɡɹˈɛs"},
    "protest": {"noun": "pɹˈoʊtɛst", "verb": "pɹətˈɛst"},
    "recall": {"noun": "ɹˈiːkɔːl", "verb": "ɹɪkˈɔːl"},
    "refund": {"noun": "ɹˈiːfʌnd", "verb": "ɹɪfˈʌnd"},
    "transfer": {"noun": "tɹˈænsfɜː", "verb": "tɹænsfˈɜː"},
    "transport": {"noun": "tɹˈænspɔːɹt", "verb": "tɹænspˈɔːɹt"},
    "upset": {"noun": "ˈʌpsɛt", "verb": "ʌpsˈɛt"},
    "address": {"noun": "ˈædɹɛs", "verb": "ədɹˈɛs"},
    "compound": {"noun": "kˈɑːmpaʊnd", "verb": "kəmpˈaʊnd"},
    "console": {"noun": "kˈɑːnsoʊl", "verb": "kənsˈoʊl"},
    "extract": {"noun": "ˈɛkstɹækt", "verb": "ɛkstɹˈækt"},
    "escort": {"noun": "ˈɛskɔːɹt", "verb": "ɛskˈɔːɹt"},
    "entrance": {"noun": "ˈɛntɹəns", "verb": "ɪntɹˈæns"},
    "attribute": {"noun": "ˈætɹɪbjuːt", "verb": "ətɹˈɪbjuːt"},
    # voiced/voiceless final-fricative pairs (use/abuse/excuse class)
    "excuse": {"noun": "ɛkskjˈuːs", "verb": "ɛkskjˈuːz"},
    "abuse": {"noun": "əbjˈuːs", "verb": "əbjˈuːz"},
    "house": {"noun": "hˈaʊs", "verb": "hˈaʊz"},
    # -ate reduction: adjective/noun schwa vs verb full diphthong
    "separate": {"adj": "sˈɛpɹət", "verb": "sˈɛpɚɹˌeɪt"},
    "estimate": {"noun": "ˈɛstɪmət", "verb": "ˈɛstɪmˌeɪt"},
    "graduate": {"noun": "ɡɹˈæʤuət", "verb": "ɡɹˈæʤuˌeɪt"},
    "duplicate": {"noun": "dˈuːplɪkət", "verb": "dˈuːplɪkˌeɪt"},
    "alternate": {"adj": "ˈɔːltɚnət", "verb": "ˈɔːltɚnˌeɪt"},
    "deliberate": {"adj": "dɪlˈɪbɚɹət", "verb": "dɪlˈɪbɚɹˌeɪt"},
    "delegate": {"noun": "dˈɛlɪɡət", "verb": "dˈɛlɪɡˌeɪt"},
    "advocate": {"noun": "ˈædvəkət", "verb": "ˈædvəkˌeɪt"},
    "associate": {"noun": "əsˈoʊsiət", "verb": "əsˈoʊsiˌeɪt"},
    "moderate": {"adj": "mˈɑːdɚɹət", "verb": "mˈɑːdɚɹˌeɪt"},
    "appropriate": {"adj": "əpɹˈoʊpɹiət", "verb": "əpɹˈoʊpɹiˌeɪt"},
    # tense/derivation splits
    "learned": {"adj": "lˈɜːnɪd", "past": "lˈɜːnd"},
    "resume": {"noun": "ɹˈɛzʊmeɪ", "verb": "ɹɪzˈuːm"},
}

# default sense when context gives no signal
_DEFAULT_SENSE = {
    "read": "verb", "lead": "verb", "bass": "noun", "live": "verb",
    "wind": "noun", "tear": "noun", "bow": "noun", "close": "verb",
    "record": "noun", "present": "noun", "object": "noun",
    "produce": "verb", "conduct": "verb", "content": "noun",
    "desert": "noun", "minute": "noun", "refuse": "verb", "wound": "noun",
    "use": "verb", "sow": "verb", "dove": "noun", "project": "noun",
    "contract": "noun", "permit": "verb", "rebel": "noun", "invalid": "adj",
    "subject": "noun", "suspect": "noun", "increase": "noun",
    "decrease": "noun", "insult": "noun", "conflict": "noun",
    "contest": "noun", "contrast": "noun", "convert": "verb",
    "convict": "noun", "export": "noun", "import": "noun",
    "impact": "noun", "progress": "noun", "protest": "noun",
    "recall": "verb", "refund": "noun", "transfer": "verb",
    "transport": "verb", "upset": "verb", "address": "verb",
    "compound": "noun", "console": "noun", "extract": "verb",
    "escort": "noun", "entrance": "noun", "attribute": "noun",
    "excuse": "verb", "abuse": "noun", "house": "noun",
    "separate": "adj", "estimate": "noun", "graduate": "noun",
    "duplicate": "noun", "alternate": "adj", "deliberate": "adj",
    "delegate": "noun", "advocate": "noun", "associate": "noun",
    "moderate": "adj", "appropriate": "adj", "learned": "past",
    "resume": "verb",
}

_NOUN_CUES = {
    "the", "a", "an", "this", "that", "these", "those", "his", "her", "my",
    "its", "our", "your", "their", "some", "any", "no", "every", "each",
    "of", "heavy", "new", "old", "musical",
}
_VERB_CUES = {
    "to", "will", "would", "can", "could", "shall", "should", "may",
    "might", "must", "dont", "doesnt", "didnt", "cant", "wont", "not",
    "i", "we", "you", "they", "please", "lets",
}
_PAST_CUES = {"have", "has", "had", "was", "were", "been", "already",
              "yesterday", "just"}


def _classify(word: str, prev_words: List[str], next_word: Optional[str]) -> str:
    senses = HETERONYMS[word]
    prev1 = prev_words[-1] if prev_words else ""
    window = set(prev_words[-3:])
    if "past" in senses and (window & _PAST_CUES):
        return "past"
    if prev1 in _VERB_CUES and "verb" in senses:
        return "verb"
    if prev1 in _NOUN_CUES:
        for sense in ("noun", "adj", "fish"):
            if sense in senses:
                return sense
    # a following determiner/object pronoun suggests a verb reading
    if next_word in {"the", "a", "an", "it", "them", "him", "her", "me",
                     "us", "your", "my"} and "verb" in senses:
        return "verb"
    return _DEFAULT_SENSE.get(word, next(iter(senses)))


_WORD_RE = re.compile(r"[A-Za-z']+")


def pronunciation_overrides(text: str) -> List[Tuple[int, int, str]]:
    """Find heteronym occurrences: [(start, end, IPA), ...] in order."""
    tokens = [(m.group(0), m.start(), m.end()) for m in _WORD_RE.finditer(text)]
    out = []
    lowered = [t[0].lower().replace("'", "") for t in tokens]
    for i, (raw, start, end) in enumerate(tokens):
        w = lowered[i]
        if w not in HETERONYMS:
            continue
        sense = _classify(
            w, lowered[max(0, i - 3):i],
            lowered[i + 1] if i + 1 < len(tokens) else None,
        )
        out.append((start, end, HETERONYMS[w][sense]))
    return out


def resolve(word: str, context: str = "") -> str:
    """Pronounce one heteronym in a sentence context (test/debug API)."""
    text = context if word.lower() in context.lower() else f"{context} {word}"
    for start, end, ipa in pronunciation_overrides(text):
        if text[start:end].lower() == word.lower():
            return ipa
    return HETERONYMS[word.lower()][_DEFAULT_SENSE[word.lower()]]
