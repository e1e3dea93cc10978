"""Grapheme-to-phoneme conversion.

The port's copy of ``stylish_tts_tpu/textproc/g2p.py`` (the port imports
nothing of the JAX package).

Equivalent of the reference's espeak-backed phonemization
(reference: lib/ttab/phonemes.py): uses the `espeak-ng`/`espeak`
binary when present (same backend the reference's fixups target);
otherwise falls back to a self-contained rule-based English
letter-to-IPA mapper so the pipeline stays runnable in hermetic
environments.  The fallback is intentionally simple — training-grade
phonemes should come from a real G2P; the fallback keeps tooling and
tests alive.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from typing import Optional

_ESPEAK: Optional[str] = shutil.which("espeak-ng") or shutil.which("espeak")

# Reference-style espeak output fixups (lib/ttab/phonemes.py applies
# similar replacements to map espeak output into the symbol table).
_ESPEAK_FIXUPS = [
    ("ɚ", "ɚ"),
    ("ɾ", "ɾ"),
    ("\n", " "),
]

# rule-based fallback: digraphs first, then single letters
_DIGRAPHS = [
    ("tch", "ʧ"), ("sch", "sk"), ("ch", "ʧ"), ("sh", "ʃ"), ("th", "θ"),
    ("ph", "f"), ("wh", "w"), ("ck", "k"), ("ng", "ŋ"), ("qu", "kw"),
    ("oo", "uː"), ("ee", "iː"), ("ea", "iː"), ("ou", "aʊ"), ("ow", "aʊ"),
    ("ai", "eɪ"), ("ay", "eɪ"), ("oi", "ɔɪ"), ("oy", "ɔɪ"), ("ar", "ɑːɹ"),
    ("er", "ɚ"), ("ir", "ɜː"), ("or", "ɔːɹ"), ("ur", "ɜː"),
]
_SINGLES = {
    "a": "æ", "b": "b", "c": "k", "d": "d", "e": "ɛ", "f": "f", "g": "ɡ",
    "h": "h", "i": "ɪ", "j": "ʤ", "k": "k", "l": "l", "m": "m", "n": "n",
    "o": "ɑː", "p": "p", "q": "k", "r": "ɹ", "s": "s", "t": "t", "u": "ʌ",
    "v": "v", "w": "w", "x": "ks", "y": "j", "z": "z",
}
_KEEP = set(';:,.!?¡¿—…"()“” ')

# Common-word exception lexicon for the rule fallback (GA, espeak-style
# IPA). Function words dominate running text and are exactly where
# letter-to-sound rules fail hardest ("the" -> θ, "she" -> ʃ); espeak
# (the reference backend, lib/ttab/phonemes.py) gets these from its own
# built-in lexicon. Heteronyms (homographs.HETERONYMS) are deliberately
# absent — they are resolved by POS context upstream in phonemize().
# Contractions are keyed apostrophe-stripped (matching the tokenizer).
_LEXICON = {
    "the": "ðə", "a": "ɐ", "an": "ɐn", "and": "ænd", "of": "ʌv",
    "to": "tuː", "in": "ɪn", "is": "ɪz", "it": "ɪt", "you": "juː",
    "that": "ðæt", "he": "hiː", "was": "wʌz", "for": "fɔːɹ",
    "on": "ɑːn", "are": "ɑːɹ", "as": "æz", "with": "wɪð", "his": "hɪz",
    "they": "ðeɪ", "i": "aɪ", "at": "æt", "be": "biː", "this": "ðɪs",
    "have": "hæv", "from": "fɹʌm", "or": "ɔːɹ", "one": "wʌn",
    "had": "hæd", "by": "baɪ", "but": "bʌt", "not": "nɑːt",
    "what": "wʌt", "all": "ɔːl", "were": "wɜː", "we": "wiː",
    "when": "wɛn", "your": "jʊɹ", "can": "kæn", "said": "sɛd",
    "there": "ðɛɹ", "each": "iːʧ", "which": "wɪʧ", "she": "ʃiː",
    "do": "duː", "how": "haʊ", "their": "ðɛɹ", "if": "ɪf",
    "will": "wɪl", "up": "ʌp", "other": "ˈʌðɚ", "about": "ɐbˈaʊt",
    "out": "aʊt", "many": "mˈɛni", "then": "ðɛn", "them": "ðɛm",
    "these": "ðiːz", "so": "soʊ", "some": "sʌm", "her": "hɜː",
    "would": "wʊd", "make": "meɪk", "like": "laɪk", "him": "hɪm",
    "into": "ˈɪntuː", "time": "taɪm", "has": "hæz", "look": "lʊk",
    "two": "tuː", "more": "mɔːɹ", "go": "ɡoʊ", "see": "siː",
    "no": "noʊ", "way": "weɪ", "could": "kʊd", "my": "maɪ",
    "than": "ðæn", "first": "fɜːst", "been": "bɪn", "who": "huː",
    "its": "ɪts", "now": "naʊ", "find": "faɪnd", "long": "lɔːŋ",
    "down": "daʊn", "day": "deɪ", "did": "dɪd", "get": "ɡɛt",
    "come": "kʌm", "made": "meɪd", "may": "meɪ", "part": "pɑːɹt",
    "over": "ˈoʊvɚ", "new": "nuː", "take": "teɪk", "only": "ˈoʊnli",
    "work": "wɜːk", "know": "noʊ", "place": "pleɪs", "year": "jɪɹ",
    "me": "miː", "back": "bæk", "give": "ɡɪv", "most": "moʊst",
    "very": "vˈɛɹi", "after": "ˈæftɚ", "thing": "θɪŋ", "our": "aʊɚ",
    "just": "ʤʌst", "name": "neɪm", "good": "ɡʊd", "man": "mæn",
    "think": "θɪŋk", "say": "seɪ", "great": "ɡɹeɪt", "where": "wɛɹ",
    "help": "hɛlp", "through": "θɹuː", "much": "mʌʧ",
    "before": "bɪfˈɔːɹ", "line": "laɪn", "right": "ɹaɪt", "too": "tuː",
    "mean": "miːn", "old": "oʊld", "any": "ˈɛni", "same": "seɪm",
    "tell": "tɛl", "boy": "bɔɪ", "came": "keɪm", "want": "wɑːnt",
    "show": "ʃoʊ", "also": "ˈɔːlsoʊ", "around": "ɚɹˈaʊnd",
    "three": "θɹiː", "small": "smɔːl", "set": "sɛt", "put": "pʊt",
    "end": "ɛnd", "does": "dʌz", "another": "ɐnˈʌðɚ", "well": "wɛl",
    "large": "lɑːɹʤ", "must": "mʌst", "big": "bɪɡ", "even": "ˈiːvən",
    "such": "sʌʧ", "because": "bɪkˈʌz", "turn": "tɜːn", "here": "hɪɹ",
    "why": "waɪ", "ask": "æsk", "went": "wɛnt", "men": "mɛn",
    "need": "niːd", "land": "lænd", "different": "dˈɪfɹənt",
    "home": "hoʊm", "us": "ʌs", "move": "muːv", "try": "tɹaɪ",
    "kind": "kaɪnd", "hand": "hænd", "again": "ɐɡˈɛn",
    "change": "ʧeɪnʤ", "off": "ɔːf", "play": "pleɪ", "air": "ɛɹ",
    "away": "ɐwˈeɪ", "point": "pɔɪnt", "page": "peɪʤ",
    "answer": "ˈænsɚ", "found": "faʊnd", "still": "stɪl",
    "learn": "lɜːn", "should": "ʃʊd", "high": "haɪ", "every": "ˈɛvɹi",
    "near": "nɪɹ", "add": "æd", "food": "fuːd", "between": "bɪtwˈiːn",
    "own": "oʊn", "below": "bɪlˈoʊ", "country": "kˈʌntɹi",
    "last": "læst", "keep": "kiːp", "tree": "tɹiː", "never": "nˈɛvɚ",
    "start": "stɑːɹt", "city": "sˈɪɾi", "earth": "ɜːθ", "eye": "aɪ",
    "light": "laɪt", "thought": "θɔːt", "head": "hɛd", "saw": "sɔː",
    "left": "lɛft", "dont": "doʊnt", "few": "fjuː", "while": "waɪl",
    "along": "ɐlˈɔːŋ", "might": "maɪt", "something": "sˈʌmθɪŋ",
    "seem": "siːm", "next": "nɛkst", "hard": "hɑːɹd", "open": "ˈoʊpən",
    "begin": "bɪɡˈɪn", "life": "laɪf", "always": "ˈɔːlweɪz",
    "those": "ðoʊz", "both": "boʊθ", "together": "təɡˈɛðɚ",
    "got": "ɡɑːt", "group": "ɡɹuːp", "often": "ˈɔːfən", "run": "ɹʌn",
    "until": "ʌntˈɪl", "children": "ʧˈɪldɹən", "side": "saɪd",
    "feet": "fiːt", "car": "kɑːɹ", "night": "naɪt", "walk": "wɔːk",
    "white": "waɪt", "sea": "siː", "began": "bɪɡˈæn", "grow": "ɡɹoʊ",
    "took": "tʊk", "four": "fɔːɹ", "once": "wʌns", "book": "bʊk",
    "hear": "hɪɹ", "stop": "stɑːp", "without": "wɪðˈaʊt",
    "second": "sˈɛkənd", "later": "lˈeɪɾɚ", "miss": "mɪs",
    "idea": "aɪdˈiːə", "enough": "ɪnˈʌf", "eat": "iːt", "face": "feɪs",
    "watch": "wɑːʧ", "far": "fɑːɹ", "really": "ɹˈɪli",
    "almost": "ˈɔːlmoʊst", "let": "lɛt", "above": "ɐbˈʌv",
    "girl": "ɡɜːl", "cut": "kʌt", "young": "jʌŋ", "talk": "tɔːk",
    "soon": "suːn", "list": "lɪst", "song": "sɔːŋ", "being": "bˈiːɪŋ",
    "leave": "liːv", "family": "fˈæmɪli", "cant": "kænt",
    "wont": "woʊnt", "im": "aɪm", "ive": "aɪv", "youre": "jʊɹ",
    "hes": "hiːz", "shes": "ʃiːz", "theyre": "ðɛɹ",
    "isnt": "ˈɪzənt", "wasnt": "wˈʌzənt", "didnt": "dˈɪdənt",
    "doesnt": "dˈʌzənt", "couldnt": "kˈʊdənt", "wouldnt": "wˈʊdənt",
    "shouldnt": "ʃˈʊdənt", "done": "dʌn", "gone": "ɡɔːn",
    "ones": "wʌnz", "today": "tədˈeɪ", "tomorrow": "təmˈɑːɹoʊ",
    "yesterday": "jˈɛstɚdeɪ", "please": "pliːz", "yes": "jɛs",
    "oh": "oʊ", "says": "sɛz", "eyes": "aɪz", "heart": "hɑːɹt",
    "sure": "ʃʊɹ", "door": "dɔːɹ", "floor": "flɔːɹ", "early": "ˈɜːli",
    "hour": "aʊɚ", "friend": "fɹɛnd", "love": "lʌv", "nothing": "nˈʌθɪŋ", "anything": "ˈɛniθɪŋ", "everything": "ˈɛvɹiθɪŋ",
    "someone": "sˈʌmwʌn", "everyone": "ˈɛvɹiwʌn", "woman": "wˈʊmən",
    "women": "wˈɪmɪn", "voice": "vɔɪs", "word": "wɜːd",
    "words": "wɜːdz", "whose": "huːz", "quite": "kwaɪt",
    "though": "ðoʊ", "although": "ɔːlðˈoʊ", "laugh": "læf",
    "laughed": "læft", "half": "hæf", "against": "ɐɡˈɛnst",
    "caught": "kɔːt", "brought": "bɹɔːt", "bought": "bɔːt",
    "daughter": "dˈɔːɾɚ", "beautiful": "bjˈuːɾɪfəl", "couldve": "kˈʊdəv",
    "heard": "hɜːd", "sword": "sɔːɹd", "island": "ˈaɪlənd",
    "listen": "lˈɪsən", "busy": "bˈɪzi", "business": "bˈɪznəs",
    "money": "mˈʌni", "honest": "ˈɑːnɪst", "honor": "ˈɑːnɚ",
    "iron": "ˈaɪɚn", "colonel": "kˈɜːnəl", "knew": "nuː",
    "knife": "naɪf", "knee": "niː", "knock": "nɑːk", "wrote": "ɹoʊt",
    "wrong": "ɹɔːŋ", "write": "ɹaɪt", "written": "ɹˈɪtən",
}


def espeak_available() -> bool:
    return _ESPEAK is not None


def _phonemize_espeak(text: str, voice: str = "en-us") -> str:
    out = subprocess.run(
        [_ESPEAK, "-q", "--ipa=3", "-v", voice, text],
        capture_output=True, text=True, check=True,
    ).stdout
    for a, b in _ESPEAK_FIXUPS:
        out = out.replace(a, b)
    out = out.replace("_", "")
    return re.sub(r"\s+", " ", out).strip()


def _phonemize_rules(text: str) -> str:
    words = []
    for token in re.findall(r"[a-zA-Z']+|[^a-zA-Z']", text.lower()):
        if not token.strip() or not token[0].isalpha():
            if token in _KEEP or token == " ":
                words.append(token)
            continue
        word = token.replace("'", "")
        if word in _LEXICON:
            words.append(_LEXICON[word])
            continue
        out = ""
        i = 0
        while i < len(word):
            for pattern, ipa in _DIGRAPHS:
                if word.startswith(pattern, i):
                    out += ipa
                    i += len(pattern)
                    break
            else:
                out += _SINGLES.get(word[i], "")
                i += 1
        # final silent e
        if word.endswith("e") and len(word) > 2 and out.endswith("ɛ"):
            out = out[:-1]
        words.append(out)
    return "".join(words)


def _phonemize_plain(text: str, voice: str = "en-us") -> str:
    if _ESPEAK is not None:
        try:
            return _phonemize_espeak(text, voice)
        except Exception:
            pass
    return _phonemize_rules(text)


def phonemize(text: str, voice: str = "en-us") -> str:
    """Plain text -> IPA phoneme string (symbol-table compatible).

    Heteronyms are resolved by POS context first (textproc/homographs.py,
    the hermetic counterpart of the reference's ModernBERT disambiguator,
    lib/ttab/homographs.py:17) and their IPA spliced around the backend
    G2P output."""
    from .homographs import pronunciation_overrides

    overrides = pronunciation_overrides(text)
    if not overrides:
        return _phonemize_plain(text, voice)
    parts = []
    pos = 0
    for start, end, ipa in overrides:
        chunk = text[pos:start]
        if chunk.strip():
            parts.append(_phonemize_plain(chunk, voice))
        elif chunk:
            parts.append(" " if " " in chunk else "")
        parts.append(ipa)
        pos = end
    tail = text[pos:]
    if tail.strip():
        parts.append(_phonemize_plain(tail, voice))
    out = ""
    for part in parts:
        if out and part and not out.endswith(" ") and not part.startswith(" "):
            out += " "
        out += part
    return re.sub(r"\s+", " ", out).strip()
