"""The port's text front end against the JAX package's, exactly.

``stylish_tts_torch/textproc/{normalize,homographs,g2p,book}.py`` are the
port's own copies of the JAX modules; every function must give the same
strings and lists as the JAX one (tolerance: none, ``==``) on the inputs
of ``tests/test_textproc.py`` and ``tests/test_textfront_quality.py``, and
on random texts (hypothesis). The g2p backend is resolved from ``PATH`` at
import time, so both modules are pinned to one backend for every
comparison: the rule fallback (``_ESPEAK = None`` on both sides) or one
fake ``espeak-ng`` script written to ``tmp_path`` (both sides point at it),
which prints a fixed IPA string around the text with ``_``, a newline and
the fixup characters in it.
"""

import difflib

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from stylish_tts_tpu.textproc import book as jbook
from stylish_tts_tpu.textproc import g2p as jg2p
from stylish_tts_tpu.textproc import homographs as jhom
from stylish_tts_tpu.textproc import normalize as jnorm
from stylish_tts_torch.textproc import book as pbook
from stylish_tts_torch.textproc import g2p as pg2p
from stylish_tts_torch.textproc import homographs as phom
from stylish_tts_torch.textproc import normalize as pnorm
from test_textfront_quality import (
    G2P_GOLDEN, G2P_SENTENCE_GOLDEN, HETERONYM_FIXTURE, _strip,
)

# the inputs of tests/test_textproc.py
NUMBERS = [0, 7, 21, 105, 1234, -7, 19, 100, 1000, 1_000_000, 2_000_000_017, 999_999]
ORDINALS = [1, 2, 3, 5, 8, 9, 12, 22, 30, 101, 1000]
YEARS = [1984, 2005, 1805, 2024, 1900, 2000, 2010, 1066, 2099]
TEXTS = [
    "Dr. Smith paid $3.50 on the 2nd of May 1999.",
    "The quick brown fox jumps over the lazy dog.",
    "i will read the book",
    "she had read it",
    "hello world",
    "Mr. and Mrs. Jones live at No. 12, St. James St.; it cost $1,200.01 in 2024!",
    "He scored 3.14159 points on the 21st, 22nd and 103rd tries.",
    "“Quotes,” she said — and… then? ¡Sí! ¿Qué?",
    "The quick brown fox. It jumped over the dog. Then it read a book.",
]
BOOK = (
    "Chapter 1\n"
    "It was a dark night. The wind howled. "
    "Nobody was outside.\n\nChapter 2\nMorning came."
)
FAKE_ESPEAK = (
    "#!/bin/sh\n"
    "# the text is the last argument: -q --ipa=3 -v VOICE TEXT\n"
    "for last; do :; done\n"
    "printf 'h_əl_ˈoʊ %s\\nɾ_ɚ  ɚ_ɾ\\n' \"$last\"\n"
)


@pytest.fixture(params=["rules", "espeak"])
def backend(request, tmp_path_factory, monkeypatch):
    """Both g2p modules on the rule fallback or on one fake espeak-ng."""
    exe = None
    if request.param == "espeak":
        exe = tmp_path_factory.mktemp("espeak") / "espeak-ng"
        exe.write_text(FAKE_ESPEAK, encoding="utf-8")
        exe.chmod(0o755)
        exe = str(exe)
    monkeypatch.setattr(jg2p, "_ESPEAK", exe)
    monkeypatch.setattr(pg2p, "_ESPEAK", exe)
    return request.param


def test_tables_are_the_jax_ones():
    assert pnorm.ABBREVIATIONS == jnorm.ABBREVIATIONS
    assert phom.HETERONYMS == jhom.HETERONYMS
    assert phom._DEFAULT_SENSE == jhom._DEFAULT_SENSE
    assert pg2p._LEXICON == jg2p._LEXICON
    assert pg2p._DIGRAPHS == jg2p._DIGRAPHS and pg2p._SINGLES == jg2p._SINGLES
    assert pg2p._ESPEAK_FIXUPS == jg2p._ESPEAK_FIXUPS and pg2p._KEEP == jg2p._KEEP
    assert pbook.MAX_PHONEMES == jbook.MAX_PHONEMES


@pytest.mark.parametrize("name, values", [
    ("number_to_words", NUMBERS), ("ordinal_to_words", ORDINALS),
    ("year_to_words", YEARS)])
def test_number_words_match_jax(name, values):
    for n in values:
        assert getattr(pnorm, name)(n) == getattr(jnorm, name)(n), n


@pytest.mark.parametrize("text", TEXTS)
def test_normalize_text_matches_jax(text):
    assert pnorm.normalize_text(text) == jnorm.normalize_text(text)


@pytest.mark.parametrize("text", TEXTS + [s for _, s, _ in HETERONYM_FIXTURE[:40]])
def test_phonemize_matches_jax(text, backend):
    assert pg2p.espeak_available() == (backend == "espeak")
    for s in (text, pnorm.normalize_text(text)):
        assert pg2p.phonemize(s) == jg2p.phonemize(s)
    if backend == "espeak":
        out = pg2p.phonemize("hello world")
        assert "_" not in out and "\n" not in out and "həlˈoʊ" in out


def test_homographs_match_jax():
    """Every fixture sentence: the overrides, ``resolve`` in context and
    without; and the heteronym accuracy figure of
    ``tests/test_textfront_quality.py`` is the same on the port's copy."""
    scores = {}
    for mod in (phom, jhom):
        scores[mod] = [mod.resolve(w, s) == want for w, s, want in HETERONYM_FIXTURE]
    for word, sentence, _ in HETERONYM_FIXTURE:
        assert phom.pronunciation_overrides(sentence) == jhom.pronunciation_overrides(sentence)
        assert phom.resolve(word, sentence) == jhom.resolve(word, sentence)
        assert phom.resolve(word, "") == jhom.resolve(word, "")
    assert scores[phom] == scores[jhom]
    assert sum(scores[phom]) / len(HETERONYM_FIXTURE) >= 0.85


def test_g2p_rules_and_agreement_match_jax():
    """``_phonemize_rules`` on the golden words and sentences, and the g2p
    agreement figures of ``tests/test_textfront_quality.py``."""
    def sims(mod, pairs):
        return [difflib.SequenceMatcher(None, _strip(mod._phonemize_rules(w)),
                                        _strip(g)).ratio() for w, g in pairs]

    for word, _ in list(G2P_GOLDEN.items()) + G2P_SENTENCE_GOLDEN:
        assert pg2p._phonemize_rules(word) == jg2p._phonemize_rules(word)
    for pairs in (list(G2P_GOLDEN.items()), G2P_SENTENCE_GOLDEN):
        assert sims(pg2p, pairs) == sims(jg2p, pairs)
    assert float(np.mean(sims(pg2p, G2P_SENTENCE_GOLDEN))) >= 0.90


def test_book_matches_jax():
    for text in (BOOK, "\n".join(TEXTS), "Prologue\n" + " ".join(TEXTS * 4)):
        p, j = pbook.split_chapters(text), jbook.split_chapters(text)
        assert [(c.title, c.sentences) for c in p] == [(c.title, c.sentences) for c in j]
        sentences = [s for c in p for s in c.sentences]
        for budget in (30, 80, jbook.MAX_PHONEMES):
            assert (pbook.pack_utterances(sentences, budget=budget)
                    == jbook.pack_utterances(sentences, budget=budget))
        for s in TEXTS:
            assert pbook.split_sentences(s) == jbook.split_sentences(s)
            assert pbook._best_cut(s, len, 20) == jbook._best_cut(s, len, 20)


def test_book_packing_by_phonemes_matches_jax(backend):
    """The audiobook packer's rule: phoneme length under each side's own
    ``phonemize``."""
    sentences = [s for c in pbook.split_chapters("\n".join(TEXTS)) for s in c.sentences]
    p = pbook.pack_utterances(sentences, lambda s: len(pg2p.phonemize(pnorm.normalize_text(s))),
                              budget=60)
    j = jbook.pack_utterances(sentences, lambda s: len(jg2p.phonemize(jnorm.normalize_text(s))),
                              budget=60)
    assert p == j


WORDS = sorted(jhom.HETERONYMS) + ["the", "Dr.", "Mr.", "St.", "will", "had", "a", "of"]
TOKENS = st.one_of(
    st.sampled_from(WORDS),
    st.from_regex(r"\$[0-9]{1,7}(\.[0-9]{2})?", fullmatch=True),
    st.from_regex(r"[0-9]{1,4}(st|nd|rd|th)?", fullmatch=True),
    st.from_regex(r"[0-9]{1,3}\.[0-9]{1,3}", fullmatch=True),
    st.sampled_from([",", ".", "!", "?", ";", ":", "—", "…", "“", "”", "\"", "'", "(", ")",
                     "¡", "¿", "\n", "Chapter 3\n"]),
    st.text(alphabet="abcdefghijklmnopqrstuvwxyzABCDEZ'éü", min_size=1, max_size=9),
)
TEXT = st.lists(TOKENS, min_size=1, max_size=14).map(" ".join)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=TEXT)
def test_random_texts_match_jax(text, backend):
    """normalize, overrides, phonemize and the book split on random texts
    of digits, currency, abbreviations, heteronyms, punctuation and unicode
    quotes, on both backends."""
    assert pnorm.normalize_text(text) == jnorm.normalize_text(text)
    assert phom.pronunciation_overrides(text) == jhom.pronunciation_overrides(text)
    assert pg2p.phonemize(text) == jg2p.phonemize(text)
    p, j = pbook.split_chapters(text), jbook.split_chapters(text)
    assert [(c.title, c.sentences) for c in p] == [(c.title, c.sentences) for c in j]
    sentences = [s for c in p for s in c.sentences]
    assert pbook.pack_utterances(sentences, budget=25) == jbook.pack_utterances(
        sentences, budget=25)
