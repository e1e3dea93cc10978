"""Phoneme/character tokenizer (the port's copy of ``stylish_tts_tpu/text.py``).

Behavior parity with the reference TextCleaner
(reference: src/stylish_tts/lib/text_utils.py:8-43): symbol table is
pad + punctuation + letters + IPA letters in that order, text is
wrapped in a leading and trailing pad symbol, and unknown characters
are skipped with a logged error.
"""

from __future__ import annotations

import logging
from typing import List

from .config import SymbolConfig

logger = logging.getLogger(__name__)


class TextCleaner:
    def __init__(self, symbols: SymbolConfig):
        table = (
            [symbols.pad]
            + list(symbols.punctuation)
            + list(symbols.letters)
            + list(symbols.letters_ipa)
        )
        self.word_index_dictionary = {ch: i for i, ch in enumerate(table)}
        self.pad_id = 0
        # Count table slots, not unique keys: the reference table contains a
        # duplicate character ("'" appears twice in letters_ipa), so the
        # model's token count (178) exceeds the number of distinct symbols
        # (177).  Duplicate characters map to their later index, matching the
        # reference's dict-overwrite behavior.
        self.n_symbols = len(table)

    def __call__(self, text: str) -> List[int]:
        out = []
        for ch in self._pad_text(text):
            idx = self.word_index_dictionary.get(ch)
            if idx is None:
                logger.error("Unknown symbol %r in text: %s", ch, text)
            else:
                out.append(idx)
        return out

    def _pad_text(self, text: str) -> str:
        pad = self._pad_symbol()
        return pad + text + pad

    def _pad_symbol(self) -> str:
        for ch, idx in self.word_index_dictionary.items():
            if idx == 0:
                return ch
        return "$"
