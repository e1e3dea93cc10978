"""Long-form text preparation (the prepare_book equivalent).

The port's copy of ``stylish_tts_tpu/textproc/book.py`` (the port imports
nothing of the JAX package).

Splits a document into chapters and synthesis-sized utterances
(reference: tts/ttab/prepare_book.py + make-sentences): chapter
detection on heading-like lines, sentence segmentation, and greedy
packing of sentences into chunks below a phoneme budget (the trainer's
510-phoneme ceiling, dataloader.py:108-111).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List

MAX_PHONEMES = 480  # stay under the 510 hard ceiling after tokenizer pads

_CHAPTER_RE = re.compile(
    r"^\s*(chapter|part|book|prologue|epilogue)\b.{0,40}$", re.IGNORECASE
)
_SENTENCE_RE = re.compile(r"(?<=[.!?…])\s+(?=[\"“”'A-Z])")


@dataclass
class Chapter:
    title: str
    sentences: List[str] = field(default_factory=list)


def split_chapters(text: str) -> List[Chapter]:
    chapters: List[Chapter] = []
    current = Chapter(title="")
    for raw_line in text.splitlines():
        line = raw_line.strip()
        if not line:
            continue
        if _CHAPTER_RE.match(line) and len(line) < 60:
            if current.sentences or current.title:
                chapters.append(current)
            current = Chapter(title=line)
        else:
            current.sentences.extend(split_sentences(line))
    if current.sentences or current.title:
        chapters.append(current)
    return chapters


def split_sentences(paragraph: str) -> List[str]:
    parts = _SENTENCE_RE.split(paragraph.strip())
    return [p.strip() for p in parts if p.strip()]


def pack_utterances(
    sentences: List[str], phoneme_len=len, budget: int = MAX_PHONEMES
) -> List[str]:
    """Greedy-pack sentences into budget-bounded utterances."""
    out: List[str] = []
    current = ""
    for sentence in sentences:
        candidate = (current + " " + sentence).strip()
        if current and phoneme_len(candidate) > budget:
            out.append(current)
            current = sentence
        else:
            current = candidate
        # a single overlong sentence is split on commas/clauses
        while phoneme_len(current) > budget:
            cut = _best_cut(current, phoneme_len, budget)
            out.append(current[:cut].strip())
            current = current[cut:].strip()
    if current:
        out.append(current)
    return out


def _best_cut(text: str, phoneme_len, budget: int) -> int:
    best = 0
    for m in re.finditer(r"[,;:—]\s", text):
        if phoneme_len(text[: m.end()]) <= budget:
            best = m.end()
        else:
            break
    if best == 0:
        # no clause boundary fits; cut at the last space under budget
        for m in re.finditer(r"\s", text):
            if phoneme_len(text[: m.end()]) <= budget:
                best = m.end()
            else:
                break
    return best or budget
