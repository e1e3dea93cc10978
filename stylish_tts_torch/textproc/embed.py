"""Sentence embeddings for dynamic voicepacks (the port's copy of
``stylish_tts_tpu/textproc/embed.py``, hashed fallback only).

The reference embeds segment texts with SBERT (stsb-mpnet-base-v2,
voicepack.py:38) and kNN-blends styles at synthesis time
(tts/cli.py:67-76).  sentence-transformers needs a model download, so
the port has only the self-contained hashed character-n-gram embedding —
no external deps, stable across runs, good enough to cluster
stylistically similar sentences by surface form.
"""

from __future__ import annotations

import hashlib
import re
from typing import Callable, List

import numpy as np

DIM = 256

# closed-class words carry register, not topic; downweight them so the
# hashed embedding clusters by content (neighbor purity measured in
# tests/test_textfront_quality.py)
_STOPWORDS = frozenset(
    "the a an and of to in is it you that he was for on are as with his"
    " they i at be this have from or one had by but not what all were we"
    " when your can said there each which she do how their if will up out"
    " then them these so some her would like him into has two more no way"
    " could my than been who its now did may over new only me back most"
    " very after our just where much too any same also does such because"
    " here went us again off should own never few while might got until"
    " once without let being".split()
)
_WORD_RE = re.compile(r"[a-z']+")


def _hash_bucket(key: str, dim: int) -> int:
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "little"
    ) % dim


def _hashed_ngram_embed(text: str, dim: int = DIM) -> np.ndarray:
    """Hashed char-n-gram + content-word features, deterministic and
    corpus-free (pack embeddings and synthesis-time queries must agree
    without shared state)."""
    vec = np.zeros(dim, np.float32)
    t = " " + text.lower() + " "
    for n in (2, 3, 4):
        for i in range(len(t) - n + 1):
            vec[_hash_bucket(t[i : i + n], dim)] += 1.0 / n
    for word in _WORD_RE.findall(t):
        weight = 0.3 if word in _STOPWORDS else 2.0
        vec[_hash_bucket("w:" + word, dim)] += weight
    norm = np.linalg.norm(vec)
    return vec / norm if norm > 0 else vec


def get_embedder() -> Callable[[List[str]], np.ndarray]:
    """Returns texts -> (N, D) embedding matrix: the hashed embedding. The
    JAX package prefers sentence-transformers when its model is cached;
    that branch needs a model download and is not ported."""

    def hashed(texts: List[str]) -> np.ndarray:
        return np.stack([_hashed_ngram_embed(t) for t in texts])

    return hashed
