"""Voicepack: precomputed style vectors for inference.

The port's copy of ``stylish_tts_tpu/tts/voicepack.py`` (numpy only):
  * static pack: 512 rows indexed by token count, each the average of
    the >=100 nearest-by-text-length segment styles;
  * dynamic pack: per-segment styles + sentence embeddings for kNN
    blending.
``encode_all_styles`` runs the style encoders over a dataset; the style
encoders are not ported yet, so neither is it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..data.caches import load_cache, save_cache

STATIC_ROWS = 512
MIN_NEIGHBORHOOD = 100


def build_static_pack(styles: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """512 rows indexed by token count; row L averages the styles of the
    segments closest in text length (window grown until >=100 samples)."""
    lengths = styles["lengths"]
    n = lengths.shape[0]
    need = min(MIN_NEIGHBORHOOD, n)
    pack = {}
    for key in ("speech", "pe", "duration"):
        vecs = styles[key]
        rows = np.zeros((STATIC_ROWS, vecs.shape[1]), np.float32)
        for row in range(STATIC_ROWS):
            radius = 0
            while np.sum(np.abs(lengths - row) <= radius) < need:
                radius += 1
                if radius > STATIC_ROWS:
                    break
            sel = np.abs(lengths - row) <= radius
            rows[row] = vecs[sel].mean(axis=0)
        pack[key] = rows
    return pack


def save_static_voicepack(path: str, pack: Dict[str, np.ndarray]) -> None:
    save_cache(path, {f"static/{k}": v for k, v in pack.items()})


def build_dynamic_pack(
    styles: Dict[str, np.ndarray], texts, embed_fn
) -> Dict[str, np.ndarray]:
    """Per-segment styles + sentence embeddings."""
    emb = embed_fn(list(texts)).astype(np.float32)
    return {
        "speech": styles["speech"],
        "pe": styles["pe"],
        "duration": styles["duration"],
        "embedding": emb,
    }


def save_dynamic_voicepack(path: str, pack: Dict[str, np.ndarray]) -> None:
    save_cache(path, {f"dynamic/{k}": v for k, v in pack.items()})


def load_voicepack(path: str) -> Dict[str, np.ndarray]:
    """Returns {"kind": "static"|"dynamic", ...arrays}."""
    raw = load_cache(path)
    kind = "dynamic" if any(k.startswith("dynamic/") for k in raw) else "static"
    out = {k.split("/", 1)[1]: v for k, v in raw.items() if k.startswith(kind + "/")}
    out["kind"] = kind
    return out


def lookup_static_style(pack: Dict[str, np.ndarray], token_count: int):
    row = min(token_count, STATIC_ROWS - 1)
    return pack["speech"][row], pack["pe"][row], pack["duration"][row]


def lookup_dynamic_style(
    pack: Dict[str, np.ndarray], query_embedding: np.ndarray, k: int = 8
):
    """Blend the k nearest segments' styles by cosine similarity."""
    emb = pack["embedding"]
    q = query_embedding / (np.linalg.norm(query_embedding) + 1e-9)
    e = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    sims = e @ q
    k = min(k, sims.shape[0])
    idx = np.argpartition(-sims, k - 1)[:k]
    w = np.maximum(sims[idx], 0.0) + 1e-6
    w = w / w.sum()

    def blend(arr):
        return (arr[idx] * w[:, None]).sum(axis=0)

    return blend(pack["speech"]), blend(pack["pe"]), blend(pack["duration"])
