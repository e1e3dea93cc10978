"""Precomputed ground-truth WavLM embeddings for the slm loss.

The port's ``stylish_tts_tpu/dataprep/slm_cache.py``. The slm loss matches
the WavLM hidden states of the target audio against the prediction's; the
target side is a function of the dataset alone, so ``slm-cache`` runs the
frozen encoder over every segment once and stores its 13 stacked hidden
states, and the acoustic step then runs WavLM on the prediction only
(``wavlm_loss_cached``).

Cache format (the JAX package's): one safetensors file keyed by segment
wav path; each value float16 (13, T, 768), the input projection and the 12
transformer layers at 50 frames/s of the 16 kHz resample; under
``FINGERPRINT_KEY`` a 16-byte digest of the WavLM weights. The digest is
the JAX package's ``wavlm_fingerprint`` of the weights in its flax layout
(``convert/wavlm.py``), so a cache that either package built with a
checkpoint passes the other's ``check_fingerprint`` with the same one.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..convert.wavlm import jax_leaves, wavlm_to_jax
from ..data.caches import save_cache
from ..data.collate import collate_batch
from ..models.slm import wavlm_embed

logger = logging.getLogger("stylish_tts_torch")

FINGERPRINT_KEY = "__wavlm_fingerprint__"


def wavlm_fingerprint(model: nn.Module) -> np.ndarray:
    """16-byte blake2b digest (uint8) over the leaves of the JAX tree of
    ``model``'s weights, sorted by their key-path strings: each leaf's path,
    shape and first 256 float32 values."""
    h = hashlib.blake2b(digest_size=16)
    for path, leaf in sorted(jax_leaves(wavlm_to_jax(model.state_dict())),
                             key=lambda kv: kv[0]):
        arr = np.asarray(leaf, np.float32)
        h.update(path.encode())
        h.update(str(arr.shape).encode())
        h.update(arr.ravel()[:256].tobytes())
    return np.frombuffer(h.digest(), dtype=np.uint8).copy()


def compute_slm_cache(dataset, model: nn.Module, batch_size: int = 8
                      ) -> Dict[str, np.ndarray]:
    """The embeddings of every segment of ``dataset`` (per time bin, in
    batches of ``batch_size``) on ``model``'s device, float32 with autocast
    off, stored as float16; with the fingerprint."""
    device = next(model.parameters()).device
    out: Dict[str, np.ndarray] = {}
    bins, _ = dataset.time_bins()
    with torch.autocast(device.type, enabled=False):
        for _bin, idxs in sorted(bins.items()):
            for start in range(0, len(idxs), batch_size):
                items = [dataset.load_segment(i) for i in idxs[start:start + batch_size]]
                batch, paths = collate_batch(items, hop_length=dataset.coarse_hop_length,
                                             require_pitch=False)
                audio = torch.from_numpy(batch.audio_gt).to(device)
                states = wavlm_embed(model, audio).to(torch.float16).cpu().numpy()
                for k, path in enumerate(paths):
                    out[path] = states[k]
    out[FINGERPRINT_KEY] = wavlm_fingerprint(model)
    return out


def check_fingerprint(cache: Dict[str, np.ndarray], model: nn.Module) -> None:
    """Raise if ``cache`` was built with other WavLM weights than
    ``model``'s; a cache without a fingerprint gets a warning only."""
    stored = cache.get(FINGERPRINT_KEY)
    if stored is None:
        logger.warning(
            "slm cache has no WavLM fingerprint (pre-fingerprint cache); "
            "cannot verify it matches the training-time weights"
        )
        return
    if not np.array_equal(np.asarray(stored, np.uint8), wavlm_fingerprint(model)):
        raise RuntimeError(
            "slm cache was built with DIFFERENT WavLM weights than the "
            "ones loaded for training — the loss would compare embeddings "
            "across two unrelated networks. Rebuild the cache with "
            "`slm-cache` using the same weights (or delete dataset.slm_path "
            "to embed GT audio in-line)."
        )


def write_slm_cache(path: str, cache: Dict[str, np.ndarray]) -> None:
    save_cache(path, cache)
    mb = sum(v.nbytes for v in cache.values()) / 1e6
    n_segments = sum(1 for k in cache if k != FINGERPRINT_KEY)
    logger.info("wrote slm cache: %d segments, %.1f MB -> %s", n_segments, mb, path)
