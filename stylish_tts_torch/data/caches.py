"""Pitch / alignment safetensors caches, keyed by segment filename.

The port's copy of ``stylish_tts_tpu/data/caches.py`` (the port imports
nothing of the JAX package).

Parity with the reference cache format (reference: dataloader.py:32-50,
dataprep/pitch_extractor.py:42, dataprep/align_text.py:134-199): one
safetensors file per cache, key = wav filename; pitch tensors are
(frames,) F0 Hz at the padded frame count; alignment tensors are
(k, text_len) with row 0 = per-token durations.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from safetensors.numpy import load_file, save_file


def load_cache(path: str) -> Dict[str, np.ndarray]:
    return load_file(path)


def save_cache(path: str, tensors: Dict[str, np.ndarray]) -> None:
    save_file({k: np.ascontiguousarray(v) for k, v in tensors.items()}, path)
