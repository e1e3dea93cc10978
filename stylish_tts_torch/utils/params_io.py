"""Weights in the JAX package's flat safetensors layout.

``stylish_tts_tpu/utils/params_io.py`` flattens a nested flax tree with
``/`` (``alignment_model.safetensors``, an inference package's
``params.safetensors``), so the JAX package and the port read and write
the same files.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
from safetensors.numpy import load_file, save_file

from ..convert.from_jax import flatten, text_aligner_from_jax, text_aligner_to_jax_flat


def unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    """Flat ``/``-keyed dict -> nested dict."""
    tree: Dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def save_params_safetensors(path: str, params: Mapping) -> None:
    """Nested (or already flat) tree of arrays -> flat ``/`` safetensors."""
    save_file({k: np.ascontiguousarray(v) for k, v in flatten(params).items()}, path)


def load_params_safetensors(path: str) -> Dict:
    return unflatten(load_file(path))


def save_text_aligner_safetensors(path: str, aligner) -> None:
    save_file(text_aligner_to_jax_flat(aligner.state_dict()), path)


def load_text_aligner_safetensors(path: str, aligner) -> None:
    aligner.load_state_dict(text_aligner_from_jax(load_file(path)))
