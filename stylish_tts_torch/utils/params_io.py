"""Aligner weights in the JAX package's flat safetensors layout.

``alignment_model.safetensors`` holds the flax variables flattened with
``/`` (``stylish_tts_tpu/utils/params_io.py``), so the JAX ``align``
command and the port read the same file.
"""

from __future__ import annotations

from safetensors.numpy import load_file, save_file

from ..convert.from_jax import text_aligner_from_jax, text_aligner_to_jax_flat


def save_text_aligner_safetensors(path: str, aligner) -> None:
    save_file(text_aligner_to_jax_flat(aligner.state_dict()), path)


def load_text_aligner_safetensors(path: str, aligner) -> None:
    aligner.load_state_dict(text_aligner_from_jax(load_file(path)))
