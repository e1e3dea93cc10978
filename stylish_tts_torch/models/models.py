"""Model registry: the part of ``stylish_tts_tpu/models/models.py`` the
ported stages build.

``build_model`` builds the aligner with the TextAligner defaults
(hidden 640) and never reads ``TextAlignerConfig.hidden_dim``; the port
keeps that behaviour.
"""

from __future__ import annotations

from ..config import ModelConfig
from .text_aligner import TextAligner


def build_text_aligner(model_config: ModelConfig) -> TextAligner:
    mc = model_config
    return TextAligner(
        n_mels=mc.text_aligner.n_mels,
        n_tokens=mc.text_encoder.tokens,
        norm_mode="affine" if mc.imported_weights else "group",
    )
