"""Model registry: the part of ``stylish_tts_tpu/models/models.py`` the
ported paths build.

``build_model`` builds the aligner with the TextAligner defaults
(hidden 640) and never reads ``TextAlignerConfig.hidden_dim``; the port
keeps that behaviour. ``imported_weights`` turns the aligner's norms and
the conformer's GroupNorm into the frozen affine norm of a folded torch
checkpoint, as ``build_model`` does (it sets ``generator.norm_mode``).
"""

from __future__ import annotations

from typing import Dict

from torch import nn

from ..config import ModelConfig
from .duration_predictor import DurationPredictor
from .pitch_energy_predictor import PitchEnergyPredictor
from .speech_predictor import SpeechPredictor
from .text_aligner import TextAligner

INFERENCE_MODELS = ("duration_predictor", "pitch_energy_predictor", "speech_predictor")


def build_text_aligner(model_config: ModelConfig) -> TextAligner:
    mc = model_config
    return TextAligner(
        n_mels=mc.text_aligner.n_mels,
        n_tokens=mc.text_encoder.tokens,
        norm_mode="affine" if mc.imported_weights else "group",
    )


def build_inference_models(model_config: ModelConfig) -> Dict[str, nn.Module]:
    """The three modules synthesis runs, by their JAX registry names."""
    mc = model_config
    return {
        "duration_predictor": DurationPredictor(
            mc.style_dim, mc.inter_dim, mc.text_encoder, mc.duration_predictor),
        "pitch_energy_predictor": PitchEnergyPredictor(
            mc.style_dim, mc.pitch_energy_predictor.inter_dim, mc.text_encoder),
        "speech_predictor": SpeechPredictor(
            mc, norm_mode="affine" if mc.imported_weights else None),
    }
