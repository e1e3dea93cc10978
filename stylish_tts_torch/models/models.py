"""Model registry: the part of ``stylish_tts_tpu/models/models.py`` the
ported paths build.

``build_model`` builds the aligner with the TextAligner defaults
(hidden 640) and never reads ``TextAlignerConfig.hidden_dim``; the port
keeps that behaviour. ``imported_weights`` turns the aligner's norms and
the conformer's GroupNorm into the frozen affine norm of a folded torch
checkpoint, as ``build_model`` does (it sets ``generator.norm_mode``),
and makes the style encoders' spectral norm off (pre-folded kernels).
``build_acoustic_models`` builds the modules the acoustic stage trains,
by their registry names.
"""

from __future__ import annotations

from typing import Dict

from torch import nn

from ..config import ModelConfig
from .discriminators import ContextFreeDiscriminator, SpecDiscriminator
from .duration_predictor import DurationPredictor
from .pitch_energy_predictor import PitchEnergyPredictor
from .speech_predictor import SpeechPredictor
from .style_encoder import MelStyleEncoder
from .text_aligner import TextAligner

INFERENCE_MODELS = ("duration_predictor", "pitch_energy_predictor", "speech_predictor")
ACOUSTIC_TRAIN_MODELS = ("speech_predictor", "speech_style_encoder")
ACOUSTIC_DISCRIMINATORS = ("mrd0", "mrd1", "mrd2", "disc")


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


def build_acoustic_models(model_config: ModelConfig) -> Dict[str, nn.Module]:
    """``speech_predictor``, ``speech_style_encoder``, ``mrd0``-``mrd2`` and
    ``disc``, with ``build_model``'s ``norm_mode`` and ``sn`` rules."""
    mc = model_config
    norm_mode = "affine" if mc.imported_weights else "group"
    se = mc.style_encoder
    return {
        "speech_predictor": SpeechPredictor(
            mc, norm_mode="affine" if mc.imported_weights else None),
        "speech_style_encoder": MelStyleEncoder(
            se.n_mels, mc.style_dim, se.max_channels, se.skip_downsample,
            sn=not mc.imported_weights),
        **{f"mrd{i}": SpecDiscriminator() for i in range(3)},
        "disc": ContextFreeDiscriminator(norm_mode=norm_mode),
    }
