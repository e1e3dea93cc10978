"""Model registry: the port's ``stylish_tts_tpu/models/models.py``.

``build_model`` builds the aligner with the TextAligner defaults
(hidden 640) and never reads ``TextAlignerConfig.hidden_dim``; the port
keeps that behaviour. ``imported_weights`` turns the aligner's norms and
the conformer's GroupNorm into the frozen affine norm of a folded torch
checkpoint, as ``build_model`` does (it sets ``generator.norm_mode``),
and makes the style encoders' spectral norm off (pre-folded kernels).
``build_models`` builds the twelve modules of the three later stages by
their registry names (``build_model`` less the aligner);
``INFERENCE_MODELS`` are the three modules that synthesis builds, and
``INFERENCE_MODULES`` the six that an inference package holds (the JAX
``export/package.py`` tuple: those three and the three style encoders);
``STAGE_TRAIN_MODELS`` and ``STAGE_DISCRIMINATORS`` are the JAX step
module's tables of what each stage trains.
"""

from __future__ import annotations

from typing import Dict

from torch import nn

from ..config import F5Config, KokoroConfig, ModelConfig
from .discriminators import ContextFreeDiscriminator, PitchDiscriminator, SpecDiscriminator
from .duration_predictor import DurationPredictor
from .kokoro import build_kokoro_models
from .pitch_energy_predictor import PitchEnergyPredictor
from .speech_predictor import SpeechPredictor
from .style_encoder import MelStyleEncoder, PitchStyleEncoder
from .text_aligner import TextAligner

INFERENCE_MODELS = ("duration_predictor", "pitch_energy_predictor", "speech_predictor")
INFERENCE_MODULES = (
    "speech_predictor",
    "pitch_energy_predictor",
    "duration_predictor",
    "speech_style_encoder",
    "pe_style_encoder",
    "duration_style_encoder",
)
STAGE_TRAIN_MODELS = {
    "acoustic": ("speech_predictor", "speech_style_encoder"),
    "textual": ("pitch_energy_predictor", "pe_style_encoder"),
    "duration": ("duration_predictor", "duration_style_encoder"),
}
STAGE_DISCRIMINATORS = {
    "acoustic": ("mrd0", "mrd1", "mrd2", "disc"),
    "textual": ("pitch_disc",),
    "duration": ("dur_disc",),
}


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
            mc.style_dim, mc.pitch_energy_predictor.inter_dim, mc.text_encoder,
            dropout=mc.pitch_energy_predictor.dropout),
        "speech_predictor": SpeechPredictor(
            mc, norm_mode="affine" if mc.imported_weights else None),
    }


def build_models(model_config: ModelConfig) -> Dict[str, nn.Module]:
    """Every module of ``build_model`` but the aligner, with its
    ``norm_mode``, ``sn`` and ``generator.remat`` rules. Kokoro (a
    ``KokoroConfig``) and F5-TTS (an ``F5Config``) have inference modules
    only."""
    if isinstance(model_config, KokoroConfig):
        return build_kokoro_models(model_config)
    if isinstance(model_config, F5Config):
        from .f5 import build_f5_models

        return build_f5_models(model_config)
    mc = model_config
    se = mc.style_encoder
    sn = not mc.imported_weights

    def mel_style_encoder():
        return MelStyleEncoder(se.n_mels, mc.style_dim, se.max_channels,
                               se.skip_downsample, sn=sn)

    return {
        **build_inference_models(mc),
        "disc": ContextFreeDiscriminator(
            norm_mode="affine" if mc.imported_weights else "group",
            remat=mc.generator.remat),
        **{f"mrd{i}": SpecDiscriminator(remat=mc.generator.remat) for i in range(3)},
        "speech_style_encoder": mel_style_encoder(),
        "pe_style_encoder": PitchStyleEncoder(
            se.n_mels, mc.style_dim, se.max_channels, se.skip_downsample,
            coarse_multiplier=mc.coarse_multiplier, sn=sn),
        "duration_style_encoder": mel_style_encoder(),
        "pitch_disc": PitchDiscriminator(2, dim_hidden=64, kernel=21),
        "dur_disc": PitchDiscriminator(1, dim_hidden=64, kernel=5),
    }
