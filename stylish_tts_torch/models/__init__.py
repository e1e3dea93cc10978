from .text_aligner import TextAligner
from .models import (
    ACOUSTIC_DISCRIMINATORS,
    ACOUSTIC_TRAIN_MODELS,
    INFERENCE_MODELS,
    build_acoustic_models,
    build_inference_models,
    build_text_aligner,
)

__all__ = ["ACOUSTIC_DISCRIMINATORS", "ACOUSTIC_TRAIN_MODELS", "INFERENCE_MODELS",
           "TextAligner", "build_acoustic_models", "build_inference_models",
           "build_text_aligner"]
