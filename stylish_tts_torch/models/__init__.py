from .text_aligner import TextAligner
from .models import (
    INFERENCE_MODELS,
    INFERENCE_MODULES,
    STAGE_DISCRIMINATORS,
    STAGE_TRAIN_MODELS,
    build_inference_models,
    build_models,
    build_text_aligner,
)

__all__ = ["INFERENCE_MODELS", "INFERENCE_MODULES", "STAGE_DISCRIMINATORS", "STAGE_TRAIN_MODELS",
           "TextAligner", "build_inference_models", "build_models",
           "build_text_aligner"]
