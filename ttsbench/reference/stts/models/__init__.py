from .models import (
    INFERENCE_MODELS,
    INFERENCE_MODULES,
    STAGE_DISCRIMINATORS,
    STAGE_TRAIN_MODELS,
    build_inference_models,
    build_models,
)

__all__ = ["INFERENCE_MODELS", "INFERENCE_MODULES", "STAGE_DISCRIMINATORS", "STAGE_TRAIN_MODELS",
           "build_inference_models", "build_models"]
