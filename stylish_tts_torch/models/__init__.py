from .text_aligner import TextAligner
from .models import INFERENCE_MODELS, build_inference_models, build_text_aligner

__all__ = ["INFERENCE_MODELS", "TextAligner", "build_inference_models",
           "build_text_aligner"]
