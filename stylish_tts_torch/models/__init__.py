from .text_aligner import TextAligner
from .models import build_text_aligner

__all__ = ["TextAligner", "build_text_aligner"]
