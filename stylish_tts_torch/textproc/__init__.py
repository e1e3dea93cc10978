from . import book, embed, g2p, normalize
from .g2p import phonemize
from .normalize import normalize_text

__all__ = ["book", "embed", "g2p", "normalize", "normalize_text", "phonemize"]
