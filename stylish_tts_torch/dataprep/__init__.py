from . import align, pitch

__all__ = ["align", "pitch"]
