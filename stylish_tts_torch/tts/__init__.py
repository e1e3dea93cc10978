from . import loudness, voicepack

__all__ = ["loudness", "voicepack"]
