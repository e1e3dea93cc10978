from . import embed

__all__ = ["embed"]
