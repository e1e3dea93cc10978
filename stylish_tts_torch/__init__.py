"""stylish_tts_torch: the PyTorch / CUDA (H100) port of stylish_tts_tpu.

The JAX package stays the reference; this package imports nothing of it
and nothing of JAX. Ported so far: the alignment stage (``train-align``).
"""

__version__ = "0.1.0"
