"""stylish_tts_torch: the PyTorch / CUDA (H100) port of stylish_tts_tpu.

The JAX package stays the reference; this package imports nothing of it
and nothing of JAX. Ported so far: the alignment stage (``train-align``),
the data-preparation front (``pitch``, ``align``), the acoustic stage
(``train --stage acoustic``) and synthesis (``speak`` through
``export.package.InferencePackage``).
"""

__version__ = "0.1.0"
