"""Pitch/energy predictor.

Counterpart of ``stylish_tts_tpu/models/pitch_energy_predictor.py``: own
TextEncoder (at the predictor's inter_dim, 256 at full width) ->
ProsodyEncoder -> prosody through the alignment to frame rate -> twin
4-block AdaptiveDecoderBlock heads for F0 (Hz) and log-energy.

In ``train()`` mode (the textual stage) the text encoder, the prosody
encoder (0.2) and the heads (``dropout``, the config's
``pitch_energy_predictor.dropout``) apply dropout from the ``generator``
the forward is given, as the JAX module does under ``training=True``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import TextEncoderConfig
from .common import AdaptiveDecoderBlock, Pointwise
from .prosody_encoder import ProsodyEncoder
from .text_encoder import TextEncoder


class PitchEnergyPredictor(nn.Module):
    def __init__(self, style_dim: int, inter_dim: int,
                 text_config: TextEncoderConfig, dropout: float = 0.2):
        super().__init__()
        self.text_encoder = TextEncoder(inter_dim, text_config)
        self.prosody_encoder = ProsodyEncoder(style_dim, inter_dim, n_layers=3)
        d = inter_dim
        dims = [(d + style_dim, d), (d, d // 2), (d // 2, d // 2), (d // 2, d // 2)]
        for head in ("f0", "n"):
            for i, (din, dout) in enumerate(dims):
                self.add_module(f"{head}_{i}", AdaptiveDecoderBlock(
                    din, dout, style_dim, dropout=dropout))
            self.add_module(f"{head}_proj", Pointwise(d // 2, 1))
        self.n_blocks = len(dims)

    def _head(self, name: str, x: torch.Tensor, style: torch.Tensor,
              generator: torch.Generator | None) -> torch.Tensor:
        for i in range(self.n_blocks):
            x = getattr(self, f"{name}_{i}")(x, style, generator)
        return getattr(self, f"{name}_proj")(x)[:, 0]

    def forward(self, texts: torch.Tensor, text_lengths: torch.Tensor,
                alignment: torch.Tensor, style: torch.Tensor,
                generator: torch.Generator | None = None):
        """alignment (B, T_text, T_frames) -> (pitch, energy), each (B, T_frames)."""
        encoding, _, _ = self.text_encoder(texts, text_lengths, generator)
        prosody = self.prosody_encoder(encoding, style, text_lengths, generator)
        x = torch.bmm(prosody, alignment)  # (B, C, T_frames)
        return (self._head("f0", x, style, generator),
                self._head("n", x, style, generator))
