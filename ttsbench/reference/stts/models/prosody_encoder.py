"""Prosody encoder.

Counterpart of ``stylish_tts_tpu/models/prosody_encoder.py``: 3 layers
that each append the style vector to the channels (d + style = 320 at
full width, so 2 heads of 160 with RoPE over 80), attend, AdaLN-norm,
conv-FFN (k=1) and project back to d_model. In ``train()`` mode dropout
(0.2) applies to the attention weights, after the attention, inside the
FFN and after it, drawing from the ``generator`` the forward is given.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import AdaptiveLayerNorm, Pointwise, dropout, sequence_mask
from .text_encoder import ConvFFN, RoPEMultiHeadAttention


class ProsodyEncoder(nn.Module):
    def __init__(self, style_dim: int, d_model: int, n_layers: int = 3,
                 dropout: float = 0.2):
        super().__init__()
        self.n_layers = n_layers
        self.dropout = dropout
        hidden = d_model + style_dim
        for i in range(n_layers):
            self.add_module(f"attn_{i}", RoPEMultiHeadAttention(hidden, 2, dropout))
            self.add_module(f"norm1_{i}", AdaptiveLayerNorm(hidden, style_dim))
            self.add_module(f"ffn_{i}", ConvFFN(hidden, hidden * 2, 1, dropout))
            self.add_module(f"norm2_{i}", AdaptiveLayerNorm(hidden, style_dim))
            self.add_module(f"proj_{i}", Pointwise(hidden, d_model))

    def forward(self, x: torch.Tensor, style: torch.Tensor, lengths: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x (B, d_model, T) -> (B, d_model + style_dim, T)."""
        x_mask = sequence_mask(lengths, x.shape[2]).to(x.dtype)[:, None, :]
        m = x_mask[:, 0, :]
        attn_mask = m[:, :, None] * m[:, None, :]
        style_tiled = style[:, :, None].expand(-1, -1, x.shape[2])
        x = torch.cat([x, style_tiled], dim=1)
        for i in range(self.n_layers):
            x = x * x_mask
            y = getattr(self, f"attn_{i}")(x, x, attn_mask, generator)
            y = dropout(y, self.dropout, self.training, generator)
            x = getattr(self, f"norm1_{i}")(x + y, style)
            y = getattr(self, f"ffn_{i}")(x, x_mask, generator)
            y = dropout(y, self.dropout, self.training, generator)
            x = getattr(self, f"norm2_{i}")(x + y, style)
            x = torch.cat([getattr(self, f"proj_{i}")(x), style_tiled], dim=1)
        return x * x_mask
