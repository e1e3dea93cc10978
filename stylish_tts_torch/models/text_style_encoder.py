"""Text-based style encoder.

Counterpart of ``stylish_tts_tpu/models/text_style_encoder.py``: a k=7
input conv, ``n_layers`` ``BasicConvNeXtBlock``s and a mean over each
sequence's text positions. Like ``build_model``, ``build_models`` does not
build it (the JAX package keeps it in its component inventory).
"""

from __future__ import annotations

import torch
from torch import nn

from .common import Conv1d, sequence_mask
from .convnext import BasicConvNeXtBlock


class TextStyleEncoder(nn.Module):
    def __init__(self, inter_dim: int, style_dim: int, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv_in = Conv1d(inter_dim, style_dim, 7)
        for i in range(n_layers):
            self.add_module(f"block_{i}", BasicConvNeXtBlock(style_dim, style_dim * 4))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """x (B, inter_dim, T), lengths (B,) -> (B, style_dim)."""
        x = self.conv_in(x)
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x)
        mask = sequence_mask(lengths, x.shape[2]).to(x.dtype)[:, None, :]
        return torch.sum(x * mask, dim=2) / lengths[:, None].to(x.dtype)
