"""Duration predictor.

Counterpart of ``stylish_tts_tpu/models/duration_predictor.py``: own
TextEncoder, a style-conditioned self-attention "cross" block (depthwise
k=5 + SiLU + pointwise after it), N AdaptiveConvNeXt blocks and a
projection to ordinal duration-class logits (first logit, then |.| of the
rest, cumulative sum, negated absolute value). Dropout is the identity at
inference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DurationPredictorConfig, TextEncoderConfig
from .common import AdaptiveLayerNorm, Conv1d, Pointwise
from .convnext import AdaptiveConvNeXtBlock
from .text_encoder import RoPEMultiHeadAttention, TextEncoder


class DurationPredictor(nn.Module):
    def __init__(self, style_dim: int, inter_dim: int,
                 text_config: TextEncoderConfig,
                 duration_config: DurationPredictorConfig):
        super().__init__()
        self.n_layer = duration_config.n_layer
        self.text_encoder = TextEncoder(inter_dim, text_config)
        self.query_norm = AdaptiveLayerNorm(inter_dim, style_dim)
        self.key_norm = AdaptiveLayerNorm(inter_dim, style_dim)
        self.cross_attention = RoPEMultiHeadAttention(inter_dim, 8)
        self.cross_post_dw = Conv1d(inter_dim, inter_dim, 5, groups=inter_dim)
        self.cross_post_pw = Pointwise(inter_dim, inter_dim)
        for i in range(self.n_layer):
            self.add_module(f"convnext_{i}", AdaptiveConvNeXtBlock(
                inter_dim, inter_dim * 4, style_dim))
        self.duration_proj = Pointwise(inter_dim, duration_config.duration_classes)

    def forward(self, texts: torch.Tensor, text_lengths: torch.Tensor,
                style: torch.Tensor) -> torch.Tensor:
        """texts (B, T) -> ordinal duration logits (B, T, classes)."""
        encoding, _, mask = self.text_encoder(texts, text_lengths)
        m = mask[:, 0, :]
        query = self.query_norm(encoding, style)
        key = self.key_norm(encoding, style)
        attention = self.cross_attention(query, key, m[:, :, None] * m[:, None, :])
        attention = self.cross_post_pw(F.silu(self.cross_post_dw(attention)))
        prosody = (attention + encoding) / math.sqrt(2.0)
        for i in range(self.n_layer):
            prosody = getattr(self, f"convnext_{i}")(prosody, style) * mask
        duration = self.duration_proj(prosody)
        duration = torch.cat([duration[:, :1], duration[:, 1:].abs()], dim=1)
        duration = -torch.cumsum(duration, dim=1).abs()
        return (duration * mask).transpose(1, 2)
