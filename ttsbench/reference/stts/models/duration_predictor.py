"""Duration predictor.

Counterpart of ``stylish_tts_tpu/models/duration_predictor.py``: own
TextEncoder, a style-conditioned self-attention "cross" block (depthwise
k=5 + SiLU + pointwise after it), N AdaptiveConvNeXt blocks and a
projection to ordinal duration-class logits (first logit, then |.| of the
rest, cumulative sum, negated absolute value).

In ``train()`` mode (the duration stage) dropout draws from the
``generator`` the forward is given: the text encoder's, 0.5 on the cross
attention's weights, ``DropPath(dropout)`` in each ConvNeXt block, and
``last_dropout`` on whole channels after each block (one mask per batch
row and channel, shared over time: flax ``broadcast_dims=(1,)`` on
(B, T, C)).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DurationPredictorConfig, TextEncoderConfig
from .common import AdaptiveLayerNorm, Conv1d, Pointwise, dropout
from .convnext import AdaptiveConvNeXtBlock
from .text_encoder import RoPEMultiHeadAttention, TextEncoder


def channel_dropout(x: torch.Tensor, rate: float, training: bool,
                    generator: torch.Generator | None) -> torch.Tensor:
    """Dropout of whole channels of (B, C, T): one keep draw per (b, c)."""
    if not training or rate <= 0.0:
        return x
    mask = dropout(torch.ones(x.shape[:2] + (1,), device=x.device), rate, True, generator)
    return x * mask.to(x.dtype)


class DurationPredictor(nn.Module):
    def __init__(self, style_dim: int, inter_dim: int,
                 text_config: TextEncoderConfig,
                 duration_config: DurationPredictorConfig):
        super().__init__()
        cfg = duration_config
        self.n_layer = cfg.n_layer
        self.last_dropout = cfg.last_dropout
        self.text_encoder = TextEncoder(inter_dim, text_config)
        self.query_norm = AdaptiveLayerNorm(inter_dim, style_dim)
        self.key_norm = AdaptiveLayerNorm(inter_dim, style_dim)
        self.cross_attention = RoPEMultiHeadAttention(inter_dim, 8, dropout=0.5)
        self.cross_post_dw = Conv1d(inter_dim, inter_dim, 5, groups=inter_dim)
        self.cross_post_pw = Pointwise(inter_dim, inter_dim)
        for i in range(self.n_layer):
            self.add_module(f"convnext_{i}", AdaptiveConvNeXtBlock(
                inter_dim, inter_dim * 4, style_dim, dropout=cfg.dropout))
        self.duration_proj = Pointwise(inter_dim, duration_config.duration_classes)

    def forward(self, texts: torch.Tensor, text_lengths: torch.Tensor,
                style: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """texts (B, T) -> ordinal duration logits (B, T, classes)."""
        encoding, _, mask = self.text_encoder(texts, text_lengths, generator)
        m = mask[:, 0, :]
        query = self.query_norm(encoding, style)
        key = self.key_norm(encoding, style)
        attention = self.cross_attention(query, key, m[:, :, None] * m[:, None, :],
                                         generator)
        attention = self.cross_post_pw(F.silu(self.cross_post_dw(attention)))
        prosody = (attention + encoding) / math.sqrt(2.0)
        for i in range(self.n_layer):
            prosody = getattr(self, f"convnext_{i}")(prosody, style, generator) * mask
            prosody = channel_dropout(prosody, self.last_dropout, self.training, generator)
        duration = self.duration_proj(prosody)
        duration = torch.cat([duration[:, :1], duration[:, 1:].abs()], dim=1)
        duration = -torch.cumsum(duration, dim=1).abs()
        return (duration * mask).transpose(1, 2)
