"""Text encoder: embedding + conv prenet + RoPE transformer.

Counterpart of ``stylish_tts_tpu/models/text_encoder.py``: token
embedding scaled by sqrt(hidden), a 3-layer ConvReluNorm prenet (k=5)
with a zero-initialised residual projection, N transformer layers whose
attention rotates half of each head's dims (RoPE pairs (i, i + d/2)),
conv-FFN layers and a 1x1 projection to ``inter_dim``.

The attention mask is ADDITIVE -1e4, as in the JAX module: padded query
rows get the softmax of their raw scores, which reaches valid frames
through the later convs, so a boolean mask (zeroed rows) would compute
another function. Modules take (B, C, T); masks are (B, 1, T).

Dropout (the prenet's 0.5, ``config.dropout`` on the attention weights
and after the attention and FFN) is active in ``train()`` mode and draws
from the ``generator`` the forward is given.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import TextEncoderConfig
from .common import Conv1d, LayerNormChannels, Linear, Pointwise, dropout, sequence_mask


def rope_rotate(x: torch.Tensor, rope_dim: int, base: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding of the first ``rope_dim`` features of x (B, T, H, D);
    theta pairs are (i, i + rope_dim/2)."""
    t = x.shape[1]
    d2 = rope_dim // 2
    theta = 1.0 / (base ** (torch.arange(0, rope_dim, 2, dtype=torch.float32,
                                          device=x.device) / rope_dim))
    idx_theta = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * theta[None, :]
    cos = torch.cat([torch.cos(idx_theta)] * 2, dim=-1)[None, :, None, :]
    sin = torch.cat([torch.sin(idx_theta)] * 2, dim=-1)[None, :, None, :]
    x_rope, x_pass = x[..., :rope_dim], x[..., rope_dim:]
    neg_half = torch.cat([-x_rope[..., d2:], x_rope[..., :d2]], dim=-1)
    return torch.cat([x_rope * cos + neg_half * sin, x_pass], dim=-1)


class RoPEMultiHeadAttention(nn.Module):
    """MHA with rotary embeddings on half of each head's dims."""

    def __init__(self, channels: int, n_heads: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.n_heads = n_heads
        self.head_dim = channels // n_heads
        self.q = Linear(channels, channels)
        self.k = Linear(channels, channels)
        self.v = Linear(channels, channels)
        self.out = Linear(channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x, context: (B, C, T); mask: (B, T, S) keep-mask -> (B, C, T)."""
        x, context = x.transpose(1, 2), context.transpose(1, 2)
        b, t, _ = x.shape

        def heads(h):
            return h.reshape(b, h.shape[1], -1, self.head_dim)

        q, k, v = heads(self.q(x)), heads(self.k(context)), heads(self.v(context))
        rope_dim = self.head_dim // 2
        q, k = rope_rotate(q, rope_dim), rope_rotate(k, rope_dim)
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(self.head_dim)
        if mask is not None:
            scores = scores - 1e4 * (1.0 - (mask[:, None] > 0).to(scores.dtype))
        attn = dropout(torch.softmax(scores, dim=-1), self.dropout, self.training,
                       generator)
        out = torch.einsum("bhts,bshd->bthd", attn, v).reshape(b, t, -1)
        return self.out(out).transpose(1, 2)


class ConvFFN(nn.Module):
    def __init__(self, channels: int, filter_channels: int, kernel_size: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.conv1 = Conv1d(channels, filter_channels, kernel_size)
        self.conv2 = Conv1d(filter_channels, channels, kernel_size)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = torch.relu(self.conv1(x * x_mask))
        x = dropout(x, self.dropout, self.training, generator)
        return self.conv2(x * x_mask) * x_mask


class ConvReluNorm(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 5, n_layers: int = 3,
                 dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"conv_{i}", Conv1d(channels, channels, kernel_size))
            self.add_module(f"norm_{i}", LayerNormChannels(channels))
        self.proj = Pointwise(channels, channels)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        res = x
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x * x_mask)
            x = torch.relu(getattr(self, f"norm_{i}")(x))
            x = dropout(x, self.dropout, self.training, generator)
        return (res + self.proj(x)) * x_mask


class TransformerEncoder(nn.Module):
    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"attn_{i}", RoPEMultiHeadAttention(hidden_channels, n_heads,
                                                                dropout))
            self.add_module(f"norm1_{i}", LayerNormChannels(hidden_channels))
            self.add_module(f"ffn_{i}", ConvFFN(hidden_channels, filter_channels,
                                                kernel_size, dropout))
            self.add_module(f"norm2_{i}", LayerNormChannels(hidden_channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        m = x_mask[:, 0, :]
        attn_mask = m[:, :, None] * m[:, None, :]
        for i in range(self.n_layers):
            x = x * x_mask
            y = getattr(self, f"attn_{i}")(x, x, attn_mask, generator)
            y = dropout(y, self.dropout, self.training, generator)
            x = getattr(self, f"norm1_{i}")(x + y)
            y = getattr(self, f"ffn_{i}")(x, x_mask, generator)
            y = dropout(y, self.dropout, self.training, generator)
            x = getattr(self, f"norm2_{i}")(x + y)
        return x * x_mask


class TextEncoder(nn.Module):
    """Token ids (B, T) -> (encoding (B, inter_dim, T), hidden (B, hidden, T),
    mask (B, 1, T))."""

    def __init__(self, inter_dim: int, config: TextEncoderConfig):
        super().__init__()
        cfg = config
        self.hidden_dim = cfg.hidden_dim
        self.emb = nn.Embedding(cfg.tokens, cfg.hidden_dim)
        nn.init.normal_(self.emb.weight, std=cfg.hidden_dim ** -0.5)
        self.prenet = ConvReluNorm(cfg.hidden_dim, kernel_size=5, n_layers=3)
        self.encoder = TransformerEncoder(
            cfg.hidden_dim, cfg.filter_channels, cfg.heads, cfg.layers,
            cfg.kernel_size, cfg.dropout)
        self.proj = Pointwise(cfg.hidden_dim, inter_dim)

    def forward(self, texts: torch.Tensor, text_lengths: torch.Tensor,
                generator: torch.Generator | None = None):
        x = (self.emb(texts) * math.sqrt(self.hidden_dim)).transpose(1, 2)
        x_mask = sequence_mask(text_lengths, texts.shape[1]).to(x.dtype)[:, None, :]
        x = self.prenet(x, x_mask, generator)
        x = self.encoder(x, x_mask, generator)
        return self.proj(x) * x_mask, x, x_mask
