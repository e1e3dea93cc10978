"""Style-conditioned Conformer over (B, C, T).

Counterpart of ``stylish_tts_tpu/models/conformer.py``. Block = 0.5*FFN
+ attention (of the block's INPUT, as the reference does) + depthwise
conv module (GLU, k=31, GroupNorm(1) with scale and bias, or the frozen
affine norm of imported weights) + 0.5*FFN, each pre-normed with
AdaptiveLayerNorm, then a post AdaptiveLayerNorm. Dropout (``dropout``,
0.2 in the generator, on the FFNs' hidden and output, the attention output
twice as the JAX block does, and the conv module's output) is active in
``train()`` mode and draws from the forward's ``generator``. The
generator calls it without lengths, and that path has
no mask; with lengths, padded keys are masked and padded query rows
zeroed, as the JAX module does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    AdaptiveLayerNorm,
    Conv1d,
    Linear,
    Norm1d,
    Pointwise,
    dropout,
    sequence_mask,
)


class ConformerFeedForward(nn.Module):
    FLAX_NAMES = {"dense_0": "Dense_0", "dense_1": "Dense_1"}

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.dense_0 = Pointwise(dim, dim * mult)
        self.dense_1 = Pointwise(dim * mult, dim)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = dropout(F.silu(self.dense_0(x)), self.dropout, self.training, generator)
        return dropout(self.dense_1(x), self.dropout, self.training, generator)


class ConformerAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.heads = heads
        self.dim_head = dim_head
        inner = heads * dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = Linear(inner, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                generator=None) -> torch.Tensor:
        x = x.transpose(1, 2)
        b, t, _ = x.shape

        def heads(h):
            return h.reshape(b, t, -1, self.dim_head).transpose(1, 2)

        q = heads(self.to_q(x))
        k, v = (heads(h) for h in self.to_kv(x).chunk(2, dim=-1))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(self.dim_head)
        if mask is not None:
            keep = (mask[:, None, :, None] * mask[:, None, None, :]) > 0
            scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
        out = torch.matmul(torch.softmax(scores, dim=-1), v)  # (B, H, T, D)
        if mask is not None:
            out = out * mask[:, None, :, None]
        out = out.transpose(1, 2).reshape(b, t, -1)
        out = dropout(self.to_out(out), self.dropout, self.training, generator)
        return out.transpose(1, 2)


class ConformerConvModule(nn.Module):
    def __init__(self, dim: int, expansion_factor: int = 2, kernel_size: int = 31,
                 norm_mode: str = "group", dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        inner = dim * expansion_factor
        self.pw_in = Pointwise(dim, inner * 2)
        self.dwconv = Conv1d(inner, inner, kernel_size, groups=inner)
        self.bn = Norm1d(inner, mode=norm_mode, use_scale_bias=True)
        self.pw_out = Pointwise(inner, dim)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        gate_in, gate = self.pw_in(x).chunk(2, dim=1)
        x = self.bn(self.dwconv(gate_in * torch.sigmoid(gate)))
        return dropout(self.pw_out(F.silu(x)), self.dropout, self.training, generator)


class ConformerBlock(nn.Module):
    def __init__(self, dim: int, style_dim: int, dim_head: int = 64, heads: int = 8,
                 ff_mult: int = 4, conv_expansion_factor: int = 2,
                 conv_kernel_size: int = 31, norm_mode: str = "group",
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.ff1_norm = AdaptiveLayerNorm(dim, style_dim)
        self.ff1 = ConformerFeedForward(dim, ff_mult, dropout)
        self.attn_norm = AdaptiveLayerNorm(dim, style_dim)
        self.attn = ConformerAttention(dim, heads, dim_head, dropout)
        self.conv_norm = AdaptiveLayerNorm(dim, style_dim)
        self.conv = ConformerConvModule(dim, conv_expansion_factor,
                                        conv_kernel_size, norm_mode, dropout)
        self.ff2_norm = AdaptiveLayerNorm(dim, style_dim)
        self.ff2 = ConformerFeedForward(dim, ff_mult, dropout)
        self.post_norm = AdaptiveLayerNorm(dim, style_dim)

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                mask: torch.Tensor | None = None, generator=None) -> torch.Tensor:
        x_ff1 = 0.5 * self.ff1(self.ff1_norm(x, style), generator) + x
        h = self.attn(self.attn_norm(x, style), mask, generator)
        x = dropout(h, self.dropout, self.training, generator) + x_ff1
        x = self.conv(self.conv_norm(x, style), generator) + x
        x = 0.5 * self.ff2(self.ff2_norm(x, style), generator) + x
        return self.post_norm(x, style)


class Conformer(nn.Module):
    def __init__(self, dim: int, depth: int, style_dim: int, norm_mode: str = "group",
                 dropout: float = 0.0):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block_{i}", ConformerBlock(
                dim, style_dim, norm_mode=norm_mode, dropout=dropout))

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                lengths: torch.Tensor | None = None, generator=None) -> torch.Tensor:
        mask = None
        if lengths is not None:
            mask = sequence_mask(lengths, x.shape[2]).to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, style, mask, generator)
        return x
