"""Style-conditioned ConvNeXt blocks over (B, C, T).

Counterpart of ``stylish_tts_tpu/models/convnext.py``
(``GeneratorConvNeXtBlock``, ``AdaptiveConvNeXtBlock``): depthwise conv
(k=7) -> AdaptiveLayerNorm (epsilon 1e-6) -> pointwise expand ->
activation -> GRN -> pointwise contract -> ``drop_path`` (rate
``dropout``, 0 by default as in JAX; active in ``train()`` mode with a
generator), residual. ``BasicConvNeXtBlock`` has no style: a plain
LayerNorm (with scale and bias, epsilon 1e-6) and exact GELU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    GRN,
    AdaptiveLayerNorm,
    ChannelLayerNorm,
    Conv1d,
    Pointwise,
    channel_param,
    drop_path,
    snake,
)


class _ConvNeXtBlock(nn.Module):
    FLAX_NAMES = {"grn": "GRN_0"}

    def __init__(self, dim: int, intermediate_dim: int, style_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.dwconv = Conv1d(dim, dim, 7, groups=dim)
        self.norm = AdaptiveLayerNorm(dim, style_dim, eps=1e-6)
        self.pwconv1 = Pointwise(dim, intermediate_dim)
        self.grn = GRN(intermediate_dim)
        self.pwconv2 = Pointwise(intermediate_dim, dim)

    def activation(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.norm(self.dwconv(x), style)
        h = self.activation(self.pwconv1(h))
        h = drop_path(self.pwconv2(self.grn(h)), self.dropout, self.training, generator)
        return x + h


class GeneratorConvNeXtBlock(_ConvNeXtBlock):
    """Snake activation with a learned per-channel ``snake`` alpha."""

    def __init__(self, dim: int, intermediate_dim: int, style_dim: int):
        super().__init__(dim, intermediate_dim, style_dim)
        self.snake = channel_param(intermediate_dim, 1.0)

    def activation(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.snake)


class AdaptiveConvNeXtBlock(_ConvNeXtBlock):
    """Exact (erf) GELU."""

    def activation(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, approximate="none")


class BasicConvNeXtBlock(nn.Module):
    """Unconditioned ConvNeXt block (the text style encoder's)."""

    FLAX_NAMES = {"norm": "LayerNorm_0", "grn": "GRN_0"}

    def __init__(self, dim: int, intermediate_dim: int, kernel: int = 7):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, kernel, groups=dim)
        self.norm = ChannelLayerNorm(dim)
        self.pwconv1 = Pointwise(dim, intermediate_dim)
        self.grn = GRN(intermediate_dim)
        self.pwconv2 = Pointwise(intermediate_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.pwconv1(self.norm(self.dwconv(x))), approximate="none")
        return x + self.pwconv2(self.grn(h))
