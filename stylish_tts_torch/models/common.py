"""Shared building blocks, the part the alignment stage needs.

Counterpart of ``stylish_tts_tpu/models/common.py`` (``sequence_mask``,
``get_padding``, ``Conv1d``, ``Norm1d``). The JAX modules take
(B, T, C); these take PyTorch's (B, C, T), and the model that uses them
transposes once at its boundary.
"""

from __future__ import annotations

import torch
from torch import nn


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_length) bool mask, True inside the sequence."""
    pos = torch.arange(max_length, device=lengths.device)[None, :]
    return pos < lengths[:, None]


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class Conv1d(nn.Conv1d):
    """1D conv over (B, C, T) with symmetric "same" padding, as the JAX
    ``Conv1d(pad="same")``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, bias: bool = True):
        super().__init__(
            in_channels, out_channels, kernel_size, dilation=dilation,
            padding=get_padding(kernel_size, dilation), bias=bias,
        )


class Norm1d(nn.Module):
    """Feature-axis norm over (B, C, T) with the JAX package's two modes.

    * ``group``  — GroupNorm(1) over (C, T), padded frames included, with
      flax's epsilon 1e-6 (torch's default is 1e-5), and no parameters,
      as the aligner uses it.
    * ``affine`` — frozen per-channel ``scale`` and ``bias`` (folded
      BatchNorm eval stats of an imported torch checkpoint).
    """

    def __init__(self, channels: int, mode: str = "group"):
        super().__init__()
        if mode not in ("group", "affine"):
            raise ValueError(f"unknown Norm1d mode {mode!r}")
        self.mode = mode
        if mode == "group":
            self.norm = nn.GroupNorm(1, channels, eps=1e-6, affine=False)
        else:
            self.scale = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "group":
            return self.norm(x)
        return x * self.scale[:, None] + self.bias[:, None]


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout drawing its mask from an explicit generator (flax
    ``nn.Dropout``: keep with probability 1 - rate, scale by 1/(1-rate))."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))
