"""Acoustic decoder.

Counterpart of ``stylish_tts_tpu/models/decoder.py``: the aligned text
encoding concatenated with conv-embedded F0, energy and voiced curves,
an AdaIN encode block and 4 decode blocks with an ``asr`` residual. In
``train()`` mode with a generator, F0 and energy are first box-smoothed
at a width drawn per step (F0 from 0/7/15, energy from 0/7/15/31), the
training-time augmentation of the JAX decoder.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import AdaptiveDecoderBlock, Conv1d

F0_WIDTHS = (0, 7, 15)
N_WIDTHS = (0, 7, 15, 31)


def _box_smooth(curve: torch.Tensor, width: int) -> torch.Tensor:
    """Box-filter a (B, T) curve: zero padding width // 2 on each side, the
    first T outputs (the JAX ``_box_smooth``)."""
    if width == 0:
        return curve
    kernel = torch.full((1, 1, width), 1.0 / width, dtype=curve.dtype,
                        device=curve.device)
    out = F.conv1d(curve[:, None, :], kernel, padding=width // 2)[:, 0, :]
    return out[:, : curve.shape[1]]


def _random_smooth(curve: torch.Tensor, widths, generator: torch.Generator):
    """``_box_smooth`` at a width drawn from ``widths``; every width is
    computed and the draw picks one on the device (no host sync)."""
    idx = torch.randint(len(widths), (1,), generator=generator,
                        device=generator.device)
    return torch.stack([_box_smooth(curve, w) for w in widths])[idx.to(curve.device)][0]


class Decoder(nn.Module):
    def __init__(self, dim_in: int, style_dim: int, hidden_dim: int,
                 residual_dim: int):
        super().__init__()
        self.f0_conv = Conv1d(1, 1, 3)
        self.n_conv = Conv1d(1, 1, 3)
        self.voiced_conv = Conv1d(1, 1, 3)
        self.encode = AdaptiveDecoderBlock(dim_in + 3, hidden_dim, style_dim)
        self.asr_res = Conv1d(dim_in, residual_dim, 1)
        for i in range(4):
            self.add_module(f"decode_{i}", AdaptiveDecoderBlock(
                hidden_dim + 3 + residual_dim, hidden_dim, style_dim))

    def forward(self, asr: torch.Tensor, f0_curve: torch.Tensor,
                energy: torch.Tensor, style: torch.Tensor,
                voiced: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """asr (B, dim_in, T); curves (B, T) -> (B, hidden_dim, T)."""
        if self.training and generator is not None:
            f0_curve = _random_smooth(f0_curve, F0_WIDTHS, generator)
            energy = _random_smooth(energy, N_WIDTHS, generator)
        f0 = self.f0_conv(f0_curve[:, None])
        n = self.n_conv(energy[:, None])
        v = self.voiced_conv(voiced[:, None])
        x = self.encode(torch.cat([asr, f0, n, v], dim=1), style)
        asr_res = self.asr_res(asr)
        for i in range(4):
            x = getattr(self, f"decode_{i}")(
                torch.cat([x, asr_res, f0, n, v], dim=1), style)
        return x
