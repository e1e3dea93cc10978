"""Acoustic decoder, inference path.

Counterpart of ``stylish_tts_tpu/models/decoder.py``: the aligned text
encoding concatenated with conv-embedded F0, energy and voiced curves,
an AdaIN encode block and 4 decode blocks with an ``asr`` residual. The
training-time random box smoothing of F0 and energy (``_box_smooth``)
belongs to the acoustic training stage and is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import AdaptiveDecoderBlock, Conv1d


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
                voiced: torch.Tensor) -> torch.Tensor:
        """asr (B, dim_in, T); curves (B, T) -> (B, hidden_dim, T)."""
        f0 = self.f0_conv(f0_curve[:, None])
        n = self.n_conv(energy[:, None])
        v = self.voiced_conv(voiced[:, None])
        x = self.encode(torch.cat([asr, f0, n, v], dim=1), style)
        asr_res = self.asr_res(asr)
        for i in range(4):
            x = getattr(self, f"decode_{i}")(
                torch.cat([x, asr_res, f0, n, v], dim=1), style)
        return x
