"""GAN discriminators of the acoustic, textual and duration stages.

Counterpart of ``stylish_tts_tpu/models/discriminators.py``
(``SpecDiscriminator``, ``ContextFreeBlock``,
``ContextFreeDiscriminator``):

* ``SpecDiscriminator`` (the MRD): 5 Conv2d layers over one |FFT|
  resolution, (B, 1, freq, frames), with explicit (1,1)/(4,4) pads as the
  JAX module sets them, each with a 1-channel score head;
* ``ContextFreeDiscriminator`` (the waveform ``disc``): raw audio cut
  into 1024-sample windows at hop 512 -> strided conv stack, SE channel
  attention, temporal and spectral branches, fusion, two linear layers.

* ``PitchDiscriminator``: 5 x (Conv1d, leaky ReLU 0.1) over stacked
  prosody curves (B, C_in, T), each layer with a 1-channel score head of
  the same kernel; ``pitch_disc`` (kernel 21, F0 and energy) and
  ``dur_disc`` (kernel 5, durations).

Each returns the list of per-layer score tensors (B, N) that the LSGAN /
TPRLS losses take. With ``remat`` (``build_models`` passes
``generator.remat``, as the JAX ``build_model`` wraps these two in
``nn.remat``) the MRD's and the waveform disc's forward is rematerialised
in the backward (``common.remat_call``).

* ``PeriodDiscriminator`` / ``MultiPeriodDiscriminator`` (HiFi-GAN, periods
  2, 3, 5, 7, 11): audio reflect-padded to a multiple of the period and
  folded to (B, 1, T/p, p), four (5, 1) convs at stride (3, 1) (32, 128,
  512, 1024 channels), one more at 1024, a (3, 1) conv to one channel,
  leaky ReLU 0.1; the score (B, N) and the feature maps. Like
  ``build_model``, ``build_models`` does not build them.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv1d, Norm1d, remat_call

# (kernel (freq, frames), stride, padding) of the MRD's five convs
SPEC_LAYERS = (
    ((3, 9), (1, 1), (1, 4)),
    ((3, 9), (1, 2), (1, 4)),
    ((3, 9), (1, 2), (1, 4)),
    ((3, 9), (1, 2), (1, 4)),
    ((3, 3), (1, 1), (1, 1)),
)


class SpecDiscriminator(nn.Module):
    """(B, 1, freq, frames) |FFT| magnitude -> 5 score tensors."""

    def __init__(self, channels: int = 32, remat: bool = False):
        super().__init__()
        self.remat = remat
        in_ch = 1
        for i, (kernel, stride, pad) in enumerate(SPEC_LAYERS):
            self.add_module(f"conv_{i}", nn.Conv2d(in_ch, channels, kernel, stride, pad))
            self.add_module(f"out_{i}", nn.Conv2d(channels, 1, 3, 1, 1))
            in_ch = channels

    def forward(self, y: torch.Tensor) -> List[torch.Tensor]:
        return remat_call(self.remat, self._scores, y)

    def _scores(self, y: torch.Tensor) -> List[torch.Tensor]:
        x = y
        results = []
        for i in range(len(SPEC_LAYERS)):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), 0.1)
            out = getattr(self, f"out_{i}")(x)
            results.append(out.reshape(out.shape[0], -1))
        return results


class ContextFreeBlock(nn.Module):
    """Conv1d (pad k // 2) -> Norm1d (GroupNorm(1) with scale and bias, or
    the frozen affine norm) -> exact GELU, over (N, C, T)."""

    def __init__(self, dim_in: int, dim_out: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = False, norm_mode: str = "group"):
        super().__init__()
        self.conv = Conv1d(dim_in, dim_out, kernel, groups=groups, bias=bias,
                           stride=stride)
        self.norm = Norm1d(dim_out, mode=norm_mode, use_scale_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.norm(self.conv(x)), approximate="none")


class ContextFreeDiscriminator(nn.Module):
    """Raw audio (B, T) -> one score tensor over 1024-sample windows."""

    WIN, STEP = 1024, 512

    def __init__(self, dim: int = 64, norm_mode: str = "group", remat: bool = False):
        super().__init__()
        self.remat = remat
        d, nm = dim, norm_mode
        self.conv0 = ContextFreeBlock(1, d, 11, stride=4, norm_mode=nm)
        self.conv1 = ContextFreeBlock(d, d * 2, 11, stride=4, norm_mode=nm)
        self.conv2 = ContextFreeBlock(d * 2, d * 4, 7, stride=2, norm_mode=nm)
        self.conv3 = ContextFreeBlock(d * 4, d * 4, 5, stride=2, norm_mode=nm)
        self.attn_fc = nn.Linear(d * 4, d * 4)
        self.t0 = ContextFreeBlock(d * 4, d * 4, 7, groups=8, bias=True, norm_mode=nm)
        self.t1 = ContextFreeBlock(d * 4, d * 4, 3, groups=8, bias=True, norm_mode=nm)
        self.s0 = ContextFreeBlock(d * 4, d * 12, 1, groups=8, bias=True, norm_mode=nm)
        self.s1 = ContextFreeBlock(d * 12, d * 4, 1, groups=8, bias=True, norm_mode=nm)
        self.fusion = ContextFreeBlock(d * 8, d * 4, 1, bias=True, norm_mode=nm)
        self.last0 = nn.Linear(d * 4, d * 8)
        self.last1 = nn.Linear(d * 8, 1)

    def forward(self, audio: torch.Tensor) -> List[torch.Tensor]:
        return remat_call(self.remat, self._scores, audio)

    def _scores(self, audio: torch.Tensor) -> List[torch.Tensor]:
        b, t = audio.shape
        if t < self.WIN:  # the JAX gather clamps past the end: edge samples
            audio = F.pad(audio[:, None], (0, self.WIN - t), mode="replicate")[:, 0]
        n_win = max((t - self.WIN) // self.STEP + 1, 1)
        # overlapping windows -> (B * n_win, 1, WIN)
        x = audio[:, : (n_win - 1) * self.STEP + self.WIN].unfold(-1, self.WIN, self.STEP)
        x = x.reshape(b * n_win, 1, self.WIN)
        for name in ("conv0", "conv1", "conv2", "conv3"):
            x = getattr(self, name)(x)
        # SE attention over channels
        attn = self.attn_fc(x.mean(dim=2))
        x = x * torch.sigmoid(attn)[:, :, None]
        temporal = self.t1(self.t0(x))
        spectral = self.s1(self.s0(x))
        x = self.fusion(torch.cat([temporal, spectral], dim=1))
        x = self.last1(torch.relu(self.last0(x.transpose(1, 2))))  # (N, T', 1)
        return [x.reshape(b, -1)]


class PitchDiscriminator(nn.Module):
    """(B, in_channels, T) prosody curves -> 5 score tensors (B, T)."""

    N_LAYERS = 5

    def __init__(self, in_channels: int, dim_hidden: int = 64, kernel: int = 21):
        super().__init__()
        for i in range(self.N_LAYERS):
            self.add_module(f"conv_{i}", Conv1d(in_channels if i == 0 else dim_hidden,
                                                dim_hidden, kernel))
            self.add_module(f"out_{i}", Conv1d(dim_hidden, 1, kernel))

    def forward(self, y: torch.Tensor) -> List[torch.Tensor]:
        x = y
        results = []
        for i in range(self.N_LAYERS):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), 0.1)
            results.append(getattr(self, f"out_{i}")(x).flatten(1))
        return results


class PeriodDiscriminator(nn.Module):
    """Audio (B, T) -> (score (B, N), feature maps (B, C, T/p, p))."""

    CHANNELS = (32, 128, 512, 1024)
    FLAX_NAMES = {f"conv_{i}": f"Conv_{i}" for i in range(len(CHANNELS) + 2)}

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        in_ch = 1
        for i, ch in enumerate(self.CHANNELS):
            self.add_module(f"conv_{i}", nn.Conv2d(in_ch, ch, (kernel_size, 1), (stride, 1),
                                                   padding=(2, 0)))
            in_ch = ch
        n = len(self.CHANNELS)
        self.add_module(f"conv_{n}", nn.Conv2d(in_ch, in_ch, (kernel_size, 1), padding=(2, 0)))
        self.add_module(f"conv_{n + 1}", nn.Conv2d(in_ch, 1, (3, 1), padding=(1, 0)))

    def forward(self, audio: torch.Tensor):
        b, t = audio.shape
        pad = (self.period - t % self.period) % self.period
        x = F.pad(audio[:, None], (0, pad), mode="reflect").reshape(b, 1, -1, self.period)
        fmap = []
        n = len(self.CHANNELS)
        for i in range(n + 1):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), 0.1)
            fmap.append(x)
        x = getattr(self, f"conv_{n + 1}")(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """Audio (B, T) -> (the periods' scores concatenated, all feature maps)."""

    def __init__(self, periods=(2, 3, 5, 7, 11)):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"period_{p}", PeriodDiscriminator(p))

    def forward(self, audio: torch.Tensor):
        scores, fmaps = [], []
        for p in self.periods:
            score, fmap = getattr(self, f"period_{p}")(audio)
            scores.append(score)
            fmaps.extend(fmap)
        return torch.cat(scores, dim=1), fmaps
