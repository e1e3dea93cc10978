"""Ringformer vocoder: conformer-interleaved upsampling + iSTFT head.

Counterpart of ``stylish_tts_tpu/models/ringformer.py`` (``generate_pcph``,
``TransposeConv1d``, ``UpsampleGenerator``; ``generator.type:
ringformer``), over (B, C, T):

  per scale i: snake (``alpha_i``) -> style Conformer (``conformer_i``,
  dropout 0.1) -> upsample (``up_i``) -> + the harmonic prior's STFT
  brought to this rate by a strided conv (``noise_conv_i``) and an AdaIN
  resblock (``noise_res_i``) -> mean of the multi-kernel resblocks
  (``resblock_i_j``)
  -> snake (``alpha_post``) -> ``conv_post`` to log-amplitude and phase
  -> exp / cos / sin -> iSTFT with the window-envelope normalisation.

Two modes, as in JAX. The default is the redesign: a dense expansion +
pixel shuffle (s-major: channel index s * C + c) for ``up_i``, edge-padded
prior STFT, the prior branch cut to the trunk's length, and a ``tanh`` on
the audio. ``faithful=True`` is the reference's exact forward: a real
transposed conv, reflect padding, the last scale's (1, 0) reflection pad on
the prior branch, the conformer's frozen affine norm, and no ``tanh``.

The prior is the pseudo-constant-power harmonic excitation (pcph). Its
initial phase is drawn per batch row from the row's ``torch.Generator``
(one generator: one draw per row from it), so that a row's audio does not
depend on the batch around it; JAX draws one scalar for the whole batch
(ROADMAP Queue 3). Without a generator, or with ``deterministic_prior``,
the phase starts at zero. ``source_draws`` carries that phase already
drawn (``UpsampleGenerator.draw_sources``), for a captured CUDA graph or an
exported program. The head's exp / cos / sin and the iSTFT run in
float32 under mixed precision.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..dsp import stft as stft_lib
from .common import AdaptiveGeneratorBlock, Conv1d, channel_param, snake
from .conformer import Conformer
from .generator import DecoderPrediction, SourceDraws, SourceGenerator, _draw

MAX_HARMONICS = 16


def generate_pcph(f0: torch.Tensor, voiced: torch.Tensor, hop_length: int,
                  sample_rate: int, generator: SourceGenerator = None,
                  power_factor: float = 0.1,
                  rand_ini: torch.Tensor | None = None) -> torch.Tensor:
    """F0 (B, frames) Hz and voicing (B, frames) -> (B, frames * hop) masked
    harmonics (up to 16, none above Nyquist) of amplitude
    power_factor * sqrt(2 / n_harm).

    The phase is constant in radians per sample within a frame, so the
    audio-rate cumulative sum is the frame-rate one times the hop plus an
    in-frame ramp that starts at 1 (the reference's sum includes the
    current sample). ``rand_ini`` (B, 1) is the initial phase in cycles,
    else it is drawn from ``generator``; ``generator=None``: zero."""
    b, frames = f0.shape
    f0 = f0.to(torch.float32)
    device = f0.device
    vuv = torch.round(voiced.to(torch.float32))
    idx = torch.arange(1, MAX_HARMONICS + 1, dtype=torch.float32, device=device)[None, :, None]
    harmonic_f0 = f0[:, None, :] * idx  # (B, H, frames)
    harmonic_mask = (harmonic_f0 <= sample_rate / 2.0).to(torch.float32)
    n_harm = torch.clamp_min(
        vuv[:, None, :] * torch.sum(harmonic_mask, dim=1, keepdim=True), 1.0)
    amplitude = vuv[:, None, :] * power_factor * torch.sqrt(2.0 / n_harm)

    rad = f0 / sample_rate  # cycles per sample, (B, frames)
    if rand_ini is None:
        rand_ini = (torch.zeros((b, 1), device=device) if generator is None
                    else _draw(torch.rand, (b, 1), generator, device))
    cum_start = torch.cumsum(rad, dim=1) - rad + rand_ini  # cycles at each frame start / hop
    ramp = torch.arange(1, hop_length + 1, dtype=torch.float32, device=device)[None, None, :]
    cycles = cum_start[:, :, None] * hop_length + rad[:, :, None] * ramp
    cycles = cycles.reshape(b, 1, frames * hop_length)
    harmonics = torch.sin(2.0 * math.pi * cycles * idx)  # (B, H, T)
    harmonics = harmonics * torch.repeat_interleave(harmonic_mask, hop_length, dim=2)
    return (torch.sum(harmonics, dim=1)
            * torch.repeat_interleave(amplitude, hop_length, dim=2)[:, 0])


class TransposeConv1d(nn.Conv1d):
    """torch ``ConvTranspose1d(stride, kernel, padding)`` over (B, C, T),
    for the faithful mode. Its weight is the JAX kernel: stored pre-flipped
    in the regular-conv layout (the flax (k, in, out), here (out, in, k)),
    so that the weight bridge's conv rule carries it unchanged. Output
    length (T - 1) * stride + kernel - 2 * padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int):
        super().__init__(in_channels, out_channels, kernel_size)
        self.up_stride = stride
        self.up_padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the lhs-dilated conv with kernel K is the transposed conv with K
        # flipped along time and its in/out axes swapped
        weight = self.weight.transpose(0, 1).flip(-1)
        return F.conv_transpose1d(x, weight, self.bias, stride=self.up_stride,
                                  padding=self.up_padding)


def pixel_shuffle_s_major(h: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, stride*C, T) -> (B, C, T*stride), channel index s*C + c (the JAX
    ringformer's ``reshape(b, t, rate, C)``)."""
    b, cs, t = h.shape
    return (h.reshape(b, stride, cs // stride, t).permute(0, 2, 3, 1)
            .reshape(b, cs // stride, t * stride))


class UpsampleGenerator(nn.Module):
    """The ringformer vocoder; ``in_dim`` is the decoder's width."""

    def __init__(self, in_dim: int, style_dim: int,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 upsample_rates: Sequence[int] = (4, 5),
                 upsample_initial_channel: int = 256,
                 resblock_dilation_sizes: Sequence[Sequence[int]] = (
                     (1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 gen_istft_n_fft: int = 60, gen_istft_hop_size: int = 15,
                 sample_rate: int = 24000, conformer_depth: int = 2,
                 faithful: bool = False,
                 upsample_kernel_sizes: Sequence[int] | None = None):
        super().__init__()
        self.upsample_rates = tuple(upsample_rates)
        self.n_kernels = len(resblock_kernel_sizes)
        self.n_fft = gen_istft_n_fft
        self.hop = gen_istft_hop_size
        self.sample_rate = sample_rate
        self.faithful = faithful
        self.prior_hop = int(math.prod(self.upsample_rates) * gen_istft_hop_size)
        n_up = len(self.upsample_rates)
        har_ch = gen_istft_n_fft + 2
        dim = in_dim
        for i, rate in enumerate(self.upsample_rates):
            setattr(self, f"alpha_{i}", channel_param(dim, 1.0))
            self.add_module(f"conformer_{i}", Conformer(
                dim, conformer_depth, style_dim,
                norm_mode="affine" if faithful else "group", dropout=0.1))
            out_ch = upsample_initial_channel // (2 ** (i + 1))
            if faithful:
                k_up = (upsample_kernel_sizes[i] if upsample_kernel_sizes is not None
                        else rate * 2)
                up = TransposeConv1d(dim, out_ch, k_up, rate, (k_up - rate) // 2)
            else:
                up = Conv1d(dim, out_ch * rate, rate * 2)
            self.add_module(f"up_{i}", up)
            stride_f0 = int(math.prod(self.upsample_rates[i + 1:]))
            if stride_f0 > 1:
                noise_conv = nn.Conv1d(har_ch, out_ch, stride_f0 * 2, stride=stride_f0,
                                       padding=(stride_f0 + 1) // 2)
            else:
                noise_conv = nn.Conv1d(har_ch, out_ch, 1)
            self.add_module(f"noise_conv_{i}", noise_conv)
            self.add_module(f"noise_res_{i}", AdaptiveGeneratorBlock(
                out_ch, style_dim, kernel_size=7 if i + 1 < n_up else 11))
            for j, (k, d) in enumerate(zip(resblock_kernel_sizes, resblock_dilation_sizes)):
                self.add_module(f"resblock_{i}_{j}", AdaptiveGeneratorBlock(
                    out_ch, style_dim, kernel_size=k, dilations=tuple(d)))
            dim = out_ch
        self.alpha_post = channel_param(dim, 1.0)
        self.conv_post = Conv1d(dim, gen_istft_n_fft + 2, 7)

    def forward(self, *, mel: torch.Tensor, style: torch.Tensor, pitch: torch.Tensor,
                voiced: torch.Tensor, generator: SourceGenerator = None,
                prior: torch.Tensor | None = None, deterministic_prior: bool = False,
                dropout_generator: torch.Generator | None = None,
                source_draws: SourceDraws | None = None) -> DecoderPrediction:
        """mel (B, in_dim, frames); pitch (Hz), voiced (B, frames) ->
        audio (B, frames * prod(upsample_rates) * hop) and the head's
        log-amplitude and phase (B, n_fft // 2 + 1, frames').

        ``prior`` (B, samples) replaces the pcph excitation: a harmonic
        prior's near-zero STFT bins make its atan2 phase pure round-off,
        which no two STFT implementations share."""
        frames = mel.shape[2]
        if prior is None:
            drawn = None if deterministic_prior or source_draws is None \
                else source_draws.rand_ini
            prior = generate_pcph(pitch, voiced, self.prior_hop, self.sample_rate,
                                  None if deterministic_prior else generator,
                                  rand_ini=drawn)
        prior = prior.detach()
        har_mag, har_x, har_y = stft_lib.stft_magnitude_unit_phase(
            prior, self.n_fft, self.hop, self.n_fft, center=True,
            pad_mode="reflect" if self.faithful else "edge")
        har_phase = torch.atan2(har_y * har_mag, har_x * har_mag)
        har = torch.cat([har_mag[:, :, :-1], har_phase[:, :, :-1]], dim=1)

        x = mel
        n_up = len(self.upsample_rates)
        for i, rate in enumerate(self.upsample_rates):
            x = snake(x, getattr(self, f"alpha_{i}"))
            x = getattr(self, f"conformer_{i}")(x, style, generator=dropout_generator)
            x = getattr(self, f"up_{i}")(x)
            if not self.faithful:
                x = pixel_shuffle_s_major(x, rate)
            xs = getattr(self, f"noise_conv_{i}")(har)
            if self.faithful and i + 1 == n_up:
                xs = torch.cat([xs[:, :, 1:2], xs], dim=2)  # ReflectionPad1d((1, 0))
            if not self.faithful:
                xs = xs[:, :, :x.shape[2]]
            xs = getattr(self, f"noise_res_{i}")(xs, style)
            if self.faithful:
                assert x.shape[2] == xs.shape[2], (x.shape, xs.shape)
                x = x + xs
            else:
                n = min(x.shape[2], xs.shape[2])
                x = x[:, :, :n] + xs[:, :, :n]
            acc = None
            for j in range(self.n_kernels):
                y = getattr(self, f"resblock_{i}_{j}")(x, style)
                acc = y if acc is None else acc + y
            x = acc / self.n_kernels

        x = self.conv_post(snake(x, self.alpha_post))
        half = self.n_fft // 2 + 1
        logamp = x[:, :half].float()
        phase = x[:, half:].float()
        spec = torch.exp(torch.clamp(logamp, -35.0, 35.0))
        audio = stft_lib.istft(spec * torch.cos(phase), spec * torch.sin(phase),
                               self.n_fft, self.hop, self.n_fft, center=True,
                               normalize_window=True, length=frames * self.prior_hop)
        return DecoderPrediction(audio=audio if self.faithful else torch.tanh(audio),
                                 magnitude=logamp, phase=phase)

    def draw_sources(self, batch: int, frames: int, generator: SourceGenerator,
                     device) -> SourceDraws:
        """The pcph's initial phase for ``batch`` rows, as ``generate_pcph``
        draws it from ``generator`` (zero without one); ``frames`` does not
        change it."""
        if generator is None:
            return SourceDraws(torch.zeros((batch, 1), device=device))
        return SourceDraws(_draw(torch.rand, (batch, 1), generator, device))
