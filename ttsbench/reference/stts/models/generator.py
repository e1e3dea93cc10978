"""FreeGAN vocoder: harmonic-prior amplitude/phase iSTFT generator.

Counterpart of ``stylish_tts_tpu/models/generator.py`` (``SineSource``,
``Generator``, ``MultiGenerator``; ``type="freegan"``, the unrolled
parameter layout):

  input conv + LayerNorm + style Conformer over the decoder's features
  -> amplitude trunk: ConvNeXt stack + pixel-shuffle upsampling x[3,5,5]
  -> harmonic prior: sine source from F0, edge-padded STFT to magnitude
     and phase at the head resolution (n_fft/8, hop/75)
  -> phase branch: [amplitude features ++ priors] -> ConvNeXt stack ->
     real/imag convs -> atan2
  -> iSTFT head (uniform 1/n_fft scaling, no window normalisation) -> tanh.

The sine source draws its initial phases and noise from one
``torch.Generator`` per batch row (so a row's audio does not depend on the
batch around it; synthesis), from one generator for the whole batch
(training), or from the global generator when given none;
``deterministic_prior`` zeroes both, and ``prior`` injects a precomputed
excitation (no two frameworks share an RNG stream). ``source_draws``
carries the draws already made (``SineSource.draw``: the same numbers the
generators would give, in the same order), so that a captured CUDA graph
or an exported program takes them as an input. The excitation is a
constant of the backward pass (stop-gradient, as in JAX), and the head's
atan2, exp and iSTFT run in float32 under mixed precision. In ``train()``
mode the conformer's dropout (0.2) draws from ``dropout_generator``.
Its phase is a float32 cumulative sum over frames times 2*pi*hop, which
reaches ~1.7e5 rad at 1000 frames, where one float32 ulp is 0.016 rad:
two implementations that sum in another order differ by that much.

``generator.remat`` (``Generator(remat=True)``) rematerialises each
``amp_convnext_i``, ``upblock_i`` and ``phase_convnext_i`` call in the
backward (``common.remat_call``), the blocks that the JAX ``nn.remat``
wraps; the call is made inside ``forward``, so the ``state_dict`` keys do
not change. Without autograd (synthesis, validation) nothing changes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..config import GeneratorConfig
from ..dsp import stft as stft_lib
from .common import AdaptiveGeneratorBlock, ChannelLayerNorm, Conv1d, remat_call
from .conformer import Conformer
from .convnext import GeneratorConvNeXtBlock


SourceGenerator = Optional[Union[torch.Generator, Sequence[torch.Generator]]]


class SourceDraws(NamedTuple):
    """The random numbers a harmonic source consumes: the initial phases
    (B, n_harm) (the ringformer's pcph: (B, 1)) and the FreeGAN sine
    source's noise (B, n_harm, frames * hop)."""

    rand_ini: torch.Tensor
    noise: Optional[torch.Tensor] = None


def _draw(fn, shape, generator: SourceGenerator, device) -> torch.Tensor:
    """``fn(shape)`` row by row, one generator per row; or from one
    generator (or the global one) for the whole batch."""
    if generator is None or isinstance(generator, torch.Generator):
        return fn(shape, generator=generator, device=device)
    return torch.stack([fn(shape[1:], generator=g, device=device) for g in generator])


class DecoderPrediction(NamedTuple):
    audio: torch.Tensor  # (B, T_samples)
    magnitude: Optional[torch.Tensor] = None  # (B, freq, frames) log-amplitude
    phase: Optional[torch.Tensor] = None  # (B, freq, frames)


def linear_resize(x: torch.Tensor, new_len: int) -> torch.Tensor:
    """Linear interpolation along the last axis of (B, C, T), half-pixel
    centres (``jax.image.resize(method="linear", antialias=False)``)."""
    return F.interpolate(x, size=new_len, mode="linear", align_corners=False)


class SineSource(nn.Module):
    """Hn-NSF harmonic sine source: F0 (B, frames) -> excitation
    (B, frames * hop)."""

    def __init__(self, sample_rate: int, hop_length: int, harmonic_num: int = 8,
                 sine_amp: float = 0.1, noise_std: float = 0.003,
                 voiced_threshold: float = 10.0):
        super().__init__()
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.n_harm = harmonic_num + 1
        self.sine_amp = sine_amp
        self.noise_std = noise_std
        self.voiced_threshold = voiced_threshold
        self.merge = nn.Linear(self.n_harm, 1)

    def draw(self, batch: int, frames: int, generator: SourceGenerator,
             device) -> SourceDraws:
        """The initial phases (the fundamental's zeroed) and the noise of
        ``batch`` rows of ``frames`` frames, drawn from ``generator`` in the
        order ``forward`` draws them."""
        rand_ini = _draw(torch.rand, (batch, self.n_harm), generator, device)
        rand_ini[:, 0] = 0.0
        noise = _draw(torch.randn, (batch, self.n_harm, frames * self.hop_length),
                      generator, device)
        return SourceDraws(rand_ini, noise)

    def forward(self, f0: torch.Tensor, generator: SourceGenerator,
                deterministic: bool = False,
                draws: SourceDraws | None = None) -> torch.Tensor:
        b, frames = f0.shape
        source_len = frames * self.hop_length
        harmonics = torch.arange(1, self.n_harm + 1, dtype=torch.float32, device=f0.device)
        rad = torch.remainder(f0[:, None, :] * harmonics[None, :, None] / self.sample_rate,
                              1.0)  # (B, n_harm, frames)
        if deterministic:
            rand_ini = torch.zeros((b, self.n_harm), device=f0.device)
        else:
            if draws is None:
                draws = self.draw(b, frames, generator, f0.device)
            rand_ini = draws.rand_ini
        # integrate at frame rate, then linearly upsample the phase
        phase = torch.cumsum(rad, dim=-1) * (2.0 * math.pi * self.hop_length)
        phase = linear_resize(phase, source_len) + (rand_ini * 2.0 * math.pi)[:, :, None]
        sines = torch.sin(phase) * self.sine_amp
        uv = linear_resize((f0 > self.voiced_threshold).to(torch.float32)[:, None, :],
                           source_len)
        sines = sines * uv
        if not deterministic:
            noise_amp = uv * self.noise_std + (1.0 - uv) * self.sine_amp / 3.0
            sines = sines + noise_amp * draws.noise
        return torch.tanh(self.merge(sines.transpose(1, 2)))[..., 0]


def pixel_shuffle_1d(h: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, C*stride, T) -> (B, C, T*stride), channel index c*stride + s."""
    b, cs, t = h.shape
    return (h.reshape(b, cs // stride, stride, t).transpose(2, 3)
            .reshape(b, cs // stride, t * stride))


class Generator(nn.Module):
    """Amplitude/phase iSTFT head generator."""

    def __init__(self, style_dim: int, n_fft: int, hop_length: int, sample_rate: int,
                 scale: int, scalehop: int, start_fft: int, hidden_dim: int,
                 input_dim: int, io_conv_kernel_size: int, conv_layers: int,
                 upsample_rates: Sequence[int], remat: bool = False):
        super().__init__()
        self.remat = remat
        self.head_fft = n_fft // scale
        self.head_hop = hop_length // scalehop
        self.start_fft = start_fft
        self.hidden_dim = hidden_dim
        self.upsample_rates = tuple(upsample_rates)
        self.amp_layers = conv_layers - len(self.upsample_rates)
        self.conv_layers = conv_layers
        k = io_conv_kernel_size
        self.source = SineSource(sample_rate, hop_length, harmonic_num=8,
                                 voiced_threshold=10.0)
        self.amp_prior_conv = Conv1d(hidden_dim, hidden_dim, k)
        self.amp_prior_block = AdaptiveGeneratorBlock(hidden_dim, style_dim, kernel_size=11)
        self.phase_prior_conv = Conv1d(hidden_dim, hidden_dim, k)
        self.phase_prior_block = AdaptiveGeneratorBlock(hidden_dim, style_dim, kernel_size=11)
        dim = input_dim
        for i in range(self.amp_layers):
            self.add_module(f"amp_convnext_{i}",
                            GeneratorConvNeXtBlock(dim, dim * 4, style_dim))
        for i, stride in enumerate(self.upsample_rates):
            out_dim = dim // 2
            self.add_module(f"upconv_{i}", Conv1d(dim, out_dim * stride, 11))
            self.add_module(f"upblock_{i}",
                            GeneratorConvNeXtBlock(out_dim, out_dim * 4, style_dim))
            dim = out_dim
        self.amp_final_norm = ChannelLayerNorm(dim)
        self.amp_output_conv = Conv1d(dim, hidden_dim, k)
        self.phase_input_conv = Conv1d(dim + 2 * hidden_dim, hidden_dim, k)
        self.phase_norm = ChannelLayerNorm(hidden_dim)
        for i in range(conv_layers):
            self.add_module(f"phase_convnext_{i}", GeneratorConvNeXtBlock(
                hidden_dim, hidden_dim * 4, style_dim))
        self.phase_final_norm = ChannelLayerNorm(hidden_dim)
        self.phase_real_conv = Conv1d(hidden_dim, hidden_dim, k)
        self.phase_imag_conv = Conv1d(hidden_dim, hidden_dim, k)

    def _block(self, name: str, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        return remat_call(self.remat, getattr(self, name), x, style)

    def forward(self, mel: torch.Tensor, style: torch.Tensor, pitch: torch.Tensor,
                voiced: torch.Tensor, *, generator: SourceGenerator = None,
                prior: torch.Tensor | None = None,
                deterministic_prior: bool = False,
                source_draws: SourceDraws | None = None) -> torch.Tensor:
        """mel (B, input_dim, frames); pitch, voiced (B, frames) ->
        audio (B, frames * hop) before the tanh."""
        if prior is None:
            prior = self.source(pitch * voiced, generator, deterministic_prior,
                                source_draws)
        prior = prior.detach()
        end = self.start_fft + self.hidden_dim
        har_mag, har_x, har_y = stft_lib.stft_magnitude_unit_phase(
            prior, self.head_fft, self.head_hop, self.head_fft, center=True,
            pad_mode="edge")
        har_phase = torch.atan2(har_y * har_mag, har_x * har_mag)
        # select the head band, strip the trailing frame: (B, hidden, frames')
        har_spec = har_mag[:, self.start_fft:end, :-1]
        har_phase = har_phase[:, self.start_fft:end, :-1]
        logamp_prior = self.amp_prior_block(self.amp_prior_conv(har_spec), style)
        phase_prior = self.phase_prior_block(self.phase_prior_conv(har_phase), style)

        x = mel
        for i in range(self.amp_layers):
            x = self._block(f"amp_convnext_{i}", x, style)
        for i, stride in enumerate(self.upsample_rates):
            x = pixel_shuffle_1d(getattr(self, f"upconv_{i}")(x), stride)
            x = self._block(f"upblock_{i}", x, style)

        logamp = self.amp_output_conv(self.amp_final_norm(x))
        phase = self.phase_input_conv(torch.cat([x, logamp_prior, phase_prior], dim=1))
        phase = self.phase_norm(phase)
        for i in range(self.conv_layers):
            phase = self._block(f"phase_convnext_{i}", phase, style)
        phase = self.phase_final_norm(phase)
        phase = torch.atan2(self.phase_imag_conv(phase).float(),
                            self.phase_real_conv(phase).float())

        # replicate-pad one trailing frame (matches the stripped prior frame)
        logamp = torch.cat([logamp, logamp[:, :, -1:]], dim=2)
        phase = torch.cat([phase, phase[:, :, -1:]], dim=2)
        spec = torch.exp(torch.clamp(logamp.float(), -35.0, 35.0))
        # the band fills bins [start, end) of n_fft/2 + 1; the rest is zero
        pad = (0, 0, self.start_fft, self.head_fft // 2 + 1 - end)
        real = F.pad(spec * torch.cos(phase), pad)
        imag = F.pad(spec * torch.sin(phase), pad)
        return stft_lib.istft(real, imag, self.head_fft, self.head_hop, self.head_fft,
                              center=True, normalize_window=False, uniform_scale=True)


class MultiGenerator(nn.Module):
    """Conformer front end + base generator, width n_fft // 2. ``in_dim`` is
    the decoder's width (``generator.input_dim`` is not read, as in JAX)."""

    def __init__(self, in_dim: int, style_dim: int, n_fft: int, hop_length: int,
                 sample_rate: int, config: GeneratorConfig,
                 norm_mode: str | None = None):
        super().__init__()
        hidden_dim = n_fft // 2
        k = config.io_conv_kernel_size
        self.amp_input_conv = Conv1d(in_dim, hidden_dim, k)
        self.amp_norm = ChannelLayerNorm(hidden_dim)
        self.amp_conformer = Conformer(hidden_dim, config.conformer_layers, style_dim,
                                       norm_mode=norm_mode or config.norm_mode,
                                       dropout=0.2)
        self.basegen = Generator(
            style_dim=style_dim, n_fft=n_fft, hop_length=hop_length,
            sample_rate=sample_rate, scale=8, scalehop=75, start_fft=0,
            hidden_dim=n_fft // 2 // 8, input_dim=hidden_dim,
            io_conv_kernel_size=k, conv_layers=config.conv_layers,
            upsample_rates=(3, 5, 5), remat=config.remat)

    def forward(self, *, mel: torch.Tensor, style: torch.Tensor, pitch: torch.Tensor,
                voiced: torch.Tensor, generator: SourceGenerator = None,
                prior: torch.Tensor | None = None,
                deterministic_prior: bool = False,
                dropout_generator: torch.Generator | None = None,
                source_draws: SourceDraws | None = None) -> DecoderPrediction:
        x = self.amp_norm(self.amp_input_conv(mel))
        x = self.amp_conformer(x, style, generator=dropout_generator)
        audio = self.basegen(x, style, pitch, voiced, generator=generator, prior=prior,
                             deterministic_prior=deterministic_prior,
                             source_draws=source_draws)
        return DecoderPrediction(audio=torch.tanh(audio))

    def draw_sources(self, batch: int, frames: int, generator: SourceGenerator,
                     device) -> SourceDraws:
        """The sine source's draws for ``batch`` rows of ``frames`` frames."""
        return self.basegen.source.draw(batch, frames, generator, device)
