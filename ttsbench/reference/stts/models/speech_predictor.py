"""SpeechPredictor: TextEncoder -> Decoder -> generator.

Counterpart of ``stylish_tts_tpu/models/speech_predictor.py``: the text
encoding is projected to frame rate through the soft alignment, decoded
with the prosody curves, and vocoded by the FreeGAN ``MultiGenerator``
(``generator.type: freegan``) or the ringformer ``UpsampleGenerator``
(``ringformer``).

In ``train()`` mode (the acoustic stage) ``dropout_generator`` feeds the
text encoder's and the conformers' dropout, and ``generator`` the
decoder's box smoothing and the harmonic source (the sine source, or the
ringformer's pcph phase), as the JAX ``rngs`` / ``rng`` pair does. JAX
ignores ``prior`` and ``deterministic_prior`` for the ringformer; the port
passes both on (an injected prior for parity runs, zero initial phase).
``source_draws`` hands either source its random numbers already drawn
(``draw_sources``), in place of ``generator``'s draws.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from .decoder import Decoder
from .generator import DecoderPrediction, MultiGenerator, SourceDraws, SourceGenerator
from .ringformer import UpsampleGenerator
from .text_encoder import TextEncoder


class SpeechPredictor(nn.Module):
    def __init__(self, model_config: ModelConfig, norm_mode: str | None = None):
        super().__init__()
        mc = model_config
        gc = mc.generator
        if gc.type not in ("freegan", "ringformer"):
            raise NotImplementedError(
                f"generator type {gc.type!r} is not ported ('freegan' or 'ringformer')")
        self.text_encoder = TextEncoder(mc.inter_dim, mc.text_encoder)
        self.decoder = Decoder(mc.inter_dim, mc.style_dim, mc.decoder.hidden_dim,
                               mc.decoder.residual_dim)
        if gc.type == "ringformer":
            self.generator = UpsampleGenerator(
                mc.decoder.hidden_dim, mc.style_dim,
                resblock_kernel_sizes=tuple(gc.resblock_kernel_sizes),
                upsample_rates=tuple(gc.upsample_rates),
                upsample_initial_channel=gc.upsample_initial_channel,
                resblock_dilation_sizes=tuple(tuple(d) for d in gc.resblock_dilation_sizes),
                gen_istft_n_fft=gc.gen_istft_n_fft, gen_istft_hop_size=gc.gen_istft_hop_size,
                sample_rate=mc.sample_rate, conformer_depth=gc.depth)
        else:
            self.generator = MultiGenerator(
                mc.decoder.hidden_dim, mc.style_dim, mc.n_fft, mc.hop_length,
                mc.sample_rate, gc, norm_mode=norm_mode)

    def forward(self, texts: torch.Tensor, text_lengths: torch.Tensor,
                alignment: torch.Tensor, pitch: torch.Tensor, energy: torch.Tensor,
                voiced: torch.Tensor, style: torch.Tensor,
                denormal_pitch: torch.Tensor, *,
                generator: SourceGenerator = None,
                prior: torch.Tensor | None = None,
                deterministic_prior: bool = False,
                dropout_generator: torch.Generator | None = None,
                source_draws: SourceDraws | None = None) -> DecoderPrediction:
        """texts (B, T_text); alignment (B, T_text, T_frames); curves
        (B, T_frames); style (B, style_dim) -> audio (B, T_frames * hop)
        (and the ringformer head's log-amplitude and phase)."""
        text_encoding, _, _ = self.text_encoder(texts, text_lengths, dropout_generator)
        asr = torch.bmm(text_encoding, alignment)  # (B, inter_dim, T_frames)
        smooth = generator if isinstance(generator, torch.Generator) else None
        mel = self.decoder(asr, pitch, energy, style, voiced, generator=smooth)
        return self.generator(mel=mel, style=style, pitch=denormal_pitch, voiced=voiced,
                              generator=generator, prior=prior,
                              deterministic_prior=deterministic_prior,
                              dropout_generator=dropout_generator,
                              source_draws=source_draws)

    def draw_sources(self, batch: int, frames: int, generator: SourceGenerator,
                     device) -> SourceDraws:
        """The harmonic source's random numbers for ``batch`` rows of
        ``frames`` frames (the pitch curve's length), drawn from
        ``generator`` exactly as ``forward`` would draw them from it."""
        return self.generator.draw_sources(batch, frames, generator, device)
