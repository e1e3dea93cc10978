"""SpeechPredictor: TextEncoder -> Decoder -> MultiGenerator.

Counterpart of ``stylish_tts_tpu/models/speech_predictor.py`` (the
FreeGAN generator; ``ringformer`` is not ported yet): the text encoding is
projected to frame rate through the soft alignment, decoded with the
prosody curves, and vocoded.

In ``train()`` mode (the acoustic stage) ``dropout_generator`` feeds the
text encoder's and the conformer's dropout, and ``generator`` the
decoder's box smoothing and the sine source, as the JAX ``rngs`` /
``rng`` pair does.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from .decoder import Decoder
from .generator import DecoderPrediction, MultiGenerator, SourceGenerator
from .text_encoder import TextEncoder


class SpeechPredictor(nn.Module):
    def __init__(self, model_config: ModelConfig, norm_mode: str | None = None):
        super().__init__()
        mc = model_config
        if mc.generator.type != "freegan":
            raise NotImplementedError(
                f"generator type {mc.generator.type!r} is not ported (only 'freegan')")
        self.text_encoder = TextEncoder(mc.inter_dim, mc.text_encoder)
        self.decoder = Decoder(mc.inter_dim, mc.style_dim, mc.decoder.hidden_dim,
                               mc.decoder.residual_dim)
        self.generator = MultiGenerator(
            mc.decoder.hidden_dim, mc.style_dim, mc.n_fft, mc.hop_length,
            mc.sample_rate, mc.generator, norm_mode=norm_mode)

    def forward(self, texts: torch.Tensor, text_lengths: torch.Tensor,
                alignment: torch.Tensor, pitch: torch.Tensor, energy: torch.Tensor,
                voiced: torch.Tensor, style: torch.Tensor,
                denormal_pitch: torch.Tensor, *,
                generator: SourceGenerator = None,
                prior: torch.Tensor | None = None,
                deterministic_prior: bool = False,
                dropout_generator: torch.Generator | None = None) -> DecoderPrediction:
        """texts (B, T_text); alignment (B, T_text, T_frames); curves
        (B, T_frames); style (B, style_dim) -> audio (B, T_frames * hop)."""
        text_encoding, _, _ = self.text_encoder(texts, text_lengths, dropout_generator)
        asr = torch.bmm(text_encoding, alignment)  # (B, inter_dim, T_frames)
        smooth = generator if isinstance(generator, torch.Generator) else None
        mel = self.decoder(asr, pitch, energy, style, voiced, generator=smooth)
        return self.generator(mel=mel, style=style, pitch=denormal_pitch, voiced=voiced,
                              generator=generator, prior=prior,
                              deterministic_prior=deterministic_prior,
                              dropout_generator=dropout_generator)
