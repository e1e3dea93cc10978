"""The reference of a synthesised line: the fused path of the program's
inference package (durations on the text bucket, the squeeze into the
frame bucket that the duration statistics pick, the acoustic phase with
the harmonic source drawn from a generator seeded 0 per row), eagerly,
then the -25 LUFS normalisation.

The buckets are part of the function (AdaIN statistics run over all frames
of the bucket and the alignment softmax over all text rows), so the
reference computes at the bucket the package's rules give; the copies of
those rules are below.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import precision
from .stts.models import INFERENCE_MODULES
from .stts.ops.duration import DurationProcessor
from .stts.tts.loudness import normalize_loudness
from .train import make_models, model_config

TEXT_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512)
FRAME_BUCKET_STEP = 100
SOURCE_SEED = 0
LUFS_TARGET = -25.0


def text_bucket(n: int) -> int:
    for b in TEXT_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"text too long for inference buckets: {n}")


def frame_bucket(total_frames: int) -> int:
    return max(-(-total_frames // FRAME_BUCKET_STEP) * FRAME_BUCKET_STEP, FRAME_BUCKET_STEP)


def fused_frames(n_tokens: int, frames_per_token_p95: float, speed: float = 1.0) -> int:
    return frame_bucket(int(math.ceil(n_tokens * frames_per_token_p95 / speed)))


class Synthesizer:
    """The six inference modules from the seed's weights on ``device``
    (``config``: a configuration file's contents)."""

    def __init__(self, config: dict, device, seed: int):
        model = config["model"]
        self.mc = model_config(model)
        self.device = torch.device(device)
        models, _ = make_models(model, self.device, seed, config["f0_bias_hz"],
                                with_wavlm=False,
                                duration_head=config.get("duration_head"))
        self.models = {k: models[k].eval() for k in INFERENCE_MODULES}
        self.dp = DurationProcessor(self.mc.duration_predictor.duration_classes,
                                    self.mc.duration_predictor.max_duration)
        self.p95 = config["duration_stats"]["frames_per_token_p95"]

    def tensors(self, tokens: np.ndarray):
        L = text_bucket(tokens.shape[0])
        texts = torch.zeros((1, L), dtype=torch.long, device=self.device)
        texts[0, :tokens.shape[0]] = torch.as_tensor(tokens, dtype=torch.long)
        lengths = torch.tensor([tokens.shape[0]], dtype=torch.long, device=self.device)
        return texts, lengths

    def acoustic(self, texts, lengths, durations, pe_style, speech_style, frames, draws):
        alignment = self.dp.duration_to_alignment(durations, frames)
        alignment_fine = self.dp.duration_to_alignment(
            durations, frames * self.mc.coarse_multiplier,
            multiplier=self.mc.coarse_multiplier)
        pitch, energy = self.models["pitch_energy_predictor"](texts, lengths, alignment,
                                                              pe_style)
        voiced = (pitch > 20.0).to(torch.float32)
        return self.models["speech_predictor"](
            texts, lengths, alignment_fine, pitch, energy, voiced, speech_style, pitch,
            source_draws=draws).audio

    @torch.inference_mode()
    def line(self, tokens: np.ndarray, speech_style, pe_style, duration_style,
             speed: float = 1.0, control: bool = False) -> np.ndarray:
        """The normalised waveform of one line (float32 with TF32 off;
        ``control``: TF32 on)."""
        with (precision.tf32() if control else precision.exact()):
            frames = fused_frames(tokens.shape[0], self.p95, speed)
            texts, lengths = self.tensors(tokens)

            def style(s):
                return torch.as_tensor(np.asarray(s, np.float32), device=self.device)[None]

            raw = self.models["duration_predictor"](texts, lengths, style(duration_style))
            durations = self.dp.prediction_to_duration(raw, lengths) / speed
            total = durations.sum(dim=1, keepdim=True)
            durations = durations * torch.clamp(
                (frames - 1.0) / torch.clamp_min(total, 1.0), max=1.0)
            gens = [torch.Generator(device=self.device).manual_seed(SOURCE_SEED)]
            draws = self.models["speech_predictor"].draw_sources(1, frames, gens, self.device)
            audio = self.acoustic(texts, lengths, durations, style(pe_style),
                                  style(speech_style), frames, draws)
            n = int(torch.round(durations.sum(dim=1))[0])
            hop = self.mc.hop_length * self.mc.coarse_multiplier
            audio = audio[0, :n * hop].float().cpu().numpy()
        return normalize_loudness(audio, self.mc.sample_rate, LUFS_TARGET)


class LineFlops:
    """Matrix-product and convolution FLOPs of one line's work at its real
    token count and frame count (no bucket padding), counted on the
    ``meta`` device: the duration predictor, then the acoustic phase."""

    def __init__(self, model: dict):
        from .stts.models import build_inference_models

        mc = model_config(model)
        synth = object.__new__(Synthesizer)
        synth.mc, synth.device = mc, torch.device("meta")
        with torch.device("meta"):
            synth.models = {k: m.eval() for k, m in build_inference_models(mc).items()}
        synth.dp = DurationProcessor(mc.duration_predictor.duration_classes,
                                     mc.duration_predictor.max_duration)
        self.synth = synth
        self.cache: Dict[tuple, float] = {}

    def __call__(self, n_tokens: int, frames: int) -> float:
        key = (n_tokens, frames)
        if key not in self.cache:
            self.cache[key] = self._count(n_tokens, frames)
        return self.cache[key]

    def _count(self, n_tokens: int, frames: int) -> float:
        from ttsbench.flops import count_flops

        synth, mc = self.synth, self.synth.mc
        texts = torch.zeros((1, n_tokens), dtype=torch.long, device="meta")
        lengths = torch.zeros((1,), dtype=torch.long, device="meta")
        style = torch.zeros((1, mc.style_dim), device="meta")
        durations = torch.zeros((1, n_tokens), device="meta")

        def work():
            with torch.no_grad():
                synth.models["duration_predictor"](texts, lengths, style)
                draws = synth.models["speech_predictor"].draw_sources(1, frames, None, "meta")
                synth.acoustic(texts, lengths, durations, style, style, frames, draws)

        return count_flops(work)
