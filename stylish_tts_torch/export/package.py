"""Inference package: export and synthesis.

Counterpart of ``stylish_tts_tpu/export/package.py``. A package
directory holds the JAX package's files, so either package reads what
the other writes:

  params.safetensors   the six inference modules' weights in the flat
                       flax layout (``INFERENCE_MODULES``: the three that
                       synthesis runs and the three style encoders, which
                       ``voicepack`` runs)
  model_config.json    the full ModelConfig
  metadata.json        normalization, pitch log stats, duration stats

Synthesis runs in two phases as in JAX: (1) durations on the text bucket
L, (2) alignment -> pitch/energy -> speech on (L, frame bucket F), or as
one fused call when the package carries duration stats. PyTorch needs no
static shapes, but the buckets stay: AdaIN statistics run over all F
frames and the alignment softmax over all L text rows, so the bucket is
part of the function. The sine source of each batch row draws from its
own ``torch.Generator``, seeded with 0 on every call, so one request
always gives the same audio, alone or in a batch (the JAX package draws
from ``PRNGKey(0)`` on every call too, but for the batch as a whole).

The JAX package's ``warmup``, ``warmup_grid`` and ``_emit_stablehlo``
only compile XLA programs and have no counterpart; the port's artifact is
the package directory.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..convert.from_jax import module_from_jax, module_to_jax_flat
from ..models import INFERENCE_MODULES, build_inference_models
from ..ops.duration import DurationProcessor
from ..text import TextCleaner
from ..trainer.normalization import NormalizationStats
from ..utils.device import resolve_device
from ..utils.params_io import load_params_safetensors, save_params_safetensors

TEXT_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512)
FRAME_BUCKET_STEP = 100
SOURCE_SEED = 0


def frame_bucket(total_frames: int) -> int:
    return max(
        ((total_frames + FRAME_BUCKET_STEP - 1) // FRAME_BUCKET_STEP)
        * FRAME_BUCKET_STEP,
        FRAME_BUCKET_STEP,
    )


def text_bucket(n: int) -> int:
    for b in TEXT_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"text too long for inference buckets: {n}")


def duration_stats_from_cache(cache: Mapping) -> Dict[str, float]:
    """Per-utterance frames-per-token quantiles from an alignment cache;
    they pick the fused path's frame bucket."""
    fpt = []
    for arr in cache.values():
        d = np.asarray(arr, np.float64).reshape(-1)
        if d.size:
            fpt.append(d.sum() / d.size)
    if not fpt:
        return {}
    fpt = np.asarray(fpt)
    return {
        "frames_per_token_p05": float(np.percentile(fpt, 5)),
        "frames_per_token_p50": float(np.percentile(fpt, 50)),
        "frames_per_token_p95": float(np.percentile(fpt, 95)),
    }


def pitch_log2_stats(cache: Mapping | None) -> tuple:
    """(log2 mean, log2 std floored at 1e-6) of a pitch cache's F0 values
    above 10 Hz, in float32, as the JAX ``convert`` computes them: 7.0 and
    1.0 without a cache or without such a value, and for an empty cache
    the stats of one 128 Hz value."""
    if cache is None:
        return 7.0, 1.0
    vals = []
    for arr in cache.values():
        arr = np.asarray(arr)
        vals.append(arr[arr > 10])
    allp = np.concatenate(vals) if vals else np.array([128.0])
    if not allp.size:
        return 7.0, 1.0
    return float(np.log2(allp).mean()), float(max(np.log2(allp).std(), 1e-6))


def export_checkpoint(
    models: Mapping[str, nn.Module], model_config: ModelConfig,
    normalization: NormalizationStats, out_dir: str,
    pitch_log2_mean: float = 0.0, pitch_log2_std: float = 1.0,
    duration_stats: Dict[str, float] | None = None,
) -> str:
    """Write the six ``INFERENCE_MODULES`` of ``models`` (``build_models``'
    registry names) as a package directory in the JAX layout."""
    os.makedirs(out_dir, exist_ok=True)
    flat = {}
    for name in INFERENCE_MODULES:
        for key, value in module_to_jax_flat(
                models[name], scan_stacks=model_config.generator.scan_stacks).items():
            flat[f"{name}/{key}"] = value
    save_params_safetensors(osp.join(out_dir, "params.safetensors"), flat)
    with open(osp.join(out_dir, "model_config.json"), "w", encoding="utf-8") as f:
        f.write(model_config.model_dump_json(indent=2))
    meta = {
        "normalization": normalization.state_dict(),
        "pitch_log2_mean": pitch_log2_mean,
        "pitch_log2_std": pitch_log2_std,
        "framework": "stylish_tts_torch",
        "duration_stats": duration_stats or {},
    }
    with open(osp.join(out_dir, "metadata.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)
    return out_dir


class InferencePackage:
    """Loads a package directory and synthesises speech on ``device``
    (``cuda`` unless the caller asks for ``cpu``)."""

    def __init__(self, package_dir: str, device: str = "cuda"):
        params = load_params_safetensors(osp.join(package_dir, "params.safetensors"))
        with open(osp.join(package_dir, "model_config.json"), encoding="utf-8") as f:
            mc = ModelConfig.model_validate_json(f.read())
        with open(osp.join(package_dir, "metadata.json"), encoding="utf-8") as f:
            meta = json.load(f)
        self.device = resolve_device(device)
        self.mc = mc
        self.normalization = NormalizationStats(**meta["normalization"])
        self.duration_stats = meta.get("duration_stats") or None
        self.models = build_inference_models(mc)
        if mc.generator.type == "ringformer":
            # a line is cut at its frames x hop_length x coarse_multiplier
            # samples; the ringformer emits prod(upsample_rates) x its iSTFT
            # hop per (fine) frame
            samples = self.models["speech_predictor"].generator.prior_hop
            if samples != mc.hop_length:
                raise ValueError(
                    f"ringformer emits {samples} samples per frame (prod(upsample_rates) "
                    f"x gen_istft_hop_size), the package cuts at hop_length "
                    f"{mc.hop_length}")
        for name, module in self.models.items():
            module.load_state_dict(module_from_jax(module, params[name]))
            module.to(self.device).eval()
        self.text_cleaner = TextCleaner(mc.symbol)
        self.duration_processor = DurationProcessor(
            mc.duration_predictor.duration_classes, mc.duration_predictor.max_duration)

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.array(x), dtype=dtype, device=self.device)

    def _source_generators(self, batch: int):
        return [torch.Generator(device=self.device).manual_seed(SOURCE_SEED)
                for _ in range(batch)]

    # ---- phase 1: durations ---------------------------------------------

    @torch.inference_mode()
    def durations(self, texts: torch.Tensor, lengths: torch.Tensor,
                  style: torch.Tensor) -> torch.Tensor:
        """texts (B, L) on the device -> expected durations (B, L)."""
        raw = self.models["duration_predictor"](texts, lengths, style)
        return self.duration_processor.prediction_to_duration(raw, lengths)

    # ---- phase 2: acoustic ----------------------------------------------

    @torch.inference_mode()
    def acoustic(self, texts: torch.Tensor, lengths: torch.Tensor,
                 durations: torch.Tensor, pe_style: torch.Tensor,
                 speech_style: torch.Tensor, frames: int, *,
                 prior: torch.Tensor | None = None,
                 deterministic_prior: bool = False) -> torch.Tensor:
        """Durations (B, L) -> audio (B, frames * hop * coarse_multiplier)."""
        dp = self.duration_processor
        coarse = self.mc.coarse_multiplier
        alignment = dp.duration_to_alignment(durations, frames)
        alignment_fine = dp.duration_to_alignment(durations, frames * coarse,
                                                  multiplier=coarse)
        pitch, energy = self.models["pitch_energy_predictor"](
            texts, lengths, alignment, pe_style)
        voiced = (pitch > 20.0).to(torch.float32)
        return self.models["speech_predictor"](
            texts, lengths, alignment_fine, pitch, energy, voiced, speech_style, pitch,
            generator=self._source_generators(texts.shape[0]), prior=prior,
            deterministic_prior=deterministic_prior).audio

    @torch.inference_mode()
    def fused(self, texts, lengths, dur_style, pe_style, speech_style,
              inv_speed: float, frames: int):
        """One call: durations -> proportional squeeze into the frame bucket
        when they overflow it -> acoustic. Returns (audio, totals (B,))."""
        durations = self.durations(texts, lengths, dur_style) * inv_speed
        total = durations.sum(dim=1, keepdim=True)
        durations = durations * torch.clamp(
            (frames - 1.0) / torch.clamp_min(total, 1.0), max=1.0)
        audio = self.acoustic(texts, lengths, durations, pe_style, speech_style, frames)
        return audio, torch.round(durations.sum(dim=1)).to(torch.int32)

    def _fused_frame_bucket(self, n_tokens: int, speed: float) -> int | None:
        """Frame bucket for the fused path, or None when the package has no
        duration stats (two-phase then)."""
        p95 = (self.duration_stats or {}).get("frames_per_token_p95")
        if not p95:
            return None
        return frame_bucket(int(np.ceil(n_tokens * p95 / speed)))

    # ---- public API ------------------------------------------------------

    def tokenize(self, text: str) -> np.ndarray:
        return np.asarray(self.text_cleaner(text), np.int32)

    def _texts(self, token_lists):
        lens = np.asarray([t.shape[0] for t in token_lists], np.int32)
        L = text_bucket(int(lens.max()))
        texts = np.zeros((len(token_lists), L), np.int32)
        for i, t in enumerate(token_lists):
            texts[i, :t.shape[0]] = t
        return self._tensor(texts, torch.long), self._tensor(lens, torch.long)

    def generate_speech(self, tokens: np.ndarray, speech_style, pe_style,
                        duration_style, speed: float = 1.0,
                        fused: bool | None = None) -> np.ndarray:
        """tokens (n,) -> waveform float32 (samples,).

        ``fused=None`` takes the fused path when the package carries
        duration stats; True forces it (needs stats), False two-phase."""
        texts, lengths = self._texts([tokens])
        hop = self.mc.hop_length * self.mc.coarse_multiplier
        f_fused = self._fused_frame_bucket(tokens.shape[0], speed)
        if fused is None:
            fused = f_fused is not None
        if fused:
            if f_fused is None:
                raise ValueError(
                    "fused path needs duration_stats in the package metadata")
            audio, totals = self.fused(
                texts, lengths, self._tensor(duration_style)[None],
                self._tensor(pe_style)[None], self._tensor(speech_style)[None],
                1.0 / speed, f_fused)
            return audio[0, :int(totals[0]) * hop].cpu().numpy()

        durations = self.durations(texts, lengths,
                                   self._tensor(duration_style)[None]).cpu().numpy()
        durations = durations / speed
        total = int(round(float(durations.sum())))
        audio = self.acoustic(texts, lengths, self._tensor(durations),
                              self._tensor(pe_style)[None],
                              self._tensor(speech_style)[None], frame_bucket(total))
        return audio[0, :total * hop].cpu().numpy()

    def generate_speech_batch(self, token_lists, speech_styles, pe_styles,
                              duration_styles, speed: float = 1.0):
        """Token arrays -> waveforms, the batch padded to one (text bucket,
        frame bucket) pair, two-phase. Styles are (B, style_dim) or one
        shared vector."""
        b = len(token_lists)
        texts, lengths = self._texts(token_lists)

        def tile(style):
            s = np.asarray(style, np.float32)
            return self._tensor(np.broadcast_to(s, (b, self.mc.style_dim)))

        durations = self.durations(texts, lengths, tile(duration_styles)).cpu().numpy()
        durations = durations / speed
        totals = np.round(durations.sum(axis=1)).astype(int)
        audio = self.acoustic(texts, lengths, self._tensor(durations), tile(pe_styles),
                              tile(speech_styles), frame_bucket(int(totals.max())))
        audio = audio.cpu().numpy()
        hop = self.mc.hop_length * self.mc.coarse_multiplier
        return [audio[i, :totals[i] * hop] for i in range(b)]
