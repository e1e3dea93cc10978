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

The JAX package serves every request through one program per bucket
(``_duration_fns[L]``, ``_acoustic_fns[(L, F)]``, ``_fused_fns[(L, F)]``),
compiled on the first request at its bucket or ahead of time by
``warmup`` over ``warmup_grid``. The port keeps those caches under the
same names; a program here is a ``programs.BucketProgram``: a CUDA graph
on the card, captured once and replayed as one launch (the eager call on
the CPU). An entry holds one program per batch size. The source draws of
a program are made once per (B, F) from the per-row generators seeded 0,
so a program gives the eager call's audio. The JAX ``convert --stablehlo``
(``_emit_stablehlo``) writes the acoustic phase at (32, 100) as a
StableHLO module; the port's ``convert --exported-program``
(``emit_exported_program``) writes it as a ``torch.export`` program,
``exported_program/acoustic_L32_F100.pt2``, which the JAX package ignores.

Spans (``utils/trace.py``), each with the line's number (a count of the
package's ``generate_speech`` calls): ``speak.line`` around a call, with
``speak.prep`` (bucketing and the inputs' copies to the device),
``program.replay`` (in ``programs.py``) and ``speak.fetch`` (the host waits
for the device and copies the result back) inside it. The counter
``programs.built`` (``BUILT``) counts the programs built, by phase.
"""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..config import F5Config, KokoroConfig, ModelConfig
from ..convert.from_jax import module_from_jax, module_to_jax_flat
from ..models import INFERENCE_MODULES, build_inference_models
from ..models.generator import SourceDraws
from ..ops.duration import DurationProcessor
from ..text import TextCleaner
from ..trainer.normalization import NormalizationStats
from ..utils.params_io import load_params_safetensors, save_params_safetensors
from ..utils.trace import span
from .kokoro import export_kokoro
from .programs import (  # noqa: F401  (BUILT, text_bucket: imported from here too)
    BUILT, FRAME_BUCKET_STEP, SOURCE_SEED, TEXT_BUCKETS, BucketPackage, BucketProgram,
    frame_bucket, text_bucket)

logger = logging.getLogger("stylish_tts_torch")

# frame buckets per text bucket that ``warmup`` builds at most
MAX_FRAMES_PER_BUCKET = 8


def duration_stats_from_cache(cache: Mapping) -> Dict[str, float]:
    """Per-utterance frames-per-token quantiles from an alignment cache;
    they pick the fused path's frame bucket and ``warmup``'s grid."""
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


def warmup_grid(text_buckets, duration_stats=None, max_frames_per_text=None):
    """The (L, F) acoustic program grid that ``warmup`` builds, as the JAX
    ``warmup_grid`` computes it.

    With duration stats, text bucket L covers utterances of n in (previous
    bucket, L] tokens at p05..p95 frames per token, so its frame buckets
    run over [(P + 1) * p05, L * p95], thinned evenly to at most
    ``MAX_FRAMES_PER_BUCKET`` (a request at a skipped bucket builds its
    program then). Without stats, ~8 frames per token and one bucket more.
    Buckets above ``max_frames_per_text`` are left out."""
    grid = []
    prev = 0
    for L in text_buckets:
        if duration_stats and "frames_per_token_p95" in duration_stats:
            lo_frames = (prev + 1) * duration_stats["frames_per_token_p05"]
            hi_frames = L * duration_stats["frames_per_token_p95"]
            lo = frame_bucket(max(1, int(np.floor(lo_frames))))
            hi = frame_bucket(int(np.ceil(hi_frames)))
            frames = list(range(lo, hi + 1, FRAME_BUCKET_STEP))
            if len(frames) > MAX_FRAMES_PER_BUCKET:
                idx = np.linspace(
                    0, len(frames) - 1, MAX_FRAMES_PER_BUCKET
                ).round().astype(int)
                logger.warning(
                    "warmup grid for text bucket %d spans %d frame buckets; "
                    "thinning to %d (a request elsewhere builds its program)",
                    L, len(frames), MAX_FRAMES_PER_BUCKET,
                )
                frames = [frames[i] for i in idx]
        else:
            expect = frame_bucket(L * 8)
            frames = (expect, expect + FRAME_BUCKET_STEP)
        for F in frames:
            if max_frames_per_text and F > max_frames_per_text:
                continue
            grid.append((L, F))
        prev = L
    return grid


def fused_grid(text_buckets, frames_per_token_p95, max_frames_per_text=None):
    """The (L, F) fused programs ``warmup`` builds: ``generate_speech``
    picks F = bucket(n * p95 / speed), so at speed 1 text bucket L reaches
    [bucket((P + 1) * p95), bucket(L * p95)] (the JAX ``warmup``'s range)."""
    grid = []
    prev = 0
    for L in text_buckets:
        lo = frame_bucket(int(np.ceil((prev + 1) * frames_per_token_p95)))
        hi = frame_bucket(int(np.ceil(L * frames_per_token_p95)))
        for F in range(lo, hi + 1, FRAME_BUCKET_STEP):
            if max_frames_per_text and F > max_frames_per_text:
                continue
            grid.append((L, F))
        prev = L
    return grid


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
    emit_exported_program: bool = False, device: str = "cuda",
) -> str:
    """Write the six ``INFERENCE_MODULES`` of ``models`` (``build_models``'
    registry names) as a package directory in the JAX layout; with
    ``emit_exported_program``, also the acoustic phase at (32, 100) as a
    ``torch.export`` program traced on ``device``. A ``KokoroConfig``
    writes a Kokoro package instead (``export/kokoro.py``; the
    normalisation and statistics do not apply)."""
    if isinstance(model_config, KokoroConfig):
        return export_kokoro(models, model_config, out_dir)
    if isinstance(model_config, F5Config):
        from .f5 import export_f5

        return export_f5(models, model_config, out_dir)
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
    if emit_exported_program:
        _emit_exported_program(out_dir, device)
    return out_dir


def exported_program_path(package_dir: str, L: int = TEXT_BUCKETS[0],
                          F: int = FRAME_BUCKET_STEP) -> str:
    return osp.join(package_dir, "exported_program", f"acoustic_L{L}_F{F}.pt2")


def _emit_exported_program(out_dir: str, device: str) -> str:
    """``torch.export`` of the acoustic phase at the smallest bucket pair,
    B = 1, its source draws among the inputs (the counterpart of the JAX
    ``_emit_stablehlo``). Traced on ``device``: the graph holds the device
    of the tensors it makes, so a program traced on the CPU runs there. One
    eager call first makes the cached constants (DFT bases, duration
    tables) as real tensors; made while tracing, the cache would keep
    the tracer's fake ones."""
    pkg = InferencePackage(out_dir, device=device)
    L, F = TEXT_BUCKETS[0], FRAME_BUCKET_STEP
    module, args = pkg._acoustic_module_and_args(L, F)
    with torch.no_grad():
        module(*args)
        program = torch.export.export(module, args, strict=False)
    path = exported_program_path(out_dir, L, F)
    os.makedirs(osp.dirname(path), exist_ok=True)
    torch.export.save(program, path)
    return path


def acoustic_phase(models: Mapping[str, nn.Module], dp: DurationProcessor, coarse: int,
                   texts: torch.Tensor, lengths: torch.Tensor, durations: torch.Tensor,
                   pe_style: torch.Tensor, speech_style: torch.Tensor, frames: int, *,
                   generator=None, prior: torch.Tensor | None = None,
                   deterministic_prior: bool = False,
                   source_draws: SourceDraws | None = None) -> torch.Tensor:
    """Durations (B, L) -> audio (B, frames * hop * coarse): the soft
    alignments, pitch and energy, the speech predictor."""
    alignment = dp.duration_to_alignment(durations, frames)
    alignment_fine = dp.duration_to_alignment(durations, frames * coarse,
                                              multiplier=coarse)
    pitch, energy = models["pitch_energy_predictor"](texts, lengths, alignment, pe_style)
    voiced = (pitch > 20.0).to(torch.float32)
    return models["speech_predictor"](
        texts, lengths, alignment_fine, pitch, energy, voiced, speech_style, pitch,
        generator=generator, prior=prior, deterministic_prior=deterministic_prior,
        source_draws=source_draws).audio


class AcousticPhase(nn.Module):
    """The acoustic phase at frame bucket ``frames`` as a module of tensor
    inputs, the source draws among them (``rand_ini``, and the FreeGAN
    sine source's ``noise``): what ``torch.export`` traces."""

    def __init__(self, pkg: "InferencePackage", frames: int):
        super().__init__()
        self.pitch_energy_predictor = pkg.models["pitch_energy_predictor"]
        self.speech_predictor = pkg.models["speech_predictor"]
        self.duration_processor = pkg.duration_processor
        self.coarse = pkg.mc.coarse_multiplier
        self.frames = frames

    def forward(self, texts, lengths, durations, pe_style, speech_style, rand_ini,
                noise=None):
        models = {"pitch_energy_predictor": self.pitch_energy_predictor,
                  "speech_predictor": self.speech_predictor}
        return acoustic_phase(models, self.duration_processor, self.coarse, texts,
                              lengths, durations, pe_style, speech_style, self.frames,
                              source_draws=SourceDraws(rand_ini, noise))


class InferencePackage(BucketPackage):
    """Loads a package directory and synthesises speech on ``device``
    (``cuda`` unless the caller asks for ``cpu``).

    Requests go through one program per bucket (``programs.BucketProgram``),
    built on the first request at its bucket or ahead of time by ``warmup``;
    the eager ``durations``, ``acoustic`` and ``fused`` are the functions the
    programs run. ``export.open_package`` opens a directory of either
    family as its own class."""

    def __init__(self, package_dir: str, device: str = "cuda"):
        params = load_params_safetensors(osp.join(package_dir, "params.safetensors"))
        with open(osp.join(package_dir, "model_config.json"), encoding="utf-8") as f:
            mc = ModelConfig.model_validate_json(f.read())
        with open(osp.join(package_dir, "metadata.json"), encoding="utf-8") as f:
            meta = json.load(f)
        super().__init__(device)
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
        self._fused_fns: Dict[tuple, Dict[int, BucketProgram]] = {}
        self._source_draws: Dict[tuple, SourceDraws] = {}

    def _source_generators(self, batch: int):
        return [torch.Generator(device=self.device).manual_seed(SOURCE_SEED)
                for _ in range(batch)]

    @torch.inference_mode()
    def source_draws(self, batch: int, frames: int) -> SourceDraws:
        """The source draws of a (batch, frame bucket) program: what the
        per-row generators of ``acoustic`` give, drawn once and kept."""
        key = (batch, frames)
        if key not in self._source_draws:
            self._source_draws[key] = self.models["speech_predictor"].draw_sources(
                batch, frames, self._source_generators(batch), self.device)
        return self._source_draws[key]

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
                 deterministic_prior: bool = False,
                 source_draws: SourceDraws | None = None) -> torch.Tensor:
        """Durations (B, L) -> audio (B, frames * hop * coarse_multiplier).
        The source draws from the per-row generators unless ``source_draws``
        brings its numbers."""
        generator = self._source_generators(texts.shape[0]) if source_draws is None else None
        return acoustic_phase(self.models, self.duration_processor,
                              self.mc.coarse_multiplier, texts, lengths, durations,
                              pe_style, speech_style, frames, generator=generator,
                              prior=prior, deterministic_prior=deterministic_prior,
                              source_draws=source_draws)

    @torch.inference_mode()
    def fused(self, texts, lengths, dur_style, pe_style, speech_style,
              inv_speed, frames: int, *, source_draws: SourceDraws | None = None):
        """One call: durations -> proportional squeeze into the frame bucket
        when they overflow it -> acoustic. ``inv_speed``: a float or a 0-d
        float32 tensor on the device. Returns (audio, totals (B,))."""
        if not torch.is_tensor(inv_speed):
            inv_speed = torch.tensor(inv_speed, dtype=torch.float32, device=texts.device)
        durations = self.durations(texts, lengths, dur_style) * inv_speed
        total = durations.sum(dim=1, keepdim=True)
        durations = durations * torch.clamp(
            (frames - 1.0) / torch.clamp_min(total, 1.0), max=1.0)
        audio = self.acoustic(texts, lengths, durations, pe_style, speech_style, frames,
                              source_draws=source_draws)
        return audio, torch.round(durations.sum(dim=1)).to(torch.int32)

    def _fused_frame_bucket(self, n_tokens: int, speed: float) -> int | None:
        """Frame bucket for the fused path, or None when the package has no
        duration stats (two-phase then)."""
        p95 = (self.duration_stats or {}).get("frames_per_token_p95")
        if not p95:
            return None
        return frame_bucket(int(np.ceil(n_tokens * p95 / speed)))

    # ---- programs per bucket ---------------------------------------------

    def _example(self, batch: int, L: int, *styles: str):
        sd = self.mc.style_dim
        texts = torch.ones((batch, L), dtype=torch.long, device=self.device)
        lengths = torch.ones((batch,), dtype=torch.long, device=self.device)
        return (texts, lengths) + tuple(
            torch.ones((batch, L), device=self.device) if s == "durations"
            else torch.zeros((batch, sd), device=self.device) for s in styles)

    def _duration_fn(self, L: int, batch: int = 1, example=None) -> BucketProgram:
        """(texts, lengths, style) -> durations at text bucket L. ``example``:
        the inputs a miss builds its static inputs from (the first
        request's; ones and zeros without it), here and below."""
        return self._program("duration", self._duration_fns, L, batch, self.durations,
                             example or self._example(batch, L, "style"))

    def _acoustic_fn(self, L: int, F: int, batch: int = 1, example=None) -> BucketProgram:
        """(texts, lengths, durations, pe_style, speech_style) -> audio at
        (L, F)."""
        draws = self.source_draws(batch, F)

        def fn(texts, lengths, durations, pe_style, speech_style):
            return self.acoustic(texts, lengths, durations, pe_style, speech_style, F,
                                 source_draws=draws)

        return self._program("acoustic", self._acoustic_fns, (L, F), batch, fn,
                             example or self._example(batch, L, "durations", "style",
                                                      "style"))

    def _fused_fn(self, L: int, F: int, batch: int = 1, example=None) -> BucketProgram:
        """(texts, lengths, dur_style, pe_style, speech_style, inv_speed) ->
        (audio, totals) at (L, F); ``inv_speed`` a 0-d input, so that a new
        speed replays the same program."""
        draws = self.source_draws(batch, F)

        def fn(texts, lengths, dur_style, pe_style, speech_style, inv_speed):
            return self.fused(texts, lengths, dur_style, pe_style, speech_style,
                              inv_speed, F, source_draws=draws)

        example = example or self._example(batch, L, "style", "style", "style") + (
            torch.ones((), device=self.device),)
        return self._program("fused", self._fused_fns, (L, F), batch, fn, example)

    def _acoustic_module_and_args(self, L: int, F: int):
        """The acoustic phase at (L, F), B = 1, and example inputs of the
        JAX ``_acoustic_fn_and_args``' values, for ``torch.export``."""
        texts, lengths, durations, pe_style, speech_style = self._example(
            1, L, "durations", "style", "style")
        draws = self.source_draws(1, F)
        args = (texts, lengths, durations, pe_style, speech_style, draws.rand_ini)
        if draws.noise is not None:
            args += (draws.noise,)
        return AcousticPhase(self, F), args

    def warmup(self, text_buckets=None, max_frames_per_text=None) -> int:
        """Build the bucket programs ahead of the requests, as the JAX
        ``warmup`` compiles them: a duration program per text bucket, the
        acoustic programs of ``warmup_grid`` and, with duration stats, the
        fused programs of ``fused_grid``, all at B = 1. Returns the number of
        acoustic and fused programs (the duration programs are not
        counted, as there).

        The largest frame bucket is built first: the pool's blocks that a
        capture frees are split for the smaller captures after it, where in
        ascending order each capture would add larger blocks of its own."""
        text_buckets = text_buckets or TEXT_BUCKETS
        programs = [(F, L, self._acoustic_fn) for L, F in
                    warmup_grid(text_buckets, self.duration_stats, max_frames_per_text)]
        p95 = (self.duration_stats or {}).get("frames_per_token_p95")
        if p95:
            programs += [(F, L, self._fused_fn)
                         for L, F in fused_grid(text_buckets, p95, max_frames_per_text)]
        for F, L, build in sorted(programs, key=lambda p: p[:2], reverse=True):
            build(L, F)
        for L in sorted(text_buckets, reverse=True):
            self._duration_fn(L)
        return len(programs)

    # ---- public API ------------------------------------------------------

    def tokenize(self, text: str) -> np.ndarray:
        return np.asarray(self.text_cleaner(text), np.int32)

    def load_voice(self, path: str):
        """A static or dynamic voicepack as the function that gives a line's
        three styles from its text and tokens. Imported here: the ``tts``
        package is heavy, and synthesis without ``speak`` needs none of it."""
        from ..tts.voicepack import load_voicepack, lookup_dynamic_style, lookup_static_style

        pack = load_voicepack(path)
        if pack["kind"] != "dynamic":
            return lambda text, tokens: lookup_static_style(pack, tokens.shape[0])
        from ..textproc.embed import get_embedder

        embed = get_embedder()
        return lambda text, tokens: lookup_dynamic_style(pack, embed([text])[0])

    def speak_line(self, text: str, voice, speed: float = 1.0) -> np.ndarray:
        tokens = self.tokenize(text)
        return self.generate_speech(tokens, *voice(text, tokens), speed=speed)

    def generate_speech(self, tokens: np.ndarray, speech_style, pe_style,
                        duration_style, speed: float = 1.0,
                        fused: bool | None = None) -> np.ndarray:
        """tokens (n,) -> waveform float32 (samples,), through the programs
        of its buckets.

        ``fused=None`` takes the fused path when the package carries
        duration stats; True forces it (needs stats), False two-phase."""
        with self._line():
            with span("speak.prep"):
                texts, lengths = self._texts([tokens])
                L = texts.shape[1]
                hop = self.mc.hop_length * self.mc.coarse_multiplier
                f_fused = self._fused_frame_bucket(tokens.shape[0], speed)
                if fused is None:
                    fused = f_fused is not None
                if fused and f_fused is None:
                    raise ValueError(
                        "fused path needs duration_stats in the package metadata")
                if fused:
                    inputs = (texts, lengths, self._tensor(duration_style)[None],
                              self._tensor(pe_style)[None], self._tensor(speech_style)[None],
                              self._tensor(1.0 / speed))
                else:
                    inputs = (texts, lengths, self._tensor(duration_style)[None])
            if fused:
                audio, totals = self._fused_fn(L, f_fused, 1, inputs)(*inputs)
                with span("speak.fetch"):
                    return audio[0, :int(totals[0]) * hop].cpu().numpy()

            durations = self._duration_fn(L, 1, inputs)(*inputs)
            with span("speak.fetch"):
                durations = durations.cpu().numpy() / speed
            with span("speak.prep"):
                total = int(round(float(durations.sum())))
                inputs = (texts, lengths, self._tensor(durations), self._tensor(pe_style)[None],
                          self._tensor(speech_style)[None])
            audio = self._acoustic_fn(L, frame_bucket(total), 1, inputs)(*inputs)
            with span("speak.fetch"):
                return audio[0, :total * hop].cpu().numpy()

    def generate_speech_batch(self, token_lists, speech_styles, pe_styles,
                              duration_styles, speed: float = 1.0):
        """Token arrays -> waveforms, the batch padded to one (text bucket,
        frame bucket) pair, two-phase, through that pair's programs at
        this batch size. Styles are (B, style_dim) or one shared vector."""
        b = len(token_lists)
        texts, lengths = self._texts(token_lists)
        L = texts.shape[1]

        def tile(style):
            s = np.asarray(style, np.float32)
            return self._tensor(np.broadcast_to(s, (b, self.mc.style_dim)))

        inputs = (texts, lengths, tile(duration_styles))
        durations = self._duration_fn(L, b, inputs)(*inputs).cpu().numpy() / speed
        totals = np.round(durations.sum(axis=1)).astype(int)
        inputs = (texts, lengths, self._tensor(durations), tile(pe_styles), tile(speech_styles))
        audio = self._acoustic_fn(L, frame_bucket(int(totals.max())), b, inputs)(*inputs)
        audio = audio.cpu().numpy()
        hop = self.mc.hop_length * self.mc.coarse_multiplier
        return [audio[i, :totals[i] * hop] for i in range(b)]
