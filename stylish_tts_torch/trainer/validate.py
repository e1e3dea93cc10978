"""Validation (pure eval, no updates): the port's
``stylish_tts_tpu/trainer/validate.py``.

Alignment: the CTC loss without priors goes through
``ctc_loss_with_priors_cuda``: under ``torch.no_grad()`` on a CUDA tensor
that is the forward kernel's alpha-only branch, on a CPU tensor the plain
version. The confidence is the mean over the batch of exp(score) of the
Viterbi best path.

Acoustic, textual and duration: the modules in eval mode, float32; the
speech predictor's sine source draws from a generator seeded 0 at every
call (the JAX ``PRNGKey(0)``), or takes an injected ``prior``. Acoustic:
the mel spectral convergence on the ground-truth prosody. Textual: the
same on the predicted F0 and energy (voiced where F0 > 20 Hz), plus their
smooth-L1. Duration: the durations' smooth-L1 and the unweighted class
cross entropy, and the audio of the whole text -> speech path with the
predicted durations. Each returns (metrics, predicted audio).
"""

from __future__ import annotations

import torch

from .. import losses as L
from ..ops.ctc import ctc_forced_align
from ..ops.ctc_cuda import ctc_loss_with_priors_cuda
from .state import StageTrainState, TrainState
from .steps import Batch, StepContext, _acoustic_features


def validate_alignment(state: TrainState, ctx: StepContext, batch: Batch):
    """(state, batch on the state's device) -> {"align_loss", "confidence"}
    as device scalars."""
    aligner = state.aligner
    aligner.eval()
    with torch.no_grad():
        mel = ctx.norm_mel(batch.audio_gt, ctx.to_align_mel)
        mel = mel.transpose(1, 2).contiguous()
        mel_lengths = torch.full((mel.shape[0],), mel.shape[1], dtype=torch.int32,
                                 device=mel.device)
        log_probs = aligner(mel, mel_lengths)
        text = batch.text.to(torch.int32).contiguous()
        text_lengths = batch.text_lengths.to(torch.int32).contiguous()
        loss = ctc_loss_with_priors_cuda(
            log_probs, mel_lengths, text, text_lengths, blank_id=ctx.blank_id,
        )
        res = ctc_forced_align(log_probs, mel_lengths, text, text_lengths,
                               blank_id=ctx.blank_id)
        confidence = torch.mean(torch.exp(res.scores))
    return {"align_loss": loss, "confidence": confidence}


def _predict_audio(state: StageTrainState, batch: Batch, alignment, pitch, energy,
                   style_mel, prior):
    """The speech predictor on the given prosody, style from the speech
    style encoder; F0 > 20 Hz is voiced."""
    generator = torch.Generator(device=batch.audio_gt.device)
    generator.manual_seed(0)
    style = state.models["speech_style_encoder"](style_mel)
    voiced = (pitch > 20.0).to(torch.float32)
    return state.models["speech_predictor"](
        batch.text, batch.text_lengths, alignment, pitch, energy, voiced, style, pitch,
        generator=generator, prior=prior).audio


def _predict_prosody(state: StageTrainState, batch: Batch, alignment, pitch, energy,
                     style_mel):
    pe_style = state.models["pe_style_encoder"](style_mel, pitch, energy)
    return state.models["pitch_energy_predictor"](batch.text, batch.text_lengths,
                                                  alignment, pe_style)


def _eval(state: StageTrainState) -> None:
    for m in state.models.values():
        m.eval()


def validate_acoustic(state: StageTrainState, ctx: StepContext, batch: Batch,
                      prior=None):
    """(state, batch on the state's device) -> ({"mel"}, predicted audio)."""
    _eval(state)
    mel, style_mel, energy, pitch, alignment, frames = _acoustic_features(ctx, batch)
    with torch.no_grad():
        audio_t = batch.audio_gt[:, : frames * ctx.mc.hop_length].to(torch.float32)
        audio = _predict_audio(state, batch, alignment, pitch, energy, style_mel, prior)
        mel_loss = L.spectral_convergence_loss(ctx.multi_spec(audio_t).mel,
                                               ctx.multi_spec(audio).mel)
    return {"mel": mel_loss}, audio


def validate_textual(state: StageTrainState, ctx: StepContext, batch: Batch,
                     prior=None):
    """(state, batch) -> ({"mel", "pitch", "energy"}, predicted audio)."""
    _eval(state)
    mel, style_mel, energy, pitch, alignment, frames = _acoustic_features(ctx, batch)
    with torch.no_grad():
        audio_t = batch.audio_gt[:, : frames * ctx.mc.hop_length].to(torch.float32)
        pred_pitch, pred_energy = _predict_prosody(state, batch, alignment, pitch, energy,
                                                   style_mel)
        audio = _predict_audio(state, batch, alignment, pred_pitch, pred_energy,
                               style_mel, prior)
        metrics = {"mel": L.spectral_convergence_loss(ctx.multi_spec(audio_t).mel,
                                                      ctx.multi_spec(audio).mel),
                   **L.pitch_energy_losses(pred_pitch, pitch, pred_energy, energy)}
    return metrics, audio


def validate_duration(state: StageTrainState, ctx: StepContext, batch: Batch,
                      prior=None):
    """(state, batch) -> ({"duration", "duration_ce"}, audio of the text ->
    speech path with the predicted durations, over the style mel's frames)."""
    _eval(state)
    dp = ctx.duration_processor
    with torch.no_grad():
        style_mel = ctx.norm_mel(batch.audio_gt, ctx.to_style_mel)
        duration_raw = state.models["duration_predictor"](
            batch.text, batch.text_lengths, state.models["duration_style_encoder"](style_mel))
        duration = dp.prediction_to_duration(duration_raw, batch.text_lengths)
        metrics = {
            "duration": L.masked_smooth_l1_per_sequence(
                duration, batch.durations.to(torch.float32), batch.text_lengths),
            "duration_ce": L.duration_ce_loss(
                duration_raw, dp.dur_to_class(batch.durations), batch.text_lengths,
                torch.ones(duration_raw.shape[-1], device=duration_raw.device)),
        }
        frames = style_mel.shape[-1]
        alignment = dp.duration_to_alignment(duration, frames)
        energy = ctx.energy_from_mel(ctx.norm_mel(batch.audio_gt, ctx.to_mel))
        pitch = batch.pitch[:, :frames].to(torch.float32)
        pred_pitch, pred_energy = _predict_prosody(state, batch, alignment, pitch, energy,
                                                   style_mel)
        audio = _predict_audio(state, batch, alignment, pred_pitch, pred_energy,
                               style_mel, prior)
    return metrics, audio


VALIDATORS = {
    "acoustic": validate_acoustic,
    "textual": validate_textual,
    "duration": validate_duration,
}
