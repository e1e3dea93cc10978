"""Validation (pure eval, no updates): the alignment and acoustic parts of
``stylish_tts_tpu/trainer/validate.py``.

Alignment: the CTC loss without priors goes through
``ctc_loss_with_priors_cuda``: under ``torch.no_grad()`` on a CUDA tensor
that is the forward kernel's alpha-only branch, on a CPU tensor the plain
version. The confidence is the mean over the batch of exp(score) of the
Viterbi best path.

Acoustic: the speech predictor in eval mode on the ground-truth prosody,
float32, its sine source drawn from a generator seeded 0 at every call
(the JAX ``PRNGKey(0)``), or an injected ``prior``; the metric is the mel
spectral convergence, and the predicted audio is returned for the eval
samples.
"""

from __future__ import annotations

import torch

from .. import losses as L
from ..ops.ctc import ctc_forced_align
from ..ops.ctc_cuda import ctc_loss_with_priors_cuda
from .state import AcousticTrainState, TrainState
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


def validate_acoustic(state: AcousticTrainState, ctx: StepContext, batch: Batch,
                      prior=None):
    """(state, batch on the state's device) -> ({"mel"}, predicted audio)."""
    sp = state.models["speech_predictor"]
    se = state.models["speech_style_encoder"]
    sp.eval()
    se.eval()
    mel, style_mel, energy, pitch, alignment, frames = _acoustic_features(ctx, batch)
    with torch.no_grad():
        audio_t = batch.audio_gt[:, : frames * ctx.mc.hop_length].to(torch.float32)
        style = se(style_mel)
        voiced = (pitch > 20.0).to(torch.float32)
        generator = torch.Generator(device=audio_t.device)
        generator.manual_seed(0)
        pred = sp(batch.text, batch.text_lengths, alignment, pitch, energy, voiced,
                  style, pitch, generator=generator, prior=prior)
        feats_t = ctx.multi_spec(audio_t)
        feats_p = ctx.multi_spec(pred.audio)
        mel_loss = L.spectral_convergence_loss(feats_t.mel, feats_p.mel)
    return {"mel": mel_loss}, pred.audio
