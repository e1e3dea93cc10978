"""Alignment validation (pure eval, no updates): the alignment part of
``stylish_tts_tpu/trainer/validate.py``.

The CTC loss without priors goes through ``ctc_loss_with_priors_cuda``:
under ``torch.no_grad()`` on a CUDA tensor that is the forward kernel's
alpha-only branch, on a CPU tensor the plain version. The confidence is
the mean over the batch of exp(score) of the Viterbi best path.
"""

from __future__ import annotations

import torch

from ..ops.ctc import ctc_forced_align
from ..ops.ctc_cuda import ctc_loss_with_priors_cuda
from .state import TrainState
from .steps import Batch, StepContext


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
