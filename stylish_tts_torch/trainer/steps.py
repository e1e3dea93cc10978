"""Train steps: the alignment stage of ``stylish_tts_tpu/trainer/steps.py``.

alignment: log-mel of the batch audio -> TextAligner (with dropout) ->
CTC with label priors (scale 0.3) through the CUDA kernels on the card
(the plain version on the CPU) -> AdamW with the nonfinite guard; the
label priors accumulate from the detached posteriors and are refreshed
at each epoch's end.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..dsp.mel import MelSpectrogram
from ..ops import ctc as ctc_ops
from ..ops.ctc_cuda import ctc_loss_with_priors_cuda
from .optim import apply_module_update, cosine_lr
from .state import TrainState

PRIOR_SCALE = 0.3


class Batch(NamedTuple):
    """One fixed-shape (bucketed) training batch, numpy or torch."""

    audio_gt: object  # (B, S) float32, S = frames*hop
    text: object  # (B, L) int32
    text_lengths: object  # (B,)
    pitch: object  # (B, F) float32 F0 Hz
    durations: object  # (B, L) int32 frames per token
    slm_gt: Optional[object] = None


def batch_to_device(batch: Batch, device) -> Batch:
    return Batch(*(
        None if x is None else torch.as_tensor(np.asarray(x)).to(device)
        for x in batch
    ))


class StepContext:
    """Static step-construction context: the alignment parts of the JAX
    ``StepContext`` (normalization, the align mel transform, blank id,
    LR schedule constants)."""

    def __init__(self, model_config, loss_weights, normalization,
                 stage_steps: int = 10_000, base_lr: float = 1e-4):
        mc = model_config
        self.mc = mc
        self.weights = loss_weights
        self.norm = normalization
        self.stage_steps = stage_steps
        self.base_lr = base_lr
        self.to_align_mel = MelSpectrogram(
            n_mels=mc.text_aligner.n_mels, n_fft=mc.text_aligner.n_fft,
            win_length=mc.text_aligner.win_length,
            hop_length=mc.hop_length * mc.coarse_multiplier,
            sample_rate=mc.sample_rate,
        )
        self.blank_id = mc.text_encoder.tokens

    def norm_mel(self, audio, transform):
        mel = transform(audio)
        mel = (torch.log(1e-5 + mel) - self.norm.mel_log_mean) / self.norm.mel_log_std
        frames = mel.shape[-1] - (mel.shape[-1] % 2)
        return mel[:, :, :frames]


def make_alignment_step(ctx: StepContext):
    """(state, batch on the state's device) -> metrics; updates ``state``
    in place."""

    def step(state: TrainState, batch: Batch):
        aligner = state.aligner
        with torch.no_grad():
            mel = ctx.norm_mel(batch.audio_gt, ctx.to_align_mel)
            mel = mel.transpose(1, 2).contiguous()  # (B, F, 80)
        frames = mel.shape[1]
        mel_lengths = torch.full((mel.shape[0],), frames, dtype=torch.int32,
                                 device=mel.device)

        aligner.train()
        log_probs = aligner(mel, mel_lengths, generator=state.generator)
        loss = ctc_loss_with_priors_cuda(
            log_probs, mel_lengths, batch.text.to(torch.int32).contiguous(),
            batch.text_lengths.to(torch.int32).contiguous(),
            blank_id=ctx.blank_id, log_priors=state.log_priors,
            prior_scale=PRIOR_SCALE,
        ) * ctx.weights.get("align_loss", 1.0)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = cosine_lr(ctx.base_lr, state.step, ctx.stage_steps)
        apply_module_update(aligner, state.optimizer, lr)

        # label-prior accumulation (logsumexp-merge)
        with torch.no_grad():
            lse, count = ctc_ops.accumulate_label_priors(
                log_probs.detach(), mel_lengths
            )
            state.log_priors_sum = torch.logaddexp(state.log_priors_sum, lse)
            state.prior_count = state.prior_count + count
        state.step += 1
        return {"align_loss": loss.detach(), "lr": lr}

    return step


def finish_alignment_epoch(ctx: StepContext, state: TrainState) -> TrainState:
    """End-of-epoch label-prior update."""
    state.log_priors = ctc_ops.update_log_priors(
        state.log_priors_sum, state.prior_count
    )
    state.log_priors_sum = torch.full_like(state.log_priors_sum, -1e30)
    state.prior_count = torch.zeros_like(state.prior_count)
    return state
